"""``python -m tpu_hc_bench_torch serve``: the port's serving entry point.

Exit codes, as in the JAX lane:

- ``0``  clean (every request completed, shed, or quarantined)
- ``1``  run completed but zero requests finished
- ``70`` the scheduler-iteration watchdog fired (``--serve_step_timeout_s``)
- ``75`` SIGTERM honored: the engine drained and journaled every
  unfinished request; ``--serve_resume=<journal>`` replays each once

Example (on the GPU; add ``--device=cpu`` and a small model to run on
the CPU)::

    python -m tpu_hc_bench_torch serve --model=llama_1b \
        --decode_attention=paged --max_prompt_len=512 \
        --max_output_len=64 --max_in_flight=8 --num_requests=16 \
        --arrival_rate=64
    python -m tpu_hc_bench_torch serve --model=resnet50 \
        --max_in_flight=8 --num_requests=32       # classify requests
"""

from __future__ import annotations

import sys
from typing import Callable

from tpu_hc_bench_torch import flags as flags_mod


def build_engine_and_requests(cfg, print_fn, model=None):
    """Construct the warmed engine, then the arrival trace: classify
    members carry no vocabulary, so their trace has no prompts."""
    from tpu_hc_bench_torch.serve import arrivals
    from tpu_hc_bench_torch.serve.engine import ServeEngine

    engine = ServeEngine(cfg, print_fn=print_fn, model=model)
    vocab = engine.spec.vocab_size if engine.decode_mode else None
    return engine, arrivals.build_requests(cfg, vocab)


def main(argv: list[str] | None = None,
         print_fn: Callable[[str], None] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    print_fn = print_fn or (lambda m: print(m, flush=True))
    cfg = flags_mod.parse_flags(argv)

    from tpu_hc_bench_torch.serve import slo as slo_mod

    print_fn(f"command: python -m tpu_hc_bench_torch serve "
             f"{' '.join(argv)}")
    for line in cfg.summary_lines():
        print_fn(line)
    engine, requests = build_engine_and_requests(cfg, print_fn)
    if cfg.serve_resume:
        # drain-journal replay: the journal is the trace
        from tpu_hc_bench_torch.serve import faults as faults_mod

        payload = faults_mod.read_journal(cfg.serve_resume)
        requests = faults_mod.journal_requests(payload)
        print_fn(f"resume: {len(requests)} unfinished request(s) from "
                 f"{cfg.serve_resume} (reason={payload.get('reason')})")
    summary = engine.run(requests)
    for line in slo_mod.slo_lines(summary):
        print_fn(line)
    if summary.get("drained"):
        from tpu_hc_bench_torch.resilience import EXIT_PREEMPTED

        return EXIT_PREEMPTED
    return 0 if summary["completed"] > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
