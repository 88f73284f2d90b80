"""``python -m tpu_hc_bench_torch serve``: the port's serving entry point.

Exit codes, as in the JAX lane:

- ``0``  clean (every request completed)
- ``1``  run completed but zero requests finished

Example (on the GPU; add ``--device=cpu`` and a small model to run on
the CPU)::

    python -m tpu_hc_bench_torch serve --model=llama_1b \
        --decode_attention=paged --max_prompt_len=512 \
        --max_output_len=64 --max_in_flight=8 --num_requests=16 \
        --arrival_rate=64
"""

from __future__ import annotations

import sys
from typing import Callable

from tpu_hc_bench_torch import flags as flags_mod


def build_engine_and_requests(cfg, print_fn, model=None):
    """Construct the warmed engine, then the arrival trace."""
    from tpu_hc_bench_torch.serve import arrivals
    from tpu_hc_bench_torch.serve.engine import ServeEngine

    engine = ServeEngine(cfg, print_fn=print_fn, model=model)
    return engine, arrivals.build_requests(cfg, engine.spec.vocab_size)


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
    summary = engine.run(requests)
    for line in slo_mod.slo_lines(summary):
        print_fn(line)
    return 0 if summary["completed"] > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
