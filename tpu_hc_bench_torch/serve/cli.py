"""``python -m tpu_hc_bench_torch serve``: the port's serving entry point.

Exit codes, as in the JAX lane:

- ``0``  clean (every request completed, shed, or quarantined)
- ``1``  run completed but zero requests finished
- ``70`` the scheduler-iteration watchdog fired (``--serve_step_timeout_s``)
- ``75`` SIGTERM honored: the engine drained and journaled every
  unfinished request; ``--serve_resume=<journal>`` replays each once
- ``130`` Ctrl-C outside the engine's loop (inside it, SIGINT drains)

With ``--metrics_dir`` the run leaves ``manifest.json`` and
``metrics.jsonl`` (JAX's formats), the heartbeat file
``metrics.0.jsonl``, the flight recorder's ``spans.0.jsonl`` and, when
a signal fired, ``signals.jsonl``; the banner prints the summarize
command.  On every exit path, Ctrl-C included, the metrics stream and
the heartbeat file are flushed and closed.

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


def serve_writer(cfg, metrics_dir):
    """A MetricsWriter stamped with the serve lane's manifest, or a
    disabled writer when ``metrics_dir`` is falsy."""
    from tpu_hc_bench_torch import resolve_device
    from tpu_hc_bench_torch.obs import metrics as obs_metrics

    return obs_metrics.MetricsWriter(
        metrics_dir,
        obs_metrics.run_manifest(cfg=cfg, device=resolve_device(cfg.device),
                                 extra={"workload": "serve"})
        if metrics_dir else None)


def run_serve(engine, requests, writer, *, batching=None, clock=None):
    """One closed loop with the writer(s) closed on every exit path.

    A metrics run also gets a FleetWriter beside the stream: the engine
    heartbeats at the serve-record cadence with ``kv_peak_pages``.  The
    serve lane is one process, so its process index is 0."""
    fleet = None
    out_dir = getattr(writer, "out_dir", None)
    if out_dir:
        from tpu_hc_bench_torch.obs import fleet as fleet_mod

        fleet = fleet_mod.FleetWriter(out_dir, process_index=0)
    try:
        return engine.run(requests, batching=batching, writer=writer,
                          clock=clock, fleet=fleet)
    finally:
        writer.close()
        if fleet is not None:
            fleet.close()


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
    writer = serve_writer(cfg, cfg.metrics_dir)
    if writer.enabled:
        from tpu_hc_bench_torch.obs import metrics as obs_metrics

        print_fn(f"metrics: {cfg.metrics_dir}/{obs_metrics.METRICS_NAME} "
                 f"(+ {obs_metrics.MANIFEST_NAME})")
    try:
        summary = run_serve(engine, requests, writer)
    except KeyboardInterrupt:
        # the engine's own handler turns SIGINT into a drain while run()
        # is live; this is a Ctrl-C outside that window — run_serve's
        # finally already closed the streams
        print_fn("interrupted — metrics stream closed")
        return 130
    for line in slo_mod.slo_lines(summary):
        print_fn(line)
    if cfg.metrics_dir:
        print_fn("summarize: python -m tpu_hc_bench_torch.obs summarize "
                 + cfg.metrics_dir)
    if summary.get("drained"):
        from tpu_hc_bench_torch.resilience import EXIT_PREEMPTED

        return EXIT_PREEMPTED
    return 0 if summary["completed"] > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
