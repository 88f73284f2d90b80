"""Observability of the port's training and serving lanes: copies of the
JAX package's ``obs`` modules, importing no JAX, whose on-disk formats
are the JAX package's (either package's readers render the other's run
directories).

- ``metrics``: ``MetricsWriter`` (``manifest.json`` + ``metrics.jsonl``),
  ``read_run``, ``summarize_run`` and ``diff_runs`` (training and
  serving runs);
- ``goodput``: the phase ledger (``PhaseTracker``, ``build_ledger``);
- ``efficiency``: MFU measured against analytic, the gradient
  all-reduce's bytes, the fabric ceiling and collective overlap;
- ``trace``: step buckets of a ``torch.profiler`` (Kineto) trace;
- ``sketch``: the mergeable quantile sketch behind every percentile;
- ``requests``: per-request attribution, bucket utilization, request
  lanes of the timeline;
- ``kv``: the KV-pool ledger fold, the queue-wait cause split;
- ``signals``: hysteresis-gated health signals (``signals.jsonl``);
- ``timeline``: the flight recorder (``spans.<rank>.jsonl``,
  ``timeline_dump.json``) and its Chrome-trace merge;
- ``fleet``: heartbeats (``metrics.<rank>.jsonl``), the step EWMA, the
  straggler gather and their readers;
- ``memory``: ``--hbm_budget``, the analytic table, device-memory
  samples, the phase-attributed ledger and forensics;
- ``watch``: the live panel over a run directory;
- ``regress``: the noise-aware regression gate over BENCH records.

``python -m tpu_hc_bench_torch.obs summarize|diff|watch|timeline|signals
<dir>`` renders run directories; ``regress FRESH --history ...`` gates a
BENCH record.
"""
