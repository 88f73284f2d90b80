"""Observability of the port's serving lane: copies of the JAX
package's ``obs`` modules, importing no JAX, whose on-disk formats are
the JAX package's (either package's readers render the other's run
directories).

- ``metrics``: ``MetricsWriter`` (``manifest.json`` + ``metrics.jsonl``),
  ``read_run`` and ``summarize_run``;
- ``sketch``: the mergeable quantile sketch behind every percentile;
- ``requests``: per-request attribution, bucket utilization, request
  lanes of the timeline;
- ``kv``: the KV-pool ledger fold, the queue-wait cause split;
- ``signals``: hysteresis-gated health signals (``signals.jsonl``);
- ``timeline``: the flight recorder (``spans.<rank>.jsonl``,
  ``timeline_dump.json``) and its Chrome-trace merge;
- ``fleet``: heartbeats (``metrics.<rank>.jsonl``) and their readers;
- ``memory``: ``--hbm_budget``, device-memory samples and forensics.

``python -m tpu_hc_bench_torch.obs summarize|timeline|signals <dir>``
renders a run directory.
"""
