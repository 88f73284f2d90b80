"""Budgeted autotuner over the model zoo (the port's copy of the JAX
package's ``tune``): the levers a manual sweep moves, searched by
successive halving over real launcher runs on the card.

- :mod:`tpu_hc_bench_torch.tune.space` — the tunable levers per member
  (batch as a power-of-two ladder, accum 1..64, accumulator dtype,
  remat/scan, fusion threshold, psum/zero1 arm; the serving lane's
  admission cap, KV geometry, decode-kernel and quantization arms) with
  per-member validity rules, plus the JAX package's seed configs as
  starting points.
- :mod:`tpu_hc_bench_torch.tune.prune` — the static pruner: flag-time
  ``resolve()`` rejections and a small device-memory model (seeded, or
  measured from the journal) skip candidates *before* paying for a run.
- :mod:`tpu_hc_bench_torch.tune.runner` — the subprocess runner
  (timeout, 0/1/70/75 exit-code contract, result parse).
- :mod:`tpu_hc_bench_torch.tune.search` — budgeted successive halving
  with a resumable ``tune_state.json`` journal (tmp→rename commits):
  measure every survivor briefly, keep the top half by goodput-adjusted
  throughput, re-measure longer.
- :mod:`tpu_hc_bench_torch.tune.registry` — the tuned-config registry
  (``artifacts/tuned/<hardware_key>.json``; hardware key = device name
  + memory + world size) that ``--config=auto`` consumes in both lanes.

CLI::

    python -m tpu_hc_bench_torch.tune search --model gpt2 --budget_s 600
    python -m tpu_hc_bench_torch.tune show
    python -m tpu_hc_bench_torch.tune promote --journal artifacts/tune/.../tune_state.json
"""

from tpu_hc_bench_torch.tune.space import (  # noqa: F401
    Candidate,
    SEED_CONFIGS,
    member_space,
    seed_candidate,
)
from tpu_hc_bench_torch.tune.registry import (  # noqa: F401
    hardware_key,
    lookup,
    promote,
)
