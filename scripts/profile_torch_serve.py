#!/usr/bin/env python3
"""Where the port's serving time goes on one NVIDIA GPU.

Serves the chip_smoke trace (llama_1b, 16 poisson requests at 64 req/s,
prompts <= 512, outputs <= 64, 8 in flight, 16-token pages) through
``ServeEngine`` once per decode-attention arm, in the order paged,
gather, gather, paged on one card and one model.  Each pass runs the
trace twice: bare (the end-to-end numbers, ``unprofiled``), then under
``torch.profiler``, which reports:

- the profiled run's summary (tokens/s, p50/p99 TTFT and e2e);
- device busy time (the union of kernel intervals) and the idle share
  of the run's wall;
- device time by kernel name, top entries, with the share of the busy
  time spent in the port's two CUDA kernels and in matrix products.

Usage: ``python3 scripts/profile_torch_serve.py [--out FILE]``; one JSON
line per pass on stdout, then the card's ``nvidia-smi`` name and power
limit, and the full kernel table in ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _kernel_table(prof):
    """(busy seconds, {kernel name: seconds}) from the profiler's device
    events (one stream: intervals are merged for the busy time)."""
    import torch

    spans, by_name = [], collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        by_name[e.name] += (t1 - t0) * 1e-6
    busy, end = 0.0, None
    for t0, t1 in sorted(spans):
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    return busy * 1e-6, by_name


def _share(by_name, busy, *needles):
    return sum(v for k, v in by_name.items()
               if any(n in k.lower() for n in needles)) / max(busy, 1e-12)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="build/profile_torch_serve.json")
    args = p.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.serve import cli

    if not torch.cuda.is_available():
        print("profile_torch_serve: needs a CUDA device", file=sys.stderr)
        return 2
    model, _ = create_model("llama_1b", device="cuda", seed=0)
    quiet = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    engines = {}
    full = []
    for arm in ("paged", "gather", "gather", "paged"):
        if arm not in engines:
            cfg = flags.parse_flags([
                "--model=llama_1b", f"--decode_attention={arm}",
                "--max_prompt_len=512", "--max_output_len=64",
                "--max_in_flight=8", "--kv_page_size=16",
                "--num_requests=16", "--arrival_rate=64", "--seed=0"])
            engines[arm] = cli.build_engine_and_requests(cfg, quiet,
                                                         model=model)
        engine, requests = engines[arm]
        warm = engine.run(requests)                # unprofiled pass
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            summary = engine.run(requests)
        busy, by_name = _kernel_table(prof)
        wall = summary["wall_s"]
        top = by_name.most_common(12)
        rec = {
            "arm": arm,
            **{k: summary[k] for k in (
                "tokens", "wall_s", "tokens_per_s", "decode_steps",
                "prefill_steps", "p50_ttft_ms", "p99_ttft_ms",
                "p50_e2e_ms", "p99_e2e_ms")},
            "unprofiled": {k: warm[k] for k in (
                "wall_s", "tokens_per_s", "p50_ttft_ms", "p99_ttft_ms",
                "p50_e2e_ms", "p99_e2e_ms")},
            "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall,
            "share_paged_kernel": _share(by_name, busy, "paged_decode"),
            "share_norm_kernel": _share(by_name, busy,
                                        "fused_residual_norm"),
            "share_matmul": _share(by_name, busy, "gemm", "gemv", "xmma",
                                   "cutlass"),
            "top_kernels_s": [[k[:80], v] for k, v in top],
        }
        print(json.dumps(rec), flush=True)
        full.append({**rec, "kernels_s": dict(by_name)})
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"gpu": torch.cuda.get_device_name(0), "passes": full},
                  f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
