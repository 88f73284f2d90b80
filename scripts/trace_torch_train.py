#!/usr/bin/env python3
"""Step breakdowns of the port's training lane from its own profiler
window (``--trace_dir``/``--profile_steps``, the Kineto trace that
``obs.trace`` summarizes) on one NVIDIA GPU.

Each model runs through the launcher, as a user would, with
``--metrics_dir``, ``--trace_dir`` and ``--profile_steps``:

- ``resnet50``: bf16, ``--fused_conv=true``, batch 128 (the bench
  protocol's shape);
- ``llama_1b``: bf16, flash attention, batch 2 x seq 2048;
- ``gpt2_moe``: bf16, flash attention, batch 8 x seq 1024 (einsum
  dispatch);
- ``gpt2``: bf16, flash attention and ``--fused_xent``, batch 16 x seq
  1024 (the xent kernels' main path).

Per model one JSON line: the four buckets of the profiled steps
(compute, collective, host-transfer, idle-bubble, in device
microseconds; each step's span runs from its first to its last kernel,
so the host's gap between steps is in no bucket), the device's busy
share over the whole window (the union of every kernel's interval over
the window's device wall, gaps included), the device time by kernel
class and the top kernels by name (``obs.trace.device_op_times``), the
run's mean and p50 step, MFU measured against analytic, goodput and
peak memory.  Inside the window the profiler also records every host
op, which slows the host's dispatch: the window's idle share is an
upper bound on the unprofiled step's.

Usage: ``python3 scripts/trace_torch_train.py [--models resnet50,...]
[--out DIR]`` (run dirs and traces under ``DIR``, default
``build/trace_torch_train``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

RUNS = {
    "resnet50": ["128", "--model=resnet50", "--use_fp16=true",
                 "--fused_conv=true"],
    "llama_1b": ["2", "--model=llama_1b", "--use_fp16=true",
                 "--attention_impl=flash"],
    "gpt2_moe": ["8", "--model=gpt2_moe", "--use_fp16=true",
                 "--attention_impl=flash"],
    "gpt2": ["16", "--model=gpt2", "--use_fp16=true",
             "--attention_impl=flash", "--fused_xent=true"],
}
WARMUP, STEPS, WINDOW = 5, 12, "6:9"

# kernel class -> name fragments (lower case), matched in this order
CLASSES = (
    ("nccl", ("nccl",)),
    ("fused_conv", ("fused_conv", "fused_bn_relu_conv", "stats_reduce")),
    ("flash", ("flash_",)),
    ("xent", ("xent_",)),
    ("gemm_conv", ("gemm", "cutlass", "xmma", "nvjet", "cudnn", "conv",
                   "wgrad", "dgrad", "implicit", "sm90_")),
    ("optimizer", ("multi_tensor", "foreach")),
    ("reduce_norm", ("reduce", "norm", "softmax")),
    ("copy", ("copy", "memcpy", "memset", "cat", "transpose")),
)


def kernel_class(name: str) -> str:
    n = name.lower()
    for cls, frags in CLASSES:
        if any(f in n for f in frags):
            return cls
    return "elementwise_other"


def trace_model(name: str, out: str) -> dict:
    from tpu_hc_bench_torch import launcher
    from tpu_hc_bench_torch.obs import trace

    run_dir = os.path.join(out, name)
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["1", "1", RUNS[name][0], "sock", *RUNS[name][1:],
            f"--num_warmup_batches={WARMUP}", f"--num_batches={STEPS}",
            "--display_every=4", f"--metrics_dir={run_dir}/metrics",
            f"--trace_dir={run_dir}/trace", f"--profile_steps={WINDOW}"]
    lines: list[str] = []

    def tee(m: str) -> None:
        lines.append(m)
        print(m, file=sys.stderr, flush=True)

    rc = launcher.main(argv, print_fn=tee)
    res = json.loads(next(ln for ln in reversed(lines)
                          if ln.startswith("{")))
    summary = [json.loads(ln) for ln in open(
        os.path.join(run_dir, "metrics", "metrics.jsonl"))
        if '"kind": "summary"' in ln][-1]
    tsum = trace.summarize_trace_dir(os.path.join(run_dir, "trace"))
    ops, counts = trace.device_op_times(os.path.join(run_dir, "trace"))
    spans = [(s, e) for _, s, e in trace.leaf_intervals(
        trace.load_events(os.path.join(run_dir, "trace")))]
    window_us = max(e for _, e in spans) - min(s for s, _ in spans)
    busy = sum(ops.values()) or 1.0
    by_class: dict[str, float] = {}
    for k, us in ops.items():
        c = kernel_class(k)
        by_class[c] = by_class.get(c, 0.0) + us
    steps = max(1, len(tsum.steps))
    return {
        "model": name, "argv": argv, "rc": rc,
        "mean_step_ms": res["mean_step_ms"],
        "p50_step_ms": res["p50_step_ms"],
        "device_busy_frac_window": trace._interval_union(spans)
        / window_us,
        "device_window_us": window_us,
        "rate": res["total_images_per_sec"],
        "mfu": summary.get("mfu"), "mfu_source": summary.get("mfu_source"),
        "mfu_analytic": summary.get("mfu_analytic"),
        "flops_disagreement": summary.get("flops_disagreement"),
        "goodput": res["goodput"], "peak_hbm_bytes": res["peak_hbm_bytes"],
        "trace_steps": len(tsum.steps), "step_source": tsum.step_source,
        "buckets_us_per_step": {k: v / steps for k, v in tsum.totals.items()},
        "buckets_frac": tsum.fractions(),
        "class_frac_of_busy": {k: v / busy for k, v in sorted(
            by_class.items(), key=lambda kv: -kv[1])},
        "kernels_per_step": sum(counts.values()) / steps,
        "top_kernels_us_per_step": [
            [k[:90], v / steps] for k, v in sorted(
                ops.items(), key=lambda kv: -kv[1])[:10]],
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--models", default=",".join(RUNS))
    p.add_argument("--out", default=os.path.join("build",
                                                 "trace_torch_train"))
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("trace_torch_train: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    for name in args.models.split(","):
        rec = trace_model(name, args.out)
        rec["nvidia_smi"] = smi
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
