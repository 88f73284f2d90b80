#!/usr/bin/env python3
"""Where the port's training time goes on one NVIDIA GPU.

Trains resnet50 at the bench protocol's shape (bf16 compute, batch 128
at 224x224, momentum SGD, one fixed synthetic batch) once per arm of
``--fused_conv``, in the order fused, unfused, unfused, fused on one
card.  Each pass builds its model from seed 0, runs ``--warmup`` untimed
steps, then ``--steps`` bare steps timed on the host clock between two
``torch.cuda.synchronize()`` (the end-to-end numbers), then
``--profile_steps`` steps under ``torch.profiler``, which reports:

- device busy time (the union of kernel intervals) and the idle share
  of the profiled steps' wall;
- device time by kernel class (convolutions and matrix products, the
  port's fused-conv kernel, elementwise, reductions, the optimizer's
  multi-tensor kernels, copies, the rest) and the top kernels by name.

Usage: ``python3 scripts/profile_torch_train.py [--out FILE]``; one JSON
line per pass on stdout, and the full kernel table in ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from profile_torch_serve import _kernel_table  # noqa: E402

# kernel class -> name fragments (lower case), matched in this order
CLASSES = (
    ("fused_conv_kernel", ("fused_bn_relu_conv", "stats_reduce")),
    ("conv_matmul", ("conv", "cudnn", "xmma", "gemm", "cutlass", "wgrad",
                     "dgrad", "implicit")),
    ("optimizer", ("multi_tensor", "foreach")),
    ("reduction", ("reduce",)),
    ("copy", ("copy", "memcpy", "memset", "catarray")),
    ("elementwise", ("elementwise",)),
)


def classify(by_name: dict) -> dict:
    out = collections.Counter()
    for name, s in by_name.items():
        low = name.lower()
        cls = next((c for c, needles in CLASSES
                    if any(n in low for n in needles)), "other")
        out[cls] += s
    return dict(out)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="build/profile_torch_train.json")
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--profile_steps", type=int, default=5)
    args = p.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.data.synthetic import SyntheticImages, to_device
    from tpu_hc_bench_torch.models import create_model, get_model_spec
    from tpu_hc_bench_torch.train import step as step_mod

    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda")
    torch.backends.cudnn.benchmark = True           # as the driver
    spec = get_model_spec("resnet50")
    batch = to_device(SyntheticImages(128, spec.input_shape, 1000,
                                      seed=0).batch(), dev)
    full = []
    for arm in ("fused", "unfused", "unfused", "fused"):
        cfg = flags.parse_benchmark_flags(
            ["--use_fp16=true", f"--fused_conv={arm == 'fused'}"])
        model, _ = create_model("resnet50", torch.bfloat16, device=dev,
                                seed=0, fused_conv=cfg.fused_conv,
                                train=True)
        state = step_mod.make_train_state(model, cfg)
        for _ in range(args.warmup):
            step_mod.train_step(state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step_mod.train_step(state, batch)
        torch.cuda.synchronize()
        bare_s = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.profile_steps):
                state, metrics = step_mod.train_step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy, by_name = _kernel_table(prof)
        classes = classify(by_name)
        rec = {
            "arm": arm, "nvidia_smi": smi, "batch": 128, "dtype": "bfloat16",
            "bare_step_ms": 1e3 * bare_s / args.steps,
            "bare_images_per_s": 128 * args.steps / bare_s,
            "profiled_step_ms": 1e3 * wall / args.profile_steps,
            "device_busy_ms_per_step": 1e3 * busy / args.profile_steps,
            "device_idle_share": 1.0 - busy / wall,
            "share_by_class": {k: v / busy for k, v in
                               sorted(classes.items(), key=lambda kv: -kv[1])},
            "kernel_launches_per_step": sum(
                1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
            / args.profile_steps,
            "final_loss": float(metrics["loss"]),
            "top_kernels_s": [[k[:90], v] for k, v in
                              by_name.most_common(12)],
        }
        print(json.dumps(rec), flush=True)
        full.append({**rec, "kernels_s": dict(by_name)})
        del model, state
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"gpu": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                   "passes": full}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
