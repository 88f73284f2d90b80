#!/usr/bin/env python3
"""Where the port's training time goes on one NVIDIA GPU.

``--model=resnet50`` (the default) trains resnet50 at the bench
protocol's shape (bf16 compute, batch 128 at 224x224, momentum SGD, one
fixed synthetic batch) once per arm of ``--fused_conv``, in the order
fused, unfused, unfused, fused on one card.  ``--model=gpt2`` trains
gpt2 at the LM lane's shape (bf16 compute, batch 16 x seq 1024, the
same optimizer, one fixed ``SyntheticTokens`` batch) once per arm of
``--attention_impl``, in the order flash, dense, dense, flash;
``--model=bert_base`` trains bert_base at its tune-space shape (batch
128 x seq 128, the masked-LM batch) the same way.  With
``--fused_xent`` a text model's arms are ``--fused_xent`` on and off
under flash attention instead (on, off, off, on).  A text model first
times the tied output head's product three ways (see ``head`` below).
Each pass builds its model from seed 0, runs ``--warmup`` untimed
steps, then ``--steps`` bare steps timed on the host clock between two
``torch.cuda.synchronize()`` (the end-to-end numbers), then
``--profile_steps`` steps under ``torch.profiler``, which reports:

- device busy time (the union of kernel intervals) and the idle share
  of the profiled steps' wall;
- device time by kernel class (convolutions and matrix products, the
  port's fused-conv and flash-attention kernels, softmax and
  cross-entropy with the port's xent kernels, LayerNorm, elementwise,
  reductions, the optimizer's multi-tensor kernels, copies, the rest)
  and the top kernels by name;
- the peak device memory of the pass and its MFU (3 x the registry's
  forward FLOPs per example, as `train/driver.py` computes it).

Usage: ``python3 scripts/profile_torch_train.py [--model=gpt2|bert_base]
[--fused_xent] [--out FILE]``; one JSON line per pass on stdout, and the
full kernel table in ``--out``.
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
    ("fused_conv_kernel", ("fused_bn_relu_conv", "fused_conv_sm90",
                           "stats_reduce")),
    ("flash_kernels", ("flash_fwd_kernel", "flash_fwd_sm90",
                       "flash_dq_kernel", "flash_dkv_kernel",
                       "flash_dq_sm90", "flash_dkv_sm90")),
    ("softmax_xent", ("softmax", "nll_loss", "xent_")),
    ("conv_matmul", ("conv", "cudnn", "xmma", "gemm", "cutlass", "wgrad",
                     "dgrad", "implicit", "nvjet")),
    ("layernorm", ("layer_norm", "gammabeta")),
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


HEAD_ITERS = 20


def time_head(torch, dev, tokens: int, hidden: int, vocab: int) -> dict:
    """The tied head's products at the LM lane's shape (CUDA events,
    median of ``HEAD_ITERS`` after 3 warmup calls).  The forward three
    ways: the port's choice, bf16 operands on the tensor cores with a
    float32 result (``torch.mm(..., out_dtype=float32)``); the same
    product with a bf16 result (logits rounded to bf16); a float32 GEMM
    of the bf16-rounded operands with TF32 off (the JAX result bit for
    bit, on the FMA units).  Then the port's backward (its two bf16
    products of the rounded cotangent), and as a yardstick the port's
    forward at a vocab padded to a multiple of 64, whose rows are 16-byte
    aligned (50257 is odd)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    padded = -(-vocab // 64) * 64
    x = torch.randn((tokens, hidden), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    w = torch.randn((vocab, hidden), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    wp = torch.randn((padded, hidden), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    g = torch.randn((tokens, vocab), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    xf, wf = x.float(), w.float()
    torch.backends.cuda.matmul.allow_tf32 = False
    ways = {
        "bf16_in_f32_out": lambda: torch.mm(x, w.t(),
                                            out_dtype=torch.float32),
        "bf16_in_bf16_out": lambda: torch.mm(x, w.t()),
        "f32_gemm_of_rounded": lambda: torch.mm(xf, wf.t()),
        "backward_bf16": lambda: (torch.mm(g, w, out_dtype=torch.float32),
                                  torch.mm(g.t(), x,
                                           out_dtype=torch.float32)),
        f"bf16_in_f32_out_vocab_{padded}": lambda: torch.mm(
            x, wp.t(), out_dtype=torch.float32),
    }
    out = {"shape": [tokens, hidden, vocab],
           "tflop": 2.0 * tokens * hidden * vocab / 1e12}
    for name, fn in ways.items():
        for _ in range(3):
            fn()
        times = []
        for _ in range(HEAD_ITERS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        out[name + "_ms"] = sorted(times)[len(times) // 2]
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="resnet50",
                   choices=("resnet50", "gpt2", "bert_base"))
    p.add_argument("--fused_xent", action="store_true",
                   help="text models: arms --fused_xent on/off (flash)")
    p.add_argument("--out", default="build/profile_torch_train.json")
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--profile_steps", type=int, default=5)
    args = p.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.data.synthetic import (
        SyntheticImages, SyntheticTokens, to_device, tokens_to_device)
    from tpu_hc_bench_torch.models import create_model, get_model_spec
    from tpu_hc_bench_torch.train import step as step_mod
    from tpu_hc_bench_torch.utils import hw

    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda")
    torch.backends.cudnn.benchmark = True           # as the driver
    spec = get_model_spec(args.model)
    head = None
    if spec.is_text:
        bs = 16 if spec.causal_lm else 128
        batch = tokens_to_device(SyntheticTokens(
            bs, spec.input_shape[0], spec.vocab_size, seed=0,
            causal_lm=spec.causal_lm).batch(), dev)
        if args.fused_xent:
            arms = [(f"fused_xent={a}",
                     [f"--model={args.model}", "--use_fp16=true",
                      "--attention_impl=flash", f"--fused_xent={a}"])
                    for a in ("true", "false", "false", "true")]
        else:
            arms = [(a, [f"--model={args.model}", "--use_fp16=true",
                         f"--attention_impl={a}"])
                    for a in ("flash", "dense", "dense", "flash")]
        head = time_head(torch, dev, bs * spec.input_shape[0], 768,
                         spec.vocab_size)
        print(json.dumps({"head": head, "nvidia_smi": smi}), flush=True)
    else:
        bs = 128
        batch = to_device(SyntheticImages(bs, spec.input_shape, 1000,
                                          seed=0).batch(), dev)
        arms = [(a, ["--use_fp16=true", f"--fused_conv={a == 'fused'}"])
                for a in ("fused", "unfused", "unfused", "fused")]
    peak = hw.peak_flops("bfloat16", dev)
    full = []
    for arm, argv in arms:
        cfg = flags.parse_benchmark_flags(argv)
        model, _ = create_model(args.model, torch.bfloat16,
                                cfg.attention_impl, device=dev, seed=0,
                                fused_conv=cfg.fused_conv, train=True)
        state = step_mod.make_train_state(model, cfg)
        torch.cuda.reset_peak_memory_stats()
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
            "model": args.model, "arm": arm, "nvidia_smi": smi, "batch": bs,
            "dtype": "bfloat16",
            "bare_step_ms": 1e3 * bare_s / args.steps,
            "bare_images_per_s": bs * args.steps / bare_s,
            "mfu": (3.0 * spec.flops_per_example * bs * args.steps / bare_s
                    / peak if peak else None),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
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
                   "head": head, "passes": full}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
