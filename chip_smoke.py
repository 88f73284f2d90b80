#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu_hc_bench_torch``) on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the root of a checkout.

Phases, each printing one JSON line; any failure raises (non-zero exit):

1. **device**: ``nvidia-smi``'s name and power limit, and the build of
   every CUDA kernel from ``tpu_hc_bench_torch/csrc`` (``nvcc``,
   ``sm_90a``), with its time.
2. **kernels**: each kernel against its plain PyTorch version on the
   card, at the serving lane's llama_1b shapes, with the tolerance
   stated: paged decode attention (f32 and int8 pools, 1 and 2 pages per
   block) and the fused residual+norm (8 and 512 rows, rmsnorm and
   layernorm).  Times are CUDA events, median of 50 launches after
   warmup, with the L2 cache flushed before each launch; ``library_ms``
   times one PyTorch call of the same function, which the port never
   calls.
3. **parity**: llama_1b at full width, seeded weights: two prompts
   prefilled, then 4 decode steps on a fixed token feed; the ``paged``
   program's logits against the ``gather`` program's.
4. **serve**: ``ServeEngine`` on llama_1b with ``--decode_attention=
   paged``, 16 poisson requests at 64 req/s; the kernels' launch counts
   are zeroed just before the run and read just after it.

Then the kernel table line, the ``nvidia-smi`` line, and as the last
line ``{"ok": true, "device": {...}}``.  Without a GPU, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_OPS_PER_S = 67e12              # H100 SXM float32, outside tensor cores
ATTN_TOL = 1e-4                    # f32 sums in another order, <= 576 keys
NORM_TOL = 1e-4                    # f32 stats over 2048 in another order
PARITY_TOL = 1e-3                  # 16 layers of f32 at width 2048
TIMED_ITERS = 50
WARMUP_ITERS = 5


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


class Timer:
    """CUDA-event timing of single launches, L2 flushed before each."""

    def __init__(self, torch, device):
        self.torch = torch
        # larger than the H100's 50 MB L2
        self.flush = torch.empty(128 << 20, dtype=torch.uint8,
                                 device=device)

    def median_ms(self, fn) -> float:
        torch = self.torch
        for _ in range(WARMUP_ITERS):
            fn()
        times = []
        for _ in range(TIMED_ITERS):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, dev, timer) -> dict:
    """Phase 2; returns the main-path numbers of each kernel."""
    import numpy as np
    import torch.nn.functional as F

    from tpu_hc_bench_torch.ops.fused_residual_ln import (
        fused_residual_norm, fused_residual_norm_plain)
    from tpu_hc_bench_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)

    rng = np.random.default_rng(0)
    L, b, heads, kvh, d, ps, w = 16, 8, 32, 8, 64, 16, 36
    pages = 1 + b * w
    layer = 5
    lengths = rng.integers(1, w * ps + 1, (b,)).astype(np.int32)
    lengths[3] = 0                                  # a padded row
    lengths[0] = w * ps                             # a full table
    tables = (1 + rng.permutation(b * w)).reshape(b, w).astype(np.int32)
    tables[3] = 0                                   # padded: trash page
    t = lambda a: torch.from_numpy(a).to(dev)       # noqa: E731
    q = torch.randn((b, heads, d), device=dev)
    tables_d, lengths_d = t(tables), t(lengths)
    pools = {
        "f32": (torch.randn((L, pages, ps, kvh, d), device=dev),
                torch.randn((L, pages, ps, kvh, d), device=dev), {}),
        "int8": (torch.randint(-127, 128, (L, pages, ps, kvh, d),
                               dtype=torch.int8, device=dev),
                 torch.randint(-127, 128, (L, pages, ps, kvh, d),
                               dtype=torch.int8, device=dev),
                 {"k_scales": 0.02 * torch.rand((L, pages), device=dev),
                  "v_scales": 0.02 * torch.rand((L, pages), device=dev)}),
    }
    tokens = int(lengths.sum())
    pages_read = int(sum(-(-int(n) // ps) for n in lengths))
    visible = torch.from_numpy(lengths > 0).to(dev)
    out_main = {}
    for kind, (kp, vp, sc) in pools.items():
        for ppb in (1, 2):
            def kernel():
                return paged_decode_attention(
                    q, kp, vp, tables_d, lengths_d, pages_per_block=ppb,
                    layer=layer, return_lse=True, **sc)

            def plain():
                return paged_decode_attention_plain(
                    q, kp, vp, tables_d, lengths_d, pages_per_block=ppb,
                    layer=layer, return_lse=True, **sc)

            got, lse = kernel()
            want, want_lse = plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            lse_err = float((lse - want_lse)[visible].abs().max())
            pad_ok = bool((got[~visible] == 0).all()
                          and torch.isfinite(lse).all()
                          and (lse[~visible] < -1e29).all())
            ms, plain_ms = timer.median_ms(kernel), timer.median_ms(plain)
            elt = 1 if kind == "int8" else 4
            nbytes = (2 * tokens * kvh * d * elt + 2 * b * heads * d * 4
                      + b * heads * 4 + b * w * 4 + b * 4
                      + (2 * pages_read * 4 if kind == "int8" else 0))
            bound_ms, bound_by = bound(nbytes, 4.0 * tokens * heads * d)
            rec = {"phase": "kernel", "name": "paged_decode_attention",
                   "pool": kind, "pages_per_block": ppb,
                   "shape": {"b": b, "heads": heads, "kv_heads": kvh,
                             "d": d, "page_size": ps, "w": w,
                             "pool_pages": pages, "layers": L},
                   "lengths": lengths.tolist(), "max_abs_err": err,
                   "lse_max_abs_err": lse_err, "tol": ATTN_TOL,
                   "padded_row_ok": pad_ok, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by}
            if kind == "f32" and ppb == 1:
                # yardstick: SDPA over a pre-gathered dense cache
                kd = kp[layer][tables_d.long()].reshape(b, w * ps, kvh, d)
                vd = vp[layer][tables_d.long()].reshape(b, w * ps, kvh, d)
                kd = kd.repeat_interleave(heads // kvh, 2).transpose(1, 2)
                vd = vd.repeat_interleave(heads // kvh, 2).transpose(1, 2)
                kd, vd = kd.contiguous(), vd.contiguous()
                mask = (torch.arange(w * ps, device=dev)[None, :]
                        < lengths_d[:, None])[:, None, None, :]
                q4 = q[:, :, None, :]
                rec["library_ms"] = timer.median_ms(
                    lambda: F.scaled_dot_product_attention(
                        q4, kd, vd, attn_mask=mask))
                del kd, vd
                out_main["paged_decode_attention"] = rec
            emit(rec)
            if not (err <= ATTN_TOL and lse_err <= ATTN_TOL and pad_ok):
                raise AssertionError(f"paged_decode_attention {kind} "
                                     f"ppb={ppb} disagrees: {rec}")
    del pools

    hidden = 2048
    for rows in (8, 512):
        for kind in ("rmsnorm", "layernorm"):
            res = torch.randn((rows, hidden), device=dev)
            x = torch.randn((rows, hidden), device=dev)
            g = torch.randn((hidden,), device=dev)
            bta = (torch.randn((hidden,), device=dev)
                   if kind == "layernorm" else None)
            y, o = fused_residual_norm(res, x, g, bta, kind=kind)
            wy, wo = fused_residual_norm_plain(res, x, g, bta, kind=kind)
            torch.cuda.synchronize()
            err = max(float((y - wy).abs().max()),
                      float((o - wo).abs().max()))
            ms = timer.median_ms(
                lambda: fused_residual_norm(res, x, g, bta, kind=kind))
            plain_ms = timer.median_ms(
                lambda: fused_residual_norm_plain(res, x, g, bta,
                                                  kind=kind))
            yc = res + x
            if kind == "rmsnorm":
                lib = lambda: F.rms_norm(yc, (hidden,), g, 1e-5)  # noqa
            else:
                lib = lambda: F.layer_norm(yc, (hidden,), g, bta,  # noqa
                                           1e-6)
            nbytes = 4 * rows * hidden * 4 + 4 * hidden * (
                2 if bta is not None else 1)
            bound_ms, bound_by = bound(nbytes, 5.0 * rows * hidden)
            rec = {"phase": "kernel", "name": "fused_residual_norm",
                   "kind": kind, "rows": rows, "hidden": hidden,
                   "max_abs_err": err, "tol": NORM_TOL, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": timer.median_ms(lib),
                   "library_note": "norm of a precomputed y (no add)",
                   "bound_ms": bound_ms, "bound_by": bound_by}
            emit(rec)
            if not err <= NORM_TOL:
                raise AssertionError(f"fused_residual_norm disagrees: {rec}")
            if rows == 8 and kind == "rmsnorm":
                out_main["fused_residual_norm"] = rec
    return out_main


def phase_parity(torch, dev, model) -> None:
    """Phase 3: paged vs gather program logits at full width."""
    import numpy as np

    from tpu_hc_bench_torch.serve import decode as decode_mod

    family = decode_mod.build_family(model)
    ps, w, b, steps = 16, 36, 2, 4
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, model.vocab_size, n).astype(np.int32)
               for n in (100, 37)]
    feed = rng.integers(1, model.vocab_size, (steps, b)).astype(np.int32)
    tables = np.arange(1, 1 + b * w, dtype=np.int32).reshape(b, w)
    t = lambda a: torch.from_numpy(a).to(dev)       # noqa: E731
    logits = {}
    for arm in ("gather", "paged"):
        kv = decode_mod.init_kv_state(family, 1 + b * w, ps, device=dev)
        prefill = decode_mod.build_prefill_fn(family, ps, w)
        decode = decode_mod.build_decode_fn(family, ps, w, attention=arm)
        lengths = np.zeros((b,), np.int32)
        for i, prompt in enumerate(prompts):
            toks = np.zeros((1, 128), np.int32)
            toks[0, :len(prompt)] = prompt
            prefill(kv, t(toks), len(prompt), t(tables[i]))
            lengths[i] = len(prompt)
        out = []
        for s in range(steps):
            _, lg, kv = decode(kv, t(feed[s]), t(tables), t(lengths),
                               t(np.ones((b,), bool)))
            out.append(lg)
            lengths += 1
        logits[arm] = torch.stack(out)
        del kv
    ref, got = logits["gather"], logits["paged"]
    err = float((got - ref).abs().max())
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * PARITY_TOL
    argmax_ok = bool((got.argmax(-1) == ref.argmax(-1))[clear].all())
    rec = {"phase": "parity", "model": "llama_1b", "prompts": [100, 37],
           "decode_steps": steps, "shape": list(got.shape),
           "finite": bool(torch.isfinite(got).all()),
           "max_abs_err": err, "tol": PARITY_TOL,
           "argmax_equal_where_top2_gap_gt_2tol": argmax_ok}
    emit(rec)
    if not (rec["finite"] and err <= PARITY_TOL and argmax_ok
            and rec["shape"] == [steps, b, model.vocab_size]):
        raise AssertionError(f"paged program disagrees with gather: {rec}")


def phase_serve(torch, model) -> dict:
    """Phase 4: the main path; returns each kernel's launch count."""
    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.ops.fused_residual_ln import fused_residual_norm
    from tpu_hc_bench_torch.ops.paged_attention import paged_decode_attention
    from tpu_hc_bench_torch.serve import cli

    cfg = flags.parse_flags([
        "--model=llama_1b", "--decode_attention=paged",
        "--max_prompt_len=512", "--max_output_len=64", "--max_in_flight=8",
        "--kv_page_size=16", "--num_requests=16", "--arrival=poisson",
        "--arrival_rate=64", "--seed=0"])
    engine, requests = cli.build_engine_and_requests(
        cfg, lambda m: print(m, file=sys.stderr, flush=True), model=model)
    paged_decode_attention.launches = 0
    fused_residual_norm.launches = 0
    summary = engine.run(requests)
    launches = {"paged_decode_attention": paged_decode_attention.launches,
                "fused_residual_norm": fused_residual_norm.launches}
    torch.cuda.synchronize()
    steps = summary["decode_steps"]
    layers = model.num_layers
    rec = {"phase": "serve", "launches": launches,
           "expected": {"paged_decode_attention": layers * steps,
                        "fused_residual_norm": (2 * layers - 1) * steps},
           **{k: summary[k] for k in (
               "requests", "completed", "wall_s", "tokens", "tokens_per_s",
               "decode_steps", "prefill_steps", "p50_ttft_ms",
               "p99_ttft_ms", "p50_e2e_ms", "p99_e2e_ms", "p50_queue_ms",
               "p99_queue_ms", "max_in_flight", "kv_pages",
               "kv_page_size", "decode_attention")}}
    emit(rec)
    if not (summary["completed"] == summary["requests"] == 16 and steps > 0
            and all(v > 0 for v in launches.values())
            and launches == rec["expected"]):
        raise AssertionError(f"serve run off its kernels: {rec}")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures the port on a GPU",
              file=sys.stderr)
        return 2
    try:
        import tpu_hc_bench_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the tpu_hc_bench_torch package is missing "
              f"beside this script: {e}", file=sys.stderr)
        return 2
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.ops import _build

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    _, build_s, log = _build.build()
    _build.load_library()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build_s,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "Compiling entry" in ln]})

    timer = Timer(torch, dev)
    main_rows = phase_kernels(torch, dev, timer)
    del timer
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model, _ = create_model("llama_1b", device=dev, seed=0)
    torch.cuda.synchronize()
    emit({"phase": "model", "name": "llama_1b",
          "params": sum(p.numel() for p in model.parameters()),
          "init_s": time.perf_counter() - t0})
    phase_parity(torch, dev, model)
    torch.cuda.empty_cache()
    launches = phase_serve(torch, model)

    sources = {
        "paged_decode_attention": (
            "tpu_hc_bench_torch/csrc/paged_attention.cu",
            "tpu_hc_bench/ops/paged_attention.py:156"),
        "fused_residual_norm": (
            "tpu_hc_bench_torch/csrc/fused_residual_norm.cu",
            "tpu_hc_bench/ops/fused_residual_ln.py:53"),
    }
    table = []
    for name, (source, replaces) in sources.items():
        r = main_rows[name]
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": launches[name],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"],
                      "library_ms": r["library_ms"]})
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
