"""Honest efficiency accounting: measured MFU + fabric-ceiling
attribution (the port's copy of the JAX package's ``obs/efficiency.py``).

Two dishonesties this module removes from the headline numbers:

- **MFU from a hand-maintained FLOP table.**  ``spec.flops_per_example``
  is a curated constant (2*MACs at the canonical shape) times a 3x
  fwd+bwd multiplier — fine until the table rots or a model variant
  (seq-len override, MoE capacity, remat recompute) drifts from it.
  JAX asks XLA's ``cost_analysis()`` of the compiled step.  Eager
  PyTorch has no compiled program, so ``probe_step_flops`` counts one
  real step, run once outside the timed window: ``FlopCounterMode``
  counts the aten matmuls and convolutions of the forward and backward,
  and each hand-written kernel adds its own operations where it
  launches (``kernel_ops``; the counter cannot see inside an
  ``autograd.Function`` calling the extension).  The source is labelled
  ``measured (FlopCounterMode + kernel formulas)``.  XLA's analysis of a
  Mosaic custom call probably omits the kernels' work on the TPU; the
  port counts it.  The driver reports MFU from the measured figure,
  and prints both when they disagree by >10% — the table cross-check
  that keeps the registry honest.

- **Collective bandwidth judged against datasheet numbers.**  The only
  ceiling that matters is the one THIS fabric measured:
  ``python -m tpu_hc_bench_torch.microbench.osu --op all --json
  sweep.json``
  saves the OSU-style sweep, and ``--fabric_ceiling=sweep.json`` lets
  the driver/``summarize`` compare the achieved gradient-allreduce bus
  bandwidth against the sweep's peak — "all_reduce at 61% of measured
  ceiling" instead of a context-free GB/s.

Achieved bandwidth derivation (documented because every term matters):
collective seconds/step = (trace collective bucket / trace total,
including idle) x the *wall-measured* mean step time — the trace
supplies only the RATIO;
bytes/step for the gradient allreduce = the gradient tree's bytes at
the wire dtype (bf16 when ``--accum_dtype=bf16`` reduces the bf16
accumulator); busbw = algbw * 2*(n-1)/n, the same ring
convention as ``microbench.osu``, so achieved and ceiling are
comparable by construction.
"""

from __future__ import annotations

import json
import os

#: the MFU source label of the probe's count
MEASURED_SOURCE = "measured (FlopCounterMode + kernel formulas)"

# trace collective-leaf substrings -> microbench.osu sweep op names
KIND_TO_SWEEP_OP = (
    ("all-reduce", "allreduce"),
    ("allreduce", "allreduce"),
    ("reduce-scatter", "reduce_scatter"),
    ("all-gather", "all_gather"),
    ("allgather", "all_gather"),
    ("all-to-all", "all_to_all"),
    ("permute", "ppermute"),
)


# ---------------------------------------------------------------------
# measured FLOPs (driver-side; one probe step outside the timed window)

#: an active probe's operation count of the hand-written kernels, which
#: ``FlopCounterMode`` cannot see (they are ``autograd.Function``s calling
#: the extension); None when no probe is running
_KERNEL_OPS: list[float] | None = None


def kernel_ops(n: float) -> None:
    """A hand-written kernel's launch adds its operations (the formulas
    ``chip_smoke.py``'s bounds use) to the running probe, if any."""
    if _KERNEL_OPS is not None:
        _KERNEL_OPS[0] += float(n)


def attn_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs one head attends to."""
    if not causal:
        return sq * sk
    # rows i < sk see i + 1 keys, the rest all sk
    m = min(sq, sk)
    return m * (m + 1) // 2 + max(0, sq - m) * sk


def probe_step_flops(run_step) -> dict | None:
    """Count one step's operations: ``run_step()`` (a real step, run once
    outside the timed window) under ``torch.utils.flop_counter.
    FlopCounterMode`` (the aten matmuls and convolutions, forward and
    backward) plus the hand-written kernels' own counts.  Returns
    ``{"flops", "aten_flops", "kernel_flops"}``, or None when the
    counter fails (the analytic figure then stands alone)."""
    global _KERNEL_OPS
    from torch.utils.flop_counter import FlopCounterMode

    _KERNEL_OPS = [0.0]
    try:
        with FlopCounterMode(display=False) as counter:
            run_step()
        aten = float(counter.get_total_flops())
        kern = _KERNEL_OPS[0]
    except Exception:
        return None
    finally:
        _KERNEL_OPS = None
    return {"flops": aten + kern, "aten_flops": aten, "kernel_flops": kern}


def grad_allreduce_bytes(params, accum_dtype: str = "f32") -> int:
    """Per-rank message bytes of the gradient all-reduce: one gradient a
    parameter, in the parameter's dtype; ``--accum_dtype=bf16`` reduces
    the accumulator's bf16 gradients, halving the wire bytes."""
    total = 0
    for p in params:
        if not hasattr(p, "numel"):
            continue
        itemsize = 2 if accum_dtype == "bf16" else p.element_size()
        total += int(p.numel()) * itemsize
    return total


# ---------------------------------------------------------------------
# MFU bookkeeping (pure)


def mfu_report(measured_flops_per_step: float | None,
               analytic_flops_per_step: float,
               mean_step_s: float, peak_flops: float) -> dict:
    """The honest MFU record: value, source label, both FLOP figures,
    and the disagreement flag (>10% — the table-rot tripwire)."""
    denom = mean_step_s * peak_flops
    mfu_analytic = analytic_flops_per_step / denom if denom > 0 else 0.0
    out = {
        "mfu": mfu_analytic,
        "mfu_source": "analytic",
        "mfu_analytic": mfu_analytic,
        "analytic_flops_per_step": analytic_flops_per_step,
    }
    if measured_flops_per_step is not None and denom > 0:
        mfu_measured = measured_flops_per_step / denom
        out.update(mfu=mfu_measured, mfu_source=MEASURED_SOURCE,
                   mfu_measured=mfu_measured,
                   measured_flops_per_step=measured_flops_per_step)
        if analytic_flops_per_step > 0:
            rel = abs(measured_flops_per_step - analytic_flops_per_step) \
                / analytic_flops_per_step
            out["flops_disagreement"] = rel
            out["flops_disagree"] = rel > 0.10
    return out


def mfu_lines(summary: dict) -> list[str]:
    """Render the MFU-source attribution from a summary record (shared
    by the driver's final print and ``obs summarize``)."""
    src = summary.get("mfu_source")
    if not src:
        return []
    lines = [f"  MFU {100 * (summary.get('mfu') or 0.0):.1f}% "
             f"(flops source: {src})"]
    if summary.get("flops_disagree"):
        lines.append(
            f"  WARNING: measured vs analytic FLOPs disagree "
            f"{summary.get('flops_disagreement', 0.0):.0%}: measured "
            f"{summary.get('measured_flops_per_step', 0.0):.3g} vs "
            f"analytic {summary.get('analytic_flops_per_step', 0.0):.3g} "
            f"flops/step — spec.flops_per_example may have rotted")
    return lines


# ---------------------------------------------------------------------
# fabric ceiling (pure file ops; the sweep json is written by
# `python -m tpu_hc_bench_torch.microbench.osu --json`)


def load_fabric_ceiling(path: str) -> dict:
    """Load an osu sweep export; returns ``{"world_size", "device_kind",
    "ceilings": {op: {"busbw_gbps", "message_bytes"}}}`` where each
    op's ceiling is its best measured busbw over the swept sizes."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"--fabric_ceiling: no such file: {path}")
    with open(path) as f:
        data = json.load(f)
    sweeps = data.get("sweeps")
    if not isinstance(sweeps, dict) or not sweeps:
        raise ValueError(
            f"--fabric_ceiling: {path} is not an osu sweep export "
            f"(write one with `python -m tpu_hc_bench_torch.microbench.osu "
            f"--op all --json {path}`)")
    ceilings = {}
    for op, rows in sweeps.items():
        best = max(rows, key=lambda r: r.get("busbw_gbps", 0.0),
                   default=None)
        if best:
            ceilings[op] = {"busbw_gbps": float(best["busbw_gbps"]),
                            "message_bytes": int(best["message_bytes"])}
    return {"world_size": data.get("world_size"),
            "device_kind": data.get("device_kind"),
            "ceilings": ceilings}


def _merge_intervals(
    intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Sorted disjoint union of [start, end) intervals."""
    out: list[tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _intersection_len(a: list[tuple[float, float]],
                      b: list[tuple[float, float]]) -> float:
    """Total overlap length of two sorted disjoint interval lists."""
    total = 0.0
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def collective_overlap(
        intervals: list[tuple[str, float, float]]) -> dict | None:
    """Overlapped-vs-exposed collective attribution from trace intervals.

    ``intervals`` is ``obs.trace.leaf_intervals``'s output.  *Exposed*
    collective wall is the part of the collective-busy span no
    compute/host-transfer op covers concurrently (a sibling track's DMA
    or MXU work hides a collective; a collective running alone is pure
    step-time cost).  This is the measurement behind
    ``--overlap_grad_comm``: the flag's win is exposed fraction going
    DOWN while total collective time stays ~flat.
    Returns None when the trace has no collective ops.
    """
    from tpu_hc_bench_torch.obs import trace as trace_mod

    coll: list[tuple[float, float]] = []
    comp: list[tuple[float, float]] = []
    for name, s, e in intervals:
        if e <= s:
            continue
        if trace_mod.bucket_of(name) == "collective":
            coll.append((s, e))
        else:
            comp.append((s, e))
    if not coll:
        return None
    coll_u = _merge_intervals(coll)
    comp_u = _merge_intervals(comp)
    total = sum(e - s for s, e in coll_u)
    covered = _intersection_len(coll_u, comp_u)
    exposed = max(0.0, total - covered)
    frac = exposed / total if total > 0 else 0.0
    return {
        "collective_us": total,
        "exposed_us": exposed,
        "exposed_frac": frac,
        "overlapped_frac": 1.0 - frac,
    }


def overlap_lines(rec: dict) -> list[str]:
    """Render a ``collective_overlap`` record (driver + summarize)."""
    return [
        f"  collective exposure: {rec.get('exposed_frac', 0.0):.1%} of "
        f"collective wall exposed, {rec.get('overlapped_frac', 0.0):.1%} "
        f"overlapped with compute"
    ]


def collective_busbw_lines(summary: dict,
                           trace_rec: dict | None) -> list[str]:
    """Absolute achieved gradient-collective bus bandwidth (GB/s).

    The ceiling-free companion of ``ceiling_utilization_lines``: the
    same trace-ratio x wall-step-time x wire-bytes derivation, printed
    in absolute GB/s so a run WITHOUT a ``--fabric_ceiling`` sweep still
    reports what the fabric achieved instead of gating the number on an
    artifact the operator may not have.  The zero1 arm's reduce-scatter
    + all-gather pair is folded into the same figure (together they move
    the allreduce's ring volume over the same gradient bytes).
    """
    if not trace_rec or not trace_rec.get("buckets"):
        return []
    buckets = trace_rec["buckets"]
    total_us = sum(buckets.values())
    if total_us <= 0 or buckets.get("collective", 0.0) <= 0:
        return []
    mean_step_s = summary.get("mean_step_ms", 0.0) / 1e3
    world = int(summary.get("total_workers") or 0)
    bytes_per_step = summary.get("allreduce_bytes_per_step")
    if mean_step_s <= 0 or world <= 1 or not bytes_per_step:
        return []
    coll_ops = trace_rec.get("collective_ops") or {
        "allreduce": buckets["collective"]}
    # every gradient-carrying kind, summed: the psum arm's all-reduce
    # buckets, the zero1 arm's reduce-scatter + all-gather pair (a zero1
    # trace ALSO has a small all-reduce — the loss pmean/BN-stat sync —
    # which must not become the denominator on its own)
    grad_us = (coll_ops.get("allreduce", 0.0)
               + coll_ops.get("reduce_scatter", 0.0)
               + coll_ops.get("all_gather", 0.0))
    if grad_us <= 0:
        return []
    frac = grad_us / total_us
    sec_per_step = frac * mean_step_s
    algbw = bytes_per_step / sec_per_step / 1e9
    busbw = algbw * 2.0 * (world - 1) / world
    return [
        f"  fabric: gradient collectives {busbw:.2f} GB/s busbw "
        f"({algbw:.2f} GB/s algbw, {frac:.1%} of step time, "
        f"{bytes_per_step / 2**20:.1f} MiB/step; absolute — pass "
        f"--fabric_ceiling for %-of-measured-ceiling)"
    ]


def collective_kind_times(op_times: dict[str, float]) -> dict[str, float]:
    """Fold leaf-op durations into sweep-op kinds (all-reduce leaves of
    any fusion spelling -> "allreduce", ...)."""
    from tpu_hc_bench_torch.obs import trace as trace_mod

    out: dict[str, float] = {}
    for name, us in op_times.items():
        if trace_mod.classify(name) != "collective":
            continue
        n = name.lower()
        for sub, op in KIND_TO_SWEEP_OP:
            if sub in n:
                out[op] = out.get(op, 0.0) + us
                break
        else:
            out["allreduce"] = out.get("allreduce", 0.0) + us
    return out


def ceiling_utilization_lines(summary: dict, trace_rec: dict | None,
                              ceiling: dict) -> list[str]:
    """Per-collective %-of-ceiling lines from run artifacts.

    ``summary``: the metrics ``summary`` record (mean_step_ms,
    total_workers, allreduce_bytes_per_step); ``trace_rec``: the
    ``trace_buckets`` record (buckets + optional ``collective_ops``
    per-kind split).  Degrades to an explanatory line when a term is
    missing rather than silently printing nothing.
    """
    if not trace_rec or not trace_rec.get("buckets"):
        return ["  fabric ceiling: no trace buckets in this run — rerun "
                "with --trace_dir/--profile_steps to attribute "
                "collective time"]
    buckets = trace_rec["buckets"]
    total_us = sum(buckets.values())
    if total_us <= 0 or buckets.get("collective", 0.0) <= 0:
        return ["  fabric ceiling: trace shows no collective time"]
    mean_step_s = summary.get("mean_step_ms", 0.0) / 1e3
    world = int(summary.get("total_workers") or 0)
    if mean_step_s <= 0 or world <= 1:
        return ["  fabric ceiling: needs a timed multi-worker summary "
                "record"]
    coll_ops = trace_rec.get("collective_ops") or {
        "allreduce": buckets["collective"]}
    bytes_per_step = summary.get("allreduce_bytes_per_step")
    cworld = ceiling.get("world_size")
    lines = []
    if cworld and cworld != world:
        lines.append(
            f"  fabric ceiling: sweep world={cworld} != run world="
            f"{world} — %-of-ceiling is indicative only")
    for op, us in sorted(coll_ops.items(), key=lambda kv: -kv[1]):
        frac = us / total_us
        sec_per_step = frac * mean_step_s
        ceil = ceiling.get("ceilings", {}).get(op)
        if ceil is None:
            lines.append(f"  fabric: {op} {frac:.1%} of step time "
                         f"(no {op} sweep in the ceiling file)")
            continue
        if op == "allreduce" and bytes_per_step and sec_per_step > 0:
            algbw = bytes_per_step / sec_per_step / 1e9
            busbw = algbw * 2.0 * (world - 1) / world
            util = busbw / ceil["busbw_gbps"] if ceil["busbw_gbps"] else 0.0
            lines.append(
                f"  fabric: {op} {busbw:.2f} GB/s busbw = {util:.0%} of "
                f"measured ceiling {ceil['busbw_gbps']:.2f} GB/s "
                f"({frac:.1%} of step time, "
                f"{bytes_per_step / 2**20:.1f} MiB/step)")
        else:
            lines.append(
                f"  fabric: {op} {frac:.1%} of step time "
                f"(ceiling {ceil['busbw_gbps']:.2f} GB/s; no byte "
                f"accounting for this collective)")
    return lines
