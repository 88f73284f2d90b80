"""Step-bucket analysis of ``torch.profiler`` (Kineto) traces (the
port's copy of the JAX package's ``obs/trace.py``, which reads perfetto
traces of ``jax.profiler``).

Kineto is not perfetto, so the loading layer differs and the analysis
above it is the JAX module's:

- **Device tracks**: Kineto's chrome trace puts device work on events
  with ``cat`` ``kernel``, ``gpu_memcpy`` and ``gpu_memset``, one track
  per (device pid, stream tid); host events (``cpu_op``,
  ``cuda_runtime``, ``user_annotation``, ``python_function``) are never
  attributed.  Timestamps are microseconds, as perfetto's.
- **Steps**: the driver annotates each profiled step ``ProfilerStep#k``.
  Kineto mirrors the annotation onto the device as a
  ``gpu_user_annotation`` over the kernels the annotating thread
  launched, which leaves out the backward's (autograd launches them
  from a thread of its own); so the step track tiles the window: each
  step from its mirror's start to the next step's, the last to the
  window's last kernel.  Without mirrors the host's ``ProfilerStep#k``
  spans stand in, then JAX's fallbacks (top-level same-track
  containers, then one span over all device work).
- **Leaf-op extraction with same-tid containment** (``leaf_intervals``):
  an event that strictly contains >= 2 other events on its own (pid,
  tid) track is a container and is dropped; a long leaf merely
  overlapping ops on a sibling stream is kept.  Kernels on one CUDA
  stream do not nest, so on a real trace the rule rarely fires; it keeps
  the JAX semantics for any trace that does nest.
- **Op classification** (``classify``): JAX's ordered substring rules,
  with three of the card's ahead of them: NCCL kernels
  (``ncclDevKernel_AllReduce...``) are collectives before any "reduce"
  rule, ``Memcpy HtoD``/``DtoH`` is host transfer, and the port's own
  kernels (``flash_*_sm90_kernel``, ``fused_conv_sm90_kernel``,
  ``xent_*``, ``paged_decode_*``, ``max_pool_bwd_kernel``) are compute,
  as is every other demangled CUDA kernel (CUTLASS's names carry
  "collective" and "barrier" in their template arguments).
- **Buckets** (``summarize_trace``): each step's device time into
  compute / collective / host-transfer, and idle-bubble the span no
  device track covers.

On the CPU the profiler writes no device track: ``summarize_trace``
raises, and the driver prints that in one line and goes on.
"""

from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import os
from collections import defaultdict

# The step-attribution buckets, in display order.  "host-transfer" is
# host<->device traffic (Memcpy HtoD/DtoH, infeed/outfeed); on-device
# data movement (copies, transposes, relayouts) is device work and
# stays in "compute".  "idle-bubble" is wall time inside a step that NO
# device track covers — the device waiting on the host (Python and
# kernel launches) or a dependency stall.
BUCKETS = ("compute", "collective", "host-transfer", "idle-bubble")


# ---------------------------------------------------------------------
# loading


#: Kineto's categories of device work
DEVICE_CATS = frozenset(("kernel", "gpu_memcpy", "gpu_memset"))
#: the annotation ``prof.step()`` wraps each step in
STEP_PREFIX = "ProfilerStep#"
STEP_TRACK = ("steps", "steps")      # the key of the synthesized track


def find_trace_file(path: str) -> str:
    """Resolve a trace dir (or direct file path) to the newest
    ``*.json`` or ``*.json.gz`` trace under it."""
    if os.path.isfile(path):
        return path
    paths = [p for pat in ("*.trace.json", "*.trace.json.gz",
                           "*.pt.trace.json", "*.pt.trace.json.gz")
             for p in glob.glob(f"{path}/**/{pat}", recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no *.trace.json[.gz] under {path}")
    return max(set(paths), key=os.path.getmtime)


def load_events(path: str) -> list[dict]:
    """Load the chrome-trace ``traceEvents`` list from a trace dir or
    file (Kineto writes a bare list in some versions)."""
    f = find_trace_file(path)
    opener = gzip.open if f.endswith(".gz") else open
    with opener(f, "rt") as fh:
        data = json.load(fh)
    return data["traceEvents"] if isinstance(data, dict) else data


def _is_device(e: dict) -> bool:
    return e.get("cat") in DEVICE_CATS


def _step_spans_of(events: list[dict]) -> list[tuple[float, float]]:
    """Per-step ``[start, end)`` from the ``ProfilerStep#k``
    annotations: the device-side mirrors (``gpu_user_annotation``,
    merged across streams) where Kineto wrote them, else the host's.
    A mirror covers only the kernels its own thread launched, and the
    backward's are launched by autograd's thread: so each step runs from
    its annotation's start to the next step's, and the last to its
    annotation's end or the window's last kernel, whichever is later."""
    last = max((e["ts"] + e["dur"] for e in events
                if e.get("ph") == "X" and _is_device(e)), default=None)
    for cat in ("gpu_user_annotation", "user_annotation"):
        spans: dict[str, list[float]] = {}
        for e in events:
            if (e.get("ph") == "X" and e.get("cat") == cat
                    and str(e.get("name", "")).startswith(STEP_PREFIX)
                    and e.get("dur", 0) > 0):
                s, t = e["ts"], e["ts"] + e["dur"]
                cur = spans.setdefault(e["name"], [s, t])
                cur[0], cur[1] = min(cur[0], s), max(cur[1], t)
        if spans:
            got = sorted((s, t) for s, t in spans.values())
            tiles = [(s, nxt) for (s, _), (nxt, _) in zip(got, got[1:])]
            s, t = got[-1]
            return tiles + [(s, max(t, last if last is not None else t))]
    return []


def _device_tracks(events: list[dict]) -> dict[tuple, list[dict]]:
    """Positive-duration device events grouped per (pid, tid) track and
    start-sorted (ties broken longest-first so containers sort before
    the children they start with); the step annotations, when present,
    as one more track under ``STEP_TRACK``."""
    by_track: dict[tuple, list] = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and _is_device(e) and e.get("dur", 0) > 0:
            by_track[(e["pid"], e.get("tid", 0))].append(e)
    if not by_track:
        # fail as loudly as a missing trace: an attribution table
        # silently built from zero device events reads as "no hot ops"
        raise RuntimeError(
            "trace has no GPU device track (no kernel, gpu_memcpy or "
            "gpu_memset events) — a CPU run's profiler writes host "
            "tracks only")
    for evs in by_track.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
    steps = _step_spans_of(events)
    if steps:
        by_track[STEP_TRACK] = [
            {"name": str(i + 1), "ts": s, "dur": t - s}
            for i, (s, t) in enumerate(steps)]
    return by_track


def _is_container(evs: list[dict], i: int) -> bool:
    """Does start-sorted ``evs[i]`` strictly contain >= 2 later events on
    its own track?  (The same-tid containment rule — module docstring.)"""
    e = evs[i]
    end = e["ts"] + e["dur"]
    contained = 0
    j = i + 1
    n = len(evs)
    # events are start-sorted: scan candidates starting inside
    # [ts, end) — leaves exit immediately, containers after 2
    while j < n and evs[j]["ts"] < end and contained < 2:
        if evs[j]["ts"] + evs[j].get("dur", 0) <= end:
            contained += 1
        j += 1
    return contained >= 2


def _split_tracks(
    tracks: dict[tuple, list[dict]], skip_tracks: set | None = None,
) -> tuple[list[dict], dict[tuple, list[dict]]]:
    """ONE containment scan over all tracks: ``(leaves,
    containers_by_track)``.  Every consumer (op aggregation, step
    reconstruction, bucket attribution) shares this split — on a real
    trace the scan is the dominant cost and must not run twice."""
    leaves: list[dict] = []
    containers: dict[tuple, list[dict]] = {}
    for key, evs in tracks.items():
        if skip_tracks and key in skip_tracks:
            continue
        cs: list[dict] = []
        for i, e in enumerate(evs):
            (cs if _is_container(evs, i) else leaves).append(e)
        containers[key] = cs
    return leaves, containers


def _aggregate(leaves: list[dict]) -> tuple[dict[str, float],
                                            dict[str, int]]:
    ops: dict[str, float] = defaultdict(float)
    counts: dict[str, int] = defaultdict(int)
    for e in leaves:
        ops[e["name"]] += e["dur"]
        counts[e["name"]] += 1
    return dict(ops), dict(counts)


def leaf_intervals(events: list[dict]) -> list[tuple[str, float, float]]:
    """``(name, start_us, end_us)`` for every leaf device op, the
    step-marker track excluded — the interval-level view
    ``obs.efficiency.collective_overlap`` needs to tell an *exposed*
    collective (device otherwise idle) from one hidden behind concurrent
    compute on a sibling stream."""
    tracks = _device_tracks(events)
    st = _step_track(events, tracks)
    leaves, _ = _split_tracks(tracks, {st} if st is not None else None)
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in leaves]


def device_op_times(trace_dir: str) -> tuple[dict[str, float],
                                             dict[str, int]]:
    """Aggregate device-track op durations (us) + event counts from the
    newest trace under ``trace_dir`` (the step annotations excluded)."""
    events = load_events(trace_dir)
    tracks = _device_tracks(events)
    st = _step_track(events, tracks)
    leaves, _ = _split_tracks(tracks, {st} if st is not None else None)
    return _aggregate(leaves)


# ---------------------------------------------------------------------
# op classification


#: the port's own kernels (``tpu_hc_bench_torch/csrc``): compute
PORT_KERNELS = ("flash_", "fused_bn_relu_conv", "fused_conv", "xent_",
                "stats_reduce", "paged_decode_", "paged_attention",
                "max_pool_bwd", "fused_residual_norm")


def classify(name: str) -> str:
    """Op class from the trace event name (a kernel's, or XLA's
    instruction name in a JAX trace)."""
    n = name.lower()
    # the card's names first: NCCL's kernels are collectives whatever
    # they reduce; host<->device copies are host transfer; the port's
    # kernels are compute.  A CUDA kernel's name, demangled ("void
    # f<...>(...)", "ns::f") or not ("_ZN..."), is never one of XLA's
    # instructions, and CUTLASS's carry "collective", "barrier" and
    # "sync" in their template arguments: past NCCL and the copies, they
    # are device work
    if "nccl" in n:
        return "collective"
    if "htod" in n or "dtoh" in n:
        return "infra"
    if any(n.startswith(k) or f" {k}" in n or f"::{k}" in n
           for k in PORT_KERNELS):
        return "kernel"
    if "::" in n or n.startswith(("void ", "_z")):
        return "conv" if any(k in n for k in ("conv", "cudnn", "gemm",
                                              "cutlass", "xmma", "nvjet",
                                              "wgrad", "dgrad")) \
            else "elementwise/other"
    if any(k in n for k in ("all-reduce", "allreduce", "all-gather",
                            "allgather", "reduce-scatter", "all-to-all",
                            "collective", "permute", "psum")):
        return "collective"
    if any(k in n for k in ("reduce", "norm", "softmax")):
        return "reduce/norm"
    # select-and-scatter is max-pool BACKWARD (a windowed reduction, not
    # routing) — must be caught before the gather/sort class below would
    # claim its "scatter" substring
    if "select-and-scatter" in n:
        return "pool-bwd"
    # routing/permutation work (MoE dispatch, embedding lookups): sorts,
    # gathers, scatters — split out from elementwise/other so the ragged
    # MoE and ncf attributions can see it (plain "gather" lands here;
    # "all-gather" was already caught by the collective class above)
    if any(k in n for k in ("sort", "gather", "scatter", "cumsum", "iota")):
        return "gather/sort"
    if any(k in n for k in ("copy", "transpose", "reshape", "bitcast",
                            "convert", "concatenate", "slice", "pad")):
        return "data-movement"
    if "conv" in n:
        return "conv"
    if "dot" in n or "matmul" in n or "einsum" in n:
        return "matmul"
    if any(k in n for k in ("infeed", "outfeed", "barrier", "sync")):
        return "infra"
    return "elementwise/other"


def bucket_of(name: str) -> str:
    """Step-attribution bucket for one leaf op (see ``BUCKETS``)."""
    cls = classify(name)
    if cls == "collective":
        return "collective"
    if cls == "infra" or "host" in name.lower():
        return "host-transfer"
    return "compute"


# ---------------------------------------------------------------------
# step reconstruction + bucket attribution


@dataclasses.dataclass
class StepBuckets:
    """One reconstructed step: wall span + per-bucket device time (us).

    Bucket sums can exceed ``dur_us`` when several device tracks run
    concurrently (compute overlapping a DMA stream is real device time
    on both); ``idle_us`` is the part of the span NO track covers.
    """

    index: int
    start_us: float
    dur_us: float
    buckets: dict[str, float]

    @property
    def idle_us(self) -> float:
        return self.buckets.get("idle-bubble", 0.0)


@dataclasses.dataclass
class TraceSummary:
    steps: list[StepBuckets]
    totals: dict[str, float]        # per-bucket us summed over steps
    step_source: str                # "step-track" (ProfilerStep#k) |
                                    # "envelopes" | "span"

    def fractions(self) -> dict[str, float]:
        total = sum(self.totals.values())
        if not total:
            return {b: 0.0 for b in self.totals}
        return {b: v / total for b, v in self.totals.items()}


def _step_track(events: list[dict],
                tracks: dict[tuple, list[dict]]) -> tuple | None:
    """The step-annotation track ``_device_tracks`` synthesized from the
    ``ProfilerStep#k`` spans, if the trace has them."""
    return STEP_TRACK if STEP_TRACK in tracks else None


def _interval_union(intervals: list[tuple[float, float]]) -> float:
    """Total length covered by a set of [start, end) intervals."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _spans_from(
    tracks: dict[tuple, list[dict]], st: tuple | None,
    containers_by_track: dict[tuple, list[dict]],
) -> tuple[list[tuple[float, float]], str]:
    """Per-step [start, end) wall spans from an already-split trace.

    Source is one of:
      - ``"step-track"``: the ``ProfilerStep#k`` annotations;
      - ``"envelopes"``: top-level same-tid container events on the
        busiest track;
      - ``"span"``: no structure found; one span covering all device
        activity (bucket totals stay right, per-step resolution is lost).
    """
    if st is not None:
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in tracks[st]]
        return sorted(spans), "step-track"
    # envelope fallback: top-level containers on the track holding them
    best: list[tuple[float, float]] = []
    for cs in containers_by_track.values():
        # top-level only: drop containers nested inside an earlier one
        # (cs is start-sorted because the track was)
        spans, covered_end = [], -float("inf")
        for e in cs:
            ts, end = e["ts"], e["ts"] + e["dur"]
            if ts >= covered_end:
                spans.append((ts, end))
                covered_end = end
        if len(spans) > len(best):
            best = spans
    if best:
        return best, "envelopes"
    lo = min(e["ts"] for evs in tracks.values() for e in evs)
    hi = max(e["ts"] + e["dur"] for evs in tracks.values() for e in evs)
    return [(lo, hi)], "span"


def summarize_trace(events: list[dict]) -> TraceSummary:
    """Per-step bucket attribution for a loaded trace.

    Each leaf op's duration is clipped to the step spans it overlaps and
    summed into its bucket; idle-bubble is each span's wall time no
    device track covers.  The step annotations (when present) define the
    spans and are not device work.
    """
    tracks = _device_tracks(events)
    st = _step_track(events, tracks)
    leaves, containers = _split_tracks(tracks,
                                       {st} if st is not None else None)
    spans, source = _spans_from(tracks, st, containers)
    # one start-sorted sweep instead of re-scanning every leaf per span
    # (spans are sorted and disjoint by construction): j tracks the
    # first leaf not entirely before the current span; real traces hold
    # ~1e5 leaves over tens of spans, where O(steps x leaves) hurts
    leaves.sort(key=lambda e: e["ts"])
    n = len(leaves)
    j = 0
    steps: list[StepBuckets] = []
    for idx, (lo, hi) in enumerate(spans):
        while j < n and leaves[j]["ts"] + leaves[j]["dur"] <= lo:
            j += 1
        buckets = {b: 0.0 for b in BUCKETS}
        busy: list[tuple[float, float]] = []
        k = j
        while k < n and leaves[k]["ts"] < hi:
            e = leaves[k]
            k += 1
            s, t = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
            if t <= s:
                continue
            buckets[bucket_of(e["name"])] += t - s
            busy.append((s, t))
        buckets["idle-bubble"] = max(0.0, (hi - lo) - _interval_union(busy))
        steps.append(StepBuckets(index=idx, start_us=lo, dur_us=hi - lo,
                                 buckets=buckets))
    totals = {b: sum(s.buckets[b] for s in steps) for b in BUCKETS}
    return TraceSummary(steps=steps, totals=totals, step_source=source)


def summarize_trace_dir(trace_dir: str) -> TraceSummary:
    return summarize_trace(load_events(trace_dir))


# ---------------------------------------------------------------------
# formatting — shared by the driver's post-run summary and the CLI


def format_summary(summary: TraceSummary, per_step: bool = True,
                   title: str = "trace summary") -> list[str]:
    """Human-readable bucket table (device microseconds)."""
    lines = [f"{title}: {len(summary.steps)} step(s) "
             f"(boundaries: {summary.step_source})"]
    frac = summary.fractions()
    total = sum(summary.totals.values())
    lines.append(f"{'bucket':>15s} {'us':>12s} {'frac':>7s}")
    for b in BUCKETS:
        lines.append(f"{b:>15s} {summary.totals[b]:12.0f} "
                     f"{frac.get(b, 0.0):6.1%}")
    lines.append(f"{'total':>15s} {total:12.0f}")
    if per_step and len(summary.steps) > 1:
        lines.append("per-step (us): "
                     + " ".join(f"{s.dur_us:.0f}" for s in summary.steps))
    return lines
