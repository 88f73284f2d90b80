"""Always-on host flight recorder: bounded span timeline per rank (the
port's copy of the JAX package's ``obs/timeline.py``).

Every instrumented lane (today the serve engine: each step kind's span
and the lifecycle instants) records *spans* — named ``(t_start,
t_end)`` intervals on the process's monotonic clock — into a
preallocated ring buffer at near-zero cost (one lock + one tuple store
per span).  On the card a step's span ends after its
``torch.cuda.synchronize()``, as the engine's step time does.  Like
``FleetWriter``, recording is telemetry and NEVER fatal: any
persistence failure disables the writer, not the run.

Three consumers:

- **Per-rank persistence**: ``flush``/``detach`` append the ring's new
  spans to ``spans.<process_index>.jsonl`` beside the heartbeat files.
  Spans that rolled off the bounded ring before a flush are counted,
  never silently lost.
- **Cross-rank merge** (``python -m tpu_hc_bench_torch.obs timeline
  <dir>``): per-rank monotonic clocks are aligned through the heartbeat
  records' ``(t_mono, t_unix)`` pairs (``obs.fleet``; each spans file
  also carries its own ``clock`` records as a fallback), and the merged
  timeline exports Chrome-trace/Perfetto JSON (one ``pid`` per rank,
  one ``tid`` per recording thread) with the serving run's request
  lanes and KV-pool counter track.
- **Hang and drain forensics**: the watchdog and the SIGTERM drain call
  ``dump_timeline`` to drop ``timeline_dump.json`` — the last-K spans
  per rank, this rank's from the live ring including unflushed spans.

The on-disk formats are the JAX package's: either package's
``merge_chrome_trace`` reads the other's run directories.
"""

from __future__ import annotations

import json
import os
import threading
import time

SPANS_RE_FMT = "spans.{rank}.jsonl"
TIMELINE_DUMP_NAME = "timeline_dump.json"
DEFAULT_CAPACITY = 4096
DUMP_LAST_K = 64

#: coarse goodput-lane phases (mirrored from obs.goodput.PHASES without
#: the import — timeline must stay import-light); summarize's span
#: attribution ranks the FINE spans and leaves these to the ledger
_PHASE_LANE_NAMES = frozenset((
    "init", "compile", "step", "data_wait", "checkpoint",
    "checkpoint_async", "rewind_replay", "emergency_save", "idle", "end",
))

#: the span-name registry (round 20): every literal name the
#: instrumented lanes record, the JAX package's set unchanged.  A typo'd
#: name silently vanishes from every fold, so a new span name is a
#: one-line registration here.
KNOWN_SPANS = frozenset((
    # train lane
    "input_wait", "step_dispatch", "device_step", "eval_dispatch",
    # data service
    "svc_decode", "ring_put", "ring_get",
    # serve engine
    "prefill", "decode", "classify", "admit", "retire",
    # serve admission forensics (round 22): edge-triggered instants the
    # moment the queue blocks on a resource
    "pool_starved", "batch_full",
    # serve degradation (round 23): every load-shed, KV-pressure
    # preemption/requeue, poisoned-request quarantine, and SIGTERM
    # drain leaves an instant — failure forensics read the timeline
    "shed", "preempt", "requeue", "quarantine", "drain",
    # checkpoint
    "ckpt_snapshot", "ckpt_write", "ckpt_restore",
)) | _PHASE_LANE_NAMES


def _to_record(item: tuple) -> dict:
    """Ring tuple -> the ONE on-disk/dump record shape (flush and
    tail must never diverge on the span format)."""
    name, t0, t1, step, tid, meta = item
    rec = {"name": name, "t0": round(t0, 6), "t1": round(t1, 6)}
    if step is not None:
        rec["step"] = step
    if tid and tid != "MainThread":
        rec["tid"] = tid
    if meta:
        rec.update(meta)
    return rec


class SpanRecorder:
    """Preallocated ring of spans for THIS process.

    ``record`` is the hot-path primitive: one lock acquire, one tuple
    store, two integer bumps — no allocation beyond the tuple, no I/O.
    Persistence (``flush``) and forensics (``dump``) are separate,
    cold-path, best-effort operations.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._ring: list = [None] * self.capacity
        self._n = 0                 # spans recorded ever
        self._flushed = 0           # watermark: spans persisted so far
        self.dropped = 0            # rolled off the ring before a flush
        self._lock = threading.Lock()
        self.enabled = True
        self.rank = 0
        self._f = None              # open spans.<rank>.jsonl handle
        self._run_dir: str | None = None
        self.last_name: str | None = None

    # -- hot path ------------------------------------------------------

    def record(self, name: str, t0: float, t1: float,
               step: int | None = None, **meta) -> None:
        if not self.enabled:
            return
        tid = threading.current_thread().name
        with self._lock:
            self._ring[self._n % self.capacity] = (
                name, t0, t1, step, tid, meta or None)
            self._n += 1
            self.last_name = name

    def instant(self, name: str, step: int | None = None, **meta) -> None:
        t = time.monotonic()
        self.record(name, t, t, step=step, **meta)

    def span(self, name: str, step: int | None = None, **meta) -> "_Span":
        return _Span(self, name, step, meta)

    # -- persistence (cold path, never fatal) --------------------------

    def attach(self, run_dir: str | None, rank: int | None = None) -> None:
        """Point persistence at ``run_dir`` (``spans.<rank>.jsonl``,
        append mode).  ``None`` detaches.  Opening is lazy — the file is
        created at the first flush, so a bare run never touches disk.
        A new target receives the spans recorded while it is attached:
        the ring's older spans (an earlier run in this process) stay out
        of it, and in the forensics tail."""
        if rank is not None:
            self.rank = int(rank)
        if self._f is not None and run_dir != self._run_dir:
            self.detach()
        if run_dir != self._run_dir:
            with self._lock:
                self._flushed = self._n
        self._run_dir = run_dir

    def _spans_path(self) -> str | None:
        if not self._run_dir:
            return None
        return os.path.join(self._run_dir,
                            SPANS_RE_FMT.format(rank=self.rank))

    def _ensure_file(self):
        if self._f is None and self._run_dir:
            os.makedirs(self._run_dir, exist_ok=True)
            self._f = open(self._spans_path(), "a")
            self._write_clock()
        return self._f

    def _write_clock(self) -> None:
        # one (monotonic, unix) pair per flush: the merge's per-rank
        # clock-alignment fallback when no heartbeats exist
        self._f.write(json.dumps(
            {"clock": {"t_mono": time.monotonic(),
                       "t_unix": time.time()}}) + "\n")

    def flush(self) -> int:
        """Persist spans recorded since the last flush; returns how many
        were written.  Best-effort: an I/O failure closes the writer
        (the ring keeps recording for forensics)."""
        if not self._run_dir or not self.enabled:
            return 0
        with self._lock:
            n = self._n
            start = self._flushed
            if n - start > self.capacity:
                self.dropped += (n - start) - self.capacity
                start = n - self.capacity
            batch = [self._ring[i % self.capacity] for i in range(start, n)]
            self._flushed = n
        if not batch:
            return 0
        try:
            f = self._ensure_file()
            if f is None:
                return 0
            self._write_clock()
            for item in batch:
                f.write(json.dumps(_to_record(item), default=str) + "\n")
            f.flush()
            return len(batch)
        except OSError:
            try:
                if self._f is not None:
                    self._f.close()
            except OSError:
                pass
            self._f = None
            self._run_dir = None    # spans are telemetry, never fatal
            return 0

    def detach(self) -> None:
        """Flush and close the spans file (run end); recording stays on."""
        try:
            self.flush()
        except Exception:
            pass
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None

    def tail(self, k: int = DUMP_LAST_K) -> list[dict]:
        """The newest ``k`` spans from the live ring (flushed or not) as
        record dicts — the forensics view."""
        with self._lock:
            n = self._n
            start = max(0, n - min(k, self.capacity))
            batch = [self._ring[i % self.capacity] for i in range(start, n)]
        return [_to_record(item) for item in batch if item is not None]


class _Span:
    """Tiny context manager: ``with recorder.span("ckpt_save"): ...``."""

    __slots__ = ("_rec", "_name", "_step", "_meta", "_t0")

    def __init__(self, rec: SpanRecorder, name: str, step, meta):
        self._rec = rec
        self._name = name
        self._step = step
        self._meta = meta

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._rec.record(self._name, self._t0, time.monotonic(),
                         step=self._step, **(self._meta or {}))
        return False


# ---------------------------------------------------------------------
# module-level singleton: the ONE recorder per process, shared by every
# instrumented lane (training, data service, serve engine, checkpoint)

_RECORDER = SpanRecorder()


def configure(enabled: bool = True, run_dir: str | None = None,
              rank: int | None = None) -> SpanRecorder:
    """Run entry: set the on/off switch (``--flight_recorder``) and
    the persistence target for this process's recorder."""
    _RECORDER.enabled = bool(enabled)
    try:
        _RECORDER.attach(run_dir, rank=rank)
    except Exception:
        pass
    return _RECORDER


def record_span(name: str, t0: float, t1: float,
                step: int | None = None, **meta) -> None:
    _RECORDER.record(name, t0, t1, step=step, **meta)


def span(name: str, step: int | None = None, **meta) -> _Span:
    return _RECORDER.span(name, step=step, **meta)


def instant(name: str, step: int | None = None, **meta) -> None:
    _RECORDER.instant(name, step=step, **meta)


def flush() -> int:
    try:
        return _RECORDER.flush()
    except Exception:
        return 0


def detach() -> None:
    _RECORDER.detach()


# ---------------------------------------------------------------------
# forensics: timeline_dump.json beside memory_dump.json


def dump_timeline(out_dir: str | None, reason: str,
                  step: int | None = None,
                  last_k: int = DUMP_LAST_K) -> str | None:
    """Write ``timeline_dump.json``: the last-K spans per rank.

    This rank's spans come from the live ring (including anything not
    yet flushed — a hang usually wedges BEFORE the next sync-window
    flush); other ranks' come from their flushed ``spans.<k>.jsonl``
    files in the run dir.  Best-effort end to end: this runs on the
    watchdog/OOM/preemption paths and must never raise over the death
    it documents.  Returns the dump path, or None on any failure."""
    if not out_dir:
        return None
    try:
        ranks: dict[str, list[dict]] = {}
        for rank, spans in read_spans(out_dir).items():
            ranks[str(rank)] = spans[-last_k:]
        # the live ring wins for THIS rank (it has the unflushed tail)
        ranks[str(_RECORDER.rank)] = _RECORDER.tail(last_k)
        payload = {"reason": reason, "step": step, "t_unix": time.time(),
                   "last_k": last_k, "dropped": _RECORDER.dropped,
                   "current_phase": _RECORDER.last_name,
                   "ranks": ranks}
        path = os.path.join(out_dir, TIMELINE_DUMP_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, default=str)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path
    except Exception:
        return None


# ---------------------------------------------------------------------
# reading / merge / export (pure file ops, render anywhere)


def read_spans(run_dir: str) -> dict[int, list[dict]]:
    """All ranks' flushed spans keyed by process index; corrupt lines
    (a flush interrupted by the death it documents) skipped silently."""
    import re

    out: dict[int, list[dict]] = {}
    pat = re.compile(r"^spans\.(\d+)\.jsonl$")
    try:
        names = os.listdir(run_dir)
    except OSError:
        return out
    for fname in sorted(names):
        m = pat.match(fname)
        if not m:
            continue
        spans: list[dict] = []
        with open(os.path.join(run_dir, fname)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "clock" not in rec:
                    spans.append(rec)
        out[int(m.group(1))] = spans
    return out


def _clock_pairs(run_dir: str) -> dict[int, list[tuple[float, float]]]:
    """Per-rank ``(t_mono, t_unix)`` samples: heartbeat records first
    (``obs.fleet`` — the richer source: one pair per sync window), the
    spans files' own ``clock`` records folded in as the fallback."""
    import re

    pairs: dict[int, list[tuple[float, float]]] = {}
    from tpu_hc_bench_torch.obs import fleet as fleet_mod

    for host, recs in fleet_mod.read_heartbeats(run_dir).items():
        for r in recs:
            tm, tu = r.get("t_mono"), r.get("t_unix")
            if isinstance(tm, (int, float)) and isinstance(tu, (int, float)):
                pairs.setdefault(host, []).append((float(tm), float(tu)))
    pat = re.compile(r"^spans\.(\d+)\.jsonl$")
    try:
        names = os.listdir(run_dir)
    except OSError:
        names = []
    for fname in names:
        m = pat.match(fname)
        if not m:
            continue
        rank = int(m.group(1))
        with open(os.path.join(run_dir, fname)) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                c = rec.get("clock")
                if isinstance(c, dict) and "t_mono" in c and "t_unix" in c:
                    pairs.setdefault(rank, []).append(
                        (float(c["t_mono"]), float(c["t_unix"])))
    return pairs


class RankClock:
    """One rank's monotonic->unix mapping, incarnation-aware.

    A rank's spans file can span several LIVES of the process (the
    append-mode heartbeats/spans of elastic resume), and a relaunch on
    a rebooted or replacement host restarts CLOCK_MONOTONIC — one
    pooled median offset would confidently misplace the minority
    life's spans by hours.  So alignment is per-sample: ``offset_at``
    returns the offset of the clock pair NEAREST in monotonic time to
    the span being aligned (pairs within one life agree to
    microseconds; across lives the monotonic ranges are disjoint, so
    nearest-in-t_mono selects the right life).
    """

    def __init__(self, pairs: list[tuple[float, float]]):
        import statistics

        self._samples = sorted((m, u - m) for m, u in pairs)
        self._monos = [m for m, _ in self._samples]
        self.median_offset = statistics.median(
            off for _, off in self._samples)

    def offset_at(self, t_mono: float) -> float:
        import bisect

        i = bisect.bisect_left(self._monos, t_mono)
        if i <= 0:
            return self._samples[0][1]
        if i >= len(self._samples):
            return self._samples[-1][1]
        before, after = self._samples[i - 1], self._samples[i]
        return (before if t_mono - before[0] <= after[0] - t_mono
                else after)[1]


def rank_clocks(run_dir: str) -> dict[int, RankClock]:
    """Per-rank clock mapping from every ``(t_mono, t_unix)`` sample
    (heartbeats preferred, spans-file ``clock`` records folded in)."""
    return {rank: RankClock(samples)
            for rank, samples in _clock_pairs(run_dir).items() if samples}


def merge_chrome_trace(run_dir: str) -> dict:
    """Merge every rank's spans into one aligned Chrome-trace JSON
    (``chrome://tracing`` / Perfetto ``traceEvents`` format): one pid
    per rank, one tid per recording thread, timestamps aligned through
    the heartbeat clock pairs and rebased to the earliest span.  A rank
    with NO clock source anywhere (no heartbeats, no spans-file
    ``clock`` records) still merges — identity offset, a loud entry in
    ``metadata["warnings"]``, and a marked process name — instead of
    silently landing hours off or being dropped.

    Serving runs (round 20): the run dir's ``metrics.jsonl`` request
    records additionally render as per-request lanes
    (``obs.requests.request_trace_events``) beside the rank spans, so a
    single slow request is traceable through the engine.  Round 22 adds
    the KV-pool occupancy counter track (``obs.kv.kv_counter_events``,
    "C"-phase stacked written/reserved/free pages), so a pool-full
    admission stall is visually attributable.

    Raises FileNotFoundError when the run dir has no spans files."""
    per_rank = read_spans(run_dir)
    if not per_rank:
        raise FileNotFoundError(
            f"no spans.<rank>.jsonl under {run_dir} — was the run's "
            f"--flight_recorder off, or --metrics_dir unset?")
    clocks = rank_clocks(run_dir)
    offsets = {rank: c.median_offset for rank, c in clocks.items()}
    warnings = [
        f"rank{rank}: no clock records in its spans file and no "
        f"heartbeats in {run_dir} — merged with IDENTITY offset "
        f"(timestamps are raw monotonic; cross-rank alignment for "
        f"this rank is meaningless)"
        for rank in sorted(per_rank) if rank not in clocks]
    aligned: list[tuple[int, dict, float]] = []
    for rank, spans in per_rank.items():
        clock = clocks.get(rank)
        for s in spans:
            t0 = float(s["t0"])
            aligned.append(
                (rank, s, t0 + (clock.offset_at(t0) if clock else 0.0)))
    # per-request lanes + the KV-pool counter track from the metrics
    # stream (serving runs; a training run simply has neither record
    # kind here)
    from tpu_hc_bench_torch.obs import kv as kv_mod
    from tpu_hc_bench_torch.obs import requests as requests_mod

    metrics_records = _metrics_records(run_dir)
    req_events = requests_mod.request_trace_events(metrics_records)
    req_events.extend(kv_mod.kv_counter_events(metrics_records))
    t_base = min(t for _, _, t in aligned)
    if req_events:
        t_base = min(t_base, min(e["ts_unix"] for e in req_events
                                 if "ts_unix" in e))
    events = []
    for rank, s, t0 in aligned:
        dur_us = max(0.0, (float(s["t1"]) - float(s["t0"])) * 1e6)
        args = {k: v for k, v in s.items()
                if k not in ("name", "t0", "t1", "tid")}
        ev = {"name": s["name"], "ph": "X",
              "ts": round((t0 - t_base) * 1e6, 1),
              "dur": round(dur_us, 1),
              "pid": rank, "tid": s.get("tid", "main")}
        if args:
            ev["args"] = args
        events.append(ev)
    for ev in req_events:
        if "ts_unix" in ev:
            ev["ts"] = round((ev.pop("ts_unix") - t_base) * 1e6, 1)
        events.append(ev)
    for rank in per_rank:
        events.append({"name": "process_name", "ph": "M", "pid": rank,
                       "args": {"name": f"rank{rank}"
                                + ("" if rank in offsets
                                   else " (unaligned clock)")}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": {"run_dir": run_dir,
                         "ranks": sorted(per_rank),
                         "aligned_ranks": sorted(offsets),
                         "warnings": warnings,
                         "request_lanes": sum(
                             1 for e in req_events
                             if e.get("name") == "queue_wait"),
                         # round 22: pool-occupancy counter samples
                         # ("C"-phase events on the kv-pool track)
                         "kv_counter_samples": sum(
                             1 for e in req_events
                             if e.get("ph") == "C"),
                         "t_base_unix": t_base}}


def _metrics_records(run_dir: str) -> list[dict]:
    """Tolerant read of the run dir's metrics stream (the request-lane
    source); missing/corrupt files are an empty list, never an error —
    spans dirs without a metrics stream are normal."""
    from tpu_hc_bench_torch.obs import metrics as metrics_mod

    return metrics_mod.read_jsonl(
        os.path.join(run_dir, metrics_mod.METRICS_NAME))


def write_trace_json(trace: dict, out_path: str) -> str:
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(trace, f, default=str)
        f.write("\n")
    os.replace(tmp, out_path)
    return out_path


def write_chrome_trace(run_dir: str, out_path: str | None = None) -> str:
    trace = merge_chrome_trace(run_dir)
    out_path = out_path or os.path.join(run_dir, "timeline.trace.json")
    return write_trace_json(trace, out_path)


# ---------------------------------------------------------------------
# summarize attribution: straggler/bubble lines from the merged spans


def _fold_rank(spans: list[dict]) -> dict[str, float]:
    """name -> total seconds, fine spans only (the coarse goodput-lane
    phases already render in the ledger — repeating them here would
    double-count the same wall)."""
    out: dict[str, float] = {}
    for s in spans:
        name = s.get("name")
        if name in _PHASE_LANE_NAMES:
            continue
        try:
            dt = float(s["t1"]) - float(s["t0"])
        except (KeyError, TypeError, ValueError):
            continue
        out[name] = out.get(name, 0.0) + max(0.0, dt)
    return out


def timeline_lines(run_dir: str | None) -> list[str]:
    """The ``summarize`` timeline section: per-rank span totals with
    the dominant waits, plus the cross-rank bubble (which rank's
    timeline ends earliest after clock alignment, and in what span) —
    pure file ops, renders anywhere."""
    if not run_dir:
        return []
    per_rank = read_spans(run_dir)
    if not per_rank:
        return []
    total = sum(len(s) for s in per_rank.values())
    lines = [f"  timeline: {len(per_rank)} rank(s), {total} span(s) "
             f"(chrome trace: python -m tpu_hc_bench_torch.obs timeline "
             f"{run_dir})"]
    for rank in sorted(per_rank):
        fold = _fold_rank(per_rank[rank])
        top = sorted(fold.items(), key=lambda kv: -kv[1])[:3]
        if top:
            lines.append(
                f"    rank{rank}: "
                + "  ".join(f"{n} {s:.2f}s" for n, s in top))
    if len(per_rank) > 1:
        clocks = rank_clocks(run_dir)
        offsets = {rank: c.median_offset for rank, c in clocks.items()}
        ends = {}
        for rank, spans in per_rank.items():
            if spans:
                t_end = max(float(s["t1"]) for s in spans)
                clock = clocks.get(rank)
                ends[rank] = t_end + (clock.offset_at(t_end)
                                      if clock else 0.0)
        if len(ends) > 1:
            lead = max(ends, key=ends.get)
            lag = min(ends, key=ends.get)
            gap = ends[lead] - ends[lag]
            last = per_rank[lag][-1].get("name", "?")
            lines.append(
                f"    bubble: rank{lag} timeline ends {gap:.2f}s before "
                f"rank{lead}'s (rank{lag} last span: {last})"
                + ("" if lag in offsets and lead in offsets
                   else " [clock alignment unavailable — skew approximate]"))
    dump_path = os.path.join(run_dir, TIMELINE_DUMP_NAME)
    if os.path.isfile(dump_path):
        try:
            with open(dump_path) as f:
                d = json.load(f)
            lines.append(
                f"  timeline dump: {TIMELINE_DUMP_NAME} (reason "
                f"{d.get('reason')}, step {d.get('step')}, "
                f"{len(d.get('ranks', {}))} rank(s), last phase "
                f"{d.get('current_phase')})")
        except (OSError, json.JSONDecodeError):
            pass
    return lines
