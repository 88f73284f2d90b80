"""Fleet-wide per-host visibility: heartbeats and their readers (the
port's copy of the JAX package's ``obs/fleet.py``).

Every process appends one compact record per sync window to its *own*
``metrics.<process_index>.jsonl`` next to the main stream — host id,
last completed step, a step-duration EWMA, and (the serve lane) the KV
pool's high-water under ``kv_peak_pages``.  Pure appends, no
coordination, so a wedged host's file simply stops growing (itself a
signal).  ``read_heartbeats`` / ``straggler_lines`` /
``classify_liveness`` are pure file operations, so ``summarize``
renders fleet state from artifacts on any machine.

The training lane adds the step EWMA (``StepEwma``), the collective
straggler gather (``straggler_gather``: an all-gather of each rank's
step and EWMA over the default process group) and the input-plane
summary (``input_lines``); ``process_index`` is a required argument
here (the serve lane pins it to 0, the training lane passes its rank).
"""

from __future__ import annotations

import json
import os
import re
import time

_HEARTBEAT_RE = re.compile(r"^metrics\.(\d+)\.jsonl$")


def heartbeat_path(out_dir: str, process_index: int) -> str:
    return os.path.join(out_dir, f"metrics.{process_index}.jsonl")


class StepEwma:
    """Step-duration EWMA from (step, wall-time) samples at sync windows.

    ``update`` returns the current EWMA in milliseconds (0.0 until two
    samples exist).  Smoothing favors recency (alpha 0.3) so a host
    that *becomes* slow shows up within a few windows.
    """

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self._last: tuple[int, float] | None = None
        self.ewma_ms = 0.0

    def update(self, step: int, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        if self._last is not None:
            last_step, last_t = self._last
            dsteps = step - last_step
            if dsteps > 0:
                sample_ms = 1e3 * (now - last_t) / dsteps
                self.ewma_ms = (sample_ms if self.ewma_ms == 0.0 else
                                self.alpha * sample_ms
                                + (1 - self.alpha) * self.ewma_ms)
        self._last = (step, now)
        return self.ewma_ms


def _tail_record(path: str, nbytes: int = 8192) -> dict | None:
    """The newest parseable JSON record in the file's tail — heartbeat
    files grow O(run), and every per-tick/startup reader must stay
    O(1), not re-parse the whole history."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return None
    if size == 0:
        return None
    try:
        with open(path, "rb") as f:
            f.seek(max(0, size - nbytes))
            tail = f.read().decode("utf-8", errors="replace")
    except OSError:
        return None
    for line in reversed(tail.splitlines()):
        line = line.strip()
        if not line:
            continue
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    return None


def next_incarnation(path: str) -> int:
    """The incarnation counter the NEXT ``FleetWriter`` on this file
    will stamp: one more than the last record's (0 for a fresh file).
    Public because the fleet supervisor derives its expected
    incarnation from the SAME file tail at launch time — deriving it
    from a launch count instead would drift permanently ahead the
    first time a life dies before its first beat."""
    try:
        if os.path.getsize(path) == 0:
            return 0
    except OSError:
        return 0
    rec = _tail_record(path)
    if rec is None:
        return 1    # non-empty file with no parseable tail: a relaunch
    return int(rec.get("incarnation", 0) or 0) + 1


class FleetWriter:
    """Append-only heartbeat stream for THIS process.

    Unlike ``MetricsWriter`` every process writes (that is the point);
    disabled (no-op) when ``out_dir`` is falsy.  Each heartbeat is
    flushed immediately — the file must be readable while the run is
    live, and a killed process must not lose its last sign of life.

    The file opens in APPEND mode: an elastic resume into the same run
    dir must extend the prior life's history, not truncate it (the
    pre-round-17 ``"w"`` open silently erased every heartbeat the
    crashed incarnation left behind — exactly the forensics a resume
    postmortem needs).  Each record carries an ``incarnation`` counter
    (0 for the first life, +1 per relaunch) so readers can tell the
    lives apart, and a ``t_mono`` stamp pairing the wall clock with
    this process's monotonic clock — the span-timeline merge's
    per-rank clock-alignment source (``obs.timeline``).
    """

    def __init__(self, out_dir: str | None, process_index: int):
        self._f = None
        self.process_index = int(process_index)
        self.incarnation = 0
        if not out_dir:
            return
        os.makedirs(out_dir, exist_ok=True)
        path = heartbeat_path(out_dir, process_index)
        self.incarnation = next_incarnation(path)
        self._f = open(path, "a")

    @property
    def enabled(self) -> bool:
        return self._f is not None

    def heartbeat(self, step: int, step_ewma_ms: float,
                  mem_peak_bytes: int | None = None,
                  kv_peak_pages: int | None = None, **extra) -> None:
        if self._f is None:
            return
        rec = {"kind": "heartbeat", "host": self.process_index,
               "step": int(step), "step_ewma_ms": float(step_ewma_ms),
               "t_unix": time.time(), "t_mono": time.monotonic(),
               "incarnation": self.incarnation}
        if mem_peak_bytes:
            # the ONE heartbeat memory field name — readers
            # (watch/summarize) consume it via heartbeat_mem_peak
            rec["mem_peak_bytes"] = int(mem_peak_bytes)
        if kv_peak_pages:
            # the serve lane's KV pool high-water (round 22)
            rec["kv_peak_pages"] = int(kv_peak_pages)
        rec.update(extra)
        try:
            self._f.write(json.dumps(rec, default=str) + "\n")
            self._f.flush()
        except OSError:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None      # heartbeats are telemetry, never fatal

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except OSError:
                pass
            self._f.close()
            self._f = None


def straggler_gather(step: int, ewma_ms: float) -> dict | None:
    """Every rank's (step, EWMA) gathered over the default process group
    (a collective: every rank calls it at the same step); the straggler
    record's fields, or None when the gather fails."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return compute_skew([int(step)], [float(ewma_ms)])
    try:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        mine = torch.tensor([float(step), float(ewma_ms)],
                            dtype=torch.float64, device=dev)
        out = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(out, mine)
        rows = [t.tolist() for t in out]
    except Exception:
        return None
    return compute_skew([int(r[0]) for r in rows], [float(r[1]) for r in rows])


def compute_skew(host_steps: list[int],
                 host_ewmas: list[float]) -> dict:
    """max - median host lag, in steps and (EWMA-scaled) milliseconds."""
    import statistics

    med = statistics.median(host_steps)
    skew_steps = max(host_steps) - med
    med_ewma = statistics.median(host_ewmas) if host_ewmas else 0.0
    return {
        "host_steps": host_steps,
        "skew_steps": float(skew_steps),
        "skew_ms": float(skew_steps) * med_ewma,
        "median_step_ewma_ms": med_ewma,
    }


# ---------------------------------------------------------------------
# liveness (heartbeat staleness — shared by the fleet supervisor and
# `obs watch`)

ALIVE = "ALIVE"
STALE = "STALE"
DEAD = "DEAD"

#: default staleness thresholds, in seconds of heartbeat silence.  A
#: heartbeat lands once per sync window (seconds at most), so tens of
#: seconds of silence is a wedged host, not a slow one.
STALE_AFTER_S = 15.0
DEAD_AFTER_S = 60.0


def classify_liveness(recs: list[dict], now: float | None = None,
                      stale_after_s: float = STALE_AFTER_S,
                      dead_after_s: float = DEAD_AFTER_S,
                      expect_incarnation: int | None = None) -> dict:
    """ALIVE/STALE/DEAD verdict over one rank's heartbeat records.

    The signal is the NEWEST heartbeat's wall-clock age plus its
    incarnation counter: a file whose freshest beat is older than
    ``dead_after_s`` belongs to a process that stopped beating (killed,
    hung past the watchdog, or wedged in uninterruptible I/O) — exactly
    the state the pre-round-19 ``watch`` rendered as silently-old
    numbers.  ``expect_incarnation`` (the fleet supervisor's relaunch
    counter) guards the elastic-resume window: a beat from an OLDER
    life must not count as the new life's sign of life, so it reports
    at most STALE until the expected incarnation appears.

    Returns ``{"status", "age_s", "step", "incarnation"}``; no records
    at all classify DEAD with ``age_s=None`` (a job that never beat).
    """
    now = time.time() if now is None else now
    newest = None
    for rec in recs:
        if rec.get("kind") != "heartbeat":
            continue
        if newest is None or rec.get("t_unix", 0) >= newest.get("t_unix", 0):
            newest = rec
    if newest is None:
        return {"status": DEAD, "age_s": None, "step": None,
                "incarnation": None}
    age = max(0.0, now - float(newest.get("t_unix", now)))
    inc = int(newest.get("incarnation", 0) or 0)
    if expect_incarnation is not None and inc < expect_incarnation:
        # an old life's beat: fresh-looking numbers, wrong process —
        # never ALIVE, DEAD once the old beat itself has aged out
        status = DEAD if age > dead_after_s else STALE
    elif age > dead_after_s:
        status = DEAD
    elif age > stale_after_s:
        status = STALE
    else:
        status = ALIVE
    return {"status": status, "age_s": age,
            "step": newest.get("step"), "incarnation": inc}


# ---------------------------------------------------------------------
# reading (pure file ops)


def heartbeat_mem_peak(rec: dict) -> int | None:
    """The heartbeat's device-memory peak, under the unified
    ``mem_peak_bytes`` name (round 15); falls back to the pre-unification
    ``peak_bytes_in_use`` spelling so old run dirs still render."""
    v = rec.get("mem_peak_bytes", rec.get("peak_bytes_in_use"))
    return int(v) if v else None


def latest_heartbeats(run_dir: str) -> dict[int, dict]:
    """Each host's NEWEST heartbeat record, by bounded tail read — the
    fleet supervisor's per-tick liveness source (``read_heartbeats``
    parses the whole history; calling that every scheduler tick would
    make the control loop's cost grow with run length)."""
    out: dict[int, dict] = {}
    try:
        names = os.listdir(run_dir)
    except OSError:
        return out
    for name in sorted(names):
        m = _HEARTBEAT_RE.match(name)
        if not m:
            continue
        rec = _tail_record(os.path.join(run_dir, name))
        if rec is not None:
            out[int(m.group(1))] = rec
    return out


def read_heartbeats(run_dir: str) -> dict[int, list[dict]]:
    """All hosts' heartbeat records, keyed by process index.  Corrupt
    lines (a heartbeat interrupted by the very death it reports) are
    skipped silently — partial fleet state beats none."""
    from tpu_hc_bench_torch.obs.metrics import read_jsonl

    out: dict[int, list[dict]] = {}
    try:
        names = os.listdir(run_dir)
    except OSError:
        return out
    for name in sorted(names):
        m = _HEARTBEAT_RE.match(name)
        if not m:
            continue
        out[int(m.group(1))] = read_jsonl(os.path.join(run_dir, name))
    return out


def input_lines(run_dir: str | None, records: list[dict],
                ledger=None) -> list[str]:
    """The ``summarize`` input-plane account (real-data runs only):
    data_wait fraction from the goodput ledger, the input service's
    ring occupancy/stall record, and per-host ring occupancy mined from
    the heartbeats' ``input`` fields."""
    svc = [r for r in records if r.get("kind") == "input_service"]
    data = [r for r in records if r.get("kind") == "data"]
    if not svc and not data:
        return []                   # synthetic input: no input plane
    head = "  input:"
    if ledger is not None and ledger.wall_s > 0:
        dw = ledger.seconds.get("data_wait", 0.0)
        head += f" data_wait {dw / ledger.wall_s:.1%} of wall"
    if svc:
        s = svc[-1]
        depth = s.get("depth", "?")
        head += (f"  service rings occ p50 {s.get('occ_p50', 0)}/{depth} "
                 f"p99 {s.get('occ_p99', 0)}/{depth}  producer stalls "
                 f"{s.get('producer_stall_s', 0.0):.2f}s  consumer waits "
                 f"{s.get('consumer_wait_s', 0.0):.2f}s  "
                 f"({s.get('decode_workers', '?')} decode thread(s) -> "
                 f"{s.get('workers', '?')} worker(s))")
    else:
        head += " (per-process pipeline)"
    lines = [head]
    beats = read_heartbeats(run_dir) if run_dir else {}
    occ = sorted(
        rec["input"]["ring_occ"]
        for recs in beats.values() for rec in recs
        if isinstance(rec.get("input"), dict)
        and "ring_occ" in rec["input"])
    if occ:
        def pct(q):
            return occ[min(len(occ) - 1, int(q * (len(occ) - 1)))]

        lines.append(
            f"    host rings (heartbeats): occ p50 {pct(0.5)} "
            f"p99 {pct(0.99)} over {len(occ)} window(s), "
            f"{len(beats)} host(s)")
    return lines


def straggler_lines(run_dir: str, records: list[dict]) -> list[str]:
    """Fleet lines for ``summarize``: the last in-stream ``straggler``
    record (collective-sampled, clock-free) plus the per-host heartbeat
    tail (last step each host reported, EWMA, time since last beat)."""
    lines: list[str] = []
    stragglers = [r for r in records if r.get("kind") == "straggler"]
    if stragglers:
        s = stragglers[-1]
        lines.append(
            f"  straggler skew: max-median {s.get('skew_steps', 0):.0f} "
            f"step(s) (~{s.get('skew_ms', 0.0):.1f}ms) across "
            f"{len(s.get('host_steps', []))} host(s) "
            f"at step {s.get('step', '?')}")
    beats = read_heartbeats(run_dir)
    if beats:
        last = {h: recs[-1] for h, recs in beats.items() if recs}
        if last:
            steps = [r.get("step", 0) for r in last.values()]
            import statistics

            med = statistics.median(steps)
            peaks = [p for p in (heartbeat_mem_peak(r)
                                 for r in last.values()) if p]
            lines.append(
                f"  heartbeats: {len(last)} host file(s), last steps "
                f"median {med:.0f} min {min(steps)} max {max(steps)}"
                + (f", mem peak max {max(peaks) / 2**20:.1f} MiB"
                   if peaks else ""))
            laggards = [(h, r) for h, r in sorted(last.items())
                        if med - r.get("step", 0) >= 1]
            for h, r in laggards[:4]:
                lines.append(
                    f"    host{h}: step {r.get('step')} "
                    f"({med - r.get('step', 0):.0f} behind median, "
                    f"ewma {r.get('step_ewma_ms', 0.0):.1f}ms)")
    return lines
