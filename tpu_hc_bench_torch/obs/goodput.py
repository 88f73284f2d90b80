"""Wall-clock goodput ledger: every second of a run attributed (the
port's copy of the JAX package's ``obs/goodput.py``).

The reference harness reports raw images/sec and nothing else; a run
that spent half its wall compiling, waiting on the input pipeline, or
replaying rewound steps posts the same headline number as a clean one.
This module closes that gap with a *ledger*: the driver emits phase
transitions into the metrics stream as it moves through the run's
lifecycle, and folding those records (plus the resilience events of
``tpu_hc_bench_torch.resilience``) yields a wall-clock account —

- ``init``           backend/layout/model/data construction
- ``compile``        the warmup loop (cuDNN's algorithm search, the
                     allocator's warm-up and the kernel library's build
                     or load fall here, as XLA's compile does in the
                     JAX lane)
- ``step``           the timed training loop (the productive part)
- ``data_wait``      host time blocked in ``next(batch_iter)`` inside
                     the timed loop (carved out of ``step``)
- ``checkpoint``     synchronous ``--train_dir`` saves (device-syncing;
                     the full snapshot + write + commit blocks)
- ``checkpoint_async`` the BLOCKING slice of an async save: barrier on
                     the previous write + device→host snapshot; the
                     write/fsync/commit runs overlapped with the
                     step loop and never enters the ledger as blocking
                     wall (per-save ``checkpoint_commit`` records carry
                     the overlapped write seconds)
- ``rewind_replay``  ``--on_nonfinite=rewind`` restores
- ``emergency_save`` the preemption path's final checkpoint
- ``idle``           anything explicitly marked idle (none in a
                     healthy run)

plus a **goodput fraction**: productive step seconds / wall seconds,
where "productive" additionally *excludes* step time whose work was
thrown away — updates dropped by ``--on_nonfinite=skip`` and steps
lost to a rewind (both folded in from the resilience records, scaled
by the mean step time).

Record shapes (append-only, in ``metrics.jsonl``):

- ``{"kind": "phase", "phase": P, "t": monotonic_s, "step": i|null}``
  — transition INTO phase ``P``; durations come from consecutive
  transitions, so the stream stays O(transitions), not O(steps).
- ``{"kind": "phase_acc", "phase": "data_wait", "seconds": s,
  "step": i}`` — seconds accumulated *inside* the current phase and
  re-attributed to ``phase`` (the driver batches per-step data waits
  and flushes once per sync window, keeping the hot loop write-free).

The fold is pure record processing (no torch), so ``summarize`` works on
artifacts from any machine; ``PhaseTracker`` keeps a local copy of its
emissions so the driver can compute the same ledger at end-of-run
without re-reading the file.
"""

from __future__ import annotations

import dataclasses
import time

from tpu_hc_bench_torch.obs import timeline as timeline_mod

PHASES = ("init", "compile", "step", "data_wait", "checkpoint",
          "checkpoint_async", "rewind_replay", "emergency_save", "idle")
END_PHASE = "end"


class PhaseTracker:
    """Driver-side phase state machine; emits through a MetricsWriter.

    Construction enters ``init`` immediately.  ``note_data_wait`` is a
    float add (safe in the hot loop); ``flush`` writes the accumulated
    wait once per sync window.  ``note_lost_steps`` /
    ``note_skipped_updates`` record wasted work for the local ledger
    (the corresponding resilience events in the stream carry the same
    numbers for the offline fold).
    """

    def __init__(self, writer):
        self._writer = writer
        self.records: list[dict] = []
        self._data_wait_acc = 0.0
        self.lost_steps = 0         # rewind: timed steps whose updates died
        self.skipped_updates = 0    # --on_nonfinite=skip drops
        self.enter("init")

    def _emit(self, kind: str, **fields) -> None:
        rec = {"kind": kind}
        rec.update(fields)
        self.records.append(rec)
        self._writer.event(kind, **fields)

    def enter(self, phase: str, step: int | None = None) -> None:
        self._emit("phase", phase=phase, t=time.monotonic(), step=step)
        # mirror the transition into the flight recorder's coarse lane
        # (obs.timeline): the ledger gets seconds, the timeline gets the
        # same spans per rank — one call site, two consumers
        timeline_mod.transition(phase, step=step)

    def note_data_wait(self, seconds: float) -> None:
        self._data_wait_acc += seconds

    def note_lost_steps(self, n: int) -> None:
        self.lost_steps += max(0, int(n))

    def note_skipped_updates(self, n: int) -> None:
        self.skipped_updates += max(0, int(n))

    def flush(self, step: int | None = None) -> None:
        if self._data_wait_acc > 0.0:
            self._emit("phase_acc", phase="data_wait",
                       seconds=self._data_wait_acc, step=step)
            self._data_wait_acc = 0.0

    def end(self, step: int | None = None) -> None:
        self.flush(step)
        self._emit("phase", phase=END_PHASE, t=time.monotonic(), step=step)
        timeline_mod.transition(END_PHASE, step=step)

    def ledger(self) -> "Ledger | None":
        """The ledger over everything emitted so far (driver-side path;
        resilience waste comes from the ``note_*`` counters)."""
        led = build_ledger(self.records, fold_resilience=False)
        if led is None:
            return None
        return _fold_waste(led, self.lost_steps, self.skipped_updates)


@dataclasses.dataclass
class Ledger:
    """Per-category wall seconds + the goodput account."""

    seconds: dict[str, float]       # category -> seconds (data_wait carved
                                    # out of its enclosing phase)
    wall_s: float                   # first transition -> end (or last seen)
    steps: int                      # timed steps observed (max step field)
    complete: bool                  # an explicit "end" transition was seen
    rewind_lost_s: float = 0.0      # step time replayed after rewinds
    skipped_updates_s: float = 0.0  # step time whose update was dropped

    @property
    def step_s(self) -> float:
        return self.seconds.get("step", 0.0)

    @property
    def mean_step_s(self) -> float:
        return self.step_s / self.steps if self.steps else 0.0

    @property
    def productive_s(self) -> float:
        return max(
            0.0, self.step_s - self.rewind_lost_s - self.skipped_updates_s)

    @property
    def goodput(self) -> float:
        return self.productive_s / self.wall_s if self.wall_s > 0 else 0.0

    def format_lines(self) -> list[str]:
        head = (f"goodput: {self.goodput:.1%} "
                f"(productive {self.productive_s:.1f}s "
                f"of {self.wall_s:.1f}s wall"
                + ("" if self.complete else "; run did not end cleanly")
                + ")")
        parts = [f"{k}={self.seconds[k]:.2f}s"
                 for k in PHASES
                 if self.seconds.get(k, 0.0) > 0.0 and k != "step"]
        if self.rewind_lost_s > 0:
            parts.append(f"rewind_lost={self.rewind_lost_s:.2f}s")
        if self.skipped_updates_s > 0:
            parts.append(f"skipped_updates={self.skipped_updates_s:.2f}s")
        lines = [head]
        if parts:
            lines.append("  non-productive: " + "  ".join(parts))
        return lines


def rewind_lost_steps(i: int, restored_step: int, base_step: int,
                      warmup_steps: int) -> int:
    """Timed steps of THIS run whose work a rewind discarded.

    ``restored_step`` is the checkpoint's absolute step counter, which
    on a ``--resume`` run includes every previous run's steps
    (``base_step``, the counter at this run's start) plus this run's
    warmup; the checkpoint's position in this run's timed loop is
    therefore ``restored_step - base_step - warmup_steps`` — clamped at
    0 for a checkpoint predating this run's timed loop (e.g. the
    resume source itself), where ALL ``i`` timed steps are lost.
    """
    at_save = max(0, restored_step - base_step - warmup_steps)
    return max(0, i - at_save)


def _fold_waste(led: Ledger, lost_steps: int, skipped: int) -> Ledger:
    """Scale wasted step *counts* into seconds by the mean step time and
    fold them into the ledger — replayed/rewound steps burned real step
    time whose work was discarded."""
    led.rewind_lost_s = min(led.step_s, lost_steps * led.mean_step_s)
    led.skipped_updates_s = min(
        max(0.0, led.step_s - led.rewind_lost_s),
        skipped * led.mean_step_s)
    return led


def build_ledger(records: list[dict],
                 fold_resilience: bool = True) -> Ledger | None:
    """Fold a metrics-record stream into a Ledger.

    Returns None when the stream carries no phase transitions (runs
    predating the ledger, or eval runs which emit only ``init``  — a
    ledger needs at least a ``step`` phase to account against).
    """
    transitions: list[tuple[str, float, int | None]] = []
    accs: list[tuple[int, str, float]] = []     # (position, phase, seconds)
    lost_steps = 0
    skipped = 0
    for rec in records:
        kind = rec.get("kind")
        if kind == "phase" and isinstance(rec.get("t"), (int, float)):
            transitions.append(
                (rec.get("phase", "idle"), float(rec["t"]), rec.get("step")))
        elif kind == "phase_acc" and isinstance(
                rec.get("seconds"), (int, float)):
            accs.append((len(transitions), rec.get("phase", "idle"),
                         float(rec["seconds"])))
        elif kind == "rewind":
            lost_steps += int(rec.get("lost_steps", 0) or 0)
        elif kind == "nonfinite_skip":
            skipped += int(rec.get("new_bad", 0) or 0)
    if not any(p == "step" for p, _, _ in transitions):
        return None

    seconds: dict[str, float] = {p: 0.0 for p in PHASES}
    complete = transitions[-1][0] == END_PHASE
    t0 = transitions[0][1]
    t_end = transitions[-1][1]
    for (p, t, _), (_, t_next, _) in zip(transitions, transitions[1:]):
        if p != END_PHASE:
            seconds[p] = seconds.get(p, 0.0) + max(0.0, t_next - t)
    # phase_acc: carve the accumulated seconds out of the phase that was
    # active when the record was appended (position = transitions seen)
    for pos, phase, s in accs:
        if pos > 0:
            host = transitions[pos - 1][0]
            if host != END_PHASE:
                seconds[host] = max(0.0, seconds.get(host, 0.0) - s)
        seconds[phase] = seconds.get(phase, 0.0) + s
    # timed-step count: the largest step stamp anywhere in the stream
    # (phase flushes, window records, resilience events all carry one)
    steps = max((r["step"] for r in records
                 if isinstance(r.get("step"), int)), default=0)
    led = Ledger(seconds=seconds, wall_s=max(0.0, t_end - t0),
                 steps=steps, complete=complete)
    if fold_resilience:
        led = _fold_waste(led, lost_steps, skipped)
    return led
