"""Priority and gang scheduling, pure decisions with no processes (the
port's copy of the JAX package's ``fleet/scheduler.py``: the same fleet
state gives the same decision list).

The scheduler is a function from fleet state to a decision list; the
controller (``fleet/supervisor.py``) applies the decisions by launching
and signalling processes.  Free of side effects, it is tested in
virtual time over a stub backend and replayable from a journal.

Policy, in priority order:

- **Gang**: a job runs with its whole granted world or not at all (a
  half gang would deadlock the group's collectives).  A pending job is
  admitted at the LARGEST world of its ladder (``world_pref`` halving
  down to ``world_min``) that fits the free cards; a requeued job's
  ladder is capped by its requeue target (a shrink survives the
  relaunch).
- **Priority**: when a higher-priority job cannot fit, lower-priority
  running jobs make room: first by SHRINKING victims to their
  ``world_min`` (the victim keeps running, smaller), then by PREEMPTING
  them (they requeue and resume elastically when cards free up).
  Victims are taken lowest priority first, youngest first (the oldest
  run has the most sunk card-seconds).
- **Grow**: when cards are free and nothing is pending, the
  highest-priority running job below its ``world_pref`` regrows, one
  job a tick and only ``settle_s`` after its last transition: a grow is
  itself a preempt and an elastic relaunch, and back-to-back regrows
  would spend the goodput they chase.

Shrink, grow and preempt ride ONE mechanism: SIGTERM, the emergency
checkpoint, exit 75, a relaunch with ``--resume=elastic`` at the new
world.
"""

from __future__ import annotations

import dataclasses

from tpu_hc_bench_torch.fleet.pool import JobSpec

__all__ = ["Decision", "RunView", "PendView", "plan",
           "ADMIT", "PREEMPT", "SHRINK", "GROW", "RESERVE"]

ADMIT = "admit"
PREEMPT = "preempt"
SHRINK = "shrink"
GROW = "grow"
RESERVE = "reserve"     # cap a pending job's next admission world


@dataclasses.dataclass(frozen=True)
class Decision:
    kind: str           # admit | preempt | shrink | grow
    job: str
    world: int = 0      # admit: granted world; shrink/grow: target
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class RunView:
    """The scheduler's view of one running job."""
    spec: JobSpec
    world: int
    since_s: float      # fleet-relative time of its last transition
    stopping: bool = False   # a preempt/shrink/grow signal is in flight


@dataclasses.dataclass(frozen=True)
class PendView:
    """One queued job (arrived, not running)."""
    spec: JobSpec
    target_world: int | None = None   # requeue hint (shrink/grow carry)
    resumable: bool = False           # has a checkpoint on disk


def world_ladder(spec: JobSpec, cap: int | None = None) -> list[int]:
    """Candidate worlds, largest first: ``world_pref`` halving down to
    ``world_min`` (``cap`` bounds the top — a requeue target)."""
    top = spec.world_pref if cap is None else min(spec.world_pref, cap)
    top = max(top, spec.world_min)
    out: list[int] = []
    w = top
    while w > spec.world_min:
        out.append(w)
        w //= 2
    out.append(spec.world_min)
    # halving can undershoot min (e.g. 6 -> 3 with min 4): dedup + floor
    return sorted({max(w, spec.world_min) for w in out}, reverse=True)


def _fit(spec: JobSpec, free: int, cap: int | None) -> int | None:
    for w in world_ladder(spec, cap):
        if w <= free:
            return w
    return None


def plan(now_s: float, free: int,
         running: list[RunView], pending: list[PendView],
         settle_s: float = 5.0) -> list[Decision]:
    """One scheduling round.  Deterministic: equal inputs, equal
    decisions; ties broken by (priority, arrival order as given)."""
    decisions: list[Decision] = []
    # jobs already being stopped will free chips on a later tick; their
    # chips are NOT free yet (no admission against them) but they ARE
    # incoming — making more room for a job that is already being made
    # room for would thrash every victim in priority order
    victims_available = [r for r in running if not r.stopping]
    incoming = sum(r.world for r in running if r.stopping)
    queue = sorted(pending,
                   key=lambda p: (-p.spec.priority, p.spec.arrival_s))
    for p in queue:
        w = _fit(p.spec, free, p.target_world)
        if w is not None:
            decisions.append(Decision(ADMIT, p.spec.name, w,
                                      reason="fits"))
            free -= w
            continue
        # not fitting at world_min: can lower-priority jobs make room?
        victims = sorted(
            (r for r in victims_available
             if r.spec.priority < p.spec.priority),
            key=lambda r: (r.spec.priority, -r.since_s))
        need = max(p.spec.world_min - free - incoming, 0)
        if need == 0:
            # chips are already on their way back; wait, don't re-evict
            incoming = max(0, incoming - p.spec.world_min)
            continue
        # pass 1 — shrinks only (victims keep running, smaller)
        shrinkable = [(r, r.world - r.spec.world_min)
                      for r in victims if r.world > r.spec.world_min]
        if sum(gain for _, gain in shrinkable) >= need:
            got = 0
            for r, gain in shrinkable:
                if got >= need:
                    break
                decisions.append(Decision(
                    SHRINK, r.spec.name, r.spec.world_min,
                    reason=f"make room for {p.spec.name} "
                           f"(priority {p.spec.priority})"))
                victims_available.remove(r)
                got += gain
            # the pending job admits on a later tick, once the shrunken
            # victims have released their chips — CAPPED at the world
            # this shrink pass budgeted for it.  Uncapped, it would
            # grab its full ladder top from the freed chips and starve
            # the very victims that were promised "keep running,
            # smaller" (the shrink would degrade into a preemption).
            decisions.append(Decision(
                RESERVE, p.spec.name, p.spec.world_min,
                reason="shrink pass budgeted exactly world_min"))
            continue
        # pass 2 — preempt whole gangs, lowest priority first
        got = 0
        chosen: list[RunView] = []
        for r in victims:
            if got >= need:
                break
            chosen.append(r)
            got += r.world
        if got >= need:
            for r in chosen:
                decisions.append(Decision(
                    PREEMPT, r.spec.name,
                    reason=f"make room for {p.spec.name} "
                           f"(priority {p.spec.priority})"))
                victims_available.remove(r)
        # else: not enough even preempting everything junior — the job
        # waits (an oversized spec is refused at submission, not here)
    if not queue and free > 0:
        # regrow ONE settled job toward its preference, seniors first
        for r in sorted(victims_available,
                        key=lambda r: (-r.spec.priority,
                                       r.spec.arrival_s)):
            if r.world >= r.spec.world_pref:
                continue
            if now_s - r.since_s < settle_s:
                continue
            # the job's own chips come back to the pool during the
            # regrow relaunch, so it can claim world + free
            w = _fit(r.spec, free + r.world, None)
            if w is not None and w > r.world:
                decisions.append(Decision(
                    GROW, r.spec.name, w,
                    reason=f"{free} chip(s) free, pref "
                           f"{r.spec.world_pref}"))
                break
    return decisions
