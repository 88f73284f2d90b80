"""Deterministic spot churn for fleet soaks (the port's copy of the JAX
package's ``fleet/churn.py``: the same seed gives the same schedule).

A soak that cannot be replayed cannot be debugged, so churn is a
schedule, not a coin flip a tick: spelled out::

    kill@8:jobA, shrink@14:jobB, arrive@6:jobC

(``<op>@<t_seconds>:<job>``), or drawn from a seed (``seeded_churn``):
a pure function of (seed, jobs, horizon), independent of wall-clock
jitter.

Event semantics (applied by the fleet controller):

- ``kill``: the spot preemption, SIGTERM to the job's process group (the
  job's preemption handler writes the emergency checkpoint and exits
  75); the job requeues and resumes elastically at whatever world the
  pool then affords.
- ``shrink``: capacity pressure, a preempt with a target of half the
  job's world (at least ``world_min``).
- ``arrive``: a delayed arrival, the job enters the queue at this time
  (overriding its spec's ``arrival_s``).
"""

from __future__ import annotations

import dataclasses
import random

__all__ = ["ChurnEvent", "parse_churn", "format_churn", "seeded_churn",
           "OPS"]

OPS = ("kill", "shrink", "arrive")


@dataclasses.dataclass(frozen=True, order=True)
class ChurnEvent:
    t_s: float
    op: str
    job: str

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"unknown churn op {self.op!r} "
                             f"(known: {', '.join(OPS)})")
        if self.t_s < 0:
            raise ValueError(f"churn time must be >= 0: {self.t_s}")


def parse_churn(spec: str) -> list[ChurnEvent]:
    """``kill@8:jobA, shrink@14:jobB`` -> sorted events.  Loud on any
    malformed entry — a silently-dropped kill event turns a failing
    soak green."""
    events: list[ChurnEvent] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            op, rest = part.split("@", 1)
            t, job = rest.split(":", 1)
            events.append(ChurnEvent(float(t), op.strip(), job.strip()))
        except ValueError as e:
            raise ValueError(
                f"malformed churn entry {part!r} (want "
                f"<op>@<t_seconds>:<job>, op in {'/'.join(OPS)}): {e}"
            ) from None
    return sorted(events)


def format_churn(events: list[ChurnEvent]) -> str:
    return ",".join(f"{e.op}@{e.t_s:g}:{e.job}" for e in sorted(events))


def seeded_churn(seed: int, jobs: list[str], horizon_s: float,
                 kills: int = 1, shrinks: int = 1,
                 min_gap_s: float = 2.0) -> list[ChurnEvent]:
    """A replayable random schedule: ``kills`` kill events and
    ``shrinks`` shrink events spread over the middle 60% of the horizon
    (the soak's steady state — events in the first/last 20% race
    startup and drain, which are churny already), round-robin over the
    job names, at least ``min_gap_s`` apart.  Same (seed, jobs,
    horizon) -> same schedule, always."""
    if not jobs:
        return []
    rng = random.Random(seed)
    lo, hi = 0.2 * horizon_s, 0.8 * horizon_s
    events: list[ChurnEvent] = []
    times: list[float] = []
    ops = ["kill"] * kills + ["shrink"] * shrinks
    for i, op in enumerate(ops):
        for _ in range(64):     # bounded rejection sampling on the gap
            t = round(rng.uniform(lo, hi), 1)
            if all(abs(t - u) >= min_gap_s for u in times):
                break
        times.append(t)
        events.append(ChurnEvent(t, op, jobs[i % len(jobs)]))
    return sorted(events)
