"""The device pool and the job-spec contract (the port's copy of the
JAX package's ``fleet/pool.py``).

One pool of cards (or, on the CPU by request, of virtual ones), many
jobs.  Two admission questions are answered here, both before a process
is spawned:

- **Cards**: gang semantics, a job holds ``world`` cards or none.
  ``reserve``/``release`` are bookkeeping with a hard overcommit
  invariant; which world a job gets is the scheduler's decision, the
  pool only says whether it fits.  Where JAX counts chips (each JAX job
  makes its own virtual devices), the port also records WHICH cards a
  job holds: on a card host two jobs launched ``1 0 ...`` would both
  bind ``cuda:0``, so each job's gang is the lowest free indices,
  handed to it as ``CUDA_VISIBLE_DEVICES`` and freed with the job.  The
  counts, and every decision made on them, stay JAX's; the scheduler
  never sees the indices.
- **Device memory**: a job whose per-card microbatch cannot fit would
  OOM in its first warmup step and burn its gang's card-seconds.
  ``hbm_admission`` asks the autotuner's memory model
  (``tune.prune.hbm_model_for``): measured anchors from run journals
  win, the seeded best-known config is the fallback, and each verdict
  carries its provenance (``measured|seeded|unknown``).  The launcher's
  ``--batch_size`` is per worker, so the per-card microbatch (batch /
  accum) does not depend on the world and the check runs once a spec.

The job spec is the fleet's unit of work: a zoo member plus its gang
geometry (preferred and minimum world), a priority, an arrival time and
the run length.  ``JobSpec.from_dict``/``to_dict`` define the ``fleet
run --spec jobs.json`` file format (README).
"""

from __future__ import annotations

import dataclasses

__all__ = ["JobSpec", "DevicePool", "HbmVerdict"]


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One training job in the fleet.

    ``batch_size`` is the launcher's per-worker batch (the global batch
    scales with the granted world).  ``world_pref`` is the gang the job
    wants, ``world_min`` the smallest worth running: the scheduler
    shrinks between the two, never below.  A higher ``priority``
    preempts a lower one.  ``arrival_s`` is when the job enters the
    queue (seconds from the fleet's start; a churn ``arrive`` event
    overrides it).  ``flags`` pass through to the launcher verbatim.
    """

    name: str
    model: str
    batch_size: int
    world_pref: int
    world_min: int = 1
    priority: int = 0
    arrival_s: float = 0.0
    batches: int = 60
    warmup: int = 2
    accum: int = 1
    save_every: int = 2
    flags: tuple[str, ...] = ()

    def __post_init__(self):
        if not self.name or "/" in self.name:
            raise ValueError(f"job name must be a plain token: "
                             f"{self.name!r}")
        if self.world_min < 1 or self.world_pref < self.world_min:
            raise ValueError(
                f"{self.name}: need 1 <= world_min <= world_pref, got "
                f"min={self.world_min} pref={self.world_pref}")
        if self.batch_size < 1 or self.accum < 1:
            raise ValueError(f"{self.name}: batch/accum must be >= 1")

    @property
    def microbatch(self) -> int:
        """The per-card activation unit (batch / accum) the memory
        admission anchors on."""
        return max(1, self.batch_size // self.accum)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["flags"] = list(self.flags)
        return d

    @staticmethod
    def from_dict(d: dict) -> "JobSpec":
        known = {f.name for f in dataclasses.fields(JobSpec)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"job spec {d.get('name', '?')!r}: unknown field(s) "
                f"{sorted(unknown)} (known: {sorted(known)})")
        d = dict(d)
        d["flags"] = tuple(d.get("flags") or ())
        return JobSpec(**d)


@dataclasses.dataclass(frozen=True)
class HbmVerdict:
    fits: bool
    reason: str | None      # refusal reason (None when it fits)
    source: str             # measured | seeded | unknown


class DevicePool:
    """Card reservations for one shared pool, gang-or-nothing.

    ``held`` counts each job's cards (JAX's bookkeeping); ``cards``
    names them.  ``measured_rows`` (tune-journal measurement rows joined
    with their overrides, ``tune.prune.measured_rows_from_journal``)
    feed the memory model its measured anchors; without them the seeded
    configs decide, and a member outside the seed table admits with
    ``source="unknown"``.
    """

    def __init__(self, chips: int,
                 measured_rows: list[dict] | None = None):
        if chips < 1:
            raise ValueError(f"pool needs >= 1 chip, got {chips}")
        self.chips = chips
        self.measured_rows = list(measured_rows or [])
        self.held: dict[str, int] = {}
        self.cards: dict[str, tuple[int, ...]] = {}
        self._hbm_cache: dict[tuple, HbmVerdict] = {}

    @property
    def free(self) -> int:
        return self.chips - sum(self.held.values())

    def can_reserve(self, world: int) -> bool:
        return 1 <= world <= self.free

    def reserve(self, name: str, world: int) -> tuple[int, ...]:
        """Hold ``world`` cards for ``name``: the lowest free indices,
        returned."""
        if name in self.held:
            raise ValueError(f"{name} already holds "
                             f"{self.held[name]} chip(s)")
        if not self.can_reserve(world):
            raise ValueError(
                f"cannot reserve {world} chip(s) for {name}: "
                f"{self.free} of {self.chips} free")
        taken = {c for cs in self.cards.values() for c in cs}
        grant = tuple(c for c in range(self.chips) if c not in taken)[:world]
        self.held[name] = world
        self.cards[name] = grant
        return grant

    def release(self, name: str) -> int:
        self.cards.pop(name, None)
        return self.held.pop(name, 0)

    def hbm_admission(self, spec: JobSpec) -> HbmVerdict:
        """Would one card hold this job's microbatch?  Measured anchors
        first, through ``tune.prune.hbm_model_for``; the verdict is
        cached per (model, batch, accum).  The pool's rows are filtered
        to this spec's model (a row without ``model`` is dropped: one
        member's memory profile never anchors another's admission)."""
        key = (spec.model, spec.batch_size, spec.accum)
        hit = self._hbm_cache.get(key)
        if hit is not None:
            return hit
        from tpu_hc_bench_torch.tune.prune import hbm_model_for
        from tpu_hc_bench_torch.tune.space import Candidate

        rows = [r for r in self.measured_rows
                if r.get("model") == spec.model]
        model = hbm_model_for(spec.model, rows or None)
        if model is None:
            verdict = HbmVerdict(True, None, "unknown")
        else:
            overrides = {"batch_size": spec.batch_size}
            if spec.accum > 1:
                overrides["gradient_accumulation_steps"] = spec.accum
            reason = model.check(Candidate.make(spec.model, overrides))
            verdict = HbmVerdict(reason is None, reason, model.source)
        self._hbm_cache[key] = verdict
        return verdict
