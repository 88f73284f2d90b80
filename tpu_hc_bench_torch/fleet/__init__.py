"""The fleet orchestrator, the port's copy of the JAX package's
``fleet``: many training jobs on one pool of cards, kept at high
fleet-wide goodput while jobs are killed and resized by spot churn and
priority arrivals.  It composes contracts the single-job layers already
keep:

- the launcher's exit codes (0/1/70/75, ``resilience.EXIT_CLASSES``)
  classify every death;
- graceful preemption (``resilience.preempt``): the supervisor's SIGTERM
  takes the emergency-checkpoint path of a spot notice;
- elastic resume (``--resume=elastic``): a preempted job relaunches at
  whatever world the scheduler can grant;
- the memory model (``tune.prune.hbm_model_for``) refuses admissions
  that would run out of memory, measured anchors first;
- heartbeats and incarnation counters (``obs.fleet``) give liveness,
  the flight recorder (``obs.timeline``) per-job span timelines.

Modules: ``pool`` (cards and memory admission, the ``JobSpec``
contract; each job's gang is a set of card indices), ``scheduler``
(the pure priority, gang and grow policy), ``supervisor`` (process
lifecycle and the control loop), ``churn`` (seeded kill, shrink and
arrival schedules), ``report`` (the fleet goodput ledger and the soak
verdict record).  CLI::

    python -m tpu_hc_bench_torch.fleet run --spec jobs.json --out /tmp/fleet
    python -m tpu_hc_bench_torch.fleet run --demo --device=cpu --out /tmp/f
    python -m tpu_hc_bench_torch.fleet status /tmp/fleet
    python -m tpu_hc_bench_torch.fleet report /tmp/fleet --control /tmp/ctl
"""

from tpu_hc_bench_torch.fleet.churn import (
    ChurnEvent, parse_churn, seeded_churn)
from tpu_hc_bench_torch.fleet.pool import DevicePool, HbmVerdict, JobSpec
from tpu_hc_bench_torch.fleet.report import fleet_ledger, write_verdict
from tpu_hc_bench_torch.fleet.scheduler import Decision, plan
from tpu_hc_bench_torch.fleet.supervisor import (
    FleetController,
    LocalBackend,
    Supervisor,
)

__all__ = [
    "ChurnEvent", "parse_churn", "seeded_churn",
    "DevicePool", "HbmVerdict", "JobSpec",
    "fleet_ledger", "write_verdict",
    "Decision", "plan",
    "FleetController", "LocalBackend", "Supervisor",
]
