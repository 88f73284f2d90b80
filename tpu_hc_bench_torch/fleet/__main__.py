"""``python -m tpu_hc_bench_torch.fleet run|status|report``: the fleet CLI
(the port's copy of the JAX package's ``fleet/__main__.py``; also
``python -m tpu_hc_bench_torch fleet ...``).

``run`` drives a real fleet on this host: its jobs are launcher
subprocesses, each on the cards the pool granted it (``--device=cuda``,
the default: ``--chips`` defaults to the visible cards, and a larger
pool is refused before any spawn, exit 2), or on gloo workers of the CPU
by request (``--device=cpu``: ``--chips`` defaults to JAX's 8 virtual
devices).  ``status`` renders a snapshot of a live or finished fleet
directory, ``report`` folds its journal into the fleet goodput ledger;
with ``--control`` and ``--artifact`` it writes the soak verdict record
``obs regress`` reads.  Exit codes: 0 ok, 1 a job failed or orphans
were left (``run``) or the churned fleet fell below the bound
(``report``), 2 an unusable input.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from tpu_hc_bench_torch.fleet import churn as churn_mod
from tpu_hc_bench_torch.fleet import report as report_mod
from tpu_hc_bench_torch.fleet.pool import DevicePool, JobSpec
from tpu_hc_bench_torch.fleet.supervisor import FleetController, LocalBackend

# the built-in --demo fleet (JAX's): three zoo members sized for a CPU
# pool, one a delayed higher-priority arrival, the smallest spec that
# exercises admit, priority, shrink and regrow
DEMO_JOBS = [
    {"name": "trivial-a", "model": "trivial", "batch_size": 2,
     "world_pref": 4, "world_min": 2, "priority": 0, "batches": 60,
     "flags": ["--num_classes=10", "--init_learning_rate=0.05"]},
    {"name": "lenet-b", "model": "lenet", "batch_size": 2,
     "world_pref": 4, "world_min": 2, "priority": 0, "batches": 60,
     "flags": ["--num_classes=10", "--init_learning_rate=0.05"]},
    {"name": "trivial-hi", "model": "trivial", "batch_size": 2,
     "world_pref": 4, "world_min": 2, "priority": 1, "arrival_s": 12.0,
     "batches": 40,
     "flags": ["--num_classes=10", "--init_learning_rate=0.05"]},
]


def load_specs(path: str | None, demo: bool) -> list[JobSpec]:
    if demo or not path:
        rows = DEMO_JOBS
    else:
        with open(path) as f:
            data = json.load(f)
        rows = data["jobs"] if isinstance(data, dict) else data
    return [JobSpec.from_dict(r) for r in rows]


def pool_chips(device: str, chips: int | None) -> int:
    """The pool's size: ``--chips``, or every visible card (``cuda``)
    or JAX's 8 virtual devices (``cpu``).  A card pool larger than the
    visible cards is refused: two jobs would share a card."""
    if device == "cpu":
        return 8 if chips is None else chips
    import torch

    from tpu_hc_bench_torch import resolve_device

    resolve_device("cuda")
    visible = torch.cuda.device_count()
    if chips is not None and chips > visible:
        raise ValueError(f"--chips={chips} but {visible} card(s) are "
                         f"visible: a pool holds real cards")
    return visible if chips is None else chips


def _cmd_run(args, out) -> int:
    specs = load_specs(args.spec, args.demo)
    chips = pool_chips(args.device, args.chips)
    events = []
    if args.churn:
        events = churn_mod.parse_churn(args.churn)
    elif args.churn_seed is not None:
        events = churn_mod.seeded_churn(
            args.churn_seed, [s.name for s in specs],
            horizon_s=args.churn_horizon, kills=args.churn_kills,
            shrinks=args.churn_shrinks)
        print(f"seeded churn ({args.churn_seed}): "
              f"{churn_mod.format_churn(events)}", file=out)
    pool = DevicePool(chips)
    ctl = FleetController(
        pool, specs, args.out,
        backend=LocalBackend(device=args.device),
        churn=events,
        tick_s=args.tick_s, settle_s=args.settle_s,
        kill_grace_s=args.kill_grace_s,
        dead_after_s=args.dead_after_s,
        startup_grace_s=args.startup_grace_s,
        deadline_s=args.deadline_s,
        print_fn=lambda s: print(s, file=out),
    )
    result = ctl.run()
    for ln in report_mod.report_lines(args.out, timelines=False):
        print(ln, file=out)
    print(f"fleet: {result['status']}  jobs {result['jobs']}", file=out)
    if result["orphans"]:
        print(f"ERROR: orphaned pids after the run: "
              f"{result['orphans']}", file=out)
        return 1
    ok = (result["status"] == "done"
          and all(s in ("done", "refused")
                  for s in result["jobs"].values()))
    return 0 if ok else 1


def _cmd_status(args, out) -> int:
    from tpu_hc_bench_torch.obs import fleet as obs_fleet

    path = os.path.join(args.dir, "fleet_state.json")
    try:
        with open(path) as f:
            state = json.load(f)
    except (OSError, ValueError) as e:
        print(f"error: no fleet state at {path}: {e}", file=out)
        return 2
    print(f"fleet {args.dir}: {state.get('chips')} chip(s), "
          f"{state.get('free')} free, t={state.get('t_s', 0):.1f}s, "
          f"{state.get('status')}", file=out)
    for name, j in sorted((state.get("jobs") or {}).items()):
        line = (f"  {name:<12} {j.get('status', '?'):<8} "
                f"world {j.get('world', 0)}  "
                f"inc {j.get('incarnations', 0)}  "
                f"prio {j.get('priority', 0)}")
        if j.get("status") in ("running", "stopping"):
            beats = obs_fleet.read_heartbeats(
                os.path.join(j.get("run_dir", ""), "m"))
            recs = [r for rs in beats.values() for r in rs]
            live = obs_fleet.classify_liveness(
                recs, expect_incarnation=j.get("expect_incarnation"))
            age = live["age_s"]
            line += (f"  {live['status']}"
                     + (f" (step {live['step']}, beat {age:.0f}s ago)"
                        if age is not None else " (no heartbeat yet)"))
        elif j.get("exit_class"):
            line += f"  [{j['exit_class']}]"
        print(line, file=out)
    return 0


def _cmd_report(args, out) -> int:
    ledger = report_mod.fleet_ledger(args.dir)
    if ledger is None:
        print(f"error: no fleet journal under {args.dir}", file=out)
        return 2
    for ln in report_mod.report_lines(args.dir, ledger,
                                      timelines=not args.no_timelines):
        print(ln, file=out)
    rc = 0
    if args.control:
        control = report_mod.fleet_ledger(args.control)
        if control is None:
            print(f"error: no fleet journal under {args.control}",
                  file=out)
            return 2
        frac = (ledger["fleet_goodput"] / control["fleet_goodput"]
                if control["fleet_goodput"] > 0 else 0.0)
        ok = ledger["fleet_goodput"] >= args.bound * \
            control["fleet_goodput"]
        print(f"churn vs control: {ledger['fleet_goodput']:.1%} vs "
              f"{control['fleet_goodput']:.1%} ({frac:.0%} of control; "
              f"bound {args.bound:.0%}) -> "
              f"{'ok' if ok else 'REGRESSION'}", file=out)
        rc = 0 if ok else 1
    if args.artifact:
        rec = report_mod.write_verdict(
            args.dir, args.artifact, control_dir=args.control,
            bound_frac=args.bound)
        print(f"verdict: {args.artifact} "
              f"(fleet_goodput {rec['value']:.4f})", file=out)
    return rc


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_hc_bench_torch.fleet",
        description="multi-job fleet orchestrator over one device pool")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run a fleet of jobs on this host")
    r.add_argument("--spec", help="job-spec JSON (list of job dicts, "
                   "or {'jobs': [...]}; see README)")
    r.add_argument("--demo", action="store_true",
                   help="use the built-in 3-member demo fleet")
    r.add_argument("--out", required=True, help="fleet output dir")
    r.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: one job a gang of cards; cpu: gloo "
                   "workers (--virtual_devices), by request")
    r.add_argument("--chips", type=int, default=None,
                   help="the pool (default: the visible cards; 8 on "
                   "the CPU)")
    r.add_argument("--churn", help="explicit schedule: "
                   "'kill@8:jobA,shrink@14:jobB,arrive@6:jobC'")
    r.add_argument("--churn-seed", type=int, default=None,
                   help="seeded deterministic churn (replayable)")
    r.add_argument("--churn-kills", type=int, default=1)
    r.add_argument("--churn-shrinks", type=int, default=1)
    r.add_argument("--churn-horizon", type=float, default=60.0)
    r.add_argument("--tick_s", type=float, default=0.5)
    r.add_argument("--settle_s", type=float, default=5.0)
    r.add_argument("--kill_grace_s", type=float, default=30.0)
    r.add_argument("--dead_after_s", type=float, default=60.0)
    r.add_argument("--startup_grace_s", type=float, default=45.0,
                   help="liveness holds off this long after a launch "
                   "(plus dead_after_s before the first beat: a model's "
                   "build and first step are not a hang)")
    r.add_argument("--deadline_s", type=float, default=1800.0)

    s = sub.add_parser("status", help="snapshot of a fleet dir "
                       "(liveness from heartbeats)")
    s.add_argument("dir")

    p = sub.add_parser("report", help="fleet goodput ledger "
                       "(+ verdict artifact with --control/--artifact)")
    p.add_argument("dir")
    p.add_argument("--control", help="no-churn control fleet dir")
    p.add_argument("--bound", type=float, default=0.5,
                   help="churn goodput must be >= bound x control")
    p.add_argument("--artifact", help="write the BENCH-shaped verdict "
                   "JSON here")
    p.add_argument("--no-timelines", action="store_true")
    return ap


def main(argv: list[str] | None = None, out=None) -> int:
    out = out or sys.stdout
    args = build_parser().parse_args(argv)
    t0 = time.time()
    try:
        if args.cmd == "run":
            rc = _cmd_run(args, out)
        elif args.cmd == "status":
            rc = _cmd_status(args, out)
        else:
            rc = _cmd_report(args, out)
    except (ValueError, OSError) as e:
        print(f"error: {e}", file=out)
        return 2
    if args.cmd == "run":
        print(f"({time.time() - t0:.1f}s)", file=out)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
