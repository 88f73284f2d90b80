"""The fleet's goodput ledger and the soak verdict record (the port's
copy of the JAX package's ``fleet/report.py``).

Of all the card-seconds the pool owned, how many went to productive
training steps of admitted jobs?  The journal (``fleet_events.jsonl``)
carries what the answer needs: each incarnation's ``exit`` event holds
its wall seconds, its world and its goodput (from the job's own metrics
stream: the summary of a completed run, the partial ledger fold of a
preempted one).  So

    fleet_goodput = sum over incarnations of goodput x world x wall_s
                    -------------------------------------------------
                    pool_cards x fleet_wall_s

The denominator charges the fleet for idle cards, scheduling gaps,
startup (imports, the kernel library's load, cuDNN's first-step
search) and every relaunch's restart tax: what a churned-against-control
comparison must not hide.

``report_lines`` also folds each job's flight-recorder spans
(``spans.<k>.jsonl`` through ``obs.timeline``) into one line a rank.
``write_verdict`` writes the BENCH-shaped record ``obs regress`` reads
(``fleet_goodput`` regresses DOWN), the churned fleet's goodput the
headline and the control's in ``extra``, with the device kind of a
job's manifest, so a card's record is keyed apart from
``artifacts/bench_fleet_soak_r19.json``'s CPU one.
"""

from __future__ import annotations

import json
import os

__all__ = ["read_events", "fleet_ledger", "report_lines",
           "write_verdict"]


def read_events(out_dir: str) -> list[dict]:
    """The fleet journal, corrupt lines skipped (a journal interrupted
    by the very death it records must still render)."""
    from tpu_hc_bench_torch.obs.metrics import read_jsonl

    return read_jsonl(os.path.join(out_dir, "fleet_events.jsonl"))


def fleet_ledger(out_dir: str) -> dict | None:
    """Fold the journal into the fleet account.  None without a
    ``fleet_start`` (not a fleet dir)."""
    events = read_events(out_dir)
    start = next((e for e in events if e["kind"] == "fleet_start"), None)
    if start is None:
        return None
    end = next((e for e in reversed(events)
                if e["kind"] == "fleet_end"), None)
    chips = int(start.get("chips", 0) or 0)
    wall_s = (float(end["wall_s"]) if end
              else max((e.get("t", 0.0) for e in events), default=0.0))
    jobs: dict[str, dict] = {}
    counts = {"kills": 0, "shrinks": 0, "grows": 0,
              "preempts": 0, "elastic_resumes": 0, "deaths": 0}
    for e in events:
        kind = e["kind"]
        name = e.get("job")
        if name is not None:
            j = jobs.setdefault(name, {
                "chip_s": 0.0, "productive_chip_s": 0.0,
                "incarnations": 0, "status": None, "worlds": [],
                "exit_classes": []})
        if kind == "launch":
            j["incarnations"] += 1
            j["worlds"].append(e.get("world"))
            if e.get("resume") == "elastic":
                counts["elastic_resumes"] += 1
        elif kind == "exit":
            w = float(e.get("world", 0) or 0)
            dur = float(e.get("wall_s", 0.0) or 0.0)
            gp = e.get("goodput")
            j["chip_s"] += w * dur
            if isinstance(gp, (int, float)):
                j["productive_chip_s"] += float(gp) * w * dur
            j["exit_classes"].append(e.get("exit_class"))
        elif kind in ("done", "failed", "refuse"):
            j["status"] = kind if kind != "refuse" else "refused"
        elif kind == "preempt_sent":
            counts["preempts"] += 1
            reason = e.get("reason", "")
            if reason == "churn-kill":
                counts["kills"] += 1
            elif reason in ("churn-shrink", "shrink"):
                counts["shrinks"] += 1
            elif reason == "grow":
                counts["grows"] += 1
        elif kind == "dead":
            counts["deaths"] += 1
    pool_chip_s = chips * wall_s
    productive = sum(j["productive_chip_s"] for j in jobs.values())
    used = sum(j["chip_s"] for j in jobs.values())
    return {
        "chips": chips,
        "wall_s": round(wall_s, 3),
        "pool_chip_s": round(pool_chip_s, 3),
        "used_chip_s": round(used, 3),
        "productive_chip_s": round(productive, 3),
        "fleet_goodput": (round(productive / pool_chip_s, 4)
                          if pool_chip_s > 0 else 0.0),
        "utilization": (round(used / pool_chip_s, 4)
                        if pool_chip_s > 0 else 0.0),
        "jobs": jobs,
        "counts": counts,
        "status": (end or {}).get("status"),
    }


def report_lines(out_dir: str, ledger: dict | None = None,
                 timelines: bool = True) -> list[str]:
    """The ``fleet report`` text: the fleet account, one line per job,
    and each job's span-timeline fold (``obs.timeline``)."""
    ledger = ledger if ledger is not None else fleet_ledger(out_dir)
    if ledger is None:
        return [f"error: no fleet journal at {out_dir}/fleet_events.jsonl"]
    c = ledger["counts"]
    lines = [
        f"fleet: {ledger['chips']} chip(s) x {ledger['wall_s']:.1f}s = "
        f"{ledger['pool_chip_s']:.0f} chip-s",
        f"  goodput {ledger['fleet_goodput']:.1%}  (utilization "
        f"{ledger['utilization']:.1%}; productive "
        f"{ledger['productive_chip_s']:.0f} chip-s)",
        f"  churn: {c['kills']} kill(s), {c['shrinks']} shrink(s), "
        f"{c['grows']} grow(s), {c['preempts']} preempt signal(s), "
        f"{c['elastic_resumes']} elastic resume(s), "
        f"{c['deaths']} liveness death(s)",
    ]
    for name, j in sorted(ledger["jobs"].items()):
        worlds = "->".join(str(w) for w in j["worlds"]) or "-"
        gp = (j["productive_chip_s"] / j["chip_s"]
              if j["chip_s"] > 0 else 0.0)
        lines.append(
            f"  {name}: {j['status'] or '?'}  worlds {worlds}  "
            f"{j['incarnations']} incarnation(s)  "
            f"{j['chip_s']:.0f} chip-s  goodput {gp:.1%}")
    if timelines:
        from tpu_hc_bench_torch.obs import timeline as timeline_mod

        for name in sorted(ledger["jobs"]):
            mdir = os.path.join(out_dir, "jobs", name, "m")
            for ln in timeline_mod.timeline_lines(mdir):
                lines.append(f"  {name} {ln.strip()}")
    return lines


def write_verdict(out_dir: str, path: str,
                  control_dir: str | None = None,
                  bound_frac: float = 0.5,
                  device_kind: str | None = None,
                  extra: dict | None = None) -> dict:
    """The soak verdict as one BENCH-shaped record: headline value =
    fleet goodput under churn, ``extra.fleet_goodput_nochurn`` = the
    control, ``within_bound`` = churn >= bound_frac x control.  Shaped
    for ``obs regress`` (metric/unit/extra/manifest — fleet_goodput is
    a direction-aware DOWN metric there)."""
    ledger = fleet_ledger(out_dir)
    if ledger is None:
        raise ValueError(f"no fleet journal under {out_dir}")
    control = fleet_ledger(control_dir) if control_dir else None
    if device_kind is None:
        device_kind = _device_kind(out_dir) or "unknown"
    c = ledger["counts"]
    rec = {
        "metric": "fleet_goodput",
        "value": ledger["fleet_goodput"],
        "unit": "fraction",
        "extra": {
            "fleet_goodput": ledger["fleet_goodput"],
            "fleet_goodput_nochurn": (control or {}).get("fleet_goodput"),
            "bound_frac": bound_frac,
            "within_bound": (
                None if control is None else
                ledger["fleet_goodput"]
                >= bound_frac * control["fleet_goodput"]),
            "chips": ledger["chips"],
            "wall_s": ledger["wall_s"],
            "wall_s_nochurn": (control or {}).get("wall_s"),
            "jobs": sorted(ledger["jobs"]),
            "kills": c["kills"], "shrinks": c["shrinks"],
            "grows": c["grows"],
            "elastic_resumes": c["elastic_resumes"],
            **(extra or {}),
        },
        "manifest": {"device_kind": device_kind, "process_count": 1},
    }
    from tpu_hc_bench_torch.tune.search import commit_json

    commit_json(path, rec)
    return rec


def _device_kind(out_dir: str) -> str | None:
    """The device kind from any job's metrics manifest (they all ran
    on the one pool)."""
    jobs_dir = os.path.join(out_dir, "jobs")
    try:
        names = sorted(os.listdir(jobs_dir))
    except OSError:
        return None
    for name in names:
        path = os.path.join(jobs_dir, name, "m", "manifest.json")
        try:
            with open(path) as f:
                kind = json.load(f).get("device_kind")
            if kind:
                return str(kind)
        except (OSError, ValueError):
            continue
    return None
