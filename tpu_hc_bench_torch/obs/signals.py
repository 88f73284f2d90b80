"""Typed health signals over the obs streams — the autoscaler's
sensing half (the port's copy of the JAX package's ``obs/signals.py``).

Pure record processing, no torch: the obs CLI reads this module on
machines with no GPU.

A *signal* is a named, hysteresis-gated judgment over a windowed
measure: it **fires** after ``fire_windows`` consecutive windows past
the fire threshold (a one-window spike is not overload) and **clears**
after ``clear_windows`` consecutive windows past the (stricter) clear
threshold (so a measure oscillating around the line does not flap).
A window with no evidence (measure ``None``) holds every streak —
silence is not health.

Events land append-only in ``signals.jsonl`` beside the metrics
stream, each with the measure, threshold, and a cause payload naming
the evidence.

Every signal name must be in ``KNOWN_SIGNALS``: a typo'd name fires
fine and then silently vanishes from every fold (``spec_of`` raises on
an unknown one).

The offline evaluator replays the serving measures, the heartbeat skew
(``STRAGGLER``) and the training lane's ``DATA_STARVED`` measure: the
share of the goodput ledger's wall (``obs.goodput``) spent in
``data_wait``.
"""

from __future__ import annotations

import dataclasses
import json
import os

SIGNAL_KIND = "signal"
SIGNALS_FILENAME = "signals.jsonl"

# the registry the signal-name-registry lint checks literals against
KNOWN_SIGNALS = (
    "SUSTAINED_OVERLOAD",   # SLO-violation share of completions, sustained
    "KV_PRESSURE",          # pool_starved share of admission-blocked time
    "STRAGGLER",            # fleet step skew (slowest vs median rank)
    "DATA_STARVED",         # data_wait share of goodput wall
    "GOODPUT_COLLAPSE",     # useful-compute share under a live backlog
)


@dataclasses.dataclass(frozen=True)
class SignalSpec:
    """One signal's thresholds: ``direction`` is the breach side
    ("above": measure >= fire_threshold breaches), and the clear
    threshold is strictly inside the fire threshold so the engine has
    a dead band to debounce across."""

    name: str
    doc: str
    direction: str = "above"
    fire_threshold: float = 0.5
    clear_threshold: float = 0.25
    fire_windows: int = 2
    clear_windows: int = 2


SPECS: dict[str, SignalSpec] = {s.name: s for s in (
    SignalSpec(
        "SUSTAINED_OVERLOAD",
        "share of window completions violating the e2e target",
        fire_threshold=0.5, clear_threshold=0.25,
        fire_windows=2, clear_windows=2),
    SignalSpec(
        "KV_PRESSURE",
        "pool_starved share of the window's admission-blocked time",
        fire_threshold=0.5, clear_threshold=0.25,
        fire_windows=2, clear_windows=2),
    SignalSpec(
        "STRAGGLER",
        "fleet step skew (slowest rank behind the median, steps)",
        fire_threshold=2.0, clear_threshold=1.0,
        fire_windows=2, clear_windows=2),
    SignalSpec(
        "DATA_STARVED",
        "data_wait share of the goodput ledger's wall",
        fire_threshold=0.3, clear_threshold=0.15,
        # the ledger is run-scoped (one observation), so the offline
        # evaluator fires on a single breach of a whole-run measure
        fire_windows=1, clear_windows=1),
    SignalSpec(
        "GOODPUT_COLLAPSE",
        "useful-compute share of window wall while a backlog exists",
        direction="below",
        fire_threshold=0.05, clear_threshold=0.15,
        fire_windows=3, clear_windows=2),
)}

# the log-only actuation hint journaled next to a fired signal: the
# policy stated as advice, so operators can audit it before anything
# holds a lever
_ADVICE = {
    "SUSTAINED_OVERLOAD": "scale out serve replicas",
    "KV_PRESSURE": "grow KV pool or enable --kv_preempt",
    "STRAGGLER": "replace or restart the lagging rank",
    "DATA_STARVED": "scale the input service / raise prefetch",
    "GOODPUT_COLLAPSE": "inspect padding/idle waste (bucket ladder)",
}


def spec_of(name: str) -> SignalSpec:
    """Registry lookup; unknown names raise — the runtime twin of the
    signal-name-registry lint."""
    try:
        return SPECS[name]
    except KeyError:
        raise ValueError(f"unknown signal {name!r}; known: "
                         f"{', '.join(KNOWN_SIGNALS)}") from None


def advice_for(name: str) -> str:
    spec_of(name)
    return _ADVICE[name]


class SignalEngine:
    """Streaming evaluator: feed one ``observe`` per window; fired and
    cleared transitions come back as event dicts (and accumulate on
    ``.events``).  State is per-signal consecutive-window streaks —
    O(signals), no sample retention."""

    def __init__(self, specs: dict[str, SignalSpec] | None = None):
        self.specs = dict(specs if specs is not None else SPECS)
        self.active: dict[str, float] = {}      # name -> fire t
        self._streak: dict[str, int] = {}
        self.events: list[dict] = []
        self.fired: dict[str, int] = {}

    def observe(self, t: float, measures: dict,
                causes: dict | None = None) -> list[dict]:
        """One window at time ``t``: ``measures[name]`` is the
        window's measure (None = no evidence this window; streaks and
        active state hold).  ``causes[name]`` rides the emitted event
        verbatim as its evidence payload."""
        out: list[dict] = []
        for name, spec in self.specs.items():
            m = measures.get(name)
            if m is None:
                continue
            m = float(m)
            above = spec.direction == "above"
            breach = m >= spec.fire_threshold if above \
                else m <= spec.fire_threshold
            recovered = m < spec.clear_threshold if above \
                else m > spec.clear_threshold
            if name not in self.active:
                self._streak[name] = self._streak.get(name, 0) + 1 \
                    if breach else 0
                if self._streak[name] >= spec.fire_windows:
                    self.active[name] = t
                    self.fired[name] = self.fired.get(name, 0) + 1
                    out.append(self._event(
                        t, name, "fire", m, spec.fire_threshold,
                        self._streak[name], causes))
                    self._streak[name] = 0
            else:
                self._streak[name] = self._streak.get(name, 0) + 1 \
                    if recovered else 0
                if self._streak[name] >= spec.clear_windows:
                    out.append(self._event(
                        t, name, "clear", m, spec.clear_threshold,
                        self._streak[name], causes,
                        since=self.active.pop(name)))
                    self._streak[name] = 0
        self.events.extend(out)
        return out

    def _event(self, t, name, state, measure, threshold, windows,
               causes, since=None) -> dict:
        ev = {"kind": SIGNAL_KIND, "t": round(float(t), 4),
              "signal": name, "state": state,
              "measure": round(float(measure), 4),
              "threshold": threshold, "windows": windows}
        if since is not None:
            ev["since"] = round(float(since), 4)
        cause = (causes or {}).get(name)
        if cause:
            ev["cause"] = cause
        return ev


def append_events(path: str, events: list[dict]) -> None:
    """Append-only jsonl — the same one-line-per-event contract as the
    metrics stream, so a crashed run keeps every fired signal."""
    if not events:
        return
    with open(path, "a") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")


def signals_path(run_dir: str) -> str:
    return os.path.join(run_dir, SIGNALS_FILENAME)


def read_signals(run_dir: str) -> list[dict]:
    """The run's signal events (empty when none fired — absence of the
    file is a clean run, not an error)."""
    from tpu_hc_bench_torch.obs import metrics as metrics_mod

    path = run_dir
    if os.path.isdir(run_dir):
        path = signals_path(run_dir)
    if not os.path.exists(path):
        return []
    return metrics_mod.read_jsonl(path)


def active_of(events: list[dict]) -> dict[str, float]:
    """Replay fire/clear transitions -> {name: fire t} still active."""
    active: dict[str, float] = {}
    for ev in events:
        name = ev.get("signal")
        if name not in SPECS:
            continue
        if ev.get("state") == "fire":
            active[name] = float(ev.get("t") or 0.0)
        elif ev.get("state") == "clear":
            active.pop(name, None)
    return active


def fired_count(events: list[dict], name: str) -> int:
    """How many times one signal fired in an event list; the name must
    be registered."""
    spec_of(name)
    return sum(1 for ev in events
               if ev.get("signal") == name and ev.get("state") == "fire")


def fired_counts(events: list[dict]) -> dict[str, int]:
    out: dict[str, int] = {}
    for ev in events:
        if ev.get("state") == "fire" and ev.get("signal") in SPECS:
            out[ev["signal"]] = out.get(ev["signal"], 0) + 1
    return dict(sorted(out.items()))


def signal_lines(events: list[dict]) -> list[str]:
    """The ``obs signals`` report body (two-space indent matches the
    other summarize sections)."""
    if not events:
        return ["  signals: none fired"]
    lines = [f"  signals: {len(events)} transition(s), "
             f"{sum(fired_counts(events).values())} fire(s)"]
    for ev in events:
        cmp_ = (">=" if spec_of(ev["signal"]).direction == "above"
                else "<=") if ev.get("state") == "fire" else "->"
        lines.append(
            f"  {ev.get('state', '?'):>5s} {ev.get('signal', '?')} "
            f"@ t={ev.get('t', 0.0):.2f}s  measure "
            f"{ev.get('measure', 0.0):.3f} {cmp_} "
            f"{ev.get('threshold', 0.0):g} "
            f"({ev.get('windows', '?')} window(s))")
        if ev.get("cause"):
            detail = " ".join(f"{k}={v}" for k, v in ev["cause"].items())
            lines.append(f"        cause: {detail}")
    act = active_of(events)
    if act:
        lines.append("  still active: " + "  ".join(
            f"{n} (since t={t:.2f}s)" for n, t in sorted(act.items())))
    return lines


def watch_lines(run_dir: str) -> list[str]:
    """The live ``obs watch`` signals column: currently-active signals
    off the append-only file; silent when the run never signalled."""
    events = read_signals(run_dir)
    if not events:
        return []
    act = active_of(events)
    if not act:
        return [f"  signals: clear ({len(events)} past transition(s))"]
    return ["  signals: " + "  ".join(
        f"{n}@t={t:.1f}s" for n, t in sorted(act.items()))]


def evaluate_records(records: list[dict],
                     run_dir: str | None = None,
                     window_s: float | None = None) -> list[dict]:
    """Offline signal evaluation over one metrics stream — the same
    hysteresis engine the serve lane runs live, replayed over the
    stream's request/serve records, plus the training-lane measures
    (heartbeat skew, goodput-ledger data_wait) the engine cannot see.

    Windows follow the burn-rate fold's convention: completion-time
    span / ``DEFAULT_BURN_WINDOWS`` unless ``window_s`` is given.
    """
    from tpu_hc_bench_torch.obs import fleet as fleet_mod
    from tpu_hc_bench_torch.obs import goodput as goodput_mod
    from tpu_hc_bench_torch.obs import kv as kv_mod
    from tpu_hc_bench_torch.serve import slo as slo_mod

    engine = SignalEngine()
    reqs = [r for r in records if r.get("kind") == "request"]
    summary = next((r for r in reversed(records)
                    if r.get("kind") == slo_mod.SERVE_SUMMARY_KIND), None)
    target_ms = None
    if summary:
        slo = summary.get("slo")
        if isinstance(slo, dict):
            target_ms = slo.get("slo_e2e_ms")
        target_ms = target_ms or summary.get("deadline_ms")
    done = []
    for r in reqs:
        e2e, arr = r.get("e2e_ms"), r.get("arrival_s")
        if isinstance(e2e, (int, float)) and isinstance(arr, (int, float)):
            done.append((float(arr) + float(e2e) / 1e3, r))
    if done:
        done.sort(key=lambda x: x[0])
        t_lo, t_hi = done[0][0], done[-1][0]
        span = max(t_hi - t_lo, 1e-9)
        w = window_s if window_s and window_s > 0 \
            else span / slo_mod.DEFAULT_BURN_WINDOWS
        n_win = max(1, int(-(-span // w)))
        wins: list[list[dict]] = [[] for _ in range(n_win)]
        for t, r in done:
            wins[min(int((t - t_lo) / w), n_win - 1)].append(r)
        for i, rows in enumerate(wins):
            measures: dict = {}
            causes: dict = {}
            if rows and target_ms:
                viol = sum(1 for r in rows
                           if float(r.get("e2e_ms") or 0.0) > target_ms)
                measures["SUSTAINED_OVERLOAD"] = viol / len(rows)
                causes["SUSTAINED_OVERLOAD"] = {
                    "violations": viol, "completed": len(rows),
                    "target_ms": target_ms}
            blocked = [0.0, 0.0]
            for r in rows:
                c = kv_mod.wait_cause_of(r)
                blocked[0] += c.get("pool_starved", 0.0)
                blocked[1] += c.get("batch_full", 0.0)
            tot = blocked[0] + blocked[1]
            if tot > 1e-9:
                measures["KV_PRESSURE"] = blocked[0] / tot
                causes["KV_PRESSURE"] = {
                    "pool_starved_ms": round(blocked[0], 3),
                    "batch_full_ms": round(blocked[1], 3)}
            engine.observe(t_lo + (i + 1) * w, measures, causes)
    # training lane: per-beat fleet skew windows (the STRAGGLER
    # measure) off the heartbeat files beside the stream
    if run_dir:
        beats = fleet_mod.read_heartbeats(run_dir)
        if len(beats) > 1:
            depth = min(len(v) for v in beats.values() if v)
            for k in range(depth):
                host_steps = [recs[k].get("step", 0)
                              for _, recs in sorted(beats.items())
                              if recs]
                ewmas = [recs[k].get("step_ewma_ms", 0.0)
                         for _, recs in sorted(beats.items()) if recs]
                skew = fleet_mod.compute_skew(host_steps, ewmas)
                t = max((recs[k].get("t_mono") or 0.0)
                        for recs in beats.values() if recs)
                engine.observe(t, {"STRAGGLER": skew["skew_steps"]},
                               {"STRAGGLER": {
                                   "skew_steps": skew["skew_steps"],
                                   "skew_ms": skew["skew_ms"]}})
    # run-scoped data starvation off the goodput ledger (one
    # observation; the spec's fire_windows is 1 for exactly this)
    ledger = goodput_mod.build_ledger(records)
    if ledger is not None and ledger.wall_s:
        frac = ledger.seconds.get("data_wait", 0.0) / ledger.wall_s
        engine.observe(ledger.wall_s, {"DATA_STARVED": frac},
                       {"DATA_STARVED": {
                           "data_wait_s": round(
                               ledger.seconds.get("data_wait", 0.0), 3),
                           "wall_s": round(ledger.wall_s, 3)}})
    return engine.events


def evaluate_run(path: str, window_s: float | None = None) -> dict:
    """``obs signals`` body: the run's recorded (live) events plus an
    offline re-evaluation of the stream.  Returns a report dict; the
    CLI renders ``lines`` and exits 1 when anything fired."""
    from tpu_hc_bench_torch.obs import metrics as metrics_mod

    problems: list[str] = []
    manifest, records = metrics_mod.read_run(path, problems=problems)
    run_dir = os.path.dirname(metrics_mod.resolve_run(path)[1])
    recorded = read_signals(run_dir)
    evaluated = evaluate_records(records, run_dir=run_dir,
                                 window_s=window_s)
    lines = [f"signals {path} — model={manifest.get('model', '?')}"]
    if recorded:
        lines.append(f"  recorded (live, {SIGNALS_FILENAME}):")
        lines.extend(signal_lines(recorded))
    lines.append("  offline re-evaluation:")
    lines.extend(signal_lines(evaluated))
    for p in problems:
        lines.append(f"  WARNING: {p}")
    fired = fired_counts(recorded) or fired_counts(evaluated)
    return {"recorded": recorded, "evaluated": evaluated,
            "fired": fired, "lines": lines, "problems": problems}
