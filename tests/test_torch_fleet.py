"""The port's fleet orchestrator (``tpu_hc_bench_torch/fleet``) against
the JAX package's, on the CPU.

The default lane spawns no fleet job: the same inputs through both
packages, pure host work.

- ``JobSpec``: round trips and the validation errors;
- the pool: gang reserve/release, the card indices each job holds
  (disjoint, the lowest free, reused after release), and
  ``hbm_admission`` (seeded and measured-first) giving JAX's verdicts on
  the same rows;
- ``plan``: JAX's ``Decision`` list on each scenario of
  ``tests/test_fleet.py`` (shrink before preempt, the requeue cap, no
  double eviction, grow after settle);
- ``parse_churn``/``format_churn``/``seeded_churn`` equal to JAX's;
- a stub-backend soak in virtual time through both controllers: equal
  journals (event kinds, order and fields; the port's ``launch`` adds
  the granted ``cards``), equal ``fleet_ledger`` arithmetic, equal
  ``status``/``report`` lines and verdict records;
- liveness (a dead job requeued, then failed at the relaunch budget), a
  crash that kills every live job, refusals before any spawn;
- ``LocalBackend``'s command lines on the CPU and the card (the runner's
  ``launch_one`` replaced: no process), the CLI's pool on the card;
- JAX's own ``fleet-blocking-wait`` rule over the port's fleet sources;
- ``spawn_local``: a worker that exits 75 no longer stops its peers
  (they may still be saving; the fleet's fingerprint proof needs rank
  0's line).

One real launcher run at ``--virtual_devices=2`` on ``trivial`` (a few
steps) is in the default lane; the real soak (``fleet run
--device=cpu``: resnet20_cifar, lenet and trivial on 8 virtual devices,
JAX's ``tests/test_fleet.py`` soak against the port) is slow-marked.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tpu_hc_bench.fleet import __main__ as jax_cli
from tpu_hc_bench.fleet import churn as jax_churn
from tpu_hc_bench.fleet import pool as jax_pool
from tpu_hc_bench.fleet import report as jax_report
from tpu_hc_bench.fleet import scheduler as jax_sched
from tpu_hc_bench.fleet import supervisor as jax_sup
from tpu_hc_bench_torch.fleet import __main__ as cli
from tpu_hc_bench_torch.fleet import churn, pool, report, scheduler, supervisor
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PKGS = {"jax": (jax_pool, jax_sched, jax_churn, jax_report, jax_sup,
                jax_cli),
        "port": (pool, scheduler, churn, report, supervisor, cli)}


def spec(pkg, name="a", model="trivial", batch=2, pref=4, wmin=2, prio=0,
         arrival=0.0, **kw):
    return pkg.JobSpec(name=name, model=model, batch_size=batch,
                       world_pref=pref, world_min=wmin, priority=prio,
                       arrival_s=arrival, **kw)


# ---------------------------------------------------------------------
# job spec and pool


def test_jobspec_roundtrip_and_validation():
    s = spec(pool, flags=("--num_classes=10",))
    assert pool.JobSpec.from_dict(s.to_dict()) == s
    assert s.to_dict() == spec(jax_pool, flags=("--num_classes=10",)
                               ).to_dict()
    for bad in (lambda p: p.JobSpec.from_dict({**s.to_dict(), "chips": 4}),
                lambda p: spec(p, pref=2, wmin=4),
                lambda p: spec(p, name="a/b"),
                lambda p: spec(p, batch=0)):
        with pytest.raises(ValueError) as mine:
            bad(pool)
        with pytest.raises(ValueError) as ref:
            bad(jax_pool)
        assert str(mine.value) == str(ref.value)
    assert spec(pool, batch=64, accum=8).microbatch == 8


def test_pool_gang_reserve_release_and_cards():
    p = pool.DevicePool(8)
    assert p.reserve("a", 4) == (0, 1, 2, 3)
    assert p.reserve("b", 2) == (4, 5)
    assert p.free == 2 and not p.can_reserve(3)
    with pytest.raises(ValueError, match="cannot reserve"):
        p.reserve("c", 3)
    with pytest.raises(ValueError, match="already holds"):
        p.reserve("a", 2)
    assert p.release("a") == 4
    assert p.release("a") == 0          # idempotent
    assert p.free == 6
    # the lowest free indices, the released ones reused, never shared
    assert p.reserve("c", 3) == (0, 1, 2)
    assert p.reserve("d", 3) == (3, 6, 7)
    held = [c for cs in p.cards.values() for c in cs]
    assert len(held) == len(set(held)) == 8 and p.free == 0
    # the counts are JAX's bookkeeping, step for step
    j = jax_pool.DevicePool(8)
    for op, name, w in (("r", "a", 4), ("r", "b", 2), ("x", "a", 0),
                        ("r", "c", 3), ("r", "d", 3)):
        if op == "r":
            j.reserve(name, w)
        else:
            j.release(name)
    assert j.held == p.held and j.free == p.free
    with pytest.raises(ValueError, match=">= 1 chip"):
        pool.DevicePool(0)


ADMISSION_ROWS = (
    None,
    [{"model": "trivial", "overrides": {"batch_size": 64},
      "error": "hbm-oom"},
     {"model": "trivial", "overrides": {"batch_size": 16},
      "peak_hbm_bytes": 1 << 28, "hbm_bytes_limit": 1 << 30}],
    [{"overrides": {"batch_size": 2}, "error": "hbm-oom"}],
)
ADMISSION_SPECS = ({"batch": 2}, {"batch": 4096}, {"batch": 4096, "accum": 8},
                   {"model": "moe_tiny", "batch": 4}, {"batch": 512},
                   {"batch": 32}, {"model": "lenet", "batch": 512},
                   {"model": "gpt2", "batch": 16},
                   {"model": "resnet50", "batch": 128})


@pytest.mark.parametrize("rows", range(len(ADMISSION_ROWS)))
def test_hbm_admission_matches_jax(rows):
    mine = pool.DevicePool(8, measured_rows=ADMISSION_ROWS[rows])
    ref = jax_pool.DevicePool(8, measured_rows=ADMISSION_ROWS[rows])
    for i, kw in enumerate(ADMISSION_SPECS):
        a = mine.hbm_admission(spec(pool, name=f"j{i}", **kw))
        b = ref.hbm_admission(spec(jax_pool, name=f"j{i}", **kw))
        assert dataclasses.astuple(a) == dataclasses.astuple(b), kw
    # cached per (model, batch, accum)
    s = spec(pool, batch=512)
    assert mine.hbm_admission(s) is mine.hbm_admission(s)
    if rows == 1:
        v = mine.hbm_admission(spec(pool, batch=512))
        assert not v.fits and v.source == "measured"


# ---------------------------------------------------------------------
# scheduler: JAX's decisions on JAX's scenarios


def _scenarios(pkg):
    """``(now, free, running, pending, settle_s)`` of each case of
    ``tests/test_fleet.py``'s scheduler tests, in ``pkg``'s classes."""
    S = pkg[1]

    def sp(**kw):
        return spec(pkg[0], **kw)

    def run(s, world, since=0.0, stopping=False):
        return S.RunView(spec=s, world=world, since_s=since,
                         stopping=stopping)

    def pend(s, target=None):
        return S.PendView(spec=s, target_world=target)

    lo1, lo2, hi = sp(name="lo1"), sp(name="lo2"), sp(name="hi", prio=1)
    lo_min = sp(name="lomin", pref=2, wmin=2)
    v, p = sp(name="v"), sp(name="p", prio=1)
    a, b = sp(name="a"), sp(name="b")
    grow = [run(a, 2), run(b, 2)]
    return [
        (0.0, 8, [], [pend(sp())], 5.0),                 # ladder top
        (0.0, 3, [], [pend(sp())], 5.0),                 # gang shrinks
        (0.0, 1, [], [pend(sp())], 5.0),                 # below min
        (0.0, 8, [], [pend(sp(), 2)], 5.0),              # requeue cap
        (0.0, 0, [run(lo1, 4), run(lo2, 4)], [pend(hi)], 5.0),  # shrink
        (0.0, 0, [run(lo_min, 2)], [pend(hi)], 5.0),     # preempt
        (0.0, 0, [run(lo1, 4), run(lo2, 4)],
         [pend(sp(name="eq"))], 5.0),                    # equals stay
        (0.0, 0, [run(v, 4)], [pend(p)], 5.0),           # reserve cap
        (1.0, 4, [], [pend(p, 2), pend(v, 2)], 5.0),     # admit capped
        (0.0, 0, [run(lo1, 4, stopping=True), run(lo2, 4)],
         [pend(hi)], 5.0),                               # no double evict
        (1.0, 4, grow, [], 5.0),                         # not settled
        (10.0, 4, grow, [], 5.0),                        # grow one
        (10.0, 4, grow, [pend(sp(name="p"))], 5.0),      # pending first
        (10.0, 4, [run(a, 2, stopping=True)], [], 5.0),  # stopping stays
        (0.0, 2, [run(lo1, 4, since=3.0), run(lo2, 4, since=1.0)],
         [pend(sp(name="h2", prio=2, pref=8, wmin=8))], 5.0),  # youngest
    ]


def test_world_ladder_matches_jax():
    for kw, cap in (({}, None), ({"pref": 6, "wmin": 4}, None), ({}, 2),
                    ({"pref": 8, "wmin": 1}, None), ({"pref": 8,
                                                       "wmin": 3}, 5)):
        assert scheduler.world_ladder(spec(pool, **kw), cap) == \
            jax_sched.world_ladder(spec(jax_pool, **kw), cap)
    assert scheduler.world_ladder(spec(pool)) == [4, 2]


@pytest.mark.parametrize("case", range(15))
def test_plan_matches_jax(case):
    got = scheduler.plan(*_scenarios(PKGS["port"])[case][:4],
                         settle_s=_scenarios(PKGS["port"])[case][4])
    want = jax_sched.plan(*_scenarios(PKGS["jax"])[case][:4],
                          settle_s=_scenarios(PKGS["jax"])[case][4])
    assert [dataclasses.astuple(d) for d in got] == \
        [dataclasses.astuple(d) for d in want]
    if case == 4:
        assert [d.kind for d in got] == ["shrink", "reserve"]
    if case == 11:
        assert [(d.kind, d.world) for d in got] == [("grow", 4)]


# ---------------------------------------------------------------------
# churn


def test_churn_parse_format_and_errors_match_jax():
    text = "kill@8:jobA, shrink@14:jobB,arrive@6:c"
    ev = churn.parse_churn(text)
    assert [dataclasses.astuple(e) for e in ev] == \
        [dataclasses.astuple(e) for e in jax_churn.parse_churn(text)]
    assert churn.format_churn(ev) == jax_churn.format_churn(
        jax_churn.parse_churn(text))
    assert churn.parse_churn(churn.format_churn(ev)) == ev
    for bad in ("kill@8", "explode@8:jobA", "kill@-1:a"):
        with pytest.raises(ValueError) as mine:
            churn.parse_churn(bad)
        with pytest.raises(ValueError) as ref:
            jax_churn.parse_churn(bad)
        assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("seed,kills,shrinks", [(7, 2, 1), (8, 2, 1),
                                                (0, 1, 1), (3, 4, 0)])
def test_seeded_churn_matches_jax(seed, kills, shrinks):
    jobs = ["a", "b", "c"]
    got = churn.seeded_churn(seed, jobs, 60.0, kills=kills,
                             shrinks=shrinks)
    want = jax_churn.seeded_churn(seed, jobs, 60.0, kills=kills,
                                  shrinks=shrinks)
    assert [dataclasses.astuple(e) for e in got] == \
        [dataclasses.astuple(e) for e in want]
    assert all(12.0 <= e.t_s <= 48.0 for e in got)


# ---------------------------------------------------------------------
# the control loop in virtual time, over one stub for both packages


class VirtualClock:
    def __init__(self):
        self.now = 0.0

    def monotonic(self):
        return self.now

    def wall(self):
        return 1_000_000.0 + self.now

    def sleep(self, dt):
        self.now += dt


class StubHandle:
    def __init__(self, pid, clock, run_s, fail_code=None, hang=False,
                 ckdir=None):
        self.pid = pid
        self.clock = clock
        now = clock.monotonic()
        self.end_at = None if hang else now + run_s
        self.exit_code = fail_code if fail_code is not None else 0
        self.preempt_at = None
        self.killed_at = None
        self.honors_sigterm = not hang
        self._ckdir = ckdir

    def poll(self):
        now = self.clock.monotonic()
        if self.killed_at is not None and now >= self.killed_at:
            return -9
        if self.preempt_at is not None and now >= self.preempt_at:
            return 75
        if self.end_at is not None and now >= self.end_at:
            return self.exit_code
        return None

    def send_preempt(self):
        if not self.honors_sigterm:
            return
        if self.preempt_at is None:
            # the emergency checkpoint's commit sentinel
            os.makedirs(self._ckdir, exist_ok=True)
            open(os.path.join(self._ckdir,
                              "step_00000002.complete"), "w").close()
            self.preempt_at = self.clock.monotonic() + 0.2

    def force_kill(self):
        self.killed_at = self.clock.monotonic()


class StubBackend:
    """JAX's test backend; ``cards`` is the port's extra argument."""

    def __init__(self, clock, behaviors):
        self.clock = clock
        self.behaviors = behaviors
        self.launches = []

    def launch(self, s, world, resume, run_dir, incarnation, cards=None):
        os.makedirs(run_dir, exist_ok=True)
        self.launches.append((s.name, world, resume, incarnation, cards))
        b = self.behaviors.get(s.name, {})
        return StubHandle(900_000_000 + len(self.launches), self.clock,
                          b.get("run_s", 10.0), b.get("fail_code"),
                          b.get("hang", False), os.path.join(run_dir, "ck"))

    def harvest(self, s, run_dir, exit_code):
        return {"goodput": 0.8}


def stub_fleet(pkg, out, specs, behaviors, churn_text="", chips=8,
               **ctl_kw):
    clock = VirtualClock()
    backend = StubBackend(clock, behaviors)
    ctl = pkg[4].FleetController(
        pkg[0].DevicePool(chips), specs, str(out), backend=backend,
        churn=pkg[2].parse_churn(churn_text),
        now_fn=clock.monotonic, wall_fn=clock.wall, sleep_fn=clock.sleep,
        tick_s=0.5, print_fn=lambda s: None,
        **{"settle_s": 1.0, "kill_grace_s": 5.0, "deadline_s": 300.0,
           **ctl_kw})
    return ctl, backend


def soak_specs(pkg):
    return [spec(pkg[0], name="a", batches=10),
            spec(pkg[0], name="b", model="lenet", batches=10),
            spec(pkg[0], name="hi", prio=1, arrival=6.0, batches=10)]


SOAK_BEHAVIORS = {"a": {"run_s": 20.0}, "b": {"run_s": 20.0},
                  "hi": {"run_s": 5.0}}


def _events(out) -> list[dict]:
    """The journal without what is per-process: pids, and the port's
    card indices."""
    return [{k: v for k, v in e.items() if k not in ("pid", "cards")}
            for e in report.read_events(str(out))]


@pytest.fixture(scope="module")
def stub_soaks(tmp_path_factory):
    """JAX's virtual-time kill, shrink and regrow story through each
    package's controller, plus a no-churn control of each."""
    out = {}
    for name, pkg in PKGS.items():
        tmp = tmp_path_factory.mktemp(f"soak_{name}")
        ctl, backend = stub_fleet(pkg, tmp / "fleet", soak_specs(pkg),
                                  SOAK_BEHAVIORS, "kill@3:a")
        result = ctl.run()
        control, _ = stub_fleet(pkg, tmp / "control", soak_specs(pkg),
                                SOAK_BEHAVIORS)
        control.run()
        out[name] = {"dir": tmp / "fleet", "control": tmp / "control",
                     "result": result, "launches": backend.launches,
                     "tmp": tmp}
    return out


def test_stub_soak_journal_equals_jax(stub_soaks):
    mine, ref = stub_soaks["port"], stub_soaks["jax"]
    assert mine["result"]["jobs"] == ref["result"]["jobs"] == {
        "a": "done", "b": "done", "hi": "done"}
    assert mine["result"]["orphans"] == []
    got, want = _events(mine["dir"]), _events(ref["dir"])
    assert [e["kind"] for e in got] == [e["kind"] for e in want]
    assert got == want
    # the launches, world for world, and the story JAX's test pins
    assert [l[:4] for l in mine["launches"]] == \
        [l[:4] for l in ref["launches"]]
    a = [l for l in mine["launches"] if l[0] == "a"]
    assert [l[1] for l in a] == [4, 4, 2, 4]
    assert a[0][2] == "auto" and all(l[2] == "elastic" for l in a[1:])


def test_stub_soak_cards_disjoint_and_journaled(stub_soaks):
    """Every launch holds its world in card indices; jobs running at the
    same time never share one (replayed from the journal)."""
    events = report.read_events(str(stub_soaks["port"]["dir"]))
    live: dict[str, set] = {}
    for e in events:
        if e["kind"] == "launch":
            cards = set(e["cards"])
            assert len(cards) == e["world"], e
            for other, held in live.items():
                assert not cards & held, (e, other, held)
            live[e["job"]] = cards
        elif e["kind"] == "exit":
            live.pop(e["job"], None)
    assert [l[4] for l in stub_soaks["port"]["launches"]][:2] == \
        [(0, 1, 2, 3), (4, 5, 6, 7)]


def test_stub_soak_ledger_equals_jax(stub_soaks):
    for key in ("dir", "control"):
        got = report.fleet_ledger(str(stub_soaks["port"][key]))
        want = jax_report.fleet_ledger(str(stub_soaks["jax"][key]))
        assert got == want
    ledger = report.fleet_ledger(str(stub_soaks["port"]["dir"]))
    exits = [e for e in report.read_events(str(stub_soaks["port"]["dir"]))
             if e["kind"] == "exit"]
    productive = sum(0.8 * e["world"] * e["wall_s"] for e in exits)
    assert ledger["fleet_goodput"] == pytest.approx(
        productive / (8 * ledger["wall_s"]), abs=1e-3)
    assert ledger["counts"]["kills"] == 1
    assert ledger["jobs"]["a"]["incarnations"] == 4
    assert report.fleet_ledger(str(stub_soaks["port"]["tmp"])) is None


def _cli(main, *args) -> tuple[int, list[str]]:
    buf = io.StringIO()
    rc = main(list(args), out=buf)
    return rc, buf.getvalue().splitlines()


def test_stub_soak_status_and_report_lines_equal_jax(stub_soaks):
    mine, ref = stub_soaks["port"], stub_soaks["jax"]
    for args in (("report",), ("report", "--control"), ("status",)):
        a = [str(mine["dir"])] + ([str(mine["control"])]
                                  if "--control" in args else [])
        b = [str(ref["dir"])] + ([str(ref["control"])]
                                 if "--control" in args else [])
        rc, got = _cli(cli.main, args[0], a[0], *args[1:], *a[1:])
        rc_ref, want = _cli(jax_cli.main, args[0], b[0], *args[1:],
                            *b[1:])
        assert rc == rc_ref == 0
        assert [ln.replace(str(mine["dir"]), "D") for ln in got] == \
            [ln.replace(str(ref["dir"]), "D") for ln in want]
    assert any("worlds 4->4->2->4" in ln for ln in _cli(
        cli.main, "report", str(mine["dir"]))[1])
    for cmd in ("status", "report"):
        assert _cli(cli.main, cmd, str(mine["tmp"] / "nope"))[0] == 2


def test_stub_soak_verdict_equals_jax_and_regresses(stub_soaks, tmp_path):
    from tpu_hc_bench_torch.obs import regress

    recs = {}
    for name, mod in (("port", report), ("jax", jax_report)):
        d = stub_soaks[name]
        recs[name] = mod.write_verdict(
            str(d["dir"]), str(tmp_path / f"{name}.json"),
            control_dir=str(d["control"]), bound_frac=0.5)
        assert json.loads((tmp_path / f"{name}.json").read_text()) == \
            recs[name]
    assert recs["port"] == recs["jax"]
    rec = recs["port"]
    assert rec["metric"] == "fleet_goodput"
    assert rec["extra"]["within_bound"] is True
    # no job wrote a manifest here: the kind is unknown in both
    assert rec["manifest"]["device_kind"] == "unknown"
    assert not regress.regress_check(rec, [rec])["regressions"]
    worse = json.loads(json.dumps(rec))
    worse["value"] = worse["extra"]["fleet_goodput"] = rec["value"] / 2
    assert any(r["metric"] == "fleet goodput"
               for r in regress.regress_check(worse, [rec])["regressions"])


def test_verdict_device_kind_from_a_job_manifest(stub_soaks, tmp_path):
    """A card fleet's record carries the card's kind (a job manifest's
    ``device_kind``), so ``obs regress`` keys it apart from a CPU soak."""
    import shutil

    d = tmp_path / "fleet"
    shutil.copytree(stub_soaks["port"]["dir"], d)
    (d / "jobs" / "b" / "m").mkdir(parents=True)
    (d / "jobs" / "b" / "m" / "manifest.json").write_text(json.dumps(
        {"device_kind": "NVIDIA H100 80GB HBM3"}))
    rec = report.write_verdict(str(d), str(tmp_path / "v.json"))
    assert rec["manifest"]["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert rec["extra"]["within_bound"] is None


def _liveness(tmp_path, name) -> list[dict]:
    """A job that ignores SIGTERM and never beats: declared dead after
    the grace windows, force-killed, requeued, failed at the relaunch
    budget; the journal."""
    pkg = PKGS[name]
    ctl, _ = stub_fleet(pkg, tmp_path, [spec(pkg[0], name="h", batches=5)],
                        {"h": {"hang": True}}, startup_grace_s=2.0,
                        dead_after_s=3.0, kill_grace_s=2.0)
    ctl.supervisor.max_relaunches = 2
    assert ctl.run()["jobs"]["h"] == "failed"
    return _events(tmp_path)


def test_liveness_dead_job_requeues_then_fails(tmp_path):
    got = _liveness(tmp_path / "p", "port")
    kinds = [e["kind"] for e in got]
    assert "dead" in kinds and "requeue" in kinds
    assert any(e["kind"] == "failed"
               and e.get("exit_class") == "relaunch-budget" for e in got)
    assert got == _liveness(tmp_path / "j", "jax")


def test_watchdog_exit_fails_the_job(tmp_path):
    ctl, _ = stub_fleet(PKGS["port"], tmp_path, [spec(pool, name="w")],
                        {"w": {"run_s": 2.0, "fail_code": 70}})
    assert ctl.run()["jobs"]["w"] == "failed"
    assert any(e["kind"] == "failed"
               and e.get("exit_class") == "watchdog-timeout"
               for e in _events(tmp_path))


def test_crash_kills_every_live_job(tmp_path):
    ctl, _ = stub_fleet(PKGS["port"], tmp_path,
                        [spec(pool, name="a", pref=2, batches=5),
                         spec(pool, name="b", pref=2, batches=5)],
                        {"a": {"run_s": 50.0}, "b": {"run_s": 50.0}})
    ticks = {"n": 0}
    orig = ctl.tick

    def exploding_tick():
        ticks["n"] += 1
        if ticks["n"] == 3:
            raise OSError("disk full")
        orig()

    ctl.tick = exploding_tick
    with pytest.raises(OSError, match="disk full"):
        ctl.run()
    assert all(st.handle is None for st in ctl.supervisor.jobs.values())
    events = _events(tmp_path)
    assert any(e["kind"] == "fleet_crash" for e in events)
    assert sorted(e["job"] for e in events if e["kind"] == "exit") == \
        ["a", "b"]


def test_refusals_before_any_spawn(tmp_path):
    specs = [spec(pool, name="big", batch=4096),
             spec(pool, name="wide", wmin=16, pref=16),
             spec(pool, name="ok", batches=3)]
    ctl, backend = stub_fleet(PKGS["port"], tmp_path, specs,
                              {"ok": {"run_s": 2.0}})
    assert ctl.run()["jobs"] == {"big": "refused", "wide": "refused",
                                 "ok": "done"}
    assert [l[0] for l in backend.launches] == ["ok"]
    refusals = {e["job"]: e for e in _events(tmp_path)
                if e["kind"] == "refuse"}
    assert refusals["big"]["hbm_source"] == "seeded"
    assert "exceeds the pool" in refusals["wide"]["reason"]


# ---------------------------------------------------------------------
# the local backend's command lines and the CLI's pool, no process


@pytest.fixture
def captured(monkeypatch):
    from tpu_hc_bench_torch.tune import runner

    calls = []

    class Proc:
        pid = 4242

        def poll(self):
            return 0

    def fake(cmd, *, env=None, cwd=None, stdout=None, stderr=None):
        calls.append((cmd, env))
        return Proc()

    monkeypatch.setattr(runner, "launch_one", fake)
    return calls


def test_local_backend_cpu_command(tmp_path, captured):
    from tpu_hc_bench_torch.ops import _build

    be = supervisor.LocalBackend(device="cpu")
    s = spec(pool, name="j", batch=2, flags=("--num_classes=10",))
    h = be.launch(s, 4, "elastic", str(tmp_path / "j"), 1, (0, 1, 2, 3))
    cmd, env = captured[0]
    assert cmd[1:7] == ["-m", "tpu_hc_bench_torch", "1", "0", "2", "ici"]
    for flag in ("--device=cpu", "--virtual_devices=4", "--resume=elastic",
                 f"--train_dir={tmp_path / 'j' / 'ck'}",
                 f"--metrics_dir={tmp_path / 'j' / 'm'}",
                 f"--compile_cache={_build.BUILD_DIR}",
                 "--save_model_steps=2", "--num_classes=10"):
        assert flag in cmd, flag
    assert not any(f.startswith("--use_fp16") for f in cmd)
    assert h.pid == 4242 and (tmp_path / "j" / "job-1.log").exists()
    h.poll()


def test_local_backend_card_command(tmp_path, captured, monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    be = supervisor.LocalBackend(cache_dir="/k")
    s = spec(pool, name="j", flags=("--use_fp16=true",))
    be.launch(s, 2, "auto", str(tmp_path / "j"), 0, (1, 3)).poll()
    cmd, env = captured[0]
    assert env["CUDA_VISIBLE_DEVICES"] == "1,3"
    assert cmd[3:5] == ["1", "0"] and "--compile_cache=/k" in cmd
    assert not any(f.startswith(("--device", "--virtual_devices"))
                   for f in cmd)
    # granted indices map through this process's own visible cards
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5,6,7")
    be.launch(s, 2, "auto", str(tmp_path / "j"), 1, (1, 3)).poll()
    assert captured[1][1]["CUDA_VISIBLE_DEVICES"] == "5,7"
    with pytest.raises(ValueError, match="2 card"):
        be.launch(s, 2, "auto", str(tmp_path / "j"), 2, (0,))
    with pytest.raises(ValueError, match="cuda|cpu"):
        supervisor.LocalBackend(device="tpu")


def test_cli_pool_on_the_card(tmp_path, monkeypatch, captured):
    import torch

    # no card: the default device raises, the CPU is taken on request
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", "--demo", "--out", str(tmp_path / "x")],
                 out=io.StringIO())
    assert cli.pool_chips("cpu", None) == 8
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert cli.pool_chips("cuda", None) == 2
    rc, lines = _cli(cli.main, "run", "--demo", "--chips", "4",
                     "--out", str(tmp_path / "y"))
    assert rc == 2 and "2 card(s) are visible" in lines[-1]
    assert captured == [] and not (tmp_path / "y").exists()


def test_fleet_subcommand_routes(tmp_path, stub_soaks, capsys):
    from tpu_hc_bench_torch.__main__ import main

    assert main(["fleet", "report", str(stub_soaks["port"]["dir"]),
                 "--no-timelines"]) == 0
    assert "goodput" in capsys.readouterr().out


# ---------------------------------------------------------------------
# JAX's blocking-wait rule over the port's fleet sources


@pytest.mark.parametrize("name", ["__init__", "__main__", "churn", "pool",
                                  "report", "scheduler", "supervisor"])
def test_no_blocking_wait_in_the_port_fleet(name):
    from tpu_hc_bench.analysis.lints import FLEET_WAIT, lint_source_text

    rel = f"tpu_hc_bench_torch/fleet/{name}.py"
    found = [f for f in lint_source_text((REPO / rel).read_text(), rel)
             if f.lint == FLEET_WAIT]
    assert found == [], [f.render() for f in found]
    # the rule is live on this path: a planted wait is found
    planted = "def loop(js):\n    for j in js:\n        j.proc.wait()\n"
    assert [f for f in lint_source_text(planted, rel)
            if f.lint == FLEET_WAIT]


# ---------------------------------------------------------------------
# spawn_local: a preempted worker stops no peer


def test_preempted_worker_does_not_stop_its_peers():
    """Rank 1 exits 75 at once; rank 0 is still printing (its emergency
    save's fingerprint line).  Before, the first 75 stopped rank 0 with
    a second SIGTERM and its line was lost; now 75 comes back once both
    have exited, with rank 0's line."""
    from tpu_hc_bench_torch.parallel import distributed

    body = (f"import os, sys, time\n"
            f"if os.environ['{distributed.RANK_ENV}'] == '0':\n"
            f"    time.sleep(1.0)\n"
            f"    print('state fingerprint: abc', flush=True)\n"
            f"sys.exit(75)\n")
    workers = [distributed.Worker(r, r, 2, "file:///unused")
               for r in range(2)]
    lines: list[str] = []
    rc = distributed.spawn_local([sys.executable, "-c", body], workers,
                                 lines.append)
    assert (rc, lines) == (75, ["state fingerprint: abc"])
    # any other failure still stops the peers at once
    body = (f"import os, sys, time\n"
            f"if os.environ['{distributed.RANK_ENV}'] == '0':\n"
            f"    time.sleep(30)\n"
            f"sys.exit(3)\n")
    rc = distributed.spawn_local([sys.executable, "-c", body], workers,
                                 lines.append)
    assert rc == 3


# ---------------------------------------------------------------------
# real processes


def test_virtual_devices_two_workers_on_trivial(tmp_path):
    """``1 0 2 ici --device=cpu --virtual_devices=2``: two gloo workers
    (JAX's two virtual devices), world 2, global batch 4."""
    env = {**os.environ, "HOME": str(tmp_path)}
    env.pop("TPU_HC_BENCH_SETENV", None)
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_hc_bench_torch", "1", "0", "2", "ici",
         "--device=cpu", "--virtual_devices=2", "--model=trivial",
         "--num_classes=10", "--num_warmup_batches=1", "--num_batches=2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    res = json.loads([ln for ln in proc.stdout.splitlines()
                      if ln.startswith("{")][-1])
    assert (res["total_workers"], res["global_batch"]) == (2, 4)
    log = tmp_path / "logs" / "tpubench-1n-2b-synthetic-ici-r1.log"
    assert proc.stdout.splitlines()[-1] == f"log: {log}"
    assert json.loads(log.read_text().splitlines()[-1]) == res


# JAX's soak flags, and the newest two checkpoints kept: a save every 4
# steps of 600 would otherwise leave ~3 GB a job directory
SOAK_FLAGS = ("--num_classes=10", "--init_learning_rate=0.05",
              "--keep_checkpoints=2")


def soak_real_specs():
    """JAX's soak members: resnet20_cifar keeps its gang busy over the
    kill, so the killed lenet's elastic resume finds a smaller pool; the
    trivial member is the priority arrival (by the churn schedule).
    The port's CPU steps are shorter than JAX's (96 ms a lenet step at
    world 4 here): 300 and 600 steps keep both jobs running past the
    schedule's 30 s, as JAX's 80 and 150 do there."""
    return [
        spec(pool, name="cifar-a", model="resnet20_cifar", batches=300,
             warmup=2, save_every=4, flags=SOAK_FLAGS),
        spec(pool, name="lenet-b", model="lenet", batches=600, warmup=2,
             save_every=4, flags=SOAK_FLAGS),
        spec(pool, name="triv-hi", prio=1, pref=2, wmin=2, arrival=9999.0,
             batches=30, warmup=2, save_every=4, flags=SOAK_FLAGS),
    ]


def _fingerprints(text: str) -> list[str]:
    return [ln.split("state fingerprint:", 1)[1].strip()
            for ln in text.splitlines() if "state fingerprint:" in ln]


def _resume_fingerprint(ck_src, model, world, resume, tmp, tag):
    """A copy of a checkpoint directory relaunched at ``world`` for one
    step (a resumed run trains its whole ``--num_batches`` again, as in
    JAX): the restore's fingerprint."""
    import shutil

    ckdir = tmp / f"ck_{tag}"
    shutil.copytree(ck_src, ckdir)
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_hc_bench_torch", "1", "0", "2", "ici",
         f"--model={model}", *SOAK_FLAGS, "--device=cpu",
         f"--virtual_devices={world}", "--num_warmup_batches=1",
         "--num_batches=1",
         f"--resume={resume}", f"--train_dir={ckdir}"],
        cwd=REPO, env={**os.environ, "HOME": str(tmp)},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    fps = _fingerprints(proc.stdout)
    assert fps, proc.stdout[-2000:]
    return fps[0]


@pytest.mark.slow
def test_fleet_soak_on_the_cpu(tmp_path):
    """JAX's real soak against the port: ``fleet run --device=cpu`` over
    8 virtual devices, a kill then an elastic resume at a smaller world,
    a regrow, every emergency save restored bit for bit, own-world and
    half-world restores equal, zero orphans, churn goodput >= 0.5 x the
    control's."""
    env = {"HOME": str(tmp_path)}

    def fleet(out, churn_text):
        ctl = supervisor.FleetController(
            pool.DevicePool(8), soak_real_specs(), str(out),
            backend=supervisor.LocalBackend(base_env=env, device="cpu"),
            churn=churn.parse_churn(churn_text), settle_s=4.0,
            kill_grace_s=30.0, deadline_s=900.0, print_fn=lambda s: None)
        return ctl, ctl.run()

    out = tmp_path / "fleet"
    ctl, result = fleet(out, "kill@30:lenet-b,arrive@30.5:triv-hi")
    assert result["status"] == "done", result
    assert all(s == "done" for s in result["jobs"].values()), result
    assert result["orphans"] == []
    journal = report.read_events(str(out))
    launches: dict[str, list[dict]] = {}
    for e in journal:
        if e["kind"] == "launch":
            launches.setdefault(e["job"], []).append(e)
    assert set(launches) == {"cifar-a", "lenet-b", "triv-hi"}
    b_worlds = [e["world"] for e in launches["lenet-b"]]
    assert len(b_worlds) >= 2 and min(b_worlds[1:]) < b_worlds[0], b_worlds
    assert any(e["resume"] == "elastic" for e in launches["lenet-b"][1:])
    assert any(e["kind"] == "grow" for e in journal)
    assert max(b_worlds[1:]) > min(b_worlds[1:]), b_worlds

    st = ctl.supervisor.jobs["lenet-b"]
    pairs = 0
    for k in range(st.incarnations - 1):
        log_k = Path(st.run_dir) / f"job-{k}.log"
        if "emergency checkpoint saved" not in log_k.read_text():
            continue
        fp_save = _fingerprints(log_k.read_text())[-1]
        fp_restore = _fingerprints(
            (Path(st.run_dir) / f"job-{k + 1}.log").read_text())[0]
        assert fp_restore == fp_save, (k, fp_save, fp_restore)
        pairs += 1
    assert pairs >= 1

    for s in soak_real_specs():
        ck = Path(ctl.supervisor.jobs[s.name].run_dir) / "ck"
        steps = sorted(int(f.name[len("step_"):-len(".complete")])
                       for f in ck.glob("step_*.complete"))
        topo = json.loads(
            (ck / f"step_{steps[-1]:08d}.topology.json").read_text())
        own = int(topo["world"])
        fp_own = _resume_fingerprint(ck, s.model, own, "must", tmp_path,
                                     f"{s.name}_o")
        fp_half = _resume_fingerprint(ck, s.model, max(1, own // 2),
                                      "elastic", tmp_path, f"{s.name}_h")
        assert fp_half == fp_own, s.name

    _, res2 = fleet(tmp_path / "control", "arrive@30.5:triv-hi")
    assert res2["status"] == "done"
    rec = report.write_verdict(str(out), str(tmp_path / "verdict.json"),
                               control_dir=str(tmp_path / "control"),
                               extra={"fingerprint_pairs": pairs})
    assert rec["manifest"]["device_kind"] == "cpu"
    assert rec["extra"]["within_bound"], rec
