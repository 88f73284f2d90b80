"""Each job's process lifecycle and the fleet's control loop (the port's
copy of the JAX package's ``fleet/supervisor.py``).

Three layers, so the default test lane never spawns a process:

- **Backend** (``LocalBackend`` or a test stub): launches one job
  incarnation and harvests its results.  The local backend rides the
  tuner's runner (``tune.runner.build_cmd``/``launch_one``: the same
  command line and process-group discipline), points every incarnation
  at the job's ``train_dir`` (its checkpoint lineage) and
  ``metrics_dir`` (heartbeat incarnation counters keep counting across
  relaunches: ``obs.fleet.FleetWriter`` appends) and tees its output
  to a per-incarnation ``job-<k>.log``.  On the card each incarnation
  runs ``1 0 ...`` with ``CUDA_VISIBLE_DEVICES`` set to the cards the
  pool granted it, so its one worker a card binds exactly its gang; on
  the CPU (by request) ``--device=cpu --virtual_devices=<world>``.

- **Supervisor**: job states and transitions.  Exits are classified by
  the launcher's contract (``resilience.classify_exit``): 0 completes
  the job, 75 requeues it (the emergency checkpoint is on disk; the
  next launch resumes with ``--resume=elastic`` at whatever world the
  scheduler grants), and 1/70/crash/signal fail it.  Liveness rides
  the heartbeat files through ``obs.fleet.classify_liveness``: a
  RUNNING job whose newest beat (at the expected incarnation) goes
  silent past ``dead_after_s`` is force-killed (its whole process
  group) and requeued like a preemption, without the emergency
  checkpoint it never wrote (it resumes from its last periodic save).

- **FleetController**: the tick loop.  Each tick: arrivals, reap exits,
  apply due churn, check liveness, escalate overdue stops, ask the
  scheduler (``fleet.scheduler.plan``) and apply its decisions, tail
  the jobs' signals, and journal everything into
  ``fleet_events.jsonl`` (append-only, the report's source) and
  ``fleet_state.json`` (committed tmp -> rename, the ``fleet status``
  snapshot).  The clock and sleep are injectable, so the default-lane
  tests drive the whole loop in virtual time over a stub backend.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import signal
import subprocess
import time
from typing import Callable, Protocol

from tpu_hc_bench_torch.fleet import scheduler as sched_mod
from tpu_hc_bench_torch.fleet.churn import ChurnEvent
from tpu_hc_bench_torch.fleet.pool import DevicePool, JobSpec
from tpu_hc_bench_torch.resilience import classify_exit

__all__ = ["JobHandle", "Backend", "LocalBackend", "JobState",
           "Supervisor", "FleetController",
           "WAITING", "PENDING", "RUNNING", "STOPPING", "DONE",
           "FAILED", "REFUSED"]

WAITING = "waiting"       # not yet arrived
PENDING = "pending"       # queued for chips
RUNNING = "running"
STOPPING = "stopping"     # preempt signal sent, waiting for exit
DONE = "done"
FAILED = "failed"
REFUSED = "refused"       # admission refused (HBM / oversized gang)


class JobHandle(Protocol):
    pid: int

    def poll(self) -> int | None: ...
    def send_preempt(self) -> None: ...
    def force_kill(self) -> None: ...


class Backend(Protocol):
    def launch(self, spec: JobSpec, world: int, resume: str,
               run_dir: str, incarnation: int,
               cards: tuple[int, ...] = ()) -> JobHandle: ...
    def harvest(self, spec: JobSpec, run_dir: str,
                exit_code: int) -> dict: ...


class _LocalHandle:
    """One live job incarnation: a Popen in its own process group plus
    the log file its output tees into."""

    def __init__(self, proc: subprocess.Popen, log_f):
        self.proc = proc
        self.pid = proc.pid
        self._log_f = log_f

    def poll(self) -> int | None:
        rc = self.proc.poll()
        if rc is not None and self._log_f is not None:
            try:
                self._log_f.close()
            except OSError:
                pass
            self._log_f = None
        return rc

    def send_preempt(self) -> None:
        # SIGTERM to the launcher alone, no escalation here: at a world
        # above one it passes the signal on to each of its workers
        # once (a second SIGTERM to a worker forces its default
        # handling, mid-save), and the in-job handler needs its grace
        # window for the emergency checkpoint; the controller escalates
        # on its own deadline, to the whole group
        try:
            self.proc.send_signal(signal.SIGTERM)
        except (ProcessLookupError, OSError):
            pass

    def force_kill(self) -> None:
        from tpu_hc_bench_torch.tune import runner as runner_mod

        runner_mod.kill_process_tree(self.proc, sig=signal.SIGKILL)


class LocalBackend:
    """Real subprocess jobs on this host's pool of cards.

    ``device`` ``cuda`` (the default) runs each incarnation ``1 0 ...``
    with ``CUDA_VISIBLE_DEVICES`` set to its granted cards (mapped
    through this process's own ``CUDA_VISIBLE_DEVICES`` where that is
    set); ``cpu`` runs it with ``--device=cpu --virtual_devices=<world>``
    (gloo workers).  ``base_env`` extends ``os.environ`` for every job.
    ``cache_dir`` is every job's ``--compile_cache``, the kernel build
    directory: one for the whole fleet, by default the port's own
    (``build/torch_kernels``), so the kernels a first job built (or an
    earlier run) are loaded by every launch, never rebuilt; jobs that
    start at once take turns on its lock."""

    def __init__(self, base_env: dict | None = None,
                 cache_dir: str | None = None, device: str = "cuda"):
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda|cpu: {device!r}")
        self.base_env = dict(base_env or {})
        if cache_dir is None:
            from tpu_hc_bench_torch.ops._build import BUILD_DIR

            cache_dir = str(BUILD_DIR)
        self.cache_dir = cache_dir
        self.device = device

    def command(self, spec: JobSpec, flags: list[str]) -> list[str]:
        """One incarnation's command line (a subclass may change its
        head)."""
        from tpu_hc_bench_torch.tune import runner as runner_mod

        # f32 unless the spec's flags say otherwise: a soak's
        # fingerprint proof needs deterministic state
        return runner_mod.build_cmd(
            spec.model, spec.batch_size, flags, warmup=spec.warmup,
            batches=spec.batches, use_fp16=False)

    def launch(self, spec: JobSpec, world: int, resume: str,
               run_dir: str, incarnation: int,
               cards: tuple[int, ...] = ()) -> _LocalHandle:
        from tpu_hc_bench_torch.tune import runner as runner_mod

        os.makedirs(run_dir, exist_ok=True)
        flags = [
            f"--train_dir={os.path.join(run_dir, 'ck')}",
            f"--metrics_dir={os.path.join(run_dir, 'm')}",
            f"--resume={resume}",
            f"--display_every={spec.save_every}",
            f"--save_model_steps={spec.save_every}",
            f"--compile_cache={self.cache_dir}",
            *spec.flags,
        ]
        env = dict(os.environ)
        env.update(self.base_env)
        if self.device == "cpu":
            flags[:0] = ["--device=cpu", f"--virtual_devices={world}"]
        else:
            if len(cards) != world:
                raise ValueError(f"{spec.name}: {world} card(s) wanted, "
                                 f"{len(cards)} granted: {cards}")
            visible = os.environ.get("CUDA_VISIBLE_DEVICES")
            names = (visible.split(",") if visible
                     else [str(c) for c in range(max(cards) + 1)])
            env["CUDA_VISIBLE_DEVICES"] = ",".join(names[c] for c in cards)
        cmd = self.command(spec, flags)
        log_f = open(os.path.join(run_dir, f"job-{incarnation}.log"), "w")
        try:
            proc = runner_mod.launch_one(cmd, env=env, stdout=log_f)
        except BaseException:
            log_f.close()
            raise
        return _LocalHandle(proc, log_f)

    def harvest(self, spec: JobSpec, run_dir: str,
                exit_code: int) -> dict:
        """This incarnation's goodput account from its metrics stream:
        the final ``summary`` record when the run completed, else the
        partial ledger fold (a preempted incarnation still worked).
        Never raises — a job that died before writing anything harvests
        an empty record."""
        from tpu_hc_bench_torch.obs import goodput as goodput_mod
        from tpu_hc_bench_torch.obs.metrics import read_jsonl

        rec: dict = {}
        records = read_jsonl(os.path.join(run_dir, "m",
                                          "metrics.jsonl"))
        if not records:
            return rec
        summary = next((r for r in reversed(records)
                        if r.get("kind") == "summary"), None)
        if summary is not None:
            gp = summary.get("goodput")
            if isinstance(gp, (int, float)) and gp == gp:
                rec["goodput"] = round(float(gp), 4)
            if summary.get("images_per_sec_per_chip") is not None:
                rec["per_chip"] = summary["images_per_sec_per_chip"]
        if "goodput" not in rec:
            ledger = goodput_mod.build_ledger(records)
            if ledger is not None:
                rec["goodput"] = round(ledger.goodput, 4)
                rec["partial"] = True
        return rec


@dataclasses.dataclass
class JobState:
    spec: JobSpec
    status: str = WAITING
    world: int = 0
    handle: JobHandle | None = None
    incarnations: int = 0           # launches so far
    run_dir: str = ""
    since_s: float = 0.0            # last transition (fleet-relative)
    stop_sent_s: float | None = None
    stop_reason: str = ""
    target_world: int | None = None     # requeue hint (shrink/grow)
    expect_incarnation: int = 0     # what THIS life's heartbeats stamp
    exit_class: str | None = None
    chip_seconds: float = 0.0           # Σ world x incarnation wall
    productive_chip_seconds: float = 0.0    # goodput-weighted
    pgids: list[int] = dataclasses.field(default_factory=list)

    @property
    def resumable(self) -> bool:
        """A committed checkpoint exists (the ``step_N.complete``
        sentinel — the same contract restore believes)."""
        return bool(glob.glob(
            os.path.join(self.run_dir, "ck", "step_*.complete")))


class Supervisor:
    """Job-state transitions over a Backend.  Pure bookkeeping plus
    signals — scheduling decisions arrive from outside."""

    def __init__(self, backend: Backend, jobs_dir: str,
                 event_fn: Callable[..., None],
                 max_relaunches: int = 8):
        self.backend = backend
        self.jobs_dir = jobs_dir
        self.jobs: dict[str, JobState] = {}
        self._event = event_fn
        self.max_relaunches = max_relaunches

    def add(self, spec: JobSpec) -> JobState:
        if spec.name in self.jobs:
            raise ValueError(f"duplicate job name {spec.name!r}")
        st = JobState(spec=spec,
                      run_dir=os.path.join(self.jobs_dir, spec.name))
        self.jobs[spec.name] = st
        return st

    def launch(self, name: str, world: int, now_s: float,
               cards: tuple[int, ...] = ()) -> None:
        from tpu_hc_bench_torch.obs import fleet as obs_fleet

        st = self.jobs[name]
        resume = "elastic" if st.resumable else "auto"
        # the incarnation THIS life's heartbeats will stamp, derived
        # from the same file tail the writer reads — a launch counter
        # would drift ahead forever the first time a life dies before
        # its first beat, and liveness would cap the job at STALE
        st.expect_incarnation = obs_fleet.next_incarnation(
            obs_fleet.heartbeat_path(os.path.join(st.run_dir, "m"), 0))
        handle = self.backend.launch(st.spec, world, resume,
                                     st.run_dir, st.incarnations, cards)
        st.handle = handle
        st.world = world
        st.status = RUNNING
        st.since_s = now_s
        st.stop_sent_s = None
        st.incarnations += 1
        st.pgids.append(handle.pid)
        self._event("launch", job=name, world=world, resume=resume,
                    incarnation=st.incarnations - 1, pid=handle.pid,
                    cards=list(cards))

    def preempt(self, name: str, now_s: float, reason: str,
                target_world: int | None = None) -> None:
        st = self.jobs[name]
        if st.status != RUNNING or st.handle is None:
            return
        st.handle.send_preempt()
        st.status = STOPPING
        # since_s stays at LAUNCH time: reap() charges the incarnation
        # its whole running wall — resetting it here would bill a
        # 100s-old preempted job 3 stop-grace seconds of chip time and
        # silently understate every churn run's fleet goodput
        st.stop_sent_s = now_s
        st.stop_reason = reason
        st.target_world = target_world
        self._event("preempt_sent", job=name, reason=reason,
                    target_world=target_world)

    def reap(self, now_s: float) -> list[tuple[JobState, int]]:
        """Collect exited jobs; classify, harvest, and transition them.
        Returns the (state, exit_code) pairs reaped this round.

        Transitions: a clean exit completes the job; an exit-75
        preemption — or ANY death of a job we were deliberately
        stopping (the escalation SIGKILL, the liveness kill) — requeues
        it for an elastic relaunch; everything else (watchdog,
        zero-throughput, crash, stray signal) fails it.  A job that
        keeps dying stops requeueing after ``max_relaunches`` — a
        crash-looping job must not hold its queue slot forever.
        """
        out: list[tuple[JobState, int]] = []
        for st in self.jobs.values():
            if st.status not in (RUNNING, STOPPING) or st.handle is None:
                continue
            code = st.handle.poll()
            if code is None:
                continue
            out.append((st, code))
            cls = classify_exit(code)
            intentional = st.status == STOPPING
            harvest = self.backend.harvest(st.spec, st.run_dir, code)
            gp = harvest.get("goodput")
            inc_wall = max(0.0, now_s - st.since_s)
            st.chip_seconds += st.world * inc_wall
            if isinstance(gp, (int, float)):
                st.productive_chip_seconds += gp * st.world * inc_wall
            self._event("exit", job=st.spec.name, code=code,
                        exit_class=cls, world=st.world,
                        wall_s=round(inc_wall, 3), **harvest)
            st.handle = None
            st.world = 0
            st.exit_class = cls
            st.since_s = now_s
            if cls is None:
                st.status = DONE
                self._event("done", job=st.spec.name)
            elif cls == "preempted" or intentional:
                if st.incarnations >= self.max_relaunches:
                    st.status = FAILED
                    self._event("failed", job=st.spec.name,
                                exit_class="relaunch-budget")
                else:
                    st.status = PENDING
                    self._event("requeue", job=st.spec.name,
                                target_world=st.target_world,
                                resumable=st.resumable)
            else:
                st.status = FAILED
                self._event("failed", job=st.spec.name, exit_class=cls)
        return out

    def check_liveness(self, now_s: float, wall_now: float,
                       dead_after_s: float,
                       startup_grace_s: float) -> None:
        """Force-kill RUNNING jobs whose heartbeats went silent (the
        hang the watchdog inside the job should have caught — this is
        the outer belt when the whole process wedged).

        A life that has not produced its FIRST beat yet (imports, the
        kernel library's load, model build, warmup — minutes for a
        large member on the card, and the
        heartbeat only starts at the first sync window) is judged from
        its LAUNCH time with the widest window,
        ``startup_grace_s + dead_after_s``: without that, a healthy job
        still compiling would be SIGKILLed into a relaunch loop that
        repeats the same startup until the relaunch budget fails it.
        """
        from tpu_hc_bench_torch.obs import fleet as obs_fleet

        for st in self.jobs.values():
            if st.status != RUNNING or st.handle is None:
                continue
            if now_s - st.since_s < startup_grace_s:
                continue
            # bounded tail reads — this runs every tick, and heartbeat
            # files grow O(run)
            beats = obs_fleet.latest_heartbeats(
                os.path.join(st.run_dir, "m"))
            verdict = obs_fleet.classify_liveness(
                list(beats.values()), now=wall_now,
                dead_after_s=dead_after_s,
                expect_incarnation=st.expect_incarnation)
            if verdict["status"] != obs_fleet.DEAD:
                continue
            inc = verdict["incarnation"]
            if (inc is None or inc < st.expect_incarnation) \
                    and now_s - st.since_s \
                    < startup_grace_s + dead_after_s:
                continue    # this life has not beaten yet: still in
                            # its startup window, judged from launch
            self._event("dead", job=st.spec.name,
                        age_s=verdict["age_s"],
                        incarnation=verdict["incarnation"])
            st.handle.force_kill()
            # reap() will see the SIGKILL exit; mark the intent so the
            # job requeues instead of failing on signal-9
            st.status = STOPPING
            st.stop_sent_s = now_s
            st.stop_reason = "liveness"
            st.target_world = None

    def escalate_stops(self, now_s: float, kill_grace_s: float) -> None:
        for st in self.jobs.values():
            if st.status != STOPPING or st.handle is None:
                continue
            if st.stop_sent_s is not None \
                    and now_s - st.stop_sent_s > kill_grace_s:
                self._event("force_kill", job=st.spec.name,
                            reason=st.stop_reason)
                st.handle.force_kill()
                st.stop_sent_s = now_s  # don't re-kill every tick

    def orphan_pids(self) -> list[int]:
        """PIDs still alive in ANY incarnation's process group — every
        launch was a session leader (``runner.launch_one``), so its
        pgid == its pid, and a /proc scan over those pgids finds every
        grandchild a kill might have orphaned.  The soak's zero-orphan
        invariant asserts this is empty after the run."""
        pgids = {pg for st in self.jobs.values() for pg in st.pgids}
        alive: list[int] = []
        for pid_dir in glob.glob("/proc/[0-9]*"):
            try:
                pid = int(os.path.basename(pid_dir))
            except ValueError:
                continue
            try:
                if os.getpgid(pid) in pgids:
                    alive.append(pid)
            except (ProcessLookupError, OSError):
                continue
        return alive


class FleetController:
    """The tick loop: churn -> reap -> liveness -> schedule -> apply."""

    def __init__(
        self,
        pool: DevicePool,
        specs: list[JobSpec],
        out_dir: str,
        backend: Backend | None = None,
        churn: list[ChurnEvent] | None = None,
        now_fn: Callable[[], float] = time.monotonic,
        wall_fn: Callable[[], float] = time.time,
        sleep_fn: Callable[[float], None] = time.sleep,
        tick_s: float = 0.5,
        settle_s: float = 5.0,
        kill_grace_s: float = 30.0,
        dead_after_s: float = 60.0,
        startup_grace_s: float = 45.0,
        deadline_s: float = 3600.0,
        print_fn: Callable[[str], None] = print,
    ):
        self.pool = pool
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.backend = backend if backend is not None else LocalBackend()
        self.churn = sorted(churn or [])
        self._churn_applied = [False] * len(self.churn)
        self.now_fn = now_fn
        self.wall_fn = wall_fn
        self.sleep_fn = sleep_fn
        self.tick_s = tick_s
        self.settle_s = settle_s
        self.kill_grace_s = kill_grace_s
        self.dead_after_s = dead_after_s
        self.startup_grace_s = startup_grace_s
        self.deadline_s = deadline_s
        self.print_fn = print_fn
        self._events_path = os.path.join(out_dir, "fleet_events.jsonl")
        self._events_f = open(self._events_path, "a")
        self.t0 = self.now_fn()
        self._started_unix = self.wall_fn()
        # health-signal advisory inputs: per-job byte offset into
        # <run_dir>/m/signals.jsonl so each tick tails only the new
        # events
        self._signal_offsets: dict[str, int] = {}
        self.supervisor = Supervisor(
            self.backend, os.path.join(out_dir, "jobs"), self._event)
        # arrival times: an arrive@t churn event overrides the spec
        arrive_at = {e.job: e.t_s for e in self.churn
                     if e.op == "arrive"}
        self._arrivals: dict[str, float] = {}
        for spec in specs:
            st = self.supervisor.add(spec)
            self._arrivals[spec.name] = arrive_at.get(
                spec.name, spec.arrival_s)
            # HBM admission runs ONCE, at submission: a job that cannot
            # fit a chip is refused before it ever burns a gang
            verdict = self.pool.hbm_admission(spec)
            if not verdict.fits:
                st.status = REFUSED
                st.exit_class = "hbm-refused"
                self._event("refuse", job=spec.name,
                            reason=verdict.reason,
                            hbm_source=verdict.source)
            elif spec.world_min > self.pool.chips:
                st.status = REFUSED
                st.exit_class = "oversized-gang"
                self._event("refuse", job=spec.name,
                            reason=f"world_min {spec.world_min} exceeds "
                                   f"the pool ({self.pool.chips} chips)")
        self._event("fleet_start", chips=self.pool.chips,
                    jobs=[s.name for s in specs],
                    churn=[dataclasses.asdict(e) for e in self.churn])

    # -- journaling ----------------------------------------------------

    def rel(self, now_s: float | None = None) -> float:
        return (self.now_fn() if now_s is None else now_s) - self.t0

    def _event(self, kind: str, **fields) -> None:
        rec = {"t": round(self.rel(), 3), "kind": kind, **fields}
        try:
            self._events_f.write(json.dumps(rec, default=str) + "\n")
            self._events_f.flush()
        except OSError:
            pass        # the journal is telemetry, never fatal
        if kind not in ("fleet_start",):
            self.print_fn(
                f"[{rec['t']:8.2f}s] {kind:<13} "
                + " ".join(f"{k}={v}" for k, v in fields.items()
                           if v is not None))

    def _commit_state(self) -> None:
        from tpu_hc_bench_torch.tune.search import commit_json

        jobs = {}
        for name, st in self.supervisor.jobs.items():
            jobs[name] = {
                "status": st.status, "world": st.world,
                "incarnations": st.incarnations,
                "expect_incarnation": st.expect_incarnation,
                "priority": st.spec.priority,
                "world_pref": st.spec.world_pref,
                "world_min": st.spec.world_min,
                "model": st.spec.model,
                "run_dir": st.run_dir,
                "exit_class": st.exit_class,
                "chip_seconds": round(st.chip_seconds, 3),
                "productive_chip_seconds":
                    round(st.productive_chip_seconds, 3),
            }
        commit_json(os.path.join(self.out_dir, "fleet_state.json"), {
            "chips": self.pool.chips,
            "free": self.pool.free,
            "t_s": round(self.rel(), 3),
            "started_unix": self._started_unix,
            "status": ("done" if self.finished() else "running"),
            "jobs": jobs,
        })

    # -- the loop ------------------------------------------------------

    def finished(self) -> bool:
        return all(st.status in (DONE, FAILED, REFUSED)
                   for st in self.supervisor.jobs.values())

    def tick(self) -> None:
        now = self.now_fn()
        rel = self.rel(now)
        sup = self.supervisor
        # 1. arrivals
        for name, st in sup.jobs.items():
            if st.status == WAITING and rel >= self._arrivals[name]:
                st.status = PENDING
                st.since_s = now
                self._event("arrive", job=name,
                            priority=st.spec.priority)
        # 2. reap exits, release chips
        for st, _code in sup.reap(now):
            self.pool.release(st.spec.name)
        # 3. churn events due
        for i, ev in enumerate(self.churn):
            if self._churn_applied[i] or rel < ev.t_s:
                continue
            self._churn_applied[i] = True
            if ev.op == "arrive":
                continue        # folded into arrivals above
            st = sup.jobs.get(ev.job)
            if st is None or st.status != RUNNING:
                self._event("churn_noop", op=ev.op, job=ev.job,
                            status=getattr(st, "status", "unknown"))
                continue
            if ev.op == "kill":
                sup.preempt(ev.job, now, reason="churn-kill")
            elif ev.op == "shrink":
                target = max(st.spec.world_min, st.world // 2)
                sup.preempt(ev.job, now, reason="churn-shrink",
                            target_world=target)
        # 4. liveness + stop escalation
        sup.check_liveness(now, self.wall_fn(), self.dead_after_s,
                           self.startup_grace_s)
        sup.escalate_stops(now, self.kill_grace_s)
        # 5. schedule
        running = [
            sched_mod.RunView(spec=st.spec, world=st.world,
                              since_s=st.since_s - self.t0,
                              stopping=(st.status == STOPPING))
            for st in sup.jobs.values()
            if st.status in (RUNNING, STOPPING)
        ]
        pending = [
            sched_mod.PendView(spec=st.spec,
                               target_world=st.target_world,
                               resumable=st.resumable)
            for st in sup.jobs.values() if st.status == PENDING
        ]
        for d in sched_mod.plan(rel, self.pool.free, running, pending,
                                settle_s=self.settle_s):
            if d.kind == sched_mod.ADMIT:
                cards = self.pool.reserve(d.job, d.world)
                st = sup.jobs[d.job]
                st.target_world = None
                self._event("admit", job=d.job, world=d.world,
                            reason=d.reason)
                sup.launch(d.job, d.world, now, cards)
            elif d.kind == sched_mod.RESERVE:
                # the shrink pass budgeted this pending job's next
                # admission — without the cap it would take its full
                # ladder top from the victims' freed chips
                sup.jobs[d.job].target_world = d.world
            elif d.kind == sched_mod.PREEMPT:
                sup.preempt(d.job, now, reason=d.reason)
            elif d.kind == sched_mod.SHRINK:
                self._event("shrink", job=d.job, world=d.world,
                            reason=d.reason)
                sup.preempt(d.job, now, reason="shrink",
                            target_world=d.world)
            elif d.kind == sched_mod.GROW:
                self._event("grow", job=d.job, world=d.world,
                            reason=d.reason)
                sup.preempt(d.job, now, reason="grow",
                            target_world=d.world)
        # 6. health signals: tail each running job's
        # signals.jsonl into the fleet journal.  ADVISORY ONLY — the
        # journal records what the ROADMAP autoscaler would do; no
        # scheduling lever moves off a signal yet.
        self._scan_signals()
        self._commit_state()

    def _scan_signals(self) -> None:
        from tpu_hc_bench_torch.obs import signals as signals_mod

        for name, st in self.supervisor.jobs.items():
            if st.status != RUNNING:
                continue
            path = signals_mod.signals_path(
                os.path.join(st.run_dir, "m"))
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            off = self._signal_offsets.get(name, 0)
            if size <= off:
                continue
            try:
                with open(path) as f:
                    f.seek(off)
                    chunk = f.read()
            except OSError:
                continue
            # only whole lines advance the offset — a mid-write tail
            # is re-read next tick, never half-parsed
            consumed = chunk.rfind("\n") + 1
            self._signal_offsets[name] = off + consumed
            for line in chunk[:consumed].splitlines():
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue
                self._event("signal", job=name,
                            signal=ev.get("signal"),
                            state=ev.get("state"),
                            t_sig=ev.get("t"),
                            measure=ev.get("measure"))
                if ev.get("state") == "fire":
                    try:
                        advice = signals_mod.advice_for(ev["signal"])
                    except (KeyError, ValueError):
                        continue
                    self._event("signal_advice", job=name,
                                signal=ev.get("signal"), advice=advice,
                                actuation="log-only")

    def _kill_all_live(self) -> None:
        for st in self.supervisor.jobs.values():
            if st.status in (RUNNING, STOPPING) \
                    and st.handle is not None:
                st.handle.force_kill()

    def run(self) -> dict:
        """Loop until every job settles (or the deadline).  Returns the
        final per-job summary (also committed as fleet_state.json).

        A crash anywhere in the loop (a failed launch, a full disk)
        must not leave live job subprocesses running unsupervised — the
        ``finally`` force-kills every live process group before the
        exception propagates, the same zero-orphan contract the clean
        path proves.
        """
        self._commit_state()
        status = "done"
        try:
            while not self.finished():
                if self.rel() > self.deadline_s:
                    status = "deadline"
                    self._event("deadline", t_limit_s=self.deadline_s)
                    break
                self.tick()
                if self.finished():
                    break
                self.sleep_fn(self.tick_s)
        except BaseException:
            status = "crash"
            self._event("fleet_crash")
            raise
        finally:
            if status != "done":
                self._kill_all_live()
            # drain: killed jobs need a beat for the SIGKILL to land
            # before the final reap settles them in the journal
            for _ in range(50):
                live = [st for st in self.supervisor.jobs.values()
                        if st.handle is not None
                        and st.status in (RUNNING, STOPPING)]
                if not live:
                    break
                for st, _code in self.supervisor.reap(self.now_fn()):
                    self.pool.release(st.spec.name)
                if any(st.handle is not None for st in live):
                    self._kill_all_live()
                    self.sleep_fn(0.1)
        wall = self.rel()
        self._event("fleet_end", wall_s=round(wall, 3), status=status)
        self._commit_state()
        try:
            self._events_f.close()
        except OSError:
            pass
        orphans = self.supervisor.orphan_pids()
        return {
            "status": status, "wall_s": round(wall, 3),
            "orphans": orphans,
            "jobs": {n: st.status
                     for n, st in self.supervisor.jobs.items()},
        }
