"""Multi-worker bring-up over ``torch.distributed``: the port's copy of the
JAX package's ``parallel/distributed.py`` hostfile contract, and the
launcher's process spawn.

The reference forms a cluster from a ``nodeips.txt`` hostfile and
``mpirun -hostfile`` starts one rank per worker on every node.  Here:

- **Hostfile.** One IP or hostname a line, the first the coordinator
  (``read_hostfile``; ``$TPU_HC_BENCH_HOSTFILE`` or ``~/nodeips.txt``).
  Every host runs the same launcher command with its index in
  ``$TPU_HC_BENCH_PROCESS_ID``; the rendezvous is a ``TCPStore`` at the
  first host's ``$TPU_HC_BENCH_COORDINATOR_PORT`` (default 9944).  One
  host needs no hostfile: its workers meet in a ``FileStore`` in a fresh
  temporary directory, so no fixed port can collide.
- **Ranks.** rank = host index x workers per host + local index; a
  worker on the card binds ``cuda:{local index}``.
- **Spawn.** ``spawn_local`` starts one process a local worker (the same
  command, ``python -m tpu_hc_bench_torch ...``) with its place in the
  world in ``TPU_HC_BENCH_RANK``, ``..._LOCAL_RANK``, ``..._WORLD_SIZE``
  and ``..._STORE``; the process reads it back with ``worker_from_env``
  and joins the group with ``init_group``.  Global rank 0's standard
  output is passed on line by line; when any worker fails, the others
  are stopped and the spawn returns its exit code.
- **World 1** on the fast fabric is a one-rank group over an in-process
  ``HashStore`` (``init_single``), as the JAX package runs its psum over
  a one-device mesh.
- **The mesh** (``build_mesh``): JAX's ``topology.build_mesh`` as process
  groups, over the axes ``(dcn, data, pipe, seq, model)``.  Axis order
  is collective frequency: ``model`` innermost, so a model group holds
  consecutive ranks (one host's cards), then ``seq``, then ``pipe``;
  ``dcn`` (``--num_slices``, the multislice layout) is outermost, so a
  slice is a block of consecutive ranks.  rank = (slice x data + data
  index) x minor + minor index, the minor index itself ``(pipe x sp +
  seq) x tp + model``.  The supported hybrids bind two minor axes:
  ``(data, pipe, model)`` and ``(data, seq, model)``.  Every rank
  creates every group, in one order (``dist.new_group`` is a collective
  call).  A group that spans the whole world is the default group (no
  second communicator).  ``force_seq_axis`` binds a one-rank seq group at
  ``sequence_parallel=1`` (the sequence-sharded impls need the axis,
  JAX's ``force_seq_axis``).  ``mesh_shape`` is the mesh's JAX shape,
  ``{"data": ..., "model": 1}`` for plain data parallelism, which the
  checkpoint's topology record keeps.
"""

from __future__ import annotations

import dataclasses
import math
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from tpu_hc_bench_torch.resilience import EXIT_PREEMPTED

# JAX's coordinator port, kept for the hostfile contract
DEFAULT_COORDINATOR_PORT = 9944
DEFAULT_HOSTFILE = Path.home() / "nodeips.txt"
HOSTFILE_ENV = "TPU_HC_BENCH_HOSTFILE"
PROCESS_ID_ENV = "TPU_HC_BENCH_PROCESS_ID"
PORT_ENV = "TPU_HC_BENCH_COORDINATOR_PORT"

# what the spawn hands each worker process
RANK_ENV = "TPU_HC_BENCH_RANK"
LOCAL_RANK_ENV = "TPU_HC_BENCH_LOCAL_RANK"
WORLD_ENV = "TPU_HC_BENCH_WORLD_SIZE"
STORE_ENV = "TPU_HC_BENCH_STORE"

_STOP_GRACE_S = 5.0


def read_hostfile(path: Path | str | None = None) -> list[str]:
    """Parse a nodeips.txt-style hostfile (blank lines and ``#``
    comments skipped)."""
    p = Path(path or os.environ.get(HOSTFILE_ENV) or DEFAULT_HOSTFILE)
    hosts = []
    for line in p.read_text().splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            hosts.append(line)
    if not hosts:
        raise ValueError(f"hostfile {p} contains no hosts")
    return hosts


def coordinator_port() -> int:
    return int(os.environ.get(PORT_ENV, DEFAULT_COORDINATOR_PORT))


@dataclasses.dataclass(frozen=True)
class Worker:
    """One process's place in the world."""

    rank: int
    local_rank: int
    world_size: int
    store: str          # file://PATH or tcp://HOST:PORT

    def env(self) -> dict[str, str]:
        return {RANK_ENV: str(self.rank), LOCAL_RANK_ENV: str(self.local_rank),
                WORLD_ENV: str(self.world_size), STORE_ENV: self.store}


def worker_from_env(env=None) -> Worker | None:
    """The ``Worker`` a spawn handed this process, or None outside one."""
    env = os.environ if env is None else env
    if RANK_ENV not in env:
        return None
    return Worker(int(env[RANK_ENV]), int(env[LOCAL_RANK_ENV]),
                  int(env[WORLD_ENV]), env[STORE_ENV])


def multi_host_store(num_hosts: int) -> tuple[int, str]:
    """``(host index, store)`` of this host in a ``num_hosts`` world:
    the hostfile's line count must be ``num_hosts``, the index comes from
    ``$TPU_HC_BENCH_PROCESS_ID`` and the store is the first host's
    coordinator port."""
    hosts = read_hostfile()
    if len(hosts) != num_hosts:
        raise ValueError(f"NUM_HOSTS is {num_hosts} but the hostfile lists "
                         f"{len(hosts)} hosts")
    if PROCESS_ID_ENV not in os.environ:
        raise ValueError(f"a world of {num_hosts} hosts needs this host's "
                         f"index in ${PROCESS_ID_ENV}")
    index = int(os.environ[PROCESS_ID_ENV])
    if not 0 <= index < num_hosts:
        raise ValueError(f"${PROCESS_ID_ENV}={index} is outside "
                         f"[0, {num_hosts})")
    return index, f"tcp://{hosts[0]}:{coordinator_port()}"


def _make_store(spec: str, rank: int, world: int):
    if spec.startswith("file://"):
        return dist.FileStore(spec[len("file://"):], world)
    if spec.startswith("tcp://"):
        host, port = spec[len("tcp://"):].rsplit(":", 1)
        return dist.TCPStore(host, int(port), world, is_master=rank == 0)
    raise ValueError(f"store must be file://PATH or tcp://HOST:PORT: "
                     f"{spec!r}")


def init_group(backend: str, worker: Worker) -> None:
    """Join ``worker``'s world with ``backend`` (``nccl`` or ``gloo``).
    A failure raises: there is no fallback to another backend."""
    dist.init_process_group(
        backend, store=_make_store(worker.store, worker.rank,
                                   worker.world_size),
        rank=worker.rank, world_size=worker.world_size)


def init_single(backend: str) -> None:
    """A one-rank group over an in-process ``HashStore``."""
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def backend_for(fast: bool, device: torch.device) -> str:
    """NCCL for the fast fabric on the card; gloo on the CPU, and for the
    host fabric, whose all-reduce runs on host copies."""
    return "nccl" if fast and device.type == "cuda" else "gloo"


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    """True on global rank 0 (the reference's head node)."""
    return rank() == 0


def barrier() -> None:
    """A barrier of the default group; on NCCL it names this process's
    card."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


DCN_AXIS, DATA_AXIS, SEQ_AXIS, MODEL_AXIS = "dcn", "data", "seq", "model"
PIPE_AXIS = "pipe"


def mesh_shape(world: int, sequence_parallel: int = 1,
               model_parallel: int = 1, num_slices: int = 1,
               num_hosts: int = 1, force_seq_axis: bool = False,
               pipeline_parallel: int = 1) -> dict:
    """The mesh's axes and sizes in JAX's order and with JAX's errors
    (``topology.build_mesh``): ``{"data": n, "model": 1}`` for plain data
    parallelism, a leading ``dcn`` axis under multislice, the minor axes
    after ``data`` in collective frequency, ``pipe``, ``seq``, then
    ``model`` innermost."""
    minors = [(PIPE_AXIS, pipeline_parallel), (SEQ_AXIS, sequence_parallel),
              (MODEL_AXIS, model_parallel)]
    for name, deg in minors:
        if deg < 1:
            raise ValueError(f"{name} degree must be >= 1, got {deg}")
    active = [(name, deg) for name, deg in minors
              if deg > 1 or (name == SEQ_AXIS and force_seq_axis)]
    prod = math.prod(deg for _, deg in active)
    if world % prod:
        raise ValueError(
            f"{world} devices not divisible by the minor-axis product "
            f"{prod} ({'x'.join(f'{nm}={d}' for nm, d in active)})")
    if not active:
        active = [(MODEL_AXIS, 1)]      # the 2-D DP mesh shape
    if num_slices < 1:
        raise ValueError(f"num_slices must be >= 1, got {num_slices}")
    data = world // prod
    if num_slices > 1:
        if num_hosts > 1 and num_hosts % num_slices:
            raise ValueError(
                f"num_slices={num_slices} does not divide "
                f"num_hosts={num_hosts}")
        if data % num_slices:
            raise ValueError(
                f"data degree {data} not divisible by num_slices="
                f"{num_slices}")
        return {DCN_AXIS: num_slices, DATA_AXIS: data // num_slices,
                **dict(active)}
    return {DATA_AXIS: data, **dict(active)}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the mesh and its groups.  ``dp`` is the
    data-parallel degree over both ``(dcn, data)``, ``data_index`` this
    rank's place on it and ``data_group`` its ranks (equal pipe, seq and
    model indexes); ``pp``, ``sp`` and ``tp`` the pipe, seq and model
    degrees, with their groups (None where the axis is not bound);
    ``pipe_prev`` and ``pipe_next`` the global ranks of the neighbouring
    stages (None at the ends: point-to-point ops take global ranks);
    ``grad_group`` the ranks a gradient is averaged over, those with
    this rank's pipe and model indexes (both data and seq vary; None
    where that is the whole world, the default group); ``hier`` the
    slice and cross-slice groups under multislice
    (``collectives.Hierarchy``), else None."""

    dp: int
    sp: int
    data_index: int
    seq_index: int
    data_group: object
    seq_group: object = None
    tp: int = 1
    model_index: int = 0
    model_group: object = None
    num_slices: int = 1
    hier: object = None
    shape: dict = dataclasses.field(default_factory=dict)
    pp: int = 1
    pipe_index: int = 0
    pipe_group: object = None
    pipe_prev: int | None = None
    pipe_next: int | None = None
    grad_group: object = None


def build_mesh(sequence_parallel: int = 1, model_parallel: int = 1,
               num_slices: int = 1, num_hosts: int = 1,
               force_seq_axis: bool = True,
               pipeline_parallel: int = 1) -> Mesh:
    """The mesh over the default process group, which must be up; a
    collective call: every rank makes it.  ``force_seq_axis``: bind the
    seq axis (its one-rank groups at ``sequence_parallel=1``) where no
    model or pipe axis is bound.  rank = ((data x pp + pipe) x sp + seq)
    x tp + model.  Every rank creates every group, in one order: the
    model groups, the seq groups, the pipe groups, the data groups, the
    gradient groups, then the slice and cross-slice groups."""
    from tpu_hc_bench_torch.parallel.collectives import Hierarchy

    world, r = dist.get_world_size(), dist.get_rank()
    shape = mesh_shape(world, sequence_parallel, model_parallel,
                       num_slices, num_hosts,
                       force_seq_axis and model_parallel == 1
                       and pipeline_parallel == 1, pipeline_parallel)
    pp = shape.get(PIPE_AXIS, 1)
    sp = shape.get(SEQ_AXIS, 1)
    tp = shape.get(MODEL_AXIS, 1)
    minor = pp * sp * tp
    dp = world // minor
    coords = [(d, p, s, m) for d in range(dp) for p in range(pp)
              for s in range(sp) for m in range(tp)]      # by rank
    d0, p0, s0, m0 = coords[r]

    def group(ranks: list[int]):
        return (dist.group.WORLD if len(ranks) == world
                else dist.new_group(ranks))

    def groups(same) -> object:
        """One group for each value of ``same(coords)`` (ranks in rank
        order); returns this rank's."""
        keys: dict = {}
        for rank_, c in enumerate(coords):
            keys.setdefault(same(c), []).append(rank_)
        made = {k: group(v) for k, v in keys.items()}
        return made[same(coords[r])]

    model_group = groups(lambda c: c[:3]) if tp > 1 else None
    seq_group = groups(lambda c: (c[0], c[1], c[3])) \
        if SEQ_AXIS in shape else None
    pipe_group = groups(lambda c: (c[0], c[2], c[3])) if pp > 1 else None
    data_group = groups(lambda c: c[1:])
    grad_group = None                  # no pipe or model axis: the world
    if minor > sp:
        grad_group = (data_group if sp == 1
                      else groups(lambda c: (c[1], c[3])))
    hier = None
    if num_slices > 1:
        m_slice = dp // num_slices
        slices = [[group([(s * m_slice + d) * minor + m
                          for d in range(m_slice)])
                   for m in range(minor)] for s in range(num_slices)]
        cross = [[group([(s * m_slice + d) * minor + m
                         for s in range(num_slices)])
                  for m in range(minor)] for d in range(m_slice)]
        d_all = r // minor
        hier = Hierarchy(slices[d_all // m_slice][r % minor],
                         cross[d_all % m_slice][r % minor], m_slice,
                         num_slices)
    at = {c: i for i, c in enumerate(coords)}
    return Mesh(dp=dp, sp=sp, data_index=d0, seq_index=s0,
                data_group=data_group, seq_group=seq_group, tp=tp,
                model_index=m0, model_group=model_group,
                num_slices=num_slices, hier=hier, shape=shape, pp=pp,
                pipe_index=p0, pipe_group=pipe_group,
                pipe_prev=at[(d0, p0 - 1, s0, m0)] if p0 > 0 else None,
                pipe_next=at[(d0, p0 + 1, s0, m0)] if p0 < pp - 1 else None,
                grad_group=None if grad_group is dist.group.WORLD
                else grad_group)


def _stop(procs: Sequence[subprocess.Popen]) -> None:
    alive = [p for p in procs if p.poll() is None]
    for p in alive:
        p.terminate()
    deadline = time.monotonic() + _STOP_GRACE_S
    for p in alive:
        try:
            p.wait(max(deadline - time.monotonic(), 0.0))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def spawn_local(cmd: Sequence[str], workers: Sequence[Worker],
                on_line: Callable[[str], None]) -> int:
    """Run ``cmd`` once for each of this host's ``workers`` and wait.

    Global rank 0's standard output goes to ``on_line`` line by line;
    the other workers' output and every standard error pass through.
    A SIGTERM or SIGINT to this process is passed on to every worker
    (each honors it at a step boundary the ranks agree on and exits 75,
    which stops no other worker: 75 is returned once all have exited).
    The first worker to exit otherwise non-zero stops the others (a rank
    blocked in a collective on a dead peer would otherwise wait for the
    group's timeout); its exit code is returned (1 for a signal), else
    0.  Each worker gets an equal share of the host's cores in
    ``OMP_NUM_THREADS`` unless it is set already."""
    base = dict(os.environ)
    root = str(Path(__file__).resolve().parents[2])
    base["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in base.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    base.setdefault("OMP_NUM_THREADS",
                    str(max(1, (os.cpu_count() or 1) // len(workers))))
    procs: list[subprocess.Popen] = []
    first_failure: list[tuple[int, int]] = []

    def forward(signum, frame) -> None:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    saved = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            saved[sig] = signal.signal(sig, forward)
    try:
        for w in workers:
            procs.append(subprocess.Popen(
                list(cmd), env={**base, **w.env()}, text=True,
                stdout=subprocess.PIPE if w.rank == 0 else None))

        def watch() -> None:
            while True:
                codes = [p.poll() for p in procs]
                # a preempted worker (75) stopped at the step boundary
                # its peers agreed on and stops nobody: they are still
                # saving or printing, and a second SIGTERM would kill
                # them there
                bad = [(w.rank, c) for w, c in zip(workers, codes)
                       if c not in (None, 0, EXIT_PREEMPTED)]
                if bad:
                    first_failure.append(bad[0])
                    _stop(procs)
                    return
                if all(c is not None for c in codes):
                    first_failure.extend(
                        (w.rank, c) for w, c in zip(workers, codes)
                        if c == EXIT_PREEMPTED)
                    return
                time.sleep(0.05)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        for w, p in zip(workers, procs):
            if w.rank == 0:
                for line in p.stdout:
                    on_line(line.rstrip("\n"))
        watcher.join()
    finally:
        for sig, old in saved.items():
            signal.signal(sig, old)
        _stop(procs)
    if first_failure:
        rank_, code = first_failure[0]
        if code != EXIT_PREEMPTED:
            print(f"worker rank {rank_} exited with code {code}; the "
                  "other workers were stopped", file=sys.stderr, flush=True)
        return code if code > 0 else 1
    return 0
