"""Positional launcher CLI of the port's training lane, the reference's
run-script contract::

    python -m tpu_hc_bench_torch NUM_HOSTS WORKERS_PER_HOST BATCH_SIZE FABRIC [--flags]

``FABRIC`` takes the JAX package's names (``ib``/``ici``, ``sock``/
``host``, ``dcn``); ``BATCH_SIZE`` is per worker; ``WORKERS_PER_HOST`` 0
means one worker per local card (one on the CPU).  tf_cnn-style
``--flags`` follow (``flags.BenchmarkConfig``), the reference's whole
line among them, and reach every worker unchanged (each runs this
command).  The workers of one host split its decode budget
(``run_benchmark``'s ``local_workers``).

The world is NUM_HOSTS x WORKERS_PER_HOST workers, one process each:

- **world 1**: ``ib|ici|dcn`` train in this process through the
  data-parallel step in a one-rank group (NCCL on the card, gloo on the
  CPU), as the JAX package runs its psum over a one-device mesh;
  ``sock|host`` train the one-worker step with no group (the host mean
  of one is the identity).
- **world > 1**: this process starts WORKERS_PER_HOST worker processes
  (``parallel.distributed.spawn_local``), each running this command
  with its rank in the environment; a worker binds ``cuda:{local
  rank}`` and joins the group (NCCL for the fast fabric on the card,
  gloo otherwise).  More workers than cards on the card raise: two NCCL
  ranks cannot share a card.  Several hosts each run the command with
  the hostfile contract of ``parallel.distributed``.

Rank 0 prints the protocol lines and the result as one JSON line.  The
launcher of the first host (not a spawned worker) also keeps the JAX
package's host plumbing: it registers the fabric's exports as the
``launcher`` block of the env registry (``envfile``; an unwritable home
does not end the run) and, in a ``finally`` (a preempted run too),
writes every line it printed to ``~/logs/<driver.log_name>`` and prints
``log: <path>``.  ``--virtual_devices=N`` (``--device=cpu``) is a CPU
host of N cards: WORKERS_PER_HOST 0 starts N gloo workers.

Exit codes (``resilience``, JAX's contract): 0
clean success (nonzero throughput measured), 1 run completed but
measured zero throughput, 70 the watchdog ended a hung run
(``--step_timeout_s``), 75 a SIGTERM/SIGINT was honored with an
emergency checkpoint (``--resume=auto`` continues); at world > 1 the
first failing worker's code (1 for a signal), the other workers
stopped, or 75 once every worker has stopped at the agreed step.  A SIGTERM or SIGINT to this process at world > 1 is passed on
to every worker, whose ranks agree on the step to stop at.
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
from pathlib import Path
from typing import Callable

import torch
import torch.distributed as dist

from tpu_hc_bench_torch import flags, resolve_device
from tpu_hc_bench_torch.parallel import distributed
from tpu_hc_bench_torch.parallel.fabric import (
    FABRICS, FabricConfig, resolve_fabric)
from tpu_hc_bench_torch.resilience import (
    EXIT_OK, EXIT_PREEMPTED, EXIT_ZERO_THROUGHPUT)

USAGE = ("usage: python -m tpu_hc_bench_torch NUM_HOSTS WORKERS_PER_HOST "
         f"BATCH_SIZE FABRIC({'|'.join(FABRICS)}) [--flags...]\n"
         "       python -m tpu_hc_bench_torch serve [--flags...]\n"
         "       python -m tpu_hc_bench_torch fleet run|status|report ...")


def parse_positionals(argv: list[str]) -> tuple[list[str], list[str]]:
    """Split ``NUM_HOSTS WORKERS BATCH FABRIC [--flags...]`` like the
    reference's ``$1 $2 $3 $4``; all four are required."""
    pos, rest = [], list(argv)
    while rest and not rest[0].startswith("-") and len(pos) < 4:
        pos.append(rest.pop(0))
    if len(pos) != 4:
        raise SystemExit(USAGE)
    return pos, rest


def local_workers(workers_per_host: int, device: str,
                  virtual_devices: int | None = None) -> int:
    """Workers on one host: ``workers_per_host``, or 0 for one per card
    (one on the CPU, or where no card is visible).  ``virtual_devices``
    N (a CPU host) is the host's card count, as JAX's layout over N
    virtual devices: 0 takes all N, more than N raise."""
    if workers_per_host < 0:
        raise ValueError(f"WORKERS_PER_HOST must be >= 0: "
                         f"{workers_per_host}")
    if virtual_devices:
        if workers_per_host > virtual_devices:
            raise ValueError(f"WORKERS_PER_HOST={workers_per_host} "
                             f"exceeds --virtual_devices={virtual_devices}")
        return workers_per_host or virtual_devices
    return max(workers_per_host or (
        torch.cuda.device_count() if device == "cuda" else 1), 1)


def world_size(num_hosts: int, workers_per_host: int, device: str,
               virtual_devices: int | None = None) -> int:
    if num_hosts < 1:
        raise ValueError(f"NUM_HOSTS must be >= 1: {num_hosts}")
    return num_hosts * local_workers(workers_per_host, device,
                                     virtual_devices)


def _train(argv: list[str], cfg: flags.BenchmarkConfig, fabric: str,
           tee: Callable[[str], None], local: int) -> int:
    from tpu_hc_bench_torch.resilience.preempt import PreemptedError
    from tpu_hc_bench_torch.train import driver

    tee(f"command: python -m tpu_hc_bench_torch {' '.join(argv)}")
    try:
        result = driver.run_benchmark(cfg, fabric=fabric, print_fn=tee,
                                      local_workers=local)
    except PreemptedError as e:
        tee(str(e))
        return EXIT_PREEMPTED
    tee(json.dumps(result.json_line()))
    if cfg.metrics_dir:
        tee("summarize: python -m tpu_hc_bench_torch.obs summarize "
            + cfg.metrics_dir
            + (f" --fabric_ceiling {cfg.fabric_ceiling}"
               if cfg.fabric_ceiling else ""))
    return EXIT_OK if result.total_images_per_sec > 0 else \
        EXIT_ZERO_THROUGHPUT


def _in_group(join: Callable[[], None], run: Callable[[], int]) -> int:
    join()
    try:
        return run()
    finally:
        dist.destroy_process_group()


def _register_env(fab, cfg: flags.BenchmarkConfig) -> None:
    """The fabric's exports as the env registry's ``launcher`` block
    (JAX's setenv role); a read-only home does not end the run."""
    from tpu_hc_bench_torch import envfile

    try:
        envfile.register("launcher", FabricConfig(
            fab, cfg.fusion_threshold_bytes).env_exports())
    except OSError:
        pass


def main(argv: list[str] | None = None,
         print_fn: Callable[[str], None] | None = None) -> int:
    from tpu_hc_bench_torch.train import step as step_mod

    argv = list(sys.argv[1:] if argv is None else argv)
    echo = print_fn or (lambda m: print(m, flush=True))
    pos, rest = parse_positionals(argv)
    fabric = pos[3].strip().lower()
    fab = resolve_fabric(fabric)
    cfg = flags.parse_benchmark_flags(["--batch_size", pos[2]] + rest)
    step_mod.check_arm(cfg, fab)
    dev = resolve_device(cfg.device)
    num_hosts = int(pos[0])
    local = local_workers(int(pos[1]), cfg.device, cfg.virtual_devices)
    world = world_size(num_hosts, int(pos[1]), cfg.device,
                       cfg.virtual_devices)
    if dev.type == "cuda" and local > torch.cuda.device_count():
        raise ValueError(f"{local} workers on this host but "
                         f"{torch.cuda.device_count()} cards: one worker "
                         "a card (WORKERS_PER_HOST 0 is one per card)")
    backend = distributed.backend_for(fab.is_fast, dev)

    worker = distributed.worker_from_env()
    if worker is not None:                      # a spawned worker
        if dev.type == "cuda":
            torch.cuda.set_device(worker.local_rank)
        out = echo if worker.rank == 0 else (lambda _m: None)
        return _in_group(
            lambda: distributed.init_group(backend, worker),
            lambda: _train(argv, cfg, fabric, out, local))

    host, store = 0, None
    if world > 1 and num_hosts > 1:
        host, store = distributed.multi_host_store(num_hosts)
    lines: list[str] = []

    def tee(m: str) -> None:
        echo(m)
        lines.append(m)

    if host == 0:
        _register_env(fab, cfg)
    try:
        if world == 1:
            if not fab.is_fast:
                return _train(argv, cfg, fabric, tee, local)
            return _in_group(lambda: distributed.init_single(backend),
                             lambda: _train(argv, cfg, fabric, tee, local))
        return _spawn_host(argv, host, store, local, world, tee)
    finally:
        if host == 0:
            # the log is part of the contract, a preempted run's too
            from tpu_hc_bench_torch.train import driver

            log = Path.home() / "logs" / driver.log_name(
                num_hosts, cfg.batch_size,
                "synthetic" if cfg.data_dir is None else "real", fab.value)
            try:
                log.parent.mkdir(parents=True, exist_ok=True)
                log.write_text("\n".join(lines) + "\n")
                print(f"log: {log}", flush=True)
            except OSError:
                pass


def _spawn_host(argv: list[str], host: int, store: str | None, local: int,
                world: int, tee: Callable[[str], None]) -> int:
    """This host's ``local`` workers of a ``world``-worker run, each this
    command in a process of its own; rank 0's lines go to ``tee``."""
    tmp = None
    if store is None:
        tmp = tempfile.mkdtemp(prefix="tpu_hc_bench_store_")
        store = f"file://{tmp}/store"
    workers = [distributed.Worker(host * local + i, i, world, store)
               for i in range(local)]
    try:
        return distributed.spawn_local(
            [sys.executable, "-m", "tpu_hc_bench_torch", *argv], workers,
            tee)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
