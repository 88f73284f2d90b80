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

Rank 0 prints the protocol lines and the result as one JSON line (no
log file is written).  Exit codes: 0 clean success (nonzero throughput
measured), 1 run completed but measured zero throughput; at world > 1
the first failing worker's code (1 for a signal), the other workers
stopped.
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
from typing import Callable

import torch
import torch.distributed as dist

from tpu_hc_bench_torch import flags, resolve_device
from tpu_hc_bench_torch.parallel import distributed
from tpu_hc_bench_torch.parallel.fabric import FABRICS, resolve_fabric

EXIT_OK = 0
EXIT_ZERO_THROUGHPUT = 1
USAGE = ("usage: python -m tpu_hc_bench_torch NUM_HOSTS WORKERS_PER_HOST "
         f"BATCH_SIZE FABRIC({'|'.join(FABRICS)}) [--flags...]\n"
         "       python -m tpu_hc_bench_torch serve [--flags...]")


def parse_positionals(argv: list[str]) -> tuple[list[str], list[str]]:
    """Split ``NUM_HOSTS WORKERS BATCH FABRIC [--flags...]`` like the
    reference's ``$1 $2 $3 $4``; all four are required."""
    pos, rest = [], list(argv)
    while rest and not rest[0].startswith("-") and len(pos) < 4:
        pos.append(rest.pop(0))
    if len(pos) != 4:
        raise SystemExit(USAGE)
    return pos, rest


def local_workers(workers_per_host: int, device: str) -> int:
    """Workers on one host: ``workers_per_host``, or 0 for one per card
    (one on the CPU, or where no card is visible)."""
    if workers_per_host < 0:
        raise ValueError(f"WORKERS_PER_HOST must be >= 0: "
                         f"{workers_per_host}")
    return max(workers_per_host or (
        torch.cuda.device_count() if device == "cuda" else 1), 1)


def world_size(num_hosts: int, workers_per_host: int, device: str) -> int:
    if num_hosts < 1:
        raise ValueError(f"NUM_HOSTS must be >= 1: {num_hosts}")
    return num_hosts * local_workers(workers_per_host, device)


def _train(argv: list[str], cfg: flags.BenchmarkConfig, fabric: str,
           tee: Callable[[str], None], local: int) -> int:
    from tpu_hc_bench_torch.train import driver

    tee(f"command: python -m tpu_hc_bench_torch {' '.join(argv)}")
    result = driver.run_benchmark(cfg, fabric=fabric, print_fn=tee,
                                  local_workers=local)
    tee(json.dumps(result.json_line()))
    return EXIT_OK if result.total_images_per_sec > 0 else \
        EXIT_ZERO_THROUGHPUT


def _in_group(join: Callable[[], None], run: Callable[[], int]) -> int:
    join()
    try:
        return run()
    finally:
        dist.destroy_process_group()


def main(argv: list[str] | None = None,
         print_fn: Callable[[str], None] | None = None) -> int:
    from tpu_hc_bench_torch.train import step as step_mod

    argv = list(sys.argv[1:] if argv is None else argv)
    tee = print_fn or (lambda m: print(m, flush=True))
    pos, rest = parse_positionals(argv)
    fabric = pos[3].strip().lower()
    fab = resolve_fabric(fabric)
    cfg = flags.parse_benchmark_flags(["--batch_size", pos[2]] + rest)
    step_mod.check_arm(cfg, fab)
    dev = resolve_device(cfg.device)
    local = local_workers(int(pos[1]), cfg.device)
    world = world_size(int(pos[0]), int(pos[1]), cfg.device)
    if dev.type == "cuda" and local > torch.cuda.device_count():
        raise ValueError(f"{local} workers on this host but "
                         f"{torch.cuda.device_count()} cards: one worker "
                         "a card (WORKERS_PER_HOST 0 is one per card)")
    backend = distributed.backend_for(fab.is_fast, dev)

    worker = distributed.worker_from_env()
    if worker is not None:                      # a spawned worker
        if dev.type == "cuda":
            torch.cuda.set_device(worker.local_rank)
        out = tee if worker.rank == 0 else (lambda _m: None)
        return _in_group(
            lambda: distributed.init_group(backend, worker),
            lambda: _train(argv, cfg, fabric, out, local))
    if world == 1:
        if not fab.is_fast:
            return _train(argv, cfg, fabric, tee, local)
        return _in_group(lambda: distributed.init_single(backend),
                         lambda: _train(argv, cfg, fabric, tee, local))

    num_hosts = int(pos[0])
    tmp = None
    if num_hosts > 1:
        host, store = distributed.multi_host_store(num_hosts)
    else:
        tmp = tempfile.mkdtemp(prefix="tpu_hc_bench_store_")
        host, store = 0, f"file://{tmp}/store"
    workers = [distributed.Worker(host * local + i, i, world, store)
               for i in range(local)]
    try:
        return distributed.spawn_local(
            [sys.executable, "-m", "tpu_hc_bench_torch", *argv], workers,
            tee)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
