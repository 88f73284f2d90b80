"""OSU-style collective latency and bandwidth sweeps over
``torch.distributed``: the port's copy of the JAX package's
``microbench/osu.py`` (the reference's fabric check, BASELINE config 5).

OSU's protocol: for each message size (powers of two over a range), a
correctness check of the collective, ``warmup`` untimed iterations, then
``iters`` timed iterations in one tight loop with one device sync at the
end; each rank times its loop and the slowest rank's time is reported,
per op.  ``message_bytes`` is the per-rank payload handed to the
collective (OSU's ``-m``).  Collectives run on NCCL on the card, or on
gloo with ``--device=cpu``.

Bandwidth columns, JAX's (and nccl-tests') convention:

- ``algbw`` = message_bytes / time, what the caller observes;
- ``busbw`` = algbw x ``busbw_factor``: 2(n-1)/n for allreduce, (n-1)/n
  for all_gather and reduce_scatter, 1 for ppermute.

The world: the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) where it is set, else
``--nproc N`` local processes started by the port's own spawn, else one
rank in this process::

    python -m tpu_hc_bench_torch.microbench.osu --op allreduce --nproc 4
    python -m tpu_hc_bench_torch.microbench.osu --op all --nproc 4 \\
        --device cpu --max_bytes 65536 --json sweep.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Callable

import torch
import torch.distributed as dist

from tpu_hc_bench_torch import resolve_device
from tpu_hc_bench_torch.parallel import collectives, distributed
from tpu_hc_bench_torch.utils import hw

OSU_OPS = ("allreduce", "all_gather", "reduce_scatter", "ppermute")
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class SweepResult:
    op: str
    world_size: int
    message_bytes: int
    mean_us: float
    algbw_gbps: float   # GB/s (1e9 bytes)
    busbw_gbps: float


def busbw_factor(op: str, n: int) -> float:
    """The ring traffic factor that turns algbw into busbw."""
    if n <= 1:
        return 1.0
    if op == "allreduce":
        return 2.0 * (n - 1) / n
    if op in ("all_gather", "reduce_scatter"):
        return (n - 1) / n
    return 1.0  # ppermute: each link carries the full message once


def _collective(op: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if op == "allreduce":
        return collectives.psum
    if op == "all_gather":
        return collectives.all_gather
    if op == "reduce_scatter":
        return collectives.reduce_scatter
    if op == "ppermute":
        return collectives.ppermute_ring
    raise ValueError(f"unknown op {op!r}; expected one of {OSU_OPS}")


def _check(op: str, elems: int, device: torch.device) -> None:
    """One call of ``op`` on rank-stamped data against its definition
    (small integers, so every float32 sum is exact in any order)."""
    n, r = dist.get_world_size(), dist.get_rank()
    base = (torch.arange(elems, device=device) % 1024).float()
    x = base + 1000 * r
    got = _collective(op)(x.clone())
    ranks = torch.arange(n, dtype=torch.float32, device=device)
    if op == "allreduce":
        want = n * base + 1000 * ranks.sum()
    elif op == "all_gather":
        want = (base[None] + 1000 * ranks[:, None]).reshape(-1)
    elif op == "reduce_scatter":
        k = elems // n
        want = n * base[r * k:(r + 1) * k] + 1000 * ranks.sum()
    else:
        want = base + 1000 * ((r - 1) % n)
    if not torch.equal(got, want):
        raise AssertionError(f"{op} at {elems} float32 elements disagrees "
                             f"with its definition on rank {r}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_sweep(op: str = "allreduce", min_bytes: int = 1024,
              max_bytes: int = 64 * 1024 * 1024, warmup: int = 5,
              iters: int = 20, device: str | torch.device = "cuda"
              ) -> list[SweepResult]:
    """Sweep one collective over the default group's ranks, float32
    messages of ``min_bytes`` to ``max_bytes`` (doubling)."""
    dev = resolve_device(device)
    coll = _collective(op)
    n = dist.get_world_size()
    results = []
    size = min_bytes
    while size <= max_bytes:
        elems = max(1, size // 4)
        if op == "reduce_scatter":
            elems = max(n, elems - elems % n)
        _check(op, elems, dev)
        x = torch.zeros(elems, dtype=torch.float32, device=dev)
        for _ in range(warmup):
            coll(x)
        _sync(dev)
        distributed.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            coll(x)
        _sync(dev)
        dt = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                          device=dev)
        dist.all_reduce(dt, op=dist.ReduceOp.MAX)
        per_op = float(dt) / iters
        msg = elems * 4
        algbw = msg / per_op / 1e9 if per_op > 0 else float("inf")
        results.append(SweepResult(op, n, msg, per_op * 1e6, algbw,
                                   algbw * busbw_factor(op, n)))
        size *= 2
    return results


def format_table(results: list[SweepResult], kind: str) -> str:
    """OSU-style output table."""
    if not results:
        return "(no results)"
    r0 = results[0]
    lines = [f"# {kind} collective micro-benchmark: {r0.op} "
             f"(world={r0.world_size}, OSU-equivalent)",
             f"# {'bytes':>12} {'latency_us':>12} {'algbw_GB/s':>12} "
             f"{'busbw_GB/s':>12}"]
    for r in results:
        lines.append(f"  {r.message_bytes:>12} {r.mean_us:>12.2f} "
                     f"{r.algbw_gbps:>12.3f} {r.busbw_gbps:>12.3f}")
    return "\n".join(lines)


def sweep_json(results_by_op: dict[str, list[SweepResult]],
               kind: str) -> dict:
    """The JAX package's sweep export schema (``schema`` 1): one row list
    per op, with the world size and device kind it holds for."""
    world = next((rs[0].world_size for rs in results_by_op.values() if rs),
                 0)
    return {"schema": 1, "created_unix": time.time(), "world_size": world,
            "device_kind": kind,
            "sweeps": {op: [dataclasses.asdict(r) for r in rows]
                       for op, rows in results_by_op.items()}}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_hc_bench_torch.microbench.osu",
        description="OSU-style collective sweeps over torch.distributed.")
    p.add_argument("--op", choices=list(OSU_OPS) + ["all"],
                   default="allreduce")
    p.add_argument("--min_bytes", type=int, default=1024)
    p.add_argument("--max_bytes", type=int, default=64 * 1024 * 1024)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--nproc", type=int, default=1,
                   help="local ranks to start (without a torchrun "
                        "environment)")
    p.add_argument("--json", metavar="PATH", default=None,
                   help="save the sweep (rank 0)")
    return p


def _sweep(args, print_fn: Callable[[str], None]) -> int:
    dev = resolve_device(args.device)
    ops = OSU_OPS if args.op == "all" else (args.op,)
    kind = hw.device_name(dev)
    by_op = {op: run_sweep(op, args.min_bytes, args.max_bytes, args.warmup,
                           args.iters, dev) for op in ops}
    if dist.get_rank() == 0:
        for rows in by_op.values():
            print_fn(format_table(rows, kind))
        if args.json:
            with open(args.json, "w") as f:
                json.dump(sweep_json(by_op, kind), f, indent=2)
                f.write("\n")
            print_fn(f"# sweep saved: {args.json}")
    return 0


def main(argv: list[str] | None = None,
         print_fn: Callable[[str], None] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    out = print_fn or (lambda m: print(m, flush=True))
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    backend = distributed.backend_for(True, dev)
    worker = distributed.worker_from_env()
    if worker is None and all(k in os.environ for k in _TORCHRUN_ENV):
        worker = distributed.Worker(
            int(os.environ["RANK"]), int(os.environ.get("LOCAL_RANK", 0)),
            int(os.environ["WORLD_SIZE"]),
            f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}")
    if worker is None and args.nproc > 1:
        if dev.type == "cuda" and args.nproc > torch.cuda.device_count():
            raise ValueError(f"--nproc {args.nproc} but "
                             f"{torch.cuda.device_count()} cards: one rank "
                             "a card")
        tmp = tempfile.mkdtemp(prefix="tpu_hc_bench_store_")
        try:
            workers = [distributed.Worker(i, i, args.nproc,
                                          f"file://{tmp}/store")
                       for i in range(args.nproc)]
            return distributed.spawn_local(
                [sys.executable, "-m", "tpu_hc_bench_torch.microbench.osu",
                 *argv], workers, out)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    if worker is None:
        distributed.init_single(backend)
    else:
        if dev.type == "cuda":
            torch.cuda.set_device(worker.local_rank)
        distributed.init_group(backend, worker)
    try:
        return _sweep(args, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
