"""Positional launcher CLI of the port's training lane, the reference's
run-script contract::

    python -m tpu_hc_bench_torch NUM_HOSTS WORKERS_PER_HOST BATCH_SIZE FABRIC [--flags]

``FABRIC`` takes the JAX package's names (``ib``/``ici``, ``sock``/
``host``, ``dcn``); ``BATCH_SIZE`` is per worker; ``WORKERS_PER_HOST`` 0
means one worker per local card.  tf_cnn-style ``--flags`` follow
(``flags.BenchmarkConfig``).  Only a world of one worker is ported: a
larger world raises.  The run prints the protocol lines and the result as
one JSON line (it writes no log file).

Exit codes: 0 clean success (nonzero throughput measured), 1 run
completed but measured zero throughput.
"""

from __future__ import annotations

import json
import sys
from typing import Callable

import torch

from tpu_hc_bench_torch import flags

EXIT_OK = 0
EXIT_ZERO_THROUGHPUT = 1
FABRICS = ("ib", "ici", "dcn", "sock", "host")
USAGE = ("usage: python -m tpu_hc_bench_torch NUM_HOSTS WORKERS_PER_HOST "
         "BATCH_SIZE FABRIC(ib|sock|ici|dcn|host) [--flags...]\n"
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


def world_size(num_hosts: int, workers_per_host: int, device: str) -> int:
    if num_hosts < 1 or workers_per_host < 0:
        raise ValueError(f"NUM_HOSTS must be >= 1 and WORKERS_PER_HOST >= 0: "
                         f"{num_hosts}, {workers_per_host}")
    local = workers_per_host or (
        torch.cuda.device_count() if device == "cuda" else 1)
    return num_hosts * max(local, 1)


def main(argv: list[str] | None = None,
         print_fn: Callable[[str], None] | None = None) -> int:
    from tpu_hc_bench_torch.train import driver

    argv = list(sys.argv[1:] if argv is None else argv)
    tee = print_fn or (lambda m: print(m, flush=True))
    pos, rest = parse_positionals(argv)
    fabric = pos[3].strip().lower()
    if fabric not in FABRICS:
        raise ValueError(f"unknown fabric {pos[3]!r}; expected one of "
                         f"{sorted(FABRICS)}")
    cfg = flags.parse_benchmark_flags(["--batch_size", pos[2]] + rest)
    world = world_size(int(pos[0]), int(pos[1]), cfg.device)
    if world > 1:
        raise ValueError(f"a world of {world} workers is not ported yet: "
                         "the port trains on one worker (1 1 BATCH FABRIC)")
    tee(f"command: python -m tpu_hc_bench_torch {' '.join(argv)}")
    result = driver.run_benchmark(cfg, total_workers=world, fabric=fabric,
                                  print_fn=tee)
    tee(json.dumps(result.json_line()))
    return EXIT_OK if result.total_images_per_sec > 0 else \
        EXIT_ZERO_THROUGHPUT
