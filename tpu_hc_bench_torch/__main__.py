"""The port's entry point::

    python -m tpu_hc_bench_torch NUM_HOSTS WORKERS_PER_HOST BATCH_SIZE FABRIC [--flags]
    python -m tpu_hc_bench_torch serve [--flags]
    python -m tpu_hc_bench_torch fleet run|status|report ...

The first form trains (``launcher.py``: one process a worker, data
parallel at a world above one); ``serve`` runs the serving lane
(``serve/cli.py``); ``fleet`` the orchestrator of many training jobs
over one pool of cards (``fleet/__main__.py``)."""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "fleet":
        from tpu_hc_bench_torch.fleet.__main__ import main as fleet_main

        return fleet_main(argv[1:])
    if argv and argv[0] == "serve":
        from tpu_hc_bench_torch.serve.cli import main as serve_main

        return serve_main(argv[1:])
    from tpu_hc_bench_torch import launcher

    return launcher.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
