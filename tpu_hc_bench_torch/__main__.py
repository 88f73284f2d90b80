"""``python -m tpu_hc_bench_torch serve [--flags]``: the port's entry
point (the serving lane is the only lane ported so far)."""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] != "serve":
        print("usage: python -m tpu_hc_bench_torch serve [--flags] "
              "(the serving lane is the only lane ported so far)",
              file=sys.stderr)
        return 2
    from tpu_hc_bench_torch.serve.cli import main as serve_main

    return serve_main(argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
