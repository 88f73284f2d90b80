"""``python -m tpu_hc_bench_torch.serve [--flags]``: the serving lane
(``serve/cli.py``), as ``python -m tpu_hc_bench_torch serve`` runs it."""

from tpu_hc_bench_torch.serve.cli import main

raise SystemExit(main())
