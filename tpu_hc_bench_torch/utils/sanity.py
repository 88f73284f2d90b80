"""Environment sanity report (the port's copy of the JAX package's
``utils/sanity.py``, the reference's container ``%runscript``: print the
stack and assert it works)::

    python -m tpu_hc_bench_torch.utils.sanity

Prints python's, torch's, CUDA's and numpy's versions, the card
inventory, a matmul smoke on the card (bf16 256x256 ones, every entry
256), that the kernel library builds or loads from ``build/`` (the
CUDA kernels of ``tpu_hc_bench_torch/csrc``), and a one-rank collective
(an NCCL all-reduce over a one-rank group).  Exits non-zero on any
failure, so a setup script can gate on it; with no card, that is a
failure.
"""

from __future__ import annotations

import platform
import sys


def collect_report() -> tuple[list[str], list[str]]:
    """``(report_lines, failures)``."""
    lines: list[str] = []
    failures: list[str] = []
    lines.append(f"host: {platform.node()} ({platform.platform()})")
    lines.append(f"python: {sys.version.split()[0]}")
    try:
        import numpy
        import torch
    except Exception as e:
        failures.append(f"torch/numpy import failed: {e}")
        return lines, failures
    lines.append(f"torch: {torch.__version__}  cuda: {torch.version.cuda}"
                 f"  cudnn: {torch.backends.cudnn.version()}"
                 f"  numpy: {numpy.__version__}")
    if not torch.cuda.is_available():
        failures.append("no CUDA device (torch.cuda.is_available() is "
                        "False)")
        return lines, failures
    n = torch.cuda.device_count()
    for i in range(n):
        p = torch.cuda.get_device_properties(i)
        lines.append(f"cuda:{i}: {p.name}  sm_{p.major}{p.minor}  "
                     f"{p.total_memory / 2**30:.1f} GiB  "
                     f"{p.multi_processor_count} SMs")
    dev = torch.device("cuda", 0)
    try:
        x = torch.ones((256, 256), dtype=torch.bfloat16, device=dev)
        y = x @ x
        torch.cuda.synchronize(dev)
        if not bool((y == 256).all()):
            failures.append(f"matmul smoke test wrong result: "
                            f"{float(y[0, 0])}")
        else:
            lines.append("matmul smoke test: ok (256x256 bf16 on cuda:0)")
    except Exception as e:
        failures.append(f"matmul smoke test failed: {e}")
    try:
        from tpu_hc_bench_torch.ops import _build

        lib, seconds, _ = _build.build()
        _build.load_library()
        lines.append(f"kernel library: {lib} "
                     + (f"built in {seconds:.1f}s" if seconds
                        else "loaded (stamp current)"))
    except Exception as e:
        failures.append(f"kernel library build/load failed: {e}")
    try:
        import torch.distributed as dist

        from tpu_hc_bench_torch.parallel import distributed

        started = not dist.is_initialized()
        if started:
            torch.cuda.set_device(dev)
            distributed.init_single("nccl")
        try:
            t = torch.arange(4, dtype=torch.float32, device=dev)
            dist.all_reduce(t)
            torch.cuda.synchronize(dev)
            if t.tolist() != [0.0, 1.0, 2.0, 3.0]:
                failures.append(f"all-reduce smoke test wrong result: "
                                f"{t.tolist()}")
            else:
                lines.append("all-reduce smoke test: ok (NCCL, one rank)")
        finally:
            if started:
                dist.destroy_process_group()
    except Exception as e:
        failures.append(f"all-reduce smoke test failed: {e}")
    return lines, failures


def main() -> int:
    lines, failures = collect_report()
    print("=" * 60)
    print("tpu_hc_bench_torch environment sanity report")
    print("=" * 60)
    for line in lines:
        print(f"  {line}")
    if failures:
        print("FAILURES:")
        for f in failures:
            print(f"  !! {f}")
        return 1
    print("all checks passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
