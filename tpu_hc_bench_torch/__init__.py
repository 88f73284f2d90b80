"""tpu_hc_bench_torch: the PyTorch/CUDA port of tpu_hc_bench.

The JAX package ``tpu_hc_bench`` stays the reference; this package is
held against it by the ``tests/test_torch_*.py`` parity tests and imports
nothing from it (no JAX, no shared module: it keeps its own copies of the
host code it needs).  The first slice is the serving lane: ``llama_1b``
served with continuous batching over a paged KV pool, with hand-written
CUDA kernels for paged decode attention and the fused residual+norm.

Every entry point runs on the GPU (``device="cuda"``) unless the caller
passes ``device="cpu"``; without a GPU the default raises.  The lane is
float32, so TF32 is switched off for matmuls and convolutions.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` to run on; raises when CUDA is asked for (the
    default) and no GPU is present, so a CPU run happens only on request."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device=cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu: {device!r}")
    return dev
