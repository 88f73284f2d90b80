"""tpu_hc_bench_torch: the PyTorch/CUDA port of tpu_hc_bench.

The JAX package ``tpu_hc_bench`` stays the reference; this package is
held against it by the ``tests/test_torch_*.py`` parity tests and imports
nothing from it (no JAX, no shared module: it keeps its own copies of the
host code it needs).  Two lanes are ported:

- serving (``python -m tpu_hc_bench_torch serve``): ``llama_1b`` served
  with continuous batching over a paged KV pool, with hand-written CUDA
  kernels for paged decode attention and the fused residual+norm;
- training (``python -m tpu_hc_bench_torch NUM_HOSTS WORKERS BATCH
  FABRIC``, the reference's flag line): ResNet v1.5 (resnet50/101/152)
  on synthetic images or ImageNet TFRecords (``--data_dir``: a native
  scanner and JPEG decode pool, ``native/``), GPT-2 and BERT masked-LM
  on synthetic tokens or a token corpus, momentum SGD or optax's
  adam/adamw/rmsprop, forward-only or eval, on one worker or data
  parallel over ``torch.distributed`` (one process a worker, gradients
  averaged through Horovod-style fusion buckets), with hand-written
  CUDA kernels for the fused BN-relu-conv3x3 (``--fused_conv``), flash
  attention and the blocked cross-entropy.

Every entry point runs on the GPU (``device="cuda"``) unless the caller
passes ``device="cpu"``; without a GPU the default raises.  float32 work
is meant as float32, so TF32 is switched off for matmuls and
convolutions (bf16 training runs on the tensor cores all the same).
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
