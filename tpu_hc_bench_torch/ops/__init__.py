"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``*_plain``): a wrapper launches the kernel for CUDA tensors and
runs the plain version for CPU tensors."""

from tpu_hc_bench_torch.ops.fused_residual_ln import (
    fused_residual_norm, fused_residual_norm_plain)
from tpu_hc_bench_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_attention_plain)

__all__ = ["fused_residual_norm", "fused_residual_norm_plain",
           "paged_decode_attention", "paged_decode_attention_plain"]
