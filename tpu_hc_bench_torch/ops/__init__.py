"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``*_plain``): a wrapper launches the kernel for CUDA tensors and
runs the plain version for CPU tensors.  (``flash_attention`` is reached
through its module, ``ops.flash_attention``, whose name it shares.)"""

from tpu_hc_bench_torch.ops.fused_conv import (
    fused_bn_relu_conv, fused_bn_relu_conv_plain)
from tpu_hc_bench_torch.ops.fused_residual_ln import (
    fused_residual_norm, fused_residual_norm_plain)
from tpu_hc_bench_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_attention_plain)
from tpu_hc_bench_torch.ops.pool_bwd import max_pool, max_pool_bwd_plain
from tpu_hc_bench_torch.ops.xent import (
    softmax_xent, softmax_xent_plain, softmax_xent_reference)

__all__ = ["fused_bn_relu_conv", "fused_bn_relu_conv_plain",
           "fused_residual_norm", "fused_residual_norm_plain",
           "max_pool", "max_pool_bwd_plain",
           "paged_decode_attention", "paged_decode_attention_plain",
           "softmax_xent", "softmax_xent_plain", "softmax_xent_reference"]
