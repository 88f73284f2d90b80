"""ResNet v1.5, the bottleneck family (resnet50/101/152), in PyTorch.

The counterpart of the JAX package's ``models/resnet.py`` for the
training lane: the 7x7/s2 stem (or its space-to-depth 4x4/s1 form), a
3x3/s2 SAME max-pool, bottleneck blocks with the stride on the 3x3
(v1.5), a global mean-pool and a float32 head.  Tensors are NCHW in
``channels_last`` memory, which is the JAX package's NHWC byte for byte.

What must match the JAX modules exactly, and how:

- **SAME padding.** XLA pads SAME asymmetrically when the total is odd
  (more after than before): the stem pads (2, 3) at 224, each 3x3/s2
  (0, 1) and the max-pool (0, 1) with -inf.  ``Conv`` and ``max_pool``
  pad explicitly with ``F.pad`` wherever the two sides differ.
- **Dtype policy.** Parameters and BN statistics are float32; convs run
  in the compute ``dtype`` (inputs and weights cast to it); BN math is
  float32 and rounds its output to ``dtype``; the mean-pool is taken in
  float32, rounded to ``dtype`` (as ``jnp.mean`` of a bf16 array), and
  the head and logits are float32.  Written out in the modules, not
  through autocast, so float32 on the CPU and bf16 on the card share one
  code path.
- **Two BatchNorm rules.** ``BatchNorm`` is Flax ``nn.BatchNorm``:
  ``var = max(0, E[x^2] - E[x]^2)`` and ``(x - mean) * (rsqrt(var + eps)
  * scale) + bias``.  ``_bn_scale_shift`` (the fused route) folds BN to
  ``x * a + b`` with the variance unclamped, from the kernel's sums when
  it has them.  Both update the running statistics with the *biased*
  batch variance, ``ra = 0.9 ra + 0.1 batch``, eps 1e-5, written out
  under ``torch.no_grad()`` (``F.batch_norm``'s update uses the unbiased
  variance).  Inside ``running_stats_frozen(model)`` (the forward-only
  step) both rules normalize with the batch's statistics and leave the
  running averages as they are.

One module layout serves both routes: ``FusedBottleneckBlock`` has the
children of ``BottleneckBlock`` under the same names, with the 3x3 conv a
``FusedBNReluConv3x3`` (it borrows the block's ``bn1`` at call time) and
``bn2`` a ``StatsBatchNorm``, so one ``state_dict`` loads into either.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpu_hc_bench_torch.ops import fused_conv as fc

__all__ = ["BatchNorm", "BottleneckBlock", "Conv", "FusedBNReluConv3x3",
           "FusedBottleneckBlock", "ResNet", "StatsBatchNorm", "max_pool",
           "resnet50", "resnet101", "resnet152", "running_stats_frozen",
           "same_pads"]

_C = (1, -1, 1, 1)      # a [C] vector broadcast over NCHW


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding ``(before, after)`` of one spatial dim."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  gen: torch.Generator) -> None:
    """Flax's ``lecun_normal``: a normal truncated at two deviations,
    scaled so the variance is ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


class Conv(nn.Module):
    """Flax ``nn.Conv(use_bias=False, padding="SAME")`` in ``dtype``;
    ``padding`` ``((top, bottom), (left, right))`` overrides SAME."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, padding=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.k, self.stride, self.dtype, self.padding = k, stride, dtype, \
            padding

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        """The conv of an input already in ``dtype``."""
        (t, bt), (l, r) = self.padding or (
            same_pads(x.shape[2], self.k, self.stride),
            same_pads(x.shape[3], self.k, self.stride))
        w = self.weight.to(self.dtype)
        if t == bt and l == r:
            return F.conv2d(x, w, stride=self.stride, padding=(t, l))
        return F.conv2d(F.pad(x, (l, r, t, bt)), w, stride=self.stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x.to(self.dtype))

    def init_weights(self, gen: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), gen)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the
    channels of an NCHW tensor; batch statistics in training mode,
    running statistics in eval mode."""

    def __init__(self, c: int, dtype: torch.dtype = torch.float32,
                 zero_init: bool = False, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))       # Flax "scale"
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.empty(c))
        self.register_buffer("running_var", torch.empty(c))
        self.dtype, self.zero_init = dtype, zero_init
        self.momentum, self.eps = momentum, eps
        self.frozen = False            # running_stats_frozen sets it

    def init_weights(self, gen: torch.Generator | None = None) -> None:
        del gen
        with torch.no_grad():
            self.weight.fill_(0.0 if self.zero_init else 1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """``ra = momentum * ra + (1 - momentum) * batch`` (biased var);
        nothing while ``frozen``."""
        if self.frozen:
            return
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean,
                              min=0.0)
            self.update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(_C)) * mul.view(_C) + self.bias.view(_C)
        return y.to(self.dtype)


@contextlib.contextmanager
def running_stats_frozen(model: nn.Module):
    """Within: every ``BatchNorm`` of ``model`` still normalizes with the
    batch's statistics in training mode but leaves its running averages
    untouched (JAX's forward-only step, which discards the new
    ``batch_stats``)."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.frozen = True
    try:
        yield
    finally:
        for bn in bns:
            bn.frozen = False


def _bn_scale_shift(bn: BatchNorm, x: torch.Tensor, stats=None):
    """BatchNorm folded to per-channel ``(a, b)`` with ``bn``'s
    parameters: batch statistics from ``stats = (sum, sumsq)`` when given
    (the fused kernel's epilogue) or by reducing ``x`` (variance
    unclamped), and the running averages updated in training mode."""
    if not bn.training:
        mean, var = bn.running_mean, bn.running_var
    else:
        if stats is None:
            xf = x.float()
            mean = xf.mean((0, 2, 3))
            var = (xf * xf).mean((0, 2, 3)) - mean * mean
        else:
            s1, s2 = stats
            n = x.shape[0] * x.shape[2] * x.shape[3]
            mean = s1 / n
            var = s2 / n - mean * mean
        bn.update_running(mean, var)
    a = bn.weight * torch.rsqrt(var + bn.eps)
    return a, bn.bias - mean * a


class StatsBatchNorm(BatchNorm):
    """BatchNorm that takes precomputed ``(sum, sumsq)`` (the fused
    kernel's epilogue) instead of reducing its input again; the same
    parameters and running-stat rule as ``BatchNorm``."""

    def forward(self, x: torch.Tensor, stats=None) -> torch.Tensor:
        a, b = _bn_scale_shift(self, x, stats)
        return (x.float() * a.view(_C) + b.view(_C)).to(self.dtype)


class FusedBNReluConv3x3(Conv):
    """BatchNorm(input) -> relu -> 3x3 conv, and the conv output's
    per-channel ``(sum, sumsq)`` for the next BatchNorm.

    Where ``fused_conv.eligible`` holds (3x3, stride 1, square maps,
    >= 128 input channels, >= 14 spatial) this is one
    ``fused_bn_relu_conv`` call, the CUDA kernel on the card; elsewhere
    the same composition on library ops, with the stats taken from the
    rounded output.  It owns the conv weight; the input's BatchNorm is
    passed at call time (the JAX module owns both, which would give the
    fused and unfused blocks different layouts here).
    """

    def forward(self, x: torch.Tensor, bn: BatchNorm):
        a, b = _bn_scale_shift(bn, x)
        n, cin, h, w = x.shape
        if fc.eligible((n, h, w, cin), (3, 3), self.stride, cin):
            y, s1, s2 = fc.fused_bn_relu_conv(
                x.permute(0, 2, 3, 1).contiguous(), a, b,
                self.weight.to(self.dtype).permute(2, 3, 1, 0).contiguous())
            return y.permute(0, 3, 1, 2), (s1, s2)
        xn = torch.relu(x.float() * a.view(_C) + b.view(_C)).to(self.dtype)
        y = self._conv(xn)
        yf = y.float()
        return y, (yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3)))


class BottleneckBlock(nn.Module):
    """ResNet-v1.5 bottleneck: 1x1 -> 3x3(stride) -> 1x1, projection
    shortcut where the shape changes; the last BN's scale starts at 0."""

    conv2_cls, bn2_cls = Conv, BatchNorm

    def __init__(self, cin: int, filters: int, strides: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = 4 * filters
        self.conv1 = Conv(cin, filters, 1, dtype=dtype)
        self.bn1 = BatchNorm(filters, dtype)
        self.conv2 = self.conv2_cls(filters, filters, 3, strides, dtype)
        self.bn2 = self.bn2_cls(filters, dtype)
        self.conv3 = Conv(filters, out, 1, dtype=dtype)
        self.bn3 = BatchNorm(out, dtype, zero_init=True)
        self.shortcut_conv = self.shortcut_bn = None
        if cin != out or strides != 1:
            self.shortcut_conv = Conv(cin, out, 1, strides, dtype)
            self.shortcut_bn = BatchNorm(out, dtype)

    def _tail(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        y = self.bn3(self.conv3(y))
        if self.shortcut_conv is not None:
            x = self.shortcut_bn(self.shortcut_conv(x))
        return torch.relu(x + y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        return self._tail(x, y)


class FusedBottleneckBlock(BottleneckBlock):
    """``BottleneckBlock`` with bn1-relu-conv2 as ``FusedBNReluConv3x3``
    and bn2 fed from its stats epilogue; the same math and the same
    parameter names."""

    conv2_cls, bn2_cls = FusedBNReluConv3x3, StatsBatchNorm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, stats = self.conv2(self.conv1(x), self.bn1)
        y = torch.relu(self.bn2(y, stats))
        return self._tail(x, y)


def max_pool(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """``nn.max_pool(x, (k, k), (s, s), "SAME")``: -inf padding."""
    t, b = same_pads(x.shape[2], k, s)
    l, r = same_pads(x.shape[3], k, s)
    return F.max_pool2d(F.pad(x, (l, r, t, b), value=float("-inf")), k, s)


class ResNet(nn.Module):
    """ImageNet ResNet, v1 bottleneck blocks; takes NCHW images (any
    float dtype) and returns float32 logits."""

    def __init__(self, stage_sizes: Sequence[int],
                 block_cls: type = BottleneckBlock, num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.float32,
                 fused_conv: bool = False, space_to_depth: bool = False):
        super().__init__()
        if block_cls is not BottleneckBlock:
            raise ValueError("the port has the v1 bottleneck family "
                             "(resnet50/101/152) only")
        if fused_conv:
            block_cls = FusedBottleneckBlock
        self.dtype, self.space_to_depth = dtype, space_to_depth
        nf = num_filters
        if space_to_depth:
            # the 7x7/s2 stem as a 4x4/s1 conv over 2x2-packed pixels;
            # (1, 2) padding in packed space is SAME's (2, 3) at even sizes
            self.conv_init_s2d = Conv(12, nf, 4, dtype=dtype,
                                      padding=((1, 2), (1, 2)))
        else:
            self.conv_init = Conv(3, nf, 7, 2, dtype)
        self.bn_init = BatchNorm(nf, dtype)
        blocks, cin = [], nf
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                filters = nf * 2 ** i
                blocks.append(block_cls(cin, filters,
                                        2 if i > 0 and j == 0 else 1, dtype))
                cin = 4 * filters
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)

    def init_weights(self, gen: torch.Generator) -> None:
        """Flax's initialisers, drawn from ``gen``: lecun-normal convs and
        head, BN scale 1 (0 on each block's last BN), zero biases."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (Conv, BatchNorm)):
                    m.init_weights(gen)
            lecun_normal_(self.head.weight, self.head.in_features, gen)
            self.head.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.space_to_depth:
            # [N, C, 2h, 2w] -> [N, 4C, h, w], channel = (dy*2 + dx)*C + c
            n, c, h, w = x.shape
            x = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(
                0, 3, 5, 1, 2, 4).reshape(n, 4 * c, h // 2, w // 2)
            x = self.conv_init_s2d(x.contiguous(
                memory_format=torch.channels_last))
        else:
            x = self.conv_init(x)
        x = max_pool(torch.relu(self.bn_init(x)))
        for block in self.blocks:
            x = block(x)
        x = x.float().mean((2, 3)).to(self.dtype)    # global average pool
        return self.head(x.float())


def _family(stages):
    def create(num_classes: int = 1000, dtype: torch.dtype = torch.float32,
               space_to_depth: bool = False, fused_conv: bool = False):
        return ResNet(stages, BottleneckBlock, num_classes=num_classes,
                      dtype=dtype, fused_conv=fused_conv,
                      space_to_depth=space_to_depth)
    return create


resnet50 = _family([3, 4, 6, 3])
resnet101 = _family([3, 4, 23, 3])
resnet152 = _family([3, 8, 36, 3])
