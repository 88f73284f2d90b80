"""The ResNet family in PyTorch, and the image zoo's shared layers.

The counterpart of the JAX package's ``models/resnet.py``: the 7x7/s2
stem (or its space-to-depth 4x4/s1 form), a 3x3/s2 SAME max-pool, then
v1.5 bottleneck blocks (resnet50/101/152, the stride on the 3x3),
two-3x3 basic blocks (resnet18/34) or full-preactivation bottlenecks
(the v2 members: no BN after the stem, BN-relu before every conv and a
``bn_final`` BN-relu before the pool), a global mean-pool and a float32
head.  Tensors are NCHW in ``channels_last`` memory, which is the JAX
package's NHWC byte for byte.

The layers every image member shares live here too: ``Conv`` (Flax
``nn.Conv``: any kernel, SAME, VALID or explicit padding, a bias,
feature groups), ``BatchNorm`` (any momentum and epsilon),
``max_pool`` and ``avg_pool`` (Flax's, SAME or VALID; ``avg_pool``
counts the zero padding, as Flax's ``count_include_pad=True`` does) and
``flax_init_``, Flax's initialisers over a model.

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
- **Sync-BN.** A batch's statistics are its per-channel ``(sum, sumsq,
  count)``, then ``mean = sum / count`` (``mean`` on the CPU is that sum
  and division, bit for bit).  With ``sync`` set on a BatchNorm (the
  data-parallel ``replicated`` arm: JAX's GSPMD step normalizes over the
  global batch) the three are summed over the ranks first, by
  ``sync_sum``, an all-reduce whose backward all-reduces the gradient,
  so every rank also carries the global statistics' gradient.  Over one
  rank it is the identity, bit for bit.

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
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tpu_hc_bench_torch.ops import fused_conv as fc

__all__ = ["BasicBlock", "BatchNorm", "BottleneckBlock", "Conv",
           "FlaxInit", "FusedBNReluConv3x3", "FusedBottleneckBlock",
           "PreactBottleneckBlock", "ResNet", "StatsBatchNorm", "avg_pool",
           "flatten_nhwc", "flax_init_", "global_pool", "max_pool",
           "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "running_stats_frozen", "same_pads", "sync_sum"]

_C = (1, -1, 1, 1)      # a [C] vector broadcast over NCHW
_DIMS = (0, 2, 3)       # a channel's values in NCHW

# all-reduce calls of ``sync_sum``, forward and backward; the train step
# reads and clears it
sync_calls = 0


def _allreduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the default group's ranks, in a new tensor; a
    card's tensor takes the host round trip where the group is gloo."""
    global sync_calls
    sync_calls += 1
    if t.is_cuda and dist.get_backend() == "gloo":
        host = t.cpu()
        dist.all_reduce(host)
        return host.to(t.device)
    out = t.clone()
    dist.all_reduce(out)
    return out


class _SyncSum(torch.autograd.Function):
    """The sum over the ranks; its gradient is the sum of every rank's
    gradient of that sum (each rank's loss depends on every rank's
    input through it)."""

    @staticmethod
    def forward(ctx, t):
        return _allreduce_sum(t)

    @staticmethod
    def backward(ctx, g):
        return _allreduce_sum(g)


def sync_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks of the default process group, with
    the backward of a global sum (one all-reduce each way)."""
    return _SyncSum.apply(t)


def batch_moments(bn: "BatchNorm", s1: torch.Tensor, s2: torch.Tensor,
                  n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mean, E[x^2])`` from a batch's per-channel float32 ``sum`` and
    ``sumsq`` over ``n`` values, summed over the ranks first where
    ``bn.sync`` is set.  Both routes divide by the count as a tensor, so
    over one rank they agree bit for bit.  A float32 count is exact
    while its odd part is below 2**24 (a count is batch x H x W, and its
    sum over ranks a multiple of it)."""
    c = s1.shape[0]
    tot = torch.cat([s1, s2, s1.new_full((1,), float(n))])
    if bn.sync:
        tot = sync_sum(tot)
    count = tot[2 * c]
    return tot[:c] / count, tot[c:2 * c] / count


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


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _pads(x: torch.Tensor, k, s, padding) -> tuple:
    """``((top, bottom), (left, right))`` of a window ``k`` at strides
    ``s`` over ``x``'s spatial dims: ``"SAME"`` (XLA's rule),
    ``"VALID"``, or explicit pairs."""
    if padding == "SAME":
        return (same_pads(x.shape[2], k[0], s[0]),
                same_pads(x.shape[3], k[1], s[1]))
    if padding == "VALID":
        return (0, 0), (0, 0)
    return padding


class Conv(nn.Module):
    """Flax ``nn.Conv`` in ``dtype``: a ``k`` (int or ``(kh, kw)``)
    window at ``stride``, ``padding`` ``"SAME"`` (XLA's rule; None
    means SAME), ``"VALID"`` or ``((top, bottom), (left, right))``;
    ``groups`` is Flax's ``feature_group_count``, and ``bias`` adds a
    bias in ``dtype`` after the product, as Flax does."""

    def __init__(self, cin: int, cout: int, k, stride=1,
                 dtype: torch.dtype = torch.float32, padding=None,
                 bias: bool = False, groups: int = 1):
        super().__init__()
        self.kernel, self.strides = _pair(k), _pair(stride)
        self.weight = nn.Parameter(torch.empty(cout, cin // groups,
                                               *self.kernel))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.dtype, self.groups = stride, dtype, groups
        self.padding = padding or "SAME"

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        """The conv of an input already in ``dtype``."""
        (t, bt), (l, r) = _pads(x, self.kernel, self.strides, self.padding)
        w = self.weight.to(self.dtype)
        if t == bt and l == r:
            y = F.conv2d(x, w, stride=self.strides, padding=(t, l),
                         groups=self.groups)
        else:
            y = F.conv2d(F.pad(x, (l, r, t, bt)), w, stride=self.strides,
                         groups=self.groups)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype).view(_C)
        return y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x.to(self.dtype))

    def init_weights(self, gen: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), gen)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()


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
        self.sync = False              # statistics over every rank

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
            mean, sq = batch_moments(self, xf.sum(_DIMS), (xf * xf).sum(_DIMS),
                                     xf.numel() // xf.shape[1])
            var = torch.clamp(sq - mean * mean, min=0.0)
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
    unclamped), over every rank under ``bn.sync``, and the running
    averages updated in training mode."""
    if not bn.training:
        mean, var = bn.running_mean, bn.running_var
    else:
        if stats is None:
            xf = x.float()
            stats = xf.sum(_DIMS), (xf * xf).sum(_DIMS)
        mean, sq = batch_moments(bn, *stats,
                                 x.shape[0] * x.shape[2] * x.shape[3])
        var = sq - mean * mean
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
    expansion = 4

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


def max_pool(x: torch.Tensor, k=3, s=2,
             padding: str = "SAME") -> torch.Tensor:
    """Flax ``nn.max_pool(x, k, s, padding)``: -inf padding."""
    k, s = _pair(k), _pair(s)
    (t, b), (l, r) = _pads(x, k, s, padding)
    if t or b or l or r:
        x = F.pad(x, (l, r, t, b), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def avg_pool(x: torch.Tensor, k, s=None,
             padding: str = "VALID") -> torch.Tensor:
    """Flax ``nn.avg_pool(x, k, s, padding)``: every window's sum over
    the window's size, zero padding counted (``count_include_pad``)."""
    k = _pair(k)
    s = _pair(s) if s is not None else (1, 1)
    (t, b), (l, r) = _pads(x, k, s, padding)
    if t == b and l == r:
        return F.avg_pool2d(x, k, s, padding=(t, l))
    return F.avg_pool2d(F.pad(x, (l, r, t, b)), k, s)


def global_pool(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``jnp.mean(x, axis=(1, 2))`` of an NHWC array in ``dtype``:
    float32 sums, the mean rounded to ``dtype``."""
    return x.float().mean((2, 3)).to(dtype)


def flax_init_(model: nn.Module, gen: torch.Generator) -> None:
    """Flax's initialisers over ``model``, drawn from ``gen`` in module
    order: lecun-normal conv, Dense and ``nn.Linear`` kernels, zero
    biases, BatchNorm scale 1 (0 where ``zero_init``), and any other
    module's own ``init_weights`` (a transformer layer's, a LayerNorm's)
    where it has one."""
    done: set[int] = set()
    with torch.no_grad():
        for m in model.modules():
            if m is model or id(m) in done:
                continue
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.in_features, gen)
                m.bias.zero_()
            elif hasattr(m, "init_weights"):
                m.init_weights(gen)
                done.update(id(c) for c in m.modules())


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Flax's ``x.reshape((n, -1))`` of an NHWC map: the NCHW tensor's
    values in (h, w, c) order, so a Dense converted from Flax sees its
    rows in their order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class FlaxInit(nn.Module):
    """A model whose ``init_weights(gen)`` is ``flax_init_``."""

    def init_weights(self, gen: torch.Generator) -> None:
        flax_init_(self, gen)


class BasicBlock(nn.Module):
    """The two-3x3 block of resnet18/34 (and the CIFAR resnets): 3x3
    (stride) -> BN -> relu -> 3x3 -> BN, a projection shortcut where the
    shape changes; the last BN's scale starts at 0."""

    expansion = 1

    def __init__(self, cin: int, filters: int, strides: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(cin, filters, 3, strides, dtype)
        self.bn1 = BatchNorm(filters, dtype)
        self.conv2 = Conv(filters, filters, 3, dtype=dtype)
        self.bn2 = BatchNorm(filters, dtype, zero_init=True)
        self.shortcut_conv = self.shortcut_bn = None
        if cin != filters or strides != 1:
            self.shortcut_conv = Conv(cin, filters, 1, strides, dtype)
            self.shortcut_bn = BatchNorm(filters, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.shortcut_conv is not None:
            x = self.shortcut_bn(self.shortcut_conv(x))
        return torch.relu(x + y)


class PreactBottleneckBlock(nn.Module):
    """ResNet-v2 bottleneck (full preactivation): BN-relu before every
    conv, the projection shortcut on the preactivated input, no
    activation after the sum."""

    expansion = 4

    def __init__(self, cin: int, filters: int, strides: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = 4 * filters
        self.bn1 = BatchNorm(cin, dtype)
        self.conv1 = Conv(cin, filters, 1, dtype=dtype)
        self.bn2 = BatchNorm(filters, dtype)
        self.conv2 = Conv(filters, filters, 3, strides, dtype)
        self.bn3 = BatchNorm(filters, dtype)
        self.conv3 = Conv(filters, out, 1, dtype=dtype)
        self.shortcut_conv = None
        if cin != out or strides != 1:
            self.shortcut_conv = Conv(cin, out, 1, strides, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pre = torch.relu(self.bn1(x))
        residual = (x if self.shortcut_conv is None
                    else self.shortcut_conv(pre))
        y = torch.relu(self.bn2(self.conv1(pre)))
        y = torch.relu(self.bn3(self.conv2(y)))
        return residual + self.conv3(y)


class ResNet(FlaxInit):
    """ImageNet ResNet of ``block_cls`` blocks (``BottleneckBlock``,
    ``BasicBlock`` or ``PreactBottleneckBlock``, the v2 arm); takes NCHW
    images (any float dtype) and returns float32 logits."""

    def __init__(self, stage_sizes: Sequence[int],
                 block_cls: type = BottleneckBlock, num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.float32,
                 fused_conv: bool = False, space_to_depth: bool = False):
        super().__init__()
        if fused_conv:
            if block_cls is not BottleneckBlock:
                raise ValueError("fused_conv applies to the v1 bottleneck "
                                 "family (resnet50/101/152) only")
            block_cls = FusedBottleneckBlock
        self.dtype, self.space_to_depth = dtype, space_to_depth
        self.preact = block_cls is PreactBottleneckBlock
        nf = num_filters
        if space_to_depth:
            # the 7x7/s2 stem as a 4x4/s1 conv over 2x2-packed pixels;
            # (1, 2) padding in packed space is SAME's (2, 3) at even sizes
            self.conv_init_s2d = Conv(12, nf, 4, dtype=dtype,
                                      padding=((1, 2), (1, 2)))
        else:
            self.conv_init = Conv(3, nf, 7, 2, dtype)
        if not self.preact:
            self.bn_init = BatchNorm(nf, dtype)
        blocks, cin = [], nf
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                filters = nf * 2 ** i
                blocks.append(block_cls(cin, filters,
                                        2 if i > 0 and j == 0 else 1, dtype))
                cin = block_cls.expansion * filters
        self.blocks = nn.ModuleList(blocks)
        if self.preact:
            self.bn_final = BatchNorm(cin, dtype)
        self.head = nn.Linear(cin, num_classes)

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
        if not self.preact:
            x = torch.relu(self.bn_init(x))
        x = max_pool(x)
        for block in self.blocks:
            x = block(x)
        if self.preact:
            x = torch.relu(self.bn_final(x))
        return self.head(global_pool(x, self.dtype).float())


def _family(stages, block_cls=BottleneckBlock):
    def create(num_classes: int = 1000, dtype: torch.dtype = torch.float32,
               space_to_depth: bool = False, fused_conv: bool = False):
        return ResNet(stages, block_cls, num_classes=num_classes,
                      dtype=dtype, fused_conv=fused_conv,
                      space_to_depth=space_to_depth)
    return create


resnet18 = _family([2, 2, 2, 2], BasicBlock)
resnet34 = _family([3, 4, 6, 3], BasicBlock)
resnet50 = _family([3, 4, 6, 3])
resnet101 = _family([3, 4, 23, 3])
resnet152 = _family([3, 8, 36, 3])
resnet50_v2 = _family([3, 4, 6, 3], PreactBottleneckBlock)
resnet101_v2 = _family([3, 4, 23, 3], PreactBottleneckBlock)
resnet152_v2 = _family([3, 8, 36, 3], PreactBottleneckBlock)
