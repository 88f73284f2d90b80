"""Fused BN-apply + relu + 3x3 conv + BN stats: a CUDA kernel and its
plain version.

The ResNet bottleneck's hot pattern is ``conv -> BN -> relu -> conv``.
In training the first conv's raw output ``y1`` must exist before its BN
statistics do, but normalize + relu + the next 3x3 conv can run in one
pass, and that pass can also sum the conv's output per channel for the
NEXT BatchNorm::

    y2, s1, s2 = fused_bn_relu_conv(y1, a, b, w)

    xn = relu(y1 * a + b)          a, b: BN folded to scale/shift (f32)
    y2 = conv3x3(xn, w)            SAME, stride 1, zero halo after relu
    s1, s2 = sum(y2), sum(y2^2)    per channel, from the f32 accumulator

The kernel is an implicit GEMM that stages ``relu(y1*a+b)`` into shared
memory, so the normalized input never goes through device memory.
``fused_bn_relu_conv`` launches it for CUDA tensors and runs
``fused_bn_relu_conv_plain`` for CPU tensors.  It has three designs,
chosen by dtype and shape (``conv_design``): bf16 with Cin a multiple of
64 and W <= 62 runs ``csrc/fused_conv_sm90.cu`` (wgmma, 128 or 64 output
channels a block), the other bf16 shapes the WMMA kernel of
``csrc/fused_conv.cu``, and float32 that file's FMA kernel.  Layouts
are the JAX package's (``ops.fused_conv``): ``y1`` ``[N, H, W, Cin]``,
``w`` ``[3, 3, Cin, Cout]``, ``y2`` ``[N, H, W, Cout]`` in ``y1``'s dtype
(float32 or bfloat16); an NCHW tensor in ``channels_last`` is this
layout after ``permute(0, 2, 3, 1)``, without a copy.

The backward is the JAX ``custom_vjp``'s ``_bwd`` on library ops: the
stats cotangents fold into the output's, the conv transposes run in the
compute dtype, the relu mask and the BN-apply backward are elementwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_hc_bench_torch.obs import efficiency
from tpu_hc_bench_torch.ops import _build

__all__ = ["fused_bn_relu_conv", "fused_bn_relu_conv_plain", "eligible",
           "conv_design"]

_DTYPES = (torch.float32, torch.bfloat16)
_TILE_M = 128           # pixels (wgmma: padded positions) per block, kBM
_CIN_STEP = 32          # kBK of csrc/fused_conv.cu: Cin must be a multiple
_COUT_STEP = 64         # kBN: Cout must be a multiple
_WGMMA_MAX_W = 62       # the wgmma kernel's window, 128 + 2 (W + 2) rows,
                        # holds at most 256
# design -> the C entry's code
_DESIGNS = {"fma": 0, "wmma": 1, "wgmma_n128": 2, "wgmma_n64": 3}


def conv_design(dtype, width: int, cin: int, cout: int) -> str:
    """The kernel a CUDA call runs, by dtype and shape: ``"wgmma_n128"``
    (bf16, Cin % 64 == 0, W <= 62, Cout % 128 == 0) or ``"wgmma_n64"``
    (the same with Cout % 64 == 0 only) on ``csrc/fused_conv_sm90.cu``;
    ``"wmma"`` (the other bf16 shapes: Cin % 32 == 0) and ``"fma"``
    (float32) on ``csrc/fused_conv.cu``.  Raises for a shape no kernel
    takes."""
    if dtype not in _DTYPES:
        raise ValueError(f"no kernel for {dtype}")
    if cin % _CIN_STEP or cout % _COUT_STEP:
        raise ValueError(f"the kernel takes Cin % {_CIN_STEP} == 0 and "
                         f"Cout % {_COUT_STEP} == 0: {cin}, {cout}")
    if dtype == torch.float32:
        return "fma"
    if cin % 64 or width > _WGMMA_MAX_W:
        return "wmma"
    return "wgmma_n128" if cout % 128 == 0 else "wgmma_n64"


def _part_rows(design: str, n: int, h: int, w: int) -> int:
    """Rows of the per-block partial stats: one per block along the
    pixels, which the wgmma kernel numbers with a zero slot after every
    image row and a zero row after every image."""
    if design.startswith("wgmma"):
        return -(-n * (h + 1) * (w + 1) // _TILE_M)
    return -(-n * h * w // _TILE_M)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as the NCHW view PyTorch's convs take (no copy)."""
    return t.permute(0, 3, 1, 2)


def _validate(y1, a, b, w):
    if y1.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"y1 must be [N,H,W,Cin] and w [3,3,Cin,Cout]: "
                         f"{tuple(y1.shape)}, {tuple(w.shape)}")
    cin = y1.shape[-1]
    if w.shape[2] != cin or a.shape != (cin,) or b.shape != (cin,):
        raise ValueError(f"w [3,3,{cin},Cout] and a, b [{cin}] expected: "
                         f"{tuple(w.shape)}, {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if y1.dtype not in _DTYPES or w.dtype != y1.dtype:
        raise ValueError(f"y1 and w must share float32|bfloat16: "
                         f"{y1.dtype}, {w.dtype}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError("a and b (the folded BN) must be float32")


def fused_bn_relu_conv_plain(y1, a, b, w):
    """The plain PyTorch version, with the kernel's rounding rule: ``xn``
    rounded to ``y1``'s dtype, the conv summed in float32 (``F.conv2d``
    of the upcast operands), stats from that float32 result, ``y2`` its
    rounding.  Returns ``(y2, s1, s2)``."""
    _validate(y1, a, b, w)
    xn = torch.relu(y1.float() * a + b).to(y1.dtype)
    acc = F.conv2d(F.pad(_nchw(xn.float()), (1, 1, 1, 1)),
                   w.float().permute(3, 2, 0, 1))
    acc = acc.permute(0, 2, 3, 1)                   # back to NHWC
    return (acc.to(y1.dtype), acc.sum((0, 1, 2)),
            (acc * acc).sum((0, 1, 2)))


def _launch(y1, a, b, w):
    """The kernel on the card; raises on what it does not take."""
    for t in (a, b, w):
        if t.device != y1.device:
            raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in (y1, a, b, w)):
        raise ValueError("the kernel takes contiguous tensors (y1 NHWC, "
                         "w [3,3,Cin,Cout])")
    if any(t.data_ptr() % 16 for t in (y1, a, b, w)):
        raise ValueError("the kernel reads 16-byte vectors: every operand "
                         "must start on a 16-byte boundary")
    n, h, wd, cin = y1.shape
    cout = w.shape[-1]
    design = conv_design(y1.dtype, wd, cin, cout)
    y2 = torch.empty((n, h, wd, cout), dtype=y1.dtype, device=y1.device)
    rows = _part_rows(design, n, h, wd)
    part = torch.empty((2, rows, cout), dtype=torch.float32,
                       device=y1.device)
    stats = torch.empty((2, cout), dtype=torch.float32, device=y1.device)
    lib = _build.load_library()
    err = lib.thb_fused_bn_relu_conv(
        y1.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
        y2.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
        stats[0].data_ptr(), stats[1].data_ptr(), n, h, wd, cin, cout,
        _DESIGNS[design], rows, _build.stream_ptr(y1.device))
    _build.check(err, "fused_bn_relu_conv")
    fused_bn_relu_conv.launches += 1
    efficiency.kernel_ops(2.0 * n * h * wd * cout * 9 * cin)
    return y2, stats[0], stats[1]


class _FusedBNReluConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y1, a, b, w):
        _validate(y1, a, b, w)
        if y1.device.type == "cpu":
            y2, s1, s2 = fused_bn_relu_conv_plain(y1, a, b, w)
        elif y1.device.type == "cuda":
            y2, s1, s2 = _launch(y1, a, b, w)
        else:
            raise ValueError(f"no kernel for device {y1.device}")
        ctx.save_for_backward(y1, a, b, w, y2)
        return y2, s1, s2

    @staticmethod
    def backward(ctx, g_y, g_s1, g_s2):
        y1, a, b, w, y2 = ctx.saved_tensors
        # s1 = sum(y2), s2 = sum(y2^2)  =>  dy2 += g_s1 + 2 * y2 * g_s2
        # (autograd hands zeros for an output the loss does not use)
        geff = g_y.float() + g_s1 + 2.0 * y2.float() * g_s2
        xn_f = torch.relu(y1.float() * a + b)
        xn = xn_f.to(y1.dtype)
        geff_c = _nchw(geff.to(y1.dtype))
        # the conv's transposes in the compute dtype (the JAX _bwd's
        # linear_transpose of the same-dtype conv)
        w_oihw = w.permute(3, 2, 0, 1)
        dxn = torch.nn.grad.conv2d_input(
            _nchw(y1).shape, w_oihw, geff_c, padding=1).permute(0, 2, 3, 1)
        dw = torch.nn.grad.conv2d_weight(
            _nchw(xn), w_oihw.shape, geff_c, padding=1).permute(2, 3, 1, 0)
        # the relu mask as a select, as XLA computes JAX's ``dxn * (xn >
        # 0)`` (a product with a converted predicate becomes a select):
        # a NaN of dxn where the mask is off is dropped, not carried
        t = torch.where(xn_f > 0, dxn.float(), 0.0)
        dy1 = (t * a).to(y1.dtype)
        da = (t * y1.float()).sum((0, 1, 2))
        db = t.sum((0, 1, 2))
        return dy1, da, db, dw.to(w.dtype)


def fused_bn_relu_conv(y1, a, b, w):
    """``relu(y1 * a + b)`` convolved with ``w`` (3x3, SAME, stride 1).

    Args:
      y1: ``[N, H, W, Cin]`` float32 or bfloat16 (contiguous NHWC on the
        card, Cin a multiple of 32).
      a, b: ``[Cin]`` float32, the folded BN scale and shift.
      w: ``[3, 3, Cin, Cout]`` in ``y1``'s dtype (Cout a multiple of 64 on
        the card).
    Returns:
      ``(y2, s1, s2)``: ``y2`` ``[N, H, W, Cout]`` in ``y1``'s dtype and
      its per-channel sum and sum of squares (``[Cout]`` float32),
      differentiable in all three.
    """
    return _FusedBNReluConv.apply(y1, a, b, w)


# kernel launches in this process; a CPU call runs the plain version and
# is no launch
fused_bn_relu_conv.launches = 0


def eligible(shape: tuple, kernel: tuple, strides, cin: int) -> bool:
    """Where the JAX package routes the segment to its kernel (copied
    unchanged from ``ops/fused_conv.py``; the window was measured on a
    TPU at bs=128):

        56x56x 64: 1.07x (XLA already fuses; stays on XLA)
        28x28x128: 0.65x  WIN
        14x14x256: 0.64x  WIN
         7x7x512: 1.06x (tiny maps; stays on XLA)

    => 3x3 stride-1 square maps, >=128 input channels, >=14 spatial.
    ``shape`` is NHWC."""
    if tuple(kernel) != (3, 3):
        return False
    s = strides if isinstance(strides, int) else max(strides)
    if s != 1:
        return False
    if len(shape) != 4 or shape[1] != shape[2]:
        return False
    return cin >= 128 and shape[1] >= 14
