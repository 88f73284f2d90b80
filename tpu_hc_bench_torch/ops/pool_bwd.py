"""Max-pool with a CUDA backward kernel, and the kernel's plain version.

The port of the JAX package's ``ops/pool_bwd.py``: ``max_pool(x, window,
strides, padding)``, whose forward is the plain ``-inf``-padded max-pool
(XLA's ``reduce_window`` in JAX, not a kernel) and whose backward is a
kernel with the JAX op's tie rule: every element equal to its window's
max receives the window's full cotangent::

    dx[i] = sum over the windows o that cover i of (x[i] == y[o]) * dy[o]

(compared and summed in float32, ``dx`` in x's dtype), where torch's own
max-pool backward, like XLA's select-and-scatter, routes it to the first
max only.  The two agree wherever no window ties.

Layout: ``x`` is the port's image layout, ``[B, C, H, W]`` (the kernel
reads NHWC memory: a ``channels_last`` tensor goes in as it is, any other
is copied to it); ``padding`` is ``"SAME"`` (the JAX split, the smaller
half before) or ``"VALID"``.

Dispatch, as the JAX ``_pool_bwd``: a stride above the window (input
rows no window covers), a dtype that is not floating, or an input that
holds ``-inf`` takes torch's own max-pool backward, with first-max
routing.  Otherwise a CUDA tensor launches ``csrc/pool_bwd.cu`` (counted
in ``max_pool.launches``; 16-byte vectors over the channels of a pixel,
scalar accesses where C is not a multiple of the vector, template cases
for the 3x3/2 and 3x3/1 pools) and a CPU tensor runs
``max_pool_bwd_plain``, the equality-mask sum over the window's taps in
the kernel's order.  The TPU's VMEM budget (``_channel_tile``) has no
counterpart: the CUDA kernel takes any size.  No model calls the op, as
in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_hc_bench_torch.ops import _build

__all__ = ["max_pool", "max_pool_bwd", "max_pool_bwd_plain",
           "max_pool_bwd_kernel", "pool_dims"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _same_pad(size: int, window: int, stride: int) -> tuple[int, int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return out, total // 2, total - total // 2


def pool_dims(hw: tuple[int, int], window, strides, padding):
    """``(Ho, Wo, (top, bottom, left, right))``: the output extent and the
    padding of a ``[.., H, W]`` input, as ``lax.reduce_window`` pads."""
    (h, w), (wh, ww), (sh, sw) = hw, window, strides
    if padding == "SAME":
        ho, top, bottom = _same_pad(h, wh, sh)
        wo, left, right = _same_pad(w, ww, sw)
        return ho, wo, (top, bottom, left, right)
    if padding == "VALID":
        return (h - wh) // sh + 1, (w - ww) // sw + 1, (0, 0, 0, 0)
    raise ValueError(f"padding must be SAME|VALID: {padding!r}")


def _pool_fwd(x, window, strides, padding):
    """The plain max-pool: ``-inf`` (an integer type's minimum) padding."""
    _, _, (top, bottom, left, right) = pool_dims(x.shape[2:], window,
                                                 strides, padding)
    fill = (float("-inf") if x.dtype.is_floating_point
            else torch.iinfo(x.dtype).min)
    xp = F.pad(x, (left, right, top, bottom), value=fill)
    return F.max_pool2d(xp, tuple(window), tuple(strides))


# --- the plain version ----------------------------------------------------


def max_pool_bwd_plain(x, y, dy, window=(3, 3), strides=(2, 2),
                       padding="SAME"):
    """The kernel's plain version: the equality-mask sum over the
    window's taps, tap row then tap column, in float32; ``dx`` in x's
    dtype.  ``-inf`` pads never equal a window's max (the caller routes
    inputs that hold ``-inf``)."""
    (wh, ww), (sh, sw) = window, strides
    ho, wo, (top, bottom, left, right) = pool_dims(x.shape[2:], window,
                                                   strides, padding)
    h, w = x.shape[2:]
    xp = F.pad(x.float(), (left, right, top, bottom), value=float("-inf"))
    yf, dyf = y.float(), dy.float()
    acc = torch.zeros_like(xp)
    for ki in range(wh):
        rows = slice(ki, ki + (ho - 1) * sh + 1, sh)
        for kj in range(ww):
            cols = slice(kj, kj + (wo - 1) * sw + 1, sw)
            acc[:, :, rows, cols] += torch.where(xp[:, :, rows, cols] == yf,
                                                 dyf, 0.0)
    dx = acc[:, :, top:top + h, left:left + w].to(x.dtype)
    return dx.contiguous(memory_format=torch.channels_last)


# --- the kernel -------------------------------------------------------------


def max_pool_bwd_kernel(x, y, dy, window=(3, 3), strides=(2, 2),
                        padding="SAME"):
    """The backward kernel on the card: ``dx`` ``[B, C, H, W]`` in
    ``channels_last`` memory."""
    if x.dtype not in _DTYPES or y.dtype != x.dtype or dy.dtype != x.dtype:
        raise ValueError(f"x, y, dy must share float32|bfloat16: "
                         f"{x.dtype}, {y.dtype}, {dy.dtype}")
    if not (x.device == y.device == dy.device):
        raise ValueError("x, y and dy must be on one device")
    b, c, h, w = x.shape
    ho, wo, (top, _, left, _) = pool_dims((h, w), window, strides, padding)
    if tuple(y.shape) != (b, c, ho, wo) or dy.shape != y.shape:
        raise ValueError(f"y and dy must be [{b}, {c}, {ho}, {wo}]: "
                         f"{tuple(y.shape)}, {tuple(dy.shape)}")
    if b > 65535:
        raise ValueError(f"the kernel's grid takes B <= 65535: "
                         f"{tuple(x.shape)}")
    cl = torch.channels_last
    x, y, dy = (t.contiguous(memory_format=cl) for t in (x, y, dy))
    dx = torch.empty_like(x, memory_format=cl)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, y, dy, dx))
    err = _build.load_library().thb_max_pool_bwd(
        x.data_ptr(), y.data_ptr(), dy.data_ptr(), dx.data_ptr(), b, h, w, c,
        ho, wo, *window, *strides, top, left, int(aligned), _DTYPES[x.dtype],
        _build.stream_ptr(x.device))
    _build.check(err, "max_pool backward")
    max_pool.launches += 1
    return dx


# --- dispatch and autograd ----------------------------------------------


def _torch_pool_vjp(x, dy, window, strides, padding):
    """torch's own max-pool backward (first-max routing).  An integer
    input runs on its float32 image (exact below 2^24; max selection
    only compares) and the cotangent is cast back, as in JAX."""
    if not x.dtype.is_floating_point:
        return _torch_pool_vjp(x.float(), dy.float(), window, strides,
                               padding).to(x.dtype)
    with torch.enable_grad():
        xr = x.detach().requires_grad_()
        y = _pool_fwd(xr, window, strides, padding)
        (dx,) = torch.autograd.grad(y, xr, dy.to(y.dtype))
    return dx


def max_pool_bwd(x, y, dy, window=(3, 3), strides=(2, 2), padding="SAME"):
    """The VJP rule of ``max_pool`` (the JAX ``_pool_bwd``): ``dx`` from
    the saved ``x`` and ``y`` and the cotangent ``dy``."""
    if (window[0] < strides[0] or window[1] < strides[1]
            or not x.dtype.is_floating_point
            or bool(torch.isneginf(x).any())):
        return _torch_pool_vjp(x, dy, window, strides, padding)
    dy = dy.to(y.dtype)
    if x.device.type == "cuda":
        return max_pool_bwd_kernel(x, y, dy, window, strides, padding)
    if x.device.type == "cpu":
        return max_pool_bwd_plain(x, y, dy, window, strides, padding)
    raise ValueError(f"no kernel for device {x.device}")


class _MaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, window, strides, padding):
        y = _pool_fwd(x, window, strides, padding)
        ctx.save_for_backward(x, y)
        ctx.args = (window, strides, padding)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        return max_pool_bwd(x, y, dy, *ctx.args), None, None, None


def max_pool(x: torch.Tensor, window=(3, 3), strides=(2, 2),
             padding: str = "SAME") -> torch.Tensor:
    """``[B, C, H, W]`` max-pool whose backward splits ties (the JAX
    ``max_pool``): the forward is the plain ``-inf``-padded pool, the
    backward the CUDA kernel on the card and its plain version on the
    CPU, or torch's own where the JAX op takes XLA's."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B, C, H, W]: {tuple(x.shape)}")
    window, strides = tuple(window), tuple(strides)
    pool_dims(x.shape[2:], window, strides, padding)     # checks padding
    return _MaxPool.apply(x, window, strides, padding)


# kernel launches in this process; a CPU call runs the plain version and
# is no launch
max_pool.launches = 0
