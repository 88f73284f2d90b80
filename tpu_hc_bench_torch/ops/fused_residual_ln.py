"""Fused residual add + layer normalization: a CUDA kernel and its plain
version.

Every pre-norm decoder layer does ``x = x + branch; h = norm(x)``.
Fused, the sum is computed once and both the new residual stream and
its normalized view leave the kernel together: one read of each input,
one write of each output (``csrc/fused_residual_norm.cu``).

``fused_residual_norm`` takes the kernel for a CUDA tensor and the plain
version (``fused_residual_norm_plain``) for a CPU tensor.  Numerics
follow the JAX package's ``ops.fused_residual_ln``: ``y`` in ``res``'s
dtype, its statistics in float32 from ``y`` as rounded, Flax
``LayerNorm``'s fast variance ``E[x^2] - E[x]^2`` clamped at 0 (eps
1e-6, with a bias) or Llama's ``RMSNorm`` (eps 1e-5, scale only), ``out``
in ``res``'s dtype.

The kernel has two launches (``norm_design``): ``"warp"`` gives each row
a team of 1 to 16 warps of one block, and ``"cluster"`` splits each row
over a thread-block cluster of 2 to 8 CTAs (``norm_launch`` sizes each).
On an H100 the warp design is the faster at every row count of llama_1b's
2048 (``chip_smoke.py`` phase 2): at a decode step's 8 rows the time is
launch and one device-memory round trip, and the cluster barrier adds to
it; at the warp design's widest rows (32 KB) the two are within a few
percent.  So the cluster design runs the rows wider than that.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tpu_hc_bench_torch.ops import _build

__all__ = ["fused_residual_norm", "fused_residual_norm_plain",
           "norm_design", "norm_launch", "NormLaunch", "KINDS", "DESIGNS",
           "empty_launch"]

KINDS = ("layernorm", "rmsnorm")
DESIGNS = ("cluster", "warp")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_THREADS = 512              # kMaxThreads in the kernel's source
_CLUSTER_SIZES = (8, 4, 2)
_MIN_CTA_VECTORS = 64           # a cluster CTA: at least two warps' worth
_WARP_ELEMENTS = 8              # values a thread of the warp design aims at
_VECTORS = (1, 2, 4)            # the kernel's template cases


class NormLaunch(NamedTuple):
    """How the kernel runs one design: ``cluster`` CTAs a row (1 for
    ``"warp"``), ``threads`` a block, ``team`` threads of a block a row,
    ``vectors`` 16-byte vectors a thread."""
    design: str
    cluster: int
    threads: int
    team: int
    vectors: int


def _per_thread(nvec: int, threads_cap: int) -> tuple[int, int] | None:
    """(threads, vectors a thread) for ``nvec`` vectors over at most
    ``threads_cap`` threads, a whole number of warps; None if 4 vectors a
    thread do not reach."""
    for nv in _VECTORS:
        threads = _build.pad_up(-(-nvec // nv), 32)
        if threads <= threads_cap:
            return threads, nv
    return None


@functools.lru_cache(maxsize=None)
def norm_launch(hidden: int, dtype, design: str) -> NormLaunch | None:
    """The launch of ``design`` for rows of ``hidden`` values of
    ``dtype``, or None where the design does not take that width.

    ``"cluster"``: the largest cluster of 8, 4 or 2 CTAs that leaves each
    CTA at least 64 of the row's 16-byte vectors, one vector a thread
    (up to 4 where 512 threads do not hold the slice).  ``"warp"``: a
    team of 1 to 16 warps a row, sized so a thread holds about 8 values
    (2 vectors in float32, 1 in bf16; up to 4 where 16 warps do not
    hold the row), at least 256 threads a block."""
    v = 16 // torch.empty((), dtype=dtype).element_size()
    nvec = -(-hidden // v)
    if design == "cluster":
        for c in _CLUSTER_SIZES:
            if nvec >= _MIN_CTA_VECTORS * c:
                fit = _per_thread(-(-nvec // c), _MAX_THREADS)
                if fit is None:
                    return None
                return NormLaunch("cluster", c, fit[0], fit[0], fit[1])
        return None
    if design == "warp":
        aim = max(1, _WARP_ELEMENTS // v)
        warps = 1
        while 32 * warps * aim < nvec and warps < _MAX_THREADS // 32:
            warps *= 2
        fit = _per_thread(nvec, 32 * warps)
        if fit is None:
            return None
        team = 32 * warps
        return NormLaunch("warp", 1, max(256, team), team, fit[1])
    raise ValueError(f"design must be cluster|warp: {design!r}")


def norm_design(rows: int, hidden: int, dtype) -> str:
    """The design a CUDA call of ``rows`` rows of ``hidden`` runs:
    ``"warp"`` wherever it takes the width, ``"cluster"`` for rows wider
    than 16 warps of 4 vectors (32 KB); raises for a width neither takes.
    At every count of rows, since the warp design was the faster at 1 to
    512 rows of 2048 and neither clearly so at 1 and 8 rows of 32 KB
    (``chip_smoke.py`` phase 2 on an H100, PERF.md)."""
    if dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16: {dtype}")
    cluster = norm_launch(hidden, dtype, "cluster")
    warp = norm_launch(hidden, dtype, "warp")
    if cluster is None and warp is None:
        raise ValueError(f"hidden={hidden} is wider than the kernel takes "
                         f"({8 * _MAX_THREADS * 4} 16-byte vectors)")
    return "warp" if warp is not None else "cluster"


def _validate(res, x, gamma, beta, kind, eps):
    if kind not in KINDS:
        raise ValueError(f"kind must be layernorm|rmsnorm: {kind!r}")
    if kind == "layernorm" and beta is None:
        raise ValueError("layernorm needs beta (bias); rmsnorm is the "
                         "scale-only form")
    if res.shape != x.shape:
        raise ValueError(f"res {tuple(res.shape)} and x {tuple(x.shape)} "
                         "must have one shape")
    h = res.shape[-1]
    if gamma.shape != (h,) or (beta is not None and beta.shape != (h,)):
        raise ValueError(f"gamma/beta must be [{h}]")
    return (1e-6 if kind == "layernorm" else 1e-5) if eps is None else eps


def fused_residual_norm_plain(res, x, gamma, beta=None, *,
                              kind: str = "layernorm",
                              eps: float | None = None):
    """The plain PyTorch version of the kernel, same arguments."""
    eps = _validate(res, x, gamma, beta, kind, eps)
    y = res + x
    f = y.float()
    if kind == "layernorm":
        mu = f.mean(-1, keepdim=True)
        var = torch.clamp((f * f).mean(-1, keepdim=True) - mu * mu, min=0.0)
        o = (f - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    else:
        var = (f * f).mean(-1, keepdim=True)
        o = f * torch.rsqrt(var + eps) * gamma.float()
    return y, o.to(res.dtype)


def fused_residual_norm(res, x, gamma, beta=None, *,
                        kind: str = "layernorm", eps: float | None = None,
                        design: str | None = None):
    """``y = res + x``; ``out = norm(y)`` in one kernel.

    Args:
      res: the residual stream, ``[..., hidden]`` float32 or bfloat16.
      x: the branch output to add, same shape and dtype.
      gamma: ``[hidden]`` norm scale, in ``res``'s dtype or float32.
      beta: ``[hidden]`` bias (layernorm only; None for rmsnorm), in
        ``gamma``'s dtype.
      kind: ``"layernorm"`` or ``"rmsnorm"``.
      eps: override the kind's default epsilon.
      design: ``"cluster"`` or ``"warp"`` instead of ``norm_design``'s
        choice (a CUDA call only).
    Returns:
      ``(y, out)``, both in ``res``'s dtype and shape.
    """
    if not res.is_cuda:
        if res.device.type == "cpu":
            return fused_residual_norm_plain(res, x, gamma, beta, kind=kind,
                                             eps=eps)
        raise ValueError(f"no kernel for device {res.device}")
    eps = _validate(res, x, gamma, beta, kind, eps)
    dt = _DTYPES.get(res.dtype)
    if dt is None or x.dtype != res.dtype:
        raise ValueError(f"the kernel takes float32 or bfloat16 res and x "
                         f"of one dtype: {res.dtype}, {x.dtype}")
    if gamma.dtype not in (res.dtype, torch.float32) or (
            beta is not None and beta.dtype != gamma.dtype):
        raise ValueError(f"gamma and beta must share res's dtype or "
                         f"float32: {gamma.dtype}")
    tensors = (res, x, gamma) if beta is None else (res, x, gamma, beta)
    index = res.get_device()
    for t in tensors:
        if t.get_device() != index:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    h = res.shape[-1]
    rows = res.numel() // h if h else 0
    y = torch.empty_like(res)
    out = torch.empty_like(res)
    if rows == 0:
        return y, out
    name = norm_design(rows, h, res.dtype) if design is None else design
    launch = norm_launch(h, res.dtype, name)
    if launch is None:
        raise ValueError(f"the {name} design does not take hidden={h}")
    ptrs = [t.data_ptr() for t in tensors]
    vec = h % (16 // res.element_size()) == 0 and not any(
        p % 16 for p in ptrs)
    err = _build.load_library().thb_fused_residual_norm(
        ptrs[0], ptrs[1], ptrs[2], None if beta is None else ptrs[3],
        y.data_ptr(), out.data_ptr(), rows, h, eps,
        kind == "layernorm", dt, dt != 0 and gamma.dtype == torch.float32,
        launch.cluster, launch.threads, launch.team, launch.vectors, vec,
        _build.stream_ptr(res.device))
    _build.check(err, "fused_residual_norm")
    fused_residual_norm.launches += 1
    fused_residual_norm.design = name
    return y, out


def empty_launch(device, cluster: int = 1) -> None:
    """Launch an empty kernel on ``cluster`` CTAs (one cluster when
    above 1): the floor under the kernel's time on the card."""
    _build.check(_build.load_library().thb_empty_launch(
        int(cluster), _build.stream_ptr(device)), "empty launch")


# kernel launches in this process; a CPU call runs the plain version and
# is no launch
fused_residual_norm.launches = 0
# the design the last launch ran ("cluster" or "warp")
fused_residual_norm.design = None
