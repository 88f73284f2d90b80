"""Fused residual add + layer normalization: a CUDA kernel and its plain
version.

Every pre-norm decoder layer does ``x = x + branch; h = norm(x)``.
Fused, the sum is computed once and both the new residual stream and
its normalized view leave the kernel together: one read of each input,
one write of each output (``csrc/fused_residual_norm.cu``).

``fused_residual_norm`` takes the kernel for a CUDA tensor and the plain
version (``fused_residual_norm_plain``) for a CPU tensor.  Numerics
follow the JAX package's ``ops.fused_residual_ln``: Flax ``LayerNorm``'s
fast variance ``E[x^2] - E[x]^2`` clamped at 0 (eps 1e-6, with a bias)
or Llama's ``RMSNorm`` (eps 1e-5, scale only), stats in float32.
"""

from __future__ import annotations

import torch

from tpu_hc_bench_torch.ops import _build

KINDS = ("layernorm", "rmsnorm")
_SMEM_LIMIT = 227 * 1024        # dynamic shared memory a Hopper block may use


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
                        kind: str = "layernorm", eps: float | None = None):
    """``y = res + x``; ``out = norm(y)`` in one kernel.

    Args:
      res: the residual stream, ``[..., hidden]`` float32.
      x: the branch output to add, same shape.
      gamma: ``[hidden]`` norm scale.
      beta: ``[hidden]`` bias (layernorm only; None for rmsnorm).
      kind: ``"layernorm"`` or ``"rmsnorm"``.
      eps: override the kind's default epsilon.
    Returns:
      ``(y, out)``, both in ``res``'s dtype and shape.
    """
    if res.device.type == "cpu":
        return fused_residual_norm_plain(res, x, gamma, beta, kind=kind,
                                         eps=eps)
    eps = _validate(res, x, gamma, beta, kind, eps)
    if res.device.type != "cuda":
        raise ValueError(f"no kernel for device {res.device}")
    tensors = (res, x, gamma) + ((beta,) if beta is not None else ())
    for t in tensors:
        if t.device != res.device:
            raise ValueError("all operands must be on one device")
        if t.dtype != torch.float32:
            raise ValueError(f"the kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    h = res.shape[-1]
    if 4 * (h + 32) > _SMEM_LIMIT:
        raise ValueError(f"hidden={h} does not fit one block's shared "
                         f"memory ({_SMEM_LIMIT} B)")
    rows = res.numel() // h if h else 0
    y = torch.empty_like(res)
    out = torch.empty_like(res)
    if rows == 0:
        return y, out
    lib = _build.load_library()
    err = lib.thb_fused_residual_norm(
        res.data_ptr(), x.data_ptr(), gamma.data_ptr(),
        beta.data_ptr() if beta is not None else None,
        y.data_ptr(), out.data_ptr(), rows, h, float(eps),
        int(kind == "layernorm"), _build.stream_ptr(res.device))
    _build.check(err, "fused_residual_norm")
    fused_residual_norm.launches += 1
    return y, out


# kernel launches in this process; a CPU call runs the plain version and
# is no launch
fused_residual_norm.launches = 0
