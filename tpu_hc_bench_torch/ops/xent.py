"""Softmax cross-entropy with integer labels: a CUDA forward and backward
kernel and their plain version.

The port of the JAX package's ``ops/xent.py``.  The forward streams the
vocab with the online logsumexp recurrence and saves the row logsumexp;
the backward recomputes ``softmax - onehot`` from it::

    m' = max(m, max(block));  s' = s e^(m - m') + sum e^(block - m')
    lse = m + log(s);  loss = lse - logits[label]
    dlogits = (exp(logits - lse) - onehot(label)) * g

Everything in float32 whatever the logits' dtype; ``dlogits`` is rounded
once to the logits' dtype.  A label outside ``[0, V)`` contributes no
label logit and no one-hot, as the JAX kernel's iota compare gives.

``softmax_xent`` keeps the JAX signature, ``[N, V]`` logits and ``[N]``
labels in, ``[N]`` float32 losses out.  For CUDA tensors it launches
``csrc/xent.cu`` (the forward, and the backward in the backward pass) and
counts each launch in ``softmax_xent.launches``; for CPU tensors it runs
the plain version.  The kernels mask the ragged vocab tail themselves:
no padding copy of the logits, where the JAX op pads them to multiples
of 128 x 512.  ``softmax_xent_plain`` is the same blocked algorithm in
PyTorch (a loop over 512-column vocab blocks, every row at once),
differentiable through the same backward; ``softmax_xent_reference`` is
the straight-line ``logsumexp - take`` of the JAX package.
"""

from __future__ import annotations

import torch

from tpu_hc_bench_torch.obs import efficiency
from tpu_hc_bench_torch.ops import _build

__all__ = ["softmax_xent", "softmax_xent_plain", "softmax_xent_reference",
           "xent_fwd", "xent_bwd", "xent_fwd_plain", "xent_bwd_plain",
           "KERNELS"]

_NEG_INF = -1e30
_BLOCK_VOCAB = 512              # the JAX kernel's vocab block
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNELS = ("fwd", "bwd")


def _validate(logits, labels):
    if logits.dim() != 2 or logits.shape[1] < 1:
        raise ValueError(f"logits must be [N, V] with V >= 1: "
                         f"{tuple(logits.shape)}")
    if logits.dtype not in _DTYPES:
        raise ValueError(f"logits must be float32|bfloat16: "
                         f"{logits.dtype}")
    if (labels.dim() != 1 or labels.shape[0] != logits.shape[0]
            or labels.dtype.is_floating_point or labels.dtype == torch.bool):
        raise ValueError(f"labels must be [N] integer ids: "
                         f"{tuple(labels.shape)} {labels.dtype}")
    if labels.device != logits.device:
        raise ValueError("logits and labels must be on one device")


def _label_logits(logits, labels):
    """``logits[row, label]`` in float32, 0 where the label is outside
    ``[0, V)``."""
    v = logits.shape[1]
    valid = (labels >= 0) & (labels < v)
    c = logits.gather(1, labels.clamp(0, v - 1).long()[:, None])[:, 0]
    return torch.where(valid, c.float(), 0.0)


# --- the plain version ----------------------------------------------------


def xent_fwd_plain(logits, labels, block: int = _BLOCK_VOCAB):
    """The forward's plain version: ``(loss [N], lse [N])`` float32, the
    online logsumexp over ``block``-column vocab blocks."""
    n, v = logits.shape
    m = torch.full((n,), _NEG_INF, device=logits.device)
    s = torch.zeros((n,), device=logits.device)
    for j0 in range(0, v, block):
        blk = logits[:, j0:j0 + block].float()
        m_new = torch.maximum(m, blk.amax(1))
        s = s * torch.exp(m - m_new) + torch.exp(blk - m_new[:, None]).sum(1)
        m = m_new
    lse = m + torch.log(s)
    return lse - _label_logits(logits, labels), lse


def xent_bwd_plain(logits, labels, lse, g, block: int = _BLOCK_VOCAB):
    """The backward's plain version: ``dlogits [N, V]`` in the logits'
    dtype, block by block."""
    n, v = logits.shape
    out = torch.empty_like(logits)
    lse, g = lse[:, None], g.float()[:, None]
    for j0 in range(0, v, block):
        blk = logits[:, j0:j0 + block].float()
        cols = torch.arange(j0, j0 + blk.shape[1], device=logits.device)
        onehot = (cols[None, :] == labels[:, None]).float()
        out[:, j0:j0 + block] = ((torch.exp(blk - lse) - onehot) * g).to(
            logits.dtype)
    return out


def softmax_xent_reference(logits, labels):
    """The straight-line reference (the JAX ``softmax_xent_reference``):
    ``logsumexp - logits[label]`` in float32."""
    return torch.logsumexp(logits.float(), -1) - _label_logits(logits,
                                                               labels)


# --- the kernels ------------------------------------------------------------


def _check_card(logits, labels):
    if not logits.is_contiguous() or not labels.is_contiguous():
        raise ValueError("the kernels read contiguous logits and labels")
    if labels.dtype != torch.int64:
        raise ValueError(f"the kernels read int64 labels: {labels.dtype}")
    if logits.shape[1] >= 2 ** 31 or logits.shape[0] >= 2 ** 31:
        raise ValueError(f"N and V must be < 2^31: {tuple(logits.shape)}")


def xent_fwd(logits, labels):
    """The forward kernel on the card: ``(loss [N], lse [N])`` float32;
    ``logits`` and int64 ``labels`` contiguous."""
    _validate(logits, labels)
    _check_card(logits, labels)
    n, v = logits.shape
    loss = torch.empty((n,), dtype=torch.float32, device=logits.device)
    lse = torch.empty((n,), dtype=torch.float32, device=logits.device)
    err = _build.load_library().thb_softmax_xent_fwd(
        logits.data_ptr(), labels.data_ptr(), loss.data_ptr(),
        lse.data_ptr(), n, v, _DTYPES[logits.dtype],
        _build.stream_ptr(logits.device))
    _build.check(err, "softmax_xent forward")
    softmax_xent.launches["fwd"] += 1
    efficiency.kernel_ops(4.0 * n * v)
    return loss, lse


def xent_bwd(logits, labels, lse, g):
    """The backward kernel on the card: ``dlogits`` in the logits' dtype;
    ``lse`` and ``g`` contiguous float32 ``[N]``."""
    _check_card(logits, labels)
    n, v = logits.shape
    for t in (lse, g):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != (n,) or t.device != logits.device):
            raise ValueError(f"lse and g must be contiguous float32 [{n}] "
                             "on the logits' device")
    dlogits = torch.empty_like(logits)
    err = _build.load_library().thb_softmax_xent_bwd(
        logits.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
        dlogits.data_ptr(), n, v, _DTYPES[logits.dtype],
        _build.stream_ptr(logits.device))
    _build.check(err, "softmax_xent backward")
    softmax_xent.launches["bwd"] += 1
    efficiency.kernel_ops(4.0 * n * v)
    return dlogits


# --- autograd ------------------------------------------------------------


def _route(t):
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


class _Xent(torch.autograd.Function):
    """Kernels on the card, the plain version on the CPU; one save (the
    JAX ``_xent_fwd`` residuals: logits, labels, lse), one backward."""

    @staticmethod
    def forward(ctx, logits, labels, card):
        if card:
            logits = logits.contiguous()
            labels = labels.to(torch.int64).contiguous()
            loss, lse = xent_fwd(logits, labels)
        else:
            loss, lse = xent_fwd_plain(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        ctx.card = card
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        g = g.float().contiguous()
        if ctx.card:
            dlogits = xent_bwd(logits, labels, lse, g)
        else:
            dlogits = xent_bwd_plain(logits, labels, lse, g)
        return dlogits, None, None


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row cross-entropy through the blocked kernels.

    Args:
      logits: ``[N, V]`` float32 or bfloat16 (float32 math).
      labels: ``[N]`` integer class ids in ``[0, V)``.
    Returns:
      ``[N]`` float32 losses, ``logsumexp(logits) - logits[label]``,
      differentiable in ``logits``.
    """
    _validate(logits, labels)
    return _Xent.apply(logits, labels, _route(logits))


# kernel launches in this process, per kernel; a CPU call runs the plain
# version and is no launch
softmax_xent.launches = dict.fromkeys(KERNELS, 0)


def softmax_xent_plain(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """The plain version of ``softmax_xent`` on any device,
    differentiable through the plain backward."""
    _validate(logits, labels)
    return _Xent.apply(logits, labels, False)
