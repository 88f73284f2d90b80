"""Flash attention (blocked online softmax) with its backward: three CUDA
kernels and their plain version.

The port of the JAX package's ``ops/flash_attention.py``.  The forward
streams 64-key tiles past a 64-query tile with the online-softmax
recurrence and saves the row logsumexp; the backward recomputes the
probabilities tile by tile from it::

    S = Q K^T * scale              masked to -1e30 (key >= seq_k; under
                                   causal, a key after the query)
    m' = max(m, rowmax S);  P = where(visible, exp(S - m'), 0)
    l' = l e^(m - m') + rowsum P;  acc' = acc e^(m - m') + P V
    O = acc / max(l, 1e-30);  lse = m + log(max(l, 1e-30))

    D = rowsum(dO * O);  P = where(visible, exp(S - lse), 0)
    dS = P * (dO V^T - D) * scale
    dQ = dS K  (over key tiles);  dK = dS^T Q, dV = P^T dO  (over query
    tiles)

Rounding, as the Pallas kernels: scores and every sum in float32, ``P``
rounded to ``v``'s dtype before ``P V`` and ``P^T dO``, ``dS`` to the
input dtype before its two products, ``O`` and the gradients to the
input dtype at the end.

``flash_attention`` keeps the JAX signature, ``[b, s, h, d]`` in and
out.  For CUDA tensors it launches the forward, then dQ and dK/dV in the
backward, and counts each launch in ``flash_attention.launches``; for
CPU tensors it runs the plain version with 64-row tiles.  Each kernel
has two designs (``fwd_design``, ``bwd_design``): bf16 at head dims 64
and 128 runs the wgmma kernels, ``csrc/flash_fwd_sm90.cu`` (128-query
tiles against 128-key tiles at head dim 64 and 64-key tiles at 128,
``fwd_blocks``) and ``csrc/flash_bwd_sm90.cu`` (dQ over 128-query tiles
against 64-key tiles, dK/dV over 128-key tiles against 64-query tiles,
``bwd_blocks``); float32, and bf16 from head dim 256, run the FMA
kernels of ``csrc/flash_attention.cu`` (64-row tiles, 32-row from head
dim 256).
The kernels read ``q``,
``k``, ``v`` through their strides, so the views of one fused QKV
projection need no copy, and they mask the ragged last tile themselves:
no sequence padding either.

The kernels take head dim 64, 128, 256 or a multiple of 256 (the FMA
kernels loop over 256-wide chunks of the head dim for ``Q K^T`` and
``dO V^T`` and give each 256-wide column block of the outputs a block of
its own).  ``flash_attention`` zero-pads any other head dim on the last
axis (to 64 up to 64, to 128 up to 128, to 256 up to 256, else to the
next multiple of 256; ``padded_head_dim``) on both routes, with the scale
``1/sqrt(d)`` of the original ``d``, and slices ``o`` back (so its
gradient ``dO`` is padded and ``dQ``, ``dK``, ``dV`` sliced): exact,
since zero columns add nothing to ``Q K^T`` or ``dO V^T`` and give zero
columns in every output.  ``flash_attention_plain`` is the same blocked
algorithm in PyTorch with the block sizes as arguments, differentiable
through the same backward formulas.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_hc_bench_torch.obs import efficiency
from tpu_hc_bench_torch.ops import _build

__all__ = ["flash_attention", "flash_attention_plain", "flash_fwd",
           "flash_dq", "flash_dkv", "flash_fwd_plain", "flash_dq_plain",
           "flash_dkv_plain", "delta_rows", "fwd_design", "fwd_blocks",
           "bwd_design", "bwd_blocks", "padded_head_dim", "KERNELS"]

_NEG_INF = -1e30
_BLOCK = 64                     # kB in csrc/flash_attention.cu, d <= 128
_BLOCK_D256 = 32                # kB there at head dim 256
_HEAD_DIMS = (64, 128, 256)     # the kernels' template cases
_CHUNK = 256                    # above 256: multiples of it
_WGMMA_HEAD_DIMS = (64, 128)    # bf16 head dims on the wgmma kernels
_DTYPES = (torch.float32, torch.bfloat16)
KERNELS = ("fwd", "dq", "dkv")
_DESIGNS = {1: "fma", 2: "wgmma"}       # the C entries' design codes


def padded_head_dim(head_dim: int) -> int:
    """The kernels' head dim for ``head_dim``: 64 up to 64, 128 up to
    128, 256 up to 256, else the next multiple of 256 (the FMA kernels'
    256-wide chunks); below 1 raises."""
    if head_dim < 1:
        raise ValueError(f"flash attention takes a head_dim of at least 1: "
                         f"{head_dim}")
    if head_dim > _HEAD_DIMS[-1]:
        return _build.pad_up(head_dim, _CHUNK)
    return next(dp for dp in _HEAD_DIMS if head_dim <= dp)


def _design(dtype, what: str, head_dim: int | None) -> str:
    if dtype not in _DTYPES:
        raise ValueError(f"no {what} kernel for {dtype}")
    if dtype == torch.bfloat16 and (
            head_dim is None or padded_head_dim(head_dim) in _WGMMA_HEAD_DIMS):
        return "wgmma"
    return "fma"


def fwd_design(dtype, head_dim: int | None = None) -> str:
    """The forward kernel a CUDA call of this dtype (and head dim, padded
    by ``padded_head_dim``; the default is one of 64 and 128) runs:
    ``"wgmma"`` (bf16 up to 128, ``csrc/flash_fwd_sm90.cu``) or ``"fma"``
    (float32, and bf16 from 256, ``csrc/flash_attention.cu``)."""
    return _design(dtype, "forward", head_dim)


def bwd_design(dtype, head_dim: int | None = None) -> str:
    """The dQ and dK/dV kernels a CUDA call of this dtype (and head dim)
    runs: ``"wgmma"`` (bf16 up to 128, ``csrc/flash_bwd_sm90.cu``) or
    ``"fma"`` (float32, and bf16 from 256, ``csrc/flash_attention.cu``)."""
    return _design(dtype, "backward", head_dim)


def _fma_block(head_dim: int) -> int:
    return _BLOCK_D256 if padded_head_dim(head_dim) >= 256 else _BLOCK


def fwd_blocks(dtype, head_dim: int) -> tuple[int, int]:
    """``(block_q, block_k)`` of the forward kernel for this dtype and head
    dim (padded by ``padded_head_dim``): the tiles its plain version
    repeats."""
    d = padded_head_dim(head_dim)
    if fwd_design(dtype, d) == "fma":
        return _fma_block(d), _fma_block(d)
    return 128, 128 if d == 64 else 64


def bwd_blocks(dtype, head_dim: int) -> dict[str, tuple[int, int]]:
    """``{"dq": (block_q, block_k), "dkv": (block_q, block_k)}``: the tiles
    over which each backward kernel sums, for this dtype and head dim
    (padded by ``padded_head_dim``), at which its plain version repeats
    the kernel's f32 summation order.  The wgmma dQ kernel owns 128 query
    rows and sums over 64-key tiles; the dK/dV kernel owns 128 keys and
    sums over 64-query tiles; the FMA kernels take 64-row tiles, 32-row
    from head dim 256."""
    d = padded_head_dim(head_dim)
    if bwd_design(dtype, d) == "fma":
        blk = (_fma_block(d), _fma_block(d))
        return {"dq": blk, "dkv": blk}
    return {"dq": (128, 64), "dkv": (64, 128)}


def _scale(q, scale):
    return 1.0 / q.shape[-1] ** 0.5 if scale is None else float(scale)


def _validate(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q [b, sq, h, d] and k, v [b, sk, h, d] expected: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2],
                                                 k.shape[3]):
        raise ValueError(f"q and k must share batch, heads and head_dim: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share float32|bfloat16: {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")


# --- the plain version ----------------------------------------------------


def _fold(x):
    """[b, s, h, d] -> [b*h, s, d]."""
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)


def _unfold(x, b, h):
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).permute(0, 2, 1, 3)


def _visible(i0, nq, j0, nk, sq, sk, causal, device):
    """[nq, nk] bool: query i0.., key j0.. in range and causally visible."""
    qpos = torch.arange(i0, i0 + nq, device=device)[:, None]
    kpos = torch.arange(j0, j0 + nk, device=device)[None, :]
    m = (kpos < sk) & (qpos < sq)
    return m & (qpos >= kpos) if causal else m


def _live(i0, bq, j0, causal):
    """The JAX ``_tile_live``: a causal tile holds a visible element."""
    return not causal or i0 + bq > j0


def flash_fwd_plain(q, k, v, causal=False, scale=None, block_q=_BLOCK,
                    block_k=_BLOCK):
    """The forward's plain version: ``(o [b, sq, h, d], lse [b, h, sq]
    float32)``."""
    _validate(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = _scale(q, scale)
    qf, kf, vf = _fold(q), _fold(k), _fold(v)
    outs, lses = [], []
    for i0 in range(0, sq, block_q):
        qi = qf[:, i0:i0 + block_q].float()
        nq = qi.shape[1]
        m = torch.full((b * h, nq, 1), _NEG_INF, device=q.device)
        l = torch.zeros((b * h, nq, 1), device=q.device)
        acc = torch.zeros((b * h, nq, d), device=q.device)
        for j0 in range(0, sk, block_k):
            if not _live(i0, block_q, j0, causal):
                break
            kj = kf[:, j0:j0 + block_k]
            vis = _visible(i0, nq, j0, kj.shape[1], sq, sk, causal, q.device)
            s = qi @ kj.float().transpose(1, 2) * scale
            s = torch.where(vis, s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(vis, torch.exp(s - m_new), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p.to(v.dtype).float() @ vf[
                :, j0:j0 + block_k].float()
            m = m_new
        l = l.clamp_min(1e-30)
        outs.append((acc / l).to(q.dtype))
        lses.append((m + torch.log(l))[..., 0])
    o = _unfold(torch.cat(outs, 1), b, h)
    return o, torch.cat(lses, 1).reshape(b, h, sq)


def delta_rows(o, do):
    """``D = rowsum(dO * O)`` in float32, ``[b, h, sq]``: a plain torch
    reduction on both routes, as JAX computes it outside its kernels."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _p_and_ds(qi, kj, vj, doi, lse_i, delta_i, vis, scale, dtype):
    """The backward's shared recompute for one tile (JAX ``_p_and_ds``):
    ``P`` and ``dS`` in ``dtype``, from float32 sums."""
    s = qi.float() @ kj.float().transpose(1, 2) * scale
    p = torch.where(vis, torch.exp(s - lse_i[..., None]), 0.0)
    dp = doi.float() @ vj.float().transpose(1, 2)
    ds = (p * (dp - delta_i[..., None]) * scale).to(dtype)
    return p.to(dtype), ds


def _bwd_operands(q, k, v, do, lse, delta):
    b, sq, h, d = q.shape
    return (_fold(q), _fold(k), _fold(v), _fold(do),
            lse.reshape(b * h, sq), delta.reshape(b * h, sq))


def flash_dq_plain(q, k, v, do, lse, delta, causal=False, scale=None,
                   block_q=_BLOCK, block_k=_BLOCK):
    """The dQ pass's plain version: ``dq [b, sq, h, d]``, summed over key
    tiles in order."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = _scale(q, scale)
    qf, kf, vf, dof, lsef, deltaf = _bwd_operands(q, k, v, do, lse, delta)
    out = []
    for i0 in range(0, sq, block_q):
        nq = qf[:, i0:i0 + block_q].shape[1]
        acc = torch.zeros((b * h, nq, d), device=q.device)
        for j0 in range(0, sk, block_k):
            if not _live(i0, block_q, j0, causal):
                break
            kj = kf[:, j0:j0 + block_k]
            vis = _visible(i0, nq, j0, kj.shape[1], sq, sk, causal, q.device)
            _, ds = _p_and_ds(qf[:, i0:i0 + block_q], kj,
                              vf[:, j0:j0 + block_k],
                              dof[:, i0:i0 + block_q],
                              lsef[:, i0:i0 + block_q],
                              deltaf[:, i0:i0 + block_q], vis, scale,
                              q.dtype)
            acc = acc + ds.float() @ kj.float()
        out.append(acc.to(q.dtype))
    return _unfold(torch.cat(out, 1), b, h)


def flash_dkv_plain(q, k, v, do, lse, delta, causal=False, scale=None,
                    block_q=_BLOCK, block_k=_BLOCK):
    """The dK/dV pass's plain version: ``(dk, dv)`` ``[b, sk, h, d]``,
    summed over query tiles in order, from the diagonal on."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = _scale(q, scale)
    qf, kf, vf, dof, lsef, deltaf = _bwd_operands(q, k, v, do, lse, delta)
    dks, dvs = [], []
    for j0 in range(0, sk, block_k):
        kj, vj = kf[:, j0:j0 + block_k], vf[:, j0:j0 + block_k]
        nk = kj.shape[1]
        dk = torch.zeros((b * h, nk, d), device=q.device)
        dv = torch.zeros((b * h, nk, d), device=q.device)
        for i0 in range(0, sq, block_q):
            if not _live(i0, block_q, j0, causal):
                continue
            qi, doi = qf[:, i0:i0 + block_q], dof[:, i0:i0 + block_q]
            vis = _visible(i0, qi.shape[1], j0, nk, sq, sk, causal, q.device)
            p, ds = _p_and_ds(qi, kj, vj, doi, lsef[:, i0:i0 + block_q],
                              deltaf[:, i0:i0 + block_q], vis, scale,
                              q.dtype)
            dv = dv + p.float().transpose(1, 2) @ doi.float()
            dk = dk + ds.float().transpose(1, 2) @ qi.float()
        dks.append(dk.to(k.dtype))
        dvs.append(dv.to(v.dtype))
    return (_unfold(torch.cat(dks, 1), b, h),
            _unfold(torch.cat(dvs, 1), b, h))


# --- the kernels ------------------------------------------------------------


def _qkv_strides(q, k, v):
    out = []
    for t in (q, k, v):
        sb, ss, sh, sd = t.stride()
        if sd != 1:
            raise ValueError("the kernels read rows of head_dim contiguous "
                             "elements: last stride must be 1")
        out += [sb, ss, sh]
    return out


def _check_card(q, k, v, do=None, lse=None, delta=None):
    rows = [t for t in (lse, delta) if t is not None]
    rest = [] if do is None else [do]
    for t in (k, v, *rest, *rows):
        if t.device != q.device:
            raise ValueError("all operands must be on one device")
    b, sq, h, d = q.shape
    for t in rows:
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                tuple(t.shape) != (b, h, sq):
            raise ValueError(f"lse and delta must be contiguous float32 "
                             f"[{b}, {h}, {sq}]")
    if do is not None and (not do.is_contiguous() or do.shape != q.shape
                           or do.dtype != q.dtype):
        raise ValueError("do must be contiguous and shaped and typed as q")
    if d not in _HEAD_DIMS and not (d > _CHUNK and d % _CHUNK == 0):
        raise ValueError(f"the kernels take head_dim 64, 128, 256 or a "
                         f"multiple of 256 (flash_attention zero-pads other "
                         f"head dims to them): {d}")
    vec = 16 // q.element_size()
    for t in (q, k, v, *rest):
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:-1]):
            raise ValueError("the kernels read 16-byte vectors: every "
                             "operand and its batch, sequence and head "
                             "strides must be 16-byte aligned")


def _rows_major(t):
    """``t`` as the kernels read it: last stride 1 and 16-byte aligned
    strides and start (a copy only when a view does not qualify)."""
    vec = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:-1])):
        return t
    return t.contiguous()


def _dims(q, k):
    b, sq, h, d = q.shape
    return b, h, sq, k.shape[1], d


def flash_fwd(q, k, v, causal=False, scale=None):
    """The forward kernel on the card: ``(o [b, sq, h, d] contiguous, lse
    [b, h, sq] float32)``."""
    _validate(q, k, v)
    _check_card(q, k, v)
    b, h, sq, sk, d = _dims(q, k)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    design = ctypes.c_int(0)
    err = _build.load_library().thb_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, sq, sk, d, *_qkv_strides(q, k, v),
        _scale(q, scale), int(causal), int(q.dtype == torch.bfloat16),
        ctypes.byref(design), _build.stream_ptr(q.device))
    _build.check(err, "flash_attention forward")
    _check_design(design, fwd_design(q.dtype, d), "fwd")
    flash_attention.launches["fwd"] += 1
    efficiency.kernel_ops(4.0 * b * h * efficiency.attn_pairs(sq, sk, causal)
                          * d)
    return o, lse


def _check_design(design, want, kernel):
    """Raise unless the C entry ran the ``want`` design; record it."""
    ran = _DESIGNS.get(design.value)
    if ran != want:
        raise RuntimeError(f"flash_attention {kernel} ran design "
                           f"{design.value}, not {want}")
    flash_attention.designs[kernel] = ran


def flash_dq(q, k, v, do, lse, delta, causal=False, scale=None):
    """The dQ kernel on the card; ``do`` contiguous ``[b, sq, h, d]``."""
    _check_card(q, k, v, do, lse, delta)
    b, h, sq, sk, d = _dims(q, k)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    design = ctypes.c_int(0)
    err = _build.load_library().thb_flash_attention_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, sq, sk, d,
        *_qkv_strides(q, k, v), _scale(q, scale), int(causal),
        int(q.dtype == torch.bfloat16), ctypes.byref(design),
        _build.stream_ptr(q.device))
    _build.check(err, "flash_attention dQ")
    _check_design(design, bwd_design(q.dtype, d), "dq")
    flash_attention.launches["dq"] += 1
    efficiency.kernel_ops(6.0 * b * h * efficiency.attn_pairs(sq, sk, causal)
                          * d)
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal=False, scale=None):
    """The dK/dV kernel on the card; returns ``(dk, dv)``."""
    _check_card(q, k, v, do, lse, delta)
    b, h, sq, sk, d = _dims(q, k)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=q.device)
    design = ctypes.c_int(0)
    err = _build.load_library().thb_flash_attention_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h,
        sq, sk, d, *_qkv_strides(q, k, v), _scale(q, scale), int(causal),
        int(q.dtype == torch.bfloat16), ctypes.byref(design),
        _build.stream_ptr(q.device))
    _build.check(err, "flash_attention dK/dV")
    _check_design(design, bwd_design(q.dtype, d), "dkv")
    flash_attention.launches["dkv"] += 1
    efficiency.kernel_ops(8.0 * b * h * efficiency.attn_pairs(sq, sk, causal)
                          * d)
    return dk, dv


# --- autograd ------------------------------------------------------------


def _route(t):
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


class _Flash(torch.autograd.Function):
    """Kernels on the card, the plain version with the caller's tiles
    (64 rows from ``flash_attention``) on the CPU; one save, one backward
    formula."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k, card):
        if card:
            q, k, v = _rows_major(q), _rows_major(k), _rows_major(v)
            o, lse = flash_fwd(q, k, v, causal, scale)
        else:
            o, lse = flash_fwd_plain(q, k, v, causal, scale, block_q,
                                     block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, block_q, block_k, card)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, block_q, block_k, card = ctx.args
        delta = delta_rows(o, do)
        if card:
            do = do.contiguous()
            dq = flash_dq(q, k, v, do, lse, delta, causal, scale)
            dk, dv = flash_dkv(q, k, v, do, lse, delta, causal, scale)
        else:
            dq = flash_dq_plain(q, k, v, do, lse, delta, causal, scale,
                                block_q, block_k)
            dk, dv = flash_dkv_plain(q, k, v, do, lse, delta, causal, scale,
                                     block_q, block_k)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: float | None = None):
    """Memory-efficient attention; drop-in for ``dense_attention``.

    Args:
      q: ``[batch, seq_q, heads, head_dim]`` float32 or bfloat16.
      k, v: ``[batch, seq_k, heads, head_dim]`` in ``q``'s dtype.
      causal: mask keys after the query's position (both from 0).
      scale: score scale; default ``1/sqrt(head_dim)``.
    Returns:
      ``[batch, seq_q, heads, head_dim]`` in ``q``'s dtype, differentiable
      in ``q``, ``k`` and ``v``.  Any head_dim, zero-padded to the
      kernels' 64, 128, 256 or a multiple of 256 (``padded_head_dim``).
    """
    _validate(q, k, v)
    return _padded_apply(q, k, v, causal, scale, _BLOCK, _BLOCK, _route(q))


def _padded_apply(q, k, v, causal, scale, block_q, block_k, card):
    """``_Flash`` at the padded head dim, ``o`` sliced back; the scale is
    taken from the original head dim before padding."""
    d = q.shape[-1]
    dp = padded_head_dim(d)
    scale = _scale(q, scale)
    if dp != d:
        q, k, v = (torch.nn.functional.pad(t, (0, dp - d)) for t in (q, k, v))
    o = _Flash.apply(q, k, v, causal, scale, block_q, block_k, card)
    return o if dp == d else o[..., :d]


# kernel launches in this process, per kernel; a CPU call runs the plain
# version and is no launch
flash_attention.launches = dict.fromkeys(KERNELS, 0)
# the design each kernel's last launch ran ("wgmma" or "fma")
flash_attention.designs = dict.fromkeys(KERNELS)


def flash_attention_plain(q, k, v, causal: bool = False,
                          scale: float | None = None,
                          block_q: int = _BLOCK, block_k: int = _BLOCK):
    """The plain version of ``flash_attention`` on any device, with the
    tile sizes as arguments and the same head-dim padding; differentiable
    through the plain backward."""
    _validate(q, k, v)
    return _padded_apply(q, k, v, causal, scale, block_q, block_k, False)
