"""Paged single-query decode attention: a CUDA kernel and its plain
version.

The serving lane's decode step attends one fresh query token per
request over that request's KV cache, which lives in a shared paged
pool (``[layers, pages, page_size, kv_heads, head_dim]`` plus an int32
page table per request).  The kernel (``csrc/paged_attention.cu``)
reads K/V straight through the page tables with an online softmax over
the pages, so no dense per-request cache is ever gathered; it returns
the logsumexp of the scores, so the caller can merge the fresh token
(not yet in the pool) without a second pass.

``paged_decode_attention`` takes the kernel for CUDA tensors and the
plain version (``paged_decode_attention_plain``) for CPU tensors.  Both
hold the numerics of the JAX package's ``ops.paged_attention``: masked
scores are -1e30, probabilities are masked again after ``exp``, the sum
is floored at 1e-30 and ``lse = m + log(l)``.  A row of length 0 (a
padded batch slot) gives out 0 and a finite lse near -1e30.
"""

from __future__ import annotations

import torch

from tpu_hc_bench_torch.ops import _build

_NEG_INF = -1e30
_SMEM_LIMIT = 227 * 1024        # dynamic shared memory a Hopper block may use


def _prepare(q, k_pages, v_pages, tables, lengths, scale, pages_per_block,
             k_scales, v_scales, layer):
    """Shared validation: returns the 5-D pools, scales, layer, the
    clamped block size and the score scale (the JAX package's checks)."""
    if k_pages.dim() == 4:
        k_pages, v_pages = k_pages[None], v_pages[None]
        if k_scales is not None:
            k_scales, v_scales = k_scales[None], v_scales[None]
        layer = 0
    if q.dim() != 3 or k_pages.dim() != 5:
        raise ValueError("q must be [b, heads, d] and the pools "
                         "[layers, pages, page_size, kv_heads, d]")
    b, heads, d = q.shape
    kv_heads = k_pages.shape[3]
    if heads % kv_heads:
        raise ValueError(f"heads={heads} not a multiple of "
                         f"kv_heads={kv_heads}")
    if k_pages.shape != v_pages.shape or k_pages.shape[4] != d:
        raise ValueError(f"pools {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} do not match q's d={d}")
    quantized = k_pages.dtype == torch.int8
    if quantized and (k_scales is None or v_scales is None):
        raise ValueError("int8 KV pool needs k_scales/v_scales "
                         "([layers, pages] f32 per-page scales)")
    if tables.dim() != 2 or tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError("tables must be [b, w] and lengths [b]")
    layer = int(layer)
    if not 0 <= layer < k_pages.shape[0]:
        raise ValueError(f"layer {layer} outside the pool's "
                         f"{k_pages.shape[0]} layers")
    scale = (1.0 / d ** 0.5) if scale is None else float(scale)
    ppb = max(1, min(int(pages_per_block), tables.shape[1]))
    return (k_pages, v_pages, k_scales, v_scales, layer, quantized, ppb,
            scale)


def paged_decode_attention_plain(q, k_pages, v_pages, tables, lengths,
                                 scale: float | None = None,
                                 pages_per_block: int = 1,
                                 k_scales=None, v_scales=None,
                                 layer: int = 0,
                                 return_lse: bool = False):
    """The plain PyTorch version of the kernel, same arguments: gathers
    the tables' pages and runs the masked softmax in one pass (the
    result equals the kernel's page-by-page online softmax)."""
    (k_pages, v_pages, k_scales, v_scales, layer, quantized, _,
     scale) = _prepare(q, k_pages, v_pages, tables, lengths, scale,
                       pages_per_block, k_scales, v_scales, layer)
    b, heads, d = q.shape
    _, _, ps, kvh, _ = k_pages.shape
    w = tables.shape[1]
    group = heads // kvh
    tbl = tables.long()
    kc = k_pages[layer][tbl].float()                  # [b, w, ps, kvh, d]
    vc = v_pages[layer][tbl].float()
    if quantized:
        kc = kc * k_scales[layer][tbl][:, :, None, None, None]
        vc = vc * v_scales[layer][tbl][:, :, None, None, None]
    kc = kc.reshape(b, w * ps, kvh, d)
    vc = vc.reshape(b, w * ps, kvh, d)
    qg = q.float().reshape(b, kvh, group, d)
    s = torch.einsum("bhgd,bthd->bhgt", qg, kc) * scale
    visible = (torch.arange(w * ps, device=q.device)[None, :]
               < lengths[:, None].long())[:, None, None, :]
    s = torch.where(visible, s, torch.full_like(s, _NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(visible, torch.exp(s - m), torch.zeros_like(s))
    l = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhgt,bthd->bhgd", p, vc) / l
    out = out.reshape(b, heads, d).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).reshape(b, heads)
    return out


def paged_decode_attention(q, k_pages, v_pages, tables, lengths,
                           scale: float | None = None,
                           pages_per_block: int = 1,
                           k_scales=None, v_scales=None,
                           layer: int = 0,
                           return_lse: bool = False):
    """Single-query attention over a paged KV pool, no dense gather.

    Args:
      q: ``[b, heads, head_dim]`` float32, one query token per row.
      k_pages, v_pages: ``[layers, pages, page_size, kv_heads, head_dim]``
        pool (a 4-D single-layer pool is accepted too), float32, or int8
        with ``*_scales``.
      tables: ``[b, w]`` int32 page tables (slot t holds tokens
        ``t*page_size..``); every slot holds a valid pool index (page 0,
        the trash page, covers unused slots).
      lengths: ``[b]`` int32 valid tokens per row, at most
        ``w * page_size``.
      scale: score scale; default ``1/sqrt(head_dim)``.
      pages_per_block: table slots the kernel stages per loop step.
      k_scales, v_scales: ``[layers, pages]`` float32 per-page dequant
        scales (``[pages]`` for a 4-D pool), required iff int8.
      layer: index into the pool's leading dim (``k_pages[l]`` is a view
        in PyTorch, so the whole pool is passed only to keep one
        signature with the JAX package).
      return_lse: also return the per-row logsumexp of the scores.
    Returns:
      ``[b, heads, head_dim]`` float32; with ``return_lse``, a
      ``(out, lse [b, heads] float32)`` pair.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, tables, lengths, scale, pages_per_block,
            k_scales, v_scales, layer, return_lse)
    (k_pages, v_pages, k_scales, v_scales, layer, quantized, ppb,
     scale) = _prepare(q, k_pages, v_pages, tables, lengths, scale,
                       pages_per_block, k_scales, v_scales, layer)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    b, heads, d = q.shape
    num_layers, pages, ps, kvh, _ = k_pages.shape
    w = tables.shape[1]
    operands = [(q, torch.float32), (tables, torch.int32),
                (lengths, torch.int32),
                (k_pages, torch.int8 if quantized else torch.float32),
                (v_pages, torch.int8 if quantized else torch.float32)]
    if quantized:
        operands += [(k_scales, torch.float32), (v_scales, torch.float32)]
        if (k_scales.shape != (num_layers, pages)
                or v_scales.shape != (num_layers, pages)):
            raise ValueError(f"scales must be [{num_layers}, {pages}]")
    for t, dtype in operands:
        if t.device != q.device:
            raise ValueError("all operands must be on one device")
        if t.dtype != dtype:
            raise ValueError(f"the kernel takes {dtype} here, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    group = heads // kvh
    tile = ppb * ps
    smem = 4 * (2 * tile * d + 2 * group * d + group * tile + 3 * group)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"pages_per_block={ppb} x page_size={ps} needs "
                         f"{smem} B of shared memory (> {_SMEM_LIMIT})")
    out = torch.empty((b, heads, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, heads), dtype=torch.float32, device=q.device)
    if b:
        lib = _build.load_library()
        err = lib.thb_paged_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if quantized else None,
            v_scales.data_ptr() if quantized else None,
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, heads, kvh, d, pages, ps, w, ppb, layer,
            scale, int(quantized), _build.stream_ptr(q.device))
        _build.check(err, "paged_decode_attention")
        paged_decode_attention.launches += 1
    if return_lse:
        return out, lse
    return out


# kernel launches in this process; a CPU call runs the plain version and
# is no launch
paged_decode_attention.launches = 0
