"""Paged single-query decode attention: CUDA kernels and their plain
version.

The serving lane's decode step attends one fresh query token per
request over that request's KV cache, which lives in a shared paged
pool (``[layers, pages, page_size, kv_heads, head_dim]`` plus an int32
page table per request).  The kernels (``csrc/paged_attention.cu``)
read K/V straight through the page tables, so no dense per-request
cache is ever gathered, and return the logsumexp of the scores, so the
caller can merge the fresh token (not yet in the pool) without a second
pass.  A call launches two kernels (``KERNELS``): the first splits each
row's table into ``paged_splits`` contiguous ranges of slots, one block
each, and writes every split's partial softmax (m, l, acc) to a float32
workspace; the second merges the splits of each row and kv head in
split order into ``out`` and ``lse``.

``paged_decode_attention`` takes the kernels for CUDA tensors and the
plain version (``paged_decode_attention_plain``) for CPU tensors.  Both
hold the numerics of the JAX package's ``ops.paged_attention``: masked
scores are -1e30, probabilities are masked again after ``exp``, the sum
is floored at 1e-30 and ``lse = m + log(l)``; for a bf16 pool ``p`` is
rounded to bf16 before ``P V``; ``out`` takes q's dtype.  A row of
length 0 (a padded batch slot) gives out 0 and a finite lse near
-1e30.  The plain version with ``splits`` repeats the kernels'
split-and-merge; without, it is one masked softmax over the gathered
pages.
"""

from __future__ import annotations

import functools

import torch

from tpu_hc_bench_torch.ops import _build

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "paged_splits", "split_slots", "split_ranges", "KERNELS"]

_NEG_INF = -1e30
KERNELS = ("paged_decode_split_kernel", "paged_decode_merge_kernel")
# split blocks paged_splits aims for an SM (4 measured faster than 2 at
# llama_1b's decode shape and at a long context on an H100)
BLOCKS_PER_SM = 4
MIN_SPLIT_TOKENS = 64           # a split keeps at least this many tokens
_HEAD_DIMS = (16, 32, 64, 128, 256)     # the kernels' template cases
_MAX_HEAD_DIM = 256             # any other d up to it runs masked
_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_Q_DTYPES = (torch.float32, torch.bfloat16)


def paged_splits(b: int, kv_heads: int, w: int, page_size: int,
                 pages_per_block: int, sm_count: int) -> int:
    """How many ranges of table slots the split kernel gives each (row,
    kv head): enough blocks to fill about ``BLOCKS_PER_SM`` blocks an SM,
    at least ``MIN_SPLIT_TOKENS`` tokens (whole pages) a split, and no
    split without a slot of the table (``split_slots``); at least 1."""
    ppb = max(1, min(int(pages_per_block), max(w, 1)))
    nblk = max(1, -(-w // ppb))                  # blocks of ppb slots
    want = -(-BLOCKS_PER_SM * max(int(sm_count), 1) // max(b * kv_heads, 1))
    min_pages = max(1, -(-MIN_SPLIT_TOKENS // max(int(page_size), 1)))
    most = max(1, nblk * ppb // max(min_pages, ppb))
    return _normalized(nblk, max(1, min(want, most, nblk)))


def _normalized(nblk: int, splits: int) -> int:
    """The split count once every split holds ``ceil(nblk / splits)``
    slot blocks: the last split is the only short one, none is empty."""
    per = -(-nblk // max(1, min(splits, nblk)))
    return -(-nblk // per)


def split_slots(w: int, pages_per_block: int, splits: int) -> tuple[int,
                                                                     int]:
    """``(splits, slots a split)`` for a table of ``w`` slots: each split
    takes the same whole number of ``pages_per_block`` blocks of slots,
    the last fewer; ``splits`` is cut to the count that leaves none
    empty."""
    ppb = max(1, min(int(pages_per_block), max(w, 1)))
    nblk = max(1, -(-w // ppb))
    splits = _normalized(nblk, int(splits))
    return splits, ppb * -(-nblk // splits)


def split_ranges(w: int, pages_per_block: int,
                 splits: int) -> list[tuple[int, int]]:
    """The ``[start, stop)`` table slots of each split, in split order;
    they cover ``range(w)`` once."""
    splits, per = split_slots(w, pages_per_block, splits)
    return [(s * per, min((s + 1) * per, w)) for s in range(splits)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _group_tile(group: int, quantized: bool) -> int:
    """Query rows a block holds: the group rounded up to 1, 2, 4 or 8
    (int8 up to 4); a larger group runs in several tiles."""
    tile = 1
    while tile < group and tile < (4 if quantized else 8):
        tile *= 2
    return tile


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


def _softmax_parts(s, visible, vc, round_p):
    """(m, l, p V) of one masked score block ``s [b, kvh, g, t]`` over
    ``vc [b, t, kvh, d]``, the TPU kernel's numerics: -1e30 masks, p
    masked again after exp, p rounded to the pool's bf16 before P V."""
    s = torch.where(visible, s, torch.full_like(s, _NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(visible, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    pv = p.to(torch.bfloat16).float() if round_p else p
    return m, l, torch.einsum("bhgt,bthd->bhgd", pv, vc)


def paged_decode_attention_plain(q, k_pages, v_pages, tables, lengths,
                                 scale: float | None = None,
                                 pages_per_block: int = 1,
                                 k_scales=None, v_scales=None,
                                 layer: int = 0,
                                 return_lse: bool = False,
                                 splits: int | None = None):
    """The plain PyTorch version of the kernels, same arguments: gathers
    the tables' pages and runs the masked softmax in f32.  Without
    ``splits``, in one pass; with ``splits``, as the kernels do: a
    partial softmax (m, l, acc) over each range of ``split_ranges``
    that holds a visible token, merged in split order."""
    (k_pages, v_pages, k_scales, v_scales, layer, quantized, ppb,
     scale) = _prepare(q, k_pages, v_pages, tables, lengths, scale,
                       pages_per_block, k_scales, v_scales, layer)
    b, heads, d = q.shape
    _, _, ps, kvh, _ = k_pages.shape
    w = tables.shape[1]
    group = heads // kvh
    round_p = k_pages.dtype == torch.bfloat16
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
    pos = torch.arange(w * ps, device=q.device)
    visible = (pos[None, :] < lengths[:, None].long())[:, None, None, :]
    if splits is None:
        m, l, acc = _softmax_parts(s, visible, vc, round_p)
    else:
        # a split is live where it holds a visible token; the merge reads
        # the live splits only, in order
        m = torch.full((b, kvh, group, 1), _NEG_INF, device=q.device)
        parts = []
        for start, stop in split_ranges(w, ppb, splits):
            t0, t1 = start * ps, stop * ps
            vis = visible[..., t0:t1]
            ms, ls, accs = _softmax_parts(s[..., t0:t1], vis, vc[:, t0:t1],
                                          round_p)
            live = vis.any(-1, keepdim=True)
            m = torch.where(live, torch.maximum(m, ms), m)
            parts.append((ms, ls, accs, live))
        l = torch.zeros_like(m)
        acc = torch.zeros((b, kvh, group, d), device=q.device)
        for ms, ls, accs, live in parts:
            c = torch.where(live, torch.exp(ms - m), torch.zeros_like(m))
            l = l + ls * c
            acc = acc + accs * c
    l = torch.clamp(l, min=1e-30)
    out = (acc / l).reshape(b, heads, d).to(q.dtype)
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
      q: ``[b, heads, head_dim]`` float32 or bfloat16, one query token
        per row (float32 with an int8 pool).
      k_pages, v_pages: ``[layers, pages, page_size, kv_heads, head_dim]``
        pool (a 4-D single-layer pool is accepted too), float32 or
        bfloat16, or int8 with ``*_scales``.
      tables: ``[b, w]`` int32 page tables (slot t holds tokens
        ``t*page_size..``); every slot holds a valid pool index (page 0,
        the trash page, covers unused slots).
      lengths: ``[b]`` int32 valid tokens per row, at most
        ``w * page_size``.
      scale: score scale; default ``1/sqrt(head_dim)``.
      pages_per_block: table slots in a block of the split: each of the
        ``paged_splits`` splits takes a whole number of them.
      k_scales, v_scales: ``[layers, pages]`` float32 per-page dequant
        scales (``[pages]`` for a 4-D pool), required iff int8.
      layer: index into the pool's leading dim (``k_pages[l]`` is a view
        in PyTorch, so the whole pool is passed only to keep one
        signature with the JAX package).
      return_lse: also return the per-row logsumexp of the scores.
    Returns:
      ``[b, heads, head_dim]`` in q's dtype; with ``return_lse``, a
      ``(out, lse [b, heads] float32)`` pair.  On the card head_dim 1 to
      256: 16, 32, 64, 128 and 256 run their own kernels, any other the
      next of those masked to it (scalar pool loads where a row of
      head_dim values is not a whole number of 16-byte vectors).
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
    if q.dtype not in _Q_DTYPES or k_pages.dtype not in _POOL_DTYPES:
        raise ValueError(f"the kernels take a float32|bfloat16 q and a "
                         f"float32|bfloat16|int8 pool: {q.dtype}, "
                         f"{k_pages.dtype}")
    if quantized and q.dtype != torch.float32:
        raise ValueError("an int8 pool takes a float32 q")
    if not 0 < d <= _MAX_HEAD_DIM:
        raise ValueError(f"the kernels take head_dim 1..{_MAX_HEAD_DIM}: "
                         f"{d}")
    operands = [(q, q.dtype), (tables, torch.int32),
                (lengths, torch.int32), (k_pages, k_pages.dtype),
                (v_pages, k_pages.dtype)]
    if quantized:
        operands += [(k_scales, torch.float32), (v_scales, torch.float32)]
        if (k_scales.shape != (num_layers, pages)
                or v_scales.shape != (num_layers, pages)):
            raise ValueError(f"scales must be [{num_layers}, {pages}]")
    for t, dtype in operands:
        if t.device != q.device:
            raise ValueError("all operands must be on one device")
        if t.dtype != dtype:
            raise ValueError(f"the kernels take {dtype} here, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors")
    vec = (d * k_pages.element_size() % 16 == 0
           and k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0)
    if d in _HEAD_DIMS and not vec:
        raise ValueError("the kernels read the pools in 16-byte vectors at "
                         "head_dim 16, 32, 64, 128 and 256")
    group = heads // kvh
    splits, slots = split_slots(w, ppb, paged_splits(
        b, kvh, w, ps, ppb, _sm_count(q.device.index or 0)))
    out = torch.empty((b, heads, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, heads), dtype=torch.float32, device=q.device)
    if b:
        n = b * kvh * splits * group
        ws = torch.empty((n * (d + 2),), dtype=torch.float32,
                         device=q.device)
        lib = _build.load_library()
        err = lib.thb_paged_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if quantized else None,
            v_scales.data_ptr() if quantized else None,
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            lse.data_ptr(), ws.data_ptr(), ws[n * d:].data_ptr(), b, heads,
            kvh, d, pages, ps, w, ppb, layer, splits, slots,
            _group_tile(group, quantized), scale,
            _POOL_DTYPES[k_pages.dtype], int(q.dtype == torch.bfloat16),
            int(vec), _build.stream_ptr(q.device))
        _build.check(err, "paged_decode_attention")
        paged_decode_attention.launches += 1
    if return_lse:
        return out, lse
    return out


# calls that launched the kernels in this process (one call launches
# both); a CPU call runs the plain version and is no launch
paged_decode_attention.launches = 0
