"""Attention over a sequence that may be sharded: the port of the JAX
package's ``parallel/sequence.py``.

- ``dense_attention``: plain softmax attention, the reference.  The
  prefill program attends with it, as the JAX prefill does.  It is plain
  tensor code, not a kernel.  ``q_offset``/``k_offset`` are the global
  positions of the first query/key row (the causal mask of a shard).
- ``ring_attention``: blockwise ring attention over a seq group (a
  ``torch.distributed`` process group whose ranks hold consecutive
  slices of the sequence, ``[batch, local_seq, heads, head_dim]``).
  Each rank folds its own K/V block into a float32 online-softmax
  accumulator (running max ``m``, normalizer ``l``, weighted sum ``o``),
  then ``n - 1`` times shifts the K/V block one rank along the ring
  (``collectives.ring_shift``, whose backward shifts the cotangent back)
  and folds the block it received, from rank ``(my - t) % n``.  GQA's
  ``kv_repeat`` is applied inside each fold, so the ring moves only the
  un-repeated K/V.  The folds are plain tensor code, as JAX's
  ``jnp.einsum`` outside any Pallas kernel; the shifts run on the
  compute stream, not overlapped with the folds, and autograd keeps
  each fold's float32 ``p`` for the backward (``n`` folds a layer,
  ``4 b h (s/n)^2`` bytes each), as JAX's autodiff of its
  ``fori_loop`` does.  The running max takes no gradient (the result
  does not depend on it; JAX differentiates through it and gets zero
  up to rounding), which spares the backward a second saved score
  tensor a fold.
- ``ulysses_attention``: one tiled ``all_to_all`` re-shards q/k/v from
  sequence-sharded to head-sharded (``[batch, seq, heads / n,
  head_dim]``), attention runs over the whole sequence on the local
  heads, and a second exchange restores the sequence sharding.  One
  stacked q/k/v exchange without GQA; under GQA q, k and v are exchanged
  apart and k/v repeated after.  ``ulysses_flash`` attends with the
  flash kernels (``ops.flash_attention``), at the global sequence over
  ``heads / n`` heads.
- ``local_attention``: the one attention entry point model code calls,
  dispatching on ``impl``; the sequence-sharded impls need ``seq_group``.

In a one-rank seq group (the degenerate seq axis) the exchanges are
copies and the same code runs.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpu_hc_bench_torch.flags import ATTENTION_IMPLS, SEQ_SHARDED_IMPLS
from tpu_hc_bench_torch.ops.flash_attention import flash_attention
from tpu_hc_bench_torch.parallel.collectives import all_to_all, ring_shift

_NEG_INF = -1e30  # mask value: large-negative, not -inf (keeps exp() clean)


def dense_attention(q, k, v, causal: bool = False,
                    scale: float | None = None, q_offset: int = 0,
                    k_offset: int = 0):
    """``q``/``k``/``v``: [batch, seq, heads, head_dim] (k/v already
    repeated to the query-head count).  Scores and softmax in float32;
    probabilities cast back to the value dtype."""
    d = q.shape[-1]
    scale = (1.0 / d ** 0.5) if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s,
                        torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def ring_attention(q, k, v, seq_group, causal: bool = False,
                   scale: float | None = None, kv_repeat: int = 1):
    """Dense attention over the global sequence of ``seq_group``'s
    shards, by ring: the local block first, then ``n - 1`` shifts."""
    n, my = dist.get_world_size(seq_group), dist.get_rank(seq_group)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    scale = (1.0 / d ** 0.5) if scale is None else scale
    qf = q.float()
    qpos = my * lq + torch.arange(lq, device=q.device)     # global rows

    def fold(carry, k_blk, v_blk, src):
        if kv_repeat > 1:
            # block-local broadcast: no extra ring traffic
            k_blk = k_blk.repeat_interleave(kv_repeat, dim=2)
            v_blk = v_blk.repeat_interleave(kv_repeat, dim=2)
        m, l, o = carry
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float()) * scale
        if causal:
            kpos = src * lk + torch.arange(lk, device=q.device)
            visible = qpos[:, None] >= kpos[None, :]
        with torch.no_grad():
            # the running max only shifts the exponents: the result does
            # not depend on it, so it takes no gradient
            sm = torch.where(visible, s, _NEG_INF) if causal else s
            m_new = torch.maximum(m, sm.amax(dim=-1))
        z = s - m_new[..., None]
        if causal:
            # masked weights are exactly 0 (JAX's forced p = 0), and exp
            # keeps the one f32 [b, h, q, k] tensor the backward needs
            z = torch.where(visible, z, float("-inf"))
        p = torch.exp(z)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = (o * corr.transpose(1, 2)[..., None]
             + torch.einsum("bhqk,bkhd->bqhd", p, v_blk.float()))
        return m_new, l, o

    carry = (torch.full((b, h, lq), _NEG_INF, device=q.device),
             torch.zeros((b, h, lq), device=q.device),
             torch.zeros((b, lq, h, d), device=q.device))
    carry = fold(carry, k, v, my)
    kv = torch.stack((k, v)) if n > 1 else None     # one shift a fold
    for t in range(1, n):
        kv = ring_shift(kv, seq_group)
        carry = fold(carry, kv[0], kv[1], (my - t) % n)
    _, l, o = carry
    l = l.clamp_min(1e-30)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def ulysses_attention(q, k, v, seq_group, causal: bool = False,
                      scale: float | None = None, attn_fn=None,
                      kv_repeat: int = 1):
    """All-to-all sequence parallelism: ``attn_fn(q, k, v, causal=...,
    scale=...)`` (default ``dense_attention``) over the global sequence
    on ``heads / n`` heads.  Needs ``heads % n == 0`` (and, under GQA,
    ``kv_heads % n == 0``)."""
    n = dist.get_world_size(seq_group)
    h, h_kv = q.shape[2], k.shape[2]
    if h % n:
        raise ValueError(f"heads={h} not divisible by axis size {n}")
    if kv_repeat > 1 and h_kv % n:
        raise ValueError(f"kv heads={h_kv} not divisible by axis size {n}")
    if kv_repeat > 1:
        qg = all_to_all(q, seq_group, 2, 1)
        kg = all_to_all(k, seq_group, 2, 1).repeat_interleave(kv_repeat, 2)
        vg = all_to_all(v, seq_group, 2, 1).repeat_interleave(kv_repeat, 2)
    else:
        # one stacked exchange for q/k/v (split/concat shifted by 1 for
        # the leading stack dim)
        qg, kg, vg = all_to_all(torch.stack((q, k, v)), seq_group, 3,
                                2).unbind(0)
    out = (attn_fn or dense_attention)(qg, kg, vg, causal=causal,
                                       scale=scale)
    return all_to_all(out, seq_group, 1, 2)


def local_attention(q, k, v, impl: str = "dense", causal: bool = False,
                    scale: float | None = None, kv_repeat: int = 1,
                    seq_group=None):
    """Attention over ``[batch, seq, heads, head_dim]`` by ``impl``:
    ``dense``/``flash`` attend to the local rows only (``seq_group`` is
    ignored); ``ring``/``ulysses``/``ulysses_flash`` need ``seq_group``.

    ``kv_repeat > 1`` (GQA): k and v arrive with ``heads / kv_repeat``
    heads.  The single-device impls repeat them up front; the sharded
    ones move the un-repeated K/V and repeat after or inside the
    exchange.
    """
    if impl not in ATTENTION_IMPLS + SEQ_SHARDED_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; have "
                         f"{list(ATTENTION_IMPLS + SEQ_SHARDED_IMPLS)}")
    if impl in ATTENTION_IMPLS:
        if kv_repeat > 1:
            k = k.repeat_interleave(kv_repeat, dim=2)
            v = v.repeat_interleave(kv_repeat, dim=2)
        if impl == "dense":
            return dense_attention(q, k, v, causal=causal, scale=scale)
        return flash_attention(q, k, v, causal=causal, scale=scale)
    if seq_group is None:
        raise ValueError(f"impl={impl!r} requires a seq group "
                         "(seq_group: the ranks that shard the sequence)")
    if impl == "ring":
        return ring_attention(q, k, v, seq_group, causal=causal,
                              scale=scale, kv_repeat=kv_repeat)
    return ulysses_attention(
        q, k, v, seq_group, causal=causal, scale=scale,
        attn_fn=flash_attention if impl == "ulysses_flash" else None,
        kv_repeat=kv_repeat)
