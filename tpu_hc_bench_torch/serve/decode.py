"""Paged-KV prefill/decode programs for the port's decoder families.

The port of the JAX package's ``serve/decode.py``, Llama family only.
The model modules hold a full-context forward; serving needs incremental
decode, one token per request per step over everything generated so
far.  The ``_Family`` adapter walks the model's own modules, and only
the attention inner product, the part that reads the KV cache, is
written here.

**Paged KV cache**: one pool of fixed-size pages per run, ``k_pages``/
``v_pages`` shaped ``[layers, pages, page_size, kv_heads, head_dim]``.
A request holds an int32 page table; the decode step reads its keys
through the table and writes the new token's K/V into
``table[pos // page]``.  Page 0 is the reserved trash page: padded and
inactive rows write there and are masked on read.  PyTorch tensors are
mutable, so the programs write the pool in place (and return it, to keep
the JAX programs' signature).

**Decode attention arms** (``--decode_attention``):

- ``gather``: gather the tables' pages into a dense ``[b, S, heads, d]``
  cache and run ``_softmax_attend``.  The parity reference.
- ``paged``: the CUDA kernel ``ops.paged_decode_attention`` reads K/V
  through the page tables; the fresh token's K/V, not yet in the pool,
  merge into its online softmax through the returned logsumexp.  Each
  residual add is fused with the following norm
  (``ops.fused_residual_norm``).

Only ``quant="off"`` is ported; the int8 arms raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from tpu_hc_bench_torch.ops.fused_residual_ln import fused_residual_norm
from tpu_hc_bench_torch.ops.paged_attention import paged_decode_attention
from tpu_hc_bench_torch.parallel.sequence import dense_attention

_NEG_INF = -1e30

QUANT_ARMS = ("off",)
DECODE_ATTENTION_ARMS = ("gather", "paged")


def _softmax_attend(q, keys, values, mask):
    """Single-query attention over gathered cache rows.

    ``q`` [b, 1, heads, d]; ``keys``/``values`` [b, S, heads, d];
    ``mask`` [b, S] bool (True = attend).  Float32 scores, 1/sqrt(d)
    scale, probabilities cast back to the value dtype.
    """
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), keys.float()) \
        * (1.0 / d ** 0.5)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(values.dtype), values)


@dataclasses.dataclass
class _Family:
    """One decoder family's pieces over its own modules."""

    model: Any
    num_layers: int
    heads: int
    kv_heads: int
    head_dim: int
    norm_kind: str              # "rmsnorm" (Llama)
    embed: Callable             # (tokens [b, s]) -> [b, s, H]
    layer: Callable             # (l) -> layer module
    attn_norm: Callable         # (blk, x) -> normed
    attn_norm_params: Callable  # (blk) -> (gamma, beta|None)
    qkv: Callable               # (blk, x, positions [b,s]|[s]) -> q, k, v
    attn_out: Callable          # (blk, ctx [b,s,heads,d]) -> [b,s,H]
    ffn: Callable               # (blk, x normed) -> [b,s,H]
    ffn_norm: Callable          # (blk, x) -> normed
    ffn_norm_params: Callable   # (blk) -> (gamma, beta|None)
    head: Callable              # (x [b,s,H]) -> f32 logits [b,s,V]


def build_family(model, quant: str = "off") -> _Family:
    """The family adapter for a constructed decoder module."""
    from tpu_hc_bench_torch.models.llama import LlamaLM

    if quant in ("int8_w", "int8_kv"):
        raise ValueError(f"quant={quant} is not ported yet (off only)")
    if quant not in QUANT_ARMS:
        raise ValueError(f"quant must be one of {QUANT_ARMS}: {quant!r}")
    if not isinstance(model, LlamaLM):
        raise ValueError(
            f"no paged-decode family for {type(model).__name__} in the "
            "port (supported: LlamaLM)")
    return _Family(
        model=model, num_layers=model.num_layers, heads=model.heads,
        kv_heads=model.num_kv_heads, head_dim=model.hidden // model.heads,
        norm_kind="rmsnorm",
        embed=lambda tokens: model.tok_embed(tokens.long()),
        layer=lambda l: model.layers[l],
        attn_norm=lambda blk, x: blk.attn_norm(x),
        attn_norm_params=lambda blk: (blk.attn_norm.weight, None),
        qkv=lambda blk, x, positions: blk.attn.qkv(x, positions),
        attn_out=lambda blk, ctx: blk.attn.out(ctx),
        ffn=lambda blk, h: blk.ffn(h),
        ffn_norm=lambda blk, x: blk.mlp_norm(x),
        ffn_norm_params=lambda blk: (blk.mlp_norm.weight, None),
        head=model.head,
    )


def init_kv_state(family: _Family, num_pages: int, page_size: int,
                  dtype=torch.float32, quant: str = "off",
                  device: str | torch.device = "cuda") -> tuple:
    """The engine's KV carry: the zeroed ``(k_pages, v_pages)`` pool,
    ``[L, pages, page_size, kv_heads, d]`` each."""
    if quant != "off":
        raise ValueError(f"quant={quant} is not ported yet (off only)")
    shape = (family.num_layers, num_pages, page_size, family.kv_heads,
             family.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _repeat_kv(t, group: int):
    return t.repeat_interleave(group, dim=2) if group > 1 else t


def build_prefill_fn(family: _Family, page_size: int, table_width: int,
                     quant: str = "off"):
    """The (batch-1, padded prompt bucket) prefill program.

    Args at call time: ``(kv, tokens [1, s], length, table [w])``.
    Returns ``(next_token [1], logits [1, vocab], kv)`` with the prompt's
    K/V written into the table's pages (pad positions go to the trash
    page 0).  Attention is the plain ``dense_attention``, as in the JAX
    prefill; the norms are the family's plain norms.
    """
    if quant != "off":
        raise ValueError(f"quant={quant} is not ported yet (off only)")
    group = family.heads // family.kv_heads

    @torch.no_grad()
    def prefill(kv, tokens, length: int, table):
        s = tokens.shape[1]
        dev = tokens.device
        positions = torch.arange(s, device=dev)[None, :]
        x = family.embed(tokens)
        new_k, new_v = [], []
        for l in range(family.num_layers):
            blk = family.layer(l)
            h = family.attn_norm(blk, x)
            q, k, v = family.qkv(blk, h, positions)
            new_k.append(k[0])
            new_v.append(v[0])
            # causal masking alone is sufficient under right-padding: the
            # only logits read are at `length - 1`, whose keys are all
            # valid prompt positions
            ctx = dense_attention(q, _repeat_kv(k, group),
                                  _repeat_kv(v, group), causal=True)
            x = x + family.attn_out(blk, ctx)
            x = x + family.ffn(blk, family.ffn_norm(blk, x))
        logits = family.head(x[:, length - 1:length])[:, 0]  # [1, vocab]
        next_token = logits.argmax(-1).to(torch.int32)
        pos = torch.arange(s, device=dev)
        page_idx = torch.where(
            pos < length,
            table.long()[torch.clamp(pos // page_size, 0, table_width - 1)],
            0)
        offset = pos % page_size
        k_pages, v_pages = kv
        k_pages[:, page_idx, offset] = torch.stack(new_k)   # [L, s, kvh, d]
        v_pages[:, page_idx, offset] = torch.stack(new_v)
        return next_token, logits, kv

    return prefill


def build_decode_fn(family: _Family, page_size: int, table_width: int,
                    attention: str = "gather", quant: str = "off",
                    block_pages: int = 0):
    """The one-token-per-row decode program for a batch bucket.

    Args at call time: ``(kv, tokens [b], tables [b, w], lengths [b],
    active [b])``, where ``lengths`` is each row's cache depth (== the
    fed token's position).  Inactive rows compute on the trash page and
    write back to it.  Returns ``(next_tokens [b], logits [b, vocab],
    kv)``.
    """
    if attention not in DECODE_ATTENTION_ARMS:
        raise ValueError(f"attention must be one of "
                         f"{DECODE_ATTENTION_ARMS}: {attention!r}")
    if quant != "off":
        raise ValueError(f"quant={quant} is not ported yet (off only)")
    ppb = max(1, block_pages)
    group = family.heads // family.kv_heads

    def scatter_new(kv, tables, lengths, active, kn, vn):
        b = lengths.shape[0]
        rows = torch.arange(b, device=lengths.device)
        lens = lengths.long()
        page_idx = torch.where(
            active,
            tables.long()[rows, torch.clamp(lens // page_size, 0,
                                            table_width - 1)], 0)
        offset = lens % page_size
        k_pages, v_pages = kv
        k_pages[:, page_idx, offset] = kn
        v_pages[:, page_idx, offset] = vn
        return kv

    @torch.no_grad()
    def decode_gather(kv, tokens, tables, lengths, active):
        k_pages, v_pages = kv
        b = tokens.shape[0]
        span = table_width * page_size
        x = family.embed(tokens[:, None])
        kv_valid = (torch.arange(span, device=tokens.device)[None, :]
                    < lengths.long()[:, None])
        mask = torch.cat([kv_valid, torch.ones((b, 1), dtype=torch.bool,
                                               device=tokens.device)], 1)
        tbl = tables.long()
        new_k, new_v = [], []
        for l in range(family.num_layers):
            blk = family.layer(l)
            h = family.attn_norm(blk, x)
            q, k, v = family.qkv(blk, h, lengths[:, None])
            new_k.append(k[:, 0])
            new_v.append(v[:, 0])
            kc = k_pages[l][tbl].reshape(b, span, family.kv_heads,
                                         family.head_dim)
            vc = v_pages[l][tbl].reshape(b, span, family.kv_heads,
                                         family.head_dim)
            keys = _repeat_kv(torch.cat([kc, k], 1), group)
            values = _repeat_kv(torch.cat([vc, v], 1), group)
            ctx = _softmax_attend(q, keys, values, mask)
            x = x + family.attn_out(blk, ctx)
            x = x + family.ffn(blk, family.ffn_norm(blk, x))
        logits = family.head(x)[:, 0]
        next_tokens = logits.argmax(-1).to(torch.int32)
        return (next_tokens, logits,
                scatter_new(kv, tables, lengths, active,
                            torch.stack(new_k), torch.stack(new_v)))

    @torch.no_grad()
    def decode_paged(kv, tokens, tables, lengths, active):
        k_pages, v_pages = kv
        scale = 1.0 / family.head_dim ** 0.5
        x = family.embed(tokens[:, None])
        new_k, new_v = [], []
        delta = None        # the pending residual add, fused into the
                            # NEXT norm (ops.fused_residual_norm)
        for l in range(family.num_layers):
            blk = family.layer(l)
            if delta is None:
                h = family.attn_norm(blk, x)
            else:
                g, bta = family.attn_norm_params(blk)
                x, h = fused_residual_norm(x, delta, g, bta,
                                           kind=family.norm_kind)
            q, k, v = family.qkv(blk, h, lengths[:, None])
            qf = q[:, 0]                                # [b, heads, d]
            new_k.append(k[:, 0])
            new_v.append(v[:, 0])
            o_cache, lse = paged_decode_attention(
                qf, k_pages, v_pages, tables, lengths,
                pages_per_block=ppb, layer=l, return_lse=True)
            # the fresh token's K/V are not in the pool yet: fold them
            # into the kernel's online softmax through its logsumexp
            # (softmax over [cache, fresh] == lse-weighted mix; rows with
            # an empty cache get lse ~ -1e30 -> weight 1 on fresh)
            kf = _repeat_kv(k, group)[:, 0].float()     # [b, heads, d]
            vf = _repeat_kv(v, group)[:, 0].float()
            s_new = (qf.float() * kf).sum(-1) * scale   # [b, heads]
            w_new = torch.sigmoid(s_new - lse)[..., None]
            ctx = o_cache.float() * (1.0 - w_new) + vf * w_new
            a_out = family.attn_out(blk, ctx.to(x.dtype)[:, None])
            g2, b2 = family.ffn_norm_params(blk)
            x, h2 = fused_residual_norm(x, a_out, g2, b2,
                                        kind=family.norm_kind)
            delta = family.ffn(blk, h2)
        x = x + delta
        logits = family.head(x)[:, 0]
        next_tokens = logits.argmax(-1).to(torch.int32)
        return (next_tokens, logits,
                scatter_new(kv, tables, lengths, active,
                            torch.stack(new_k), torch.stack(new_v)))

    return decode_paged if attention == "paged" else decode_gather
