"""Paged-KV prefill/decode programs for the port's decoder families.

The port of the JAX package's ``serve/decode.py`` for its decoder
families: ``GPTLM`` (gpt2, gpt2_medium: learned positions, a fused qkv
projection with biases, LayerNorm, the gelu MLP; gpt2_moe, moe_tiny: the
same with ``MoEFFN`` layers) and ``LlamaLM`` (llama_*: RoPE, GQA,
RMSNorm, SwiGLU).  An MoE layer always dispatches ragged here, whatever
the model's ``moe_impl``, as the JAX programs do: no capacity, so no
token loses its FFN and prefill and decode agree with the full forward.
The ragged route reads each layer's group sizes to the host (one device
sync a layer).  Scanned (``scan_layers``) models are not servable, as in
JAX.  The model modules hold a full-context forward; serving needs
incremental decode, one token per request per step over everything
generated so far.  The ``_Family``
adapter walks the model's own modules, and only the attention inner
product, the part that reads the KV cache, is written here.

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
  (``ops.fused_residual_norm``, RMSNorm or LayerNorm with its bias):
  2L - 1 launches a step.

**Quantization arms** (``--quant``):

- ``int8_w``: ``quantize_weights`` holds the decode projections (qkv,
  the attention output, the dense FFN or SwiGLU; an MoE layer's router
  and experts stay float32) as per-output-channel int8 with float32
  scales; the int8 tensor is cast at the matmul and the scale
  multiplies the product's output, the JAX form.  Eager
  PyTorch materializes the cast weight at each call (XLA fuses it).
- ``int8_kv``: the pool is int8 with one float32 scale per (layer,
  page), written at prefill (a scale per page-sized chunk,
  ``_write_quantized_chunks``) and on every append (the touched page
  dequantized, extended and requantized over all layers at once,
  ``_append_quantized``), and read inside the paged kernel.  The
  paged arm only: the gather arm raises, as in JAX.

``build_page_copy_fn`` is the prefix cache's copy-on-write: one
physical page duplicated across every KV leaf, scales included.

``build_classify_fn`` is the classify mode's program (JAX
``_warm_classify``): the argmax over the last axis of the eval-mode
forward of a float32 batch, ``[B]`` for an image member (the NHWC batch
as an NCHW view, the image models' layout) and ``[B, T']`` for the
speech member, frame by frame.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.nn.functional as F

from tpu_hc_bench_torch.ops.fused_residual_ln import fused_residual_norm
from tpu_hc_bench_torch.ops.paged_attention import paged_decode_attention
from tpu_hc_bench_torch.parallel.sequence import dense_attention

_NEG_INF = -1e30
_QUANT_EPS = 1e-8

QUANT_ARMS = ("off", "int8_w", "int8_kv")
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


def _quantize_leaf(w) -> dict:
    """Per-output-channel symmetric int8 of a ``[out, in]`` weight: amax
    over the input (contraction) axis, scale = amax/127 floored at
    1e-8, round half to even; float32 throughout, as JAX quantizes."""
    wf = w.detach().float()
    amax = wf.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp_min(amax / 127.0, _QUANT_EPS)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale[:, 0]}


def _qlinear(x, leaf):
    """The scale-fused int8 matmul: the int8 weight cast at the product,
    the per-output-channel scale on its output."""
    return (F.linear(x, leaf["q"].to(x.dtype))
            * leaf["scale"].to(x.dtype))


@dataclasses.dataclass
class _Family:
    """One decoder family's pieces over its own modules; every callable
    takes the layer index ``l`` first."""

    model: Any
    num_layers: int
    heads: int
    kv_heads: int
    head_dim: int
    norm_kind: str              # "layernorm" (GPT) | "rmsnorm" (Llama)
    embed: Callable             # (tokens [b, s], positions) -> [b, s, H]
    attn_norm: Callable         # (l, x) -> normed
    attn_norm_params: Callable  # (l) -> (gamma, beta|None)
    qkv: Callable               # (l, x, positions [b,s]|[1,s]) -> q, k, v
    attn_out: Callable          # (l, ctx [b,s,heads,d]) -> [b,s,H]
    ffn: Callable               # (l, x normed) -> [b,s,H]
    ffn_norm: Callable          # (l, x) -> normed
    ffn_norm_params: Callable   # (l) -> (gamma, beta|None)
    head: Callable              # (x [b,s,H]) -> f32 logits [b,s,V]
    quant_paths: Callable       # (l) -> [state_dict names] of int8_w
    qweights: dict | None = None    # int8_w: name -> {"q", "scale"}

    def weight_bytes(self) -> int:
        """Bytes of the weights the decode programs read: the model's
        parameters, with each quantized projection counted as its int8
        tensor and float32 scales."""
        q = self.qweights or {}
        total = sum(leaf["q"].nbytes + leaf["scale"].nbytes
                    for leaf in q.values())
        return total + sum(p.nbytes for name, p in
                           self.model.named_parameters() if name not in q)


def quantize_weights(family: _Family) -> dict:
    """The ``--quant=int8_w`` leaves: every decode projection weight of
    ``family.quant_paths`` as ``{"q": int8 [out, in], "scale": float32
    [out]}``, keyed by its ``state_dict`` name.  Embeddings, norms,
    biases and the head stay the model's own."""
    params = dict(family.model.named_parameters())
    return {name: _quantize_leaf(params[name])
            for l in range(family.num_layers)
            for name in family.quant_paths(l)}


def build_family(model, quant: str = "off") -> _Family:
    """The family adapter for a constructed decoder module.

    ``quant="int8_w"`` quantizes the projections (``quantize_weights``)
    and swaps their callables for scale-fused int8 products; every other
    weight is read as in the float32 adapter.
    """
    from tpu_hc_bench_torch.models.gpt import GPTLM
    from tpu_hc_bench_torch.models.llama import LlamaLM, apply_rope

    if quant not in QUANT_ARMS:
        raise ValueError(f"quant must be one of {QUANT_ARMS}: {quant!r}")
    int8_w = quant == "int8_w"
    qw: dict = {}

    def proj(name: str, module, x):
        return _qlinear(x, qw[name]) if int8_w else module(x)

    if getattr(model, "scan_layers", False):
        raise ValueError("serving decodes the unrolled layers.<i> layout; "
                         "scan_layers models are not servable")
    if isinstance(model, GPTLM):
        d = model.hidden // model.heads
        dt = model.dtype
        layers = model.layers

        def embed(tokens, positions):
            return (F.embedding(tokens.long(), model.wte.weight).to(dt)
                    + F.embedding(positions.long(),
                                  model.wpe.weight).to(dt))

        def qkv(l, x, positions):
            del positions               # learned positions live in embed
            a = layers[l].attn.qkv
            if int8_w:
                out = (_qlinear(x.to(dt), qw[f"layers.{l}.attn.qkv.weight"])
                       + a.bias.to(dt))
            else:
                out = a(x)
            out = out.view(*x.shape[:2], 3, model.heads, d)
            return out[:, :, 0], out[:, :, 1], out[:, :, 2]

        def attn_out(l, ctx):
            o = layers[l].attn.out
            ctx = ctx.reshape(*ctx.shape[:2], -1).to(dt)
            if int8_w:
                return (_qlinear(ctx, qw[f"layers.{l}.attn.out.weight"])
                        + o.bias.to(dt))
            return o(ctx)

        def ffn(l, h):
            blk = layers[l]
            h = h.to(dt)
            if model.num_experts:
                return blk.moe(h, impl="ragged")[0]
            if int8_w:
                h = _qlinear(h, qw[f"layers.{l}.fc.weight"]) \
                    + blk.fc.bias.to(dt)
                h = F.gelu(h, approximate="tanh")
                return _qlinear(h, qw[f"layers.{l}.proj.weight"]) \
                    + blk.proj.bias.to(dt)
            return blk.proj(F.gelu(blk.fc(h), approximate="tanh"))

        from tpu_hc_bench_torch.models.bert import tied_logits

        fam = _Family(
            model=model, num_layers=model.num_layers, heads=model.heads,
            kv_heads=model.heads, head_dim=d, norm_kind="layernorm",
            embed=embed,
            attn_norm=lambda l, x: layers[l].ln1(x),
            attn_norm_params=lambda l: (layers[l].ln1.weight,
                                        layers[l].ln1.bias),
            qkv=qkv, attn_out=attn_out, ffn=ffn,
            ffn_norm=lambda l, x: layers[l].ln2(x),
            ffn_norm_params=lambda l: (layers[l].ln2.weight,
                                       layers[l].ln2.bias),
            head=lambda x: tied_logits(model.ln_f(x), model.wte.weight,
                                       dt),
            quant_paths=lambda l: [f"layers.{l}.{n}.weight" for n in (
                ("attn.qkv", "attn.out") if model.num_experts
                else ("attn.qkv", "attn.out", "fc", "proj"))],
        )
    elif isinstance(model, LlamaLM):
        d = model.hidden // model.heads
        layers = model.layers

        def qkv(l, x, positions):
            a = layers[l].attn
            b, s, _ = x.shape
            pre = f"layers.{l}.attn."
            q = proj(pre + "wq.weight", a.wq, x).view(b, s, a.heads, d)
            k = proj(pre + "wk.weight", a.wk, x).view(b, s, a.kv_heads, d)
            v = proj(pre + "wv.weight", a.wv, x).view(b, s, a.kv_heads, d)
            return apply_rope(q, positions), apply_rope(k, positions), v

        def attn_out(l, ctx):
            return proj(f"layers.{l}.attn.wo.weight", layers[l].attn.wo,
                        ctx.reshape(*ctx.shape[:2], -1))

        def ffn(l, h):
            blk = layers[l]
            pre = f"layers.{l}."
            gate = proj(pre + "gate.weight", blk.gate, h)
            up = proj(pre + "up.weight", blk.up, h)
            return proj(pre + "down.weight", blk.down, F.silu(gate) * up)

        fam = _Family(
            model=model, num_layers=model.num_layers, heads=model.heads,
            kv_heads=model.num_kv_heads, head_dim=d, norm_kind="rmsnorm",
            embed=lambda tokens, positions: model.tok_embed(tokens.long()),
            attn_norm=lambda l, x: layers[l].attn_norm(x),
            attn_norm_params=lambda l: (layers[l].attn_norm.weight, None),
            qkv=qkv, attn_out=attn_out, ffn=ffn,
            ffn_norm=lambda l, x: layers[l].mlp_norm(x),
            ffn_norm_params=lambda l: (layers[l].mlp_norm.weight, None),
            head=model.head,
            quant_paths=lambda l: [f"layers.{l}.{n}.weight" for n in (
                "attn.wq", "attn.wk", "attn.wv", "attn.wo", "gate", "up",
                "down")],
        )
    else:
        raise ValueError(
            f"no paged-decode family for {type(model).__name__} (supported: "
            "GPTLM, LlamaLM)")
    if int8_w:
        qw.update(quantize_weights(fam))
        fam.qweights = qw
    return fam


def init_kv_state(family: _Family, num_pages: int, page_size: int,
                  dtype=torch.float32, quant: str = "off",
                  device: str | torch.device = "cuda") -> tuple:
    """The engine's KV carry: the zeroed ``(k_pages, v_pages)`` pool,
    ``[L, pages, page_size, kv_heads, d]`` each; under ``int8_kv`` int8
    pools plus ``[L, pages]`` float32 scales that start at 1 (two
    tensors: the programs write them in place)."""
    shape = (family.num_layers, num_pages, page_size, family.kv_heads,
             family.head_dim)
    if quant == "int8_kv":
        return (torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.ones((family.num_layers, num_pages),
                           dtype=torch.float32, device=device),
                torch.ones((family.num_layers, num_pages),
                           dtype=torch.float32, device=device))
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def build_classify_fn(model, spec) -> Callable:
    """``fn(x) -> (argmax, logits)`` of ``model`` in eval mode on a
    float32 batch ``x`` of ``spec.input_shape`` rows."""
    image = len(spec.input_shape) == 3
    model.eval()

    @torch.no_grad()
    def classify(x):
        logits = model(x.permute(0, 3, 1, 2) if image else x)
        return logits.argmax(-1), logits
    return classify


def build_page_copy_fn():
    """The copy-on-write program: duplicate physical page ``src`` into
    ``dst`` in every KV leaf, all layers at once (the pools and, under
    ``int8_kv``, the scale planes: every leaf indexes pages on axis 1,
    so an int8 page moves in its quantized form with its scale).  Args:
    ``(kv, src, dst)`` with ints; writes in place, returns ``kv``."""

    @torch.no_grad()
    def page_copy(kv, src: int, dst: int):
        for leaf in kv:
            leaf[:, dst] = leaf[:, src]
        return kv

    return page_copy


def _write_quantized_chunks(pages_q, scales, new, table, length: int,
                            page_size: int, table_width: int) -> None:
    """Prefill's int8 page write, in place: ``new`` [L, s, kvh, d] cut
    into pages, one amax scale per (layer, chunk), chunks past the
    prompt routed to the trash page 0."""
    num_layers, s = new.shape[0], new.shape[1]
    s_pad = -(-s // page_size) * page_size
    if s_pad != s:
        new = F.pad(new, (0, 0, 0, 0, 0, s_pad - s))
    c = s_pad // page_size
    chunks = new.reshape(num_layers, c, page_size, *new.shape[2:])
    idx = torch.arange(c, device=new.device)
    cpage = torch.where(idx * page_size < length,
                        table.long()[torch.clamp(idx, 0, table_width - 1)],
                        0)
    amax = chunks.abs().amax(dim=(2, 3, 4))
    sc = torch.clamp_min(amax / 127.0, _QUANT_EPS)          # [L, c]
    q = torch.clamp(torch.round(chunks / sc[:, :, None, None, None]),
                    -127, 127).to(torch.int8)
    pages_q[:, cpage] = q
    scales[:, cpage] = sc


def _append_quantized(pages_q, scales, page_idx, offset, new) -> None:
    """Decode's int8 append, in place: each touched page dequantized
    with its stored scale, the new row written at ``offset``, and the
    page requantized with a fresh amax, over all layers and rows at
    once.  Rows past the offset are zeroed BEFORE the amax: a page
    recycled from a retired request still holds its values there, and
    they would set this token's scale."""
    b = page_idx.shape[0]
    rows = torch.arange(b, device=page_idx.device)
    old = pages_q[:, page_idx]                      # [L, b, ps, kvh, d]
    sc = scales[:, page_idx]                        # [L, b]
    page = old.float() * sc[..., None, None, None]
    page_size = page.shape[2]
    own = (torch.arange(page_size, device=page.device)[None, :]
           <= offset[:, None])                      # [b, ps]
    page = torch.where(own[None, :, :, None, None], page,
                       torch.zeros((), device=page.device))
    page[:, rows, offset] = new.float()
    amax = page.abs().amax(dim=(2, 3, 4))
    new_sc = torch.clamp_min(amax / 127.0, _QUANT_EPS)
    q = torch.clamp(torch.round(page / new_sc[..., None, None, None]),
                    -127, 127).to(torch.int8)
    pages_q[:, page_idx] = q
    scales[:, page_idx] = new_sc


def _repeat_kv(t, group: int):
    return t.repeat_interleave(group, dim=2) if group > 1 else t


def build_prefill_fn(family: _Family, page_size: int, table_width: int,
                     quant: str = "off"):
    """The (batch-1, padded prompt bucket) prefill program.

    Args at call time: ``(kv, tokens [1, s], length, table [w])``.
    Returns ``(next_token [1], logits [1, vocab], kv)`` with the prompt's
    K/V written into the table's pages (pad positions go to the trash
    page 0; int8 pools get a scale per page-sized chunk, the pad
    positions zeroed first).  ``table`` is the WRITE table: a prefix-
    cache hit passes one with its shared slots zeroed, so their stores
    go to the trash page while the dense pass still runs over every
    prompt position.  Attention is the plain ``dense_attention``, as in
    the JAX prefill; the norms are the family's plain norms.
    """
    group = family.heads // family.kv_heads

    @torch.no_grad()
    def prefill(kv, tokens, length: int, table):
        s = tokens.shape[1]
        dev = tokens.device
        positions = torch.arange(s, device=dev)[None, :]
        x = family.embed(tokens, positions)
        new_k, new_v = [], []
        for l in range(family.num_layers):
            h = family.attn_norm(l, x)
            q, k, v = family.qkv(l, h, positions)
            new_k.append(k[0])
            new_v.append(v[0])
            # causal masking alone is sufficient under right-padding: the
            # only logits read are at `length - 1`, whose keys are all
            # valid prompt positions
            ctx = dense_attention(q, _repeat_kv(k, group),
                                  _repeat_kv(v, group), causal=True)
            x = x + family.attn_out(l, ctx)
            x = x + family.ffn(l, family.ffn_norm(l, x))
        logits = family.head(x[:, length - 1:length])[:, 0]  # [1, vocab]
        next_token = logits.argmax(-1).to(torch.int32)
        pos = torch.arange(s, device=dev)
        kn = torch.stack(new_k)                     # [L, s, kvh, d]
        vn = torch.stack(new_v)
        if quant == "int8_kv":
            k_pages, v_pages, k_scales, v_scales = kv
            valid = (pos < length)[None, :, None, None]
            zero = torch.zeros((), device=dev, dtype=kn.dtype)
            _write_quantized_chunks(k_pages, k_scales,
                                    torch.where(valid, kn, zero), table,
                                    length, page_size, table_width)
            _write_quantized_chunks(v_pages, v_scales,
                                    torch.where(valid, vn, zero), table,
                                    length, page_size, table_width)
            return next_token, logits, kv
        page_idx = torch.where(
            pos < length,
            table.long()[torch.clamp(pos // page_size, 0, table_width - 1)],
            0)
        offset = pos % page_size
        k_pages, v_pages = kv
        k_pages[:, page_idx, offset] = kn
        v_pages[:, page_idx, offset] = vn
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
    if quant == "int8_kv" and attention != "paged":
        raise ValueError("int8_kv scales are consumed inside the paged "
                         "kernel; the gather reference has no "
                         "scale-fused read path")
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
        if quant == "int8_kv":
            k_pages, v_pages, k_scales, v_scales = kv
            _append_quantized(k_pages, k_scales, page_idx, offset, kn)
            _append_quantized(v_pages, v_scales, page_idx, offset, vn)
            return kv
        k_pages, v_pages = kv
        k_pages[:, page_idx, offset] = kn
        v_pages[:, page_idx, offset] = vn
        return kv

    @torch.no_grad()
    def decode_gather(kv, tokens, tables, lengths, active):
        k_pages, v_pages = kv
        b = tokens.shape[0]
        span = table_width * page_size
        x = family.embed(tokens[:, None], lengths[:, None])
        kv_valid = (torch.arange(span, device=tokens.device)[None, :]
                    < lengths.long()[:, None])
        mask = torch.cat([kv_valid, torch.ones((b, 1), dtype=torch.bool,
                                               device=tokens.device)], 1)
        tbl = tables.long()
        new_k, new_v = [], []
        for l in range(family.num_layers):
            h = family.attn_norm(l, x)
            q, k, v = family.qkv(l, h, lengths[:, None])
            new_k.append(k[:, 0])
            new_v.append(v[:, 0])
            kc = k_pages[l][tbl].reshape(b, span, family.kv_heads,
                                         family.head_dim)
            vc = v_pages[l][tbl].reshape(b, span, family.kv_heads,
                                         family.head_dim)
            keys = _repeat_kv(torch.cat([kc, k], 1), group)
            values = _repeat_kv(torch.cat([vc, v], 1), group)
            ctx = _softmax_attend(q, keys, values, mask)
            x = x + family.attn_out(l, ctx)
            x = x + family.ffn(l, family.ffn_norm(l, x))
        logits = family.head(x)[:, 0]
        next_tokens = logits.argmax(-1).to(torch.int32)
        return (next_tokens, logits,
                scatter_new(kv, tables, lengths, active,
                            torch.stack(new_k), torch.stack(new_v)))

    @torch.no_grad()
    def decode_paged(kv, tokens, tables, lengths, active):
        if quant == "int8_kv":
            k_pages, v_pages, k_scales, v_scales = kv
        else:
            k_pages, v_pages = kv
            k_scales = v_scales = None
        scale = 1.0 / family.head_dim ** 0.5
        x = family.embed(tokens[:, None], lengths[:, None])
        new_k, new_v = [], []
        delta = None        # the pending residual add, fused into the
                            # NEXT norm (ops.fused_residual_norm)
        for l in range(family.num_layers):
            if delta is None:
                h = family.attn_norm(l, x)
            else:
                g, bta = family.attn_norm_params(l)
                x, h = fused_residual_norm(x, delta, g, bta,
                                           kind=family.norm_kind)
            q, k, v = family.qkv(l, h, lengths[:, None])
            # [b, heads, d]; GPT's q is a view of the fused projection,
            # and the kernel reads contiguous rows
            qf = q[:, 0].contiguous()
            new_k.append(k[:, 0])
            new_v.append(v[:, 0])
            o_cache, lse = paged_decode_attention(
                qf, k_pages, v_pages, tables, lengths,
                pages_per_block=ppb, layer=l, return_lse=True,
                k_scales=k_scales, v_scales=v_scales)
            # the fresh token's K/V are not in the pool yet: fold them
            # into the kernel's online softmax through its logsumexp
            # (softmax over [cache, fresh] == lse-weighted mix; rows with
            # an empty cache get lse ~ -1e30 -> weight 1 on fresh)
            kf = _repeat_kv(k, group)[:, 0].float()     # [b, heads, d]
            vf = _repeat_kv(v, group)[:, 0].float()
            s_new = (qf.float() * kf).sum(-1) * scale   # [b, heads]
            w_new = torch.sigmoid(s_new - lse)[..., None]
            ctx = o_cache.float() * (1.0 - w_new) + vf * w_new
            a_out = family.attn_out(l, ctx.to(x.dtype)[:, None])
            g2, b2 = family.ffn_norm_params(l)
            x, h2 = fused_residual_norm(x, a_out, g2, b2,
                                        kind=family.norm_kind)
            delta = family.ffn(l, h2)
        x = x + delta
        logits = family.head(x)[:, 0]
        next_tokens = logits.argmax(-1).to(torch.int32)
        return (next_tokens, logits,
                scatter_new(kv, tables, lengths, active,
                            torch.stack(new_k), torch.stack(new_v)))

    return decode_paged if attention == "paged" else decode_gather
