"""Llama-style decoder (RMSNorm + RoPE + SwiGLU + GQA) as PyTorch modules.

The port of the JAX package's ``models/llama.py``.  Parameter layout
follows PyTorch (``nn.Linear`` weights are ``[out, in]``) except the
untied ``lm_head``, which keeps the JAX ``[hidden, vocab]`` orientation;
``convert.llama_params_from_flax`` maps a Flax param tree onto it.

Without converted weights, ``init_weights`` draws from Flax's default
initialiser families from an explicit ``torch.Generator``: lecun-normal
(truncated normal, std 1/sqrt(fan_in)) for the projections, Flax's
``Embed`` default (normal, std 1/sqrt(hidden)) for ``tok_embed``, ones
for the norm scales and normal(0.02) for ``lm_head``.  The numbers differ
from JAX's for the same seed; only the families match.

The training arm follows the JAX dtype policy: float32 parameters, every
projection in the compute ``dtype`` (``Linear``), RMSNorm statistics in
float32 and its output in ``dtype``, the embedding gathered from the
float32 table and rounded, attention through ``local_attention``
(``dense|flash``, GQA's K/V repeated up front), and the untied head a
float32 product of ``dtype``-rounded operands (JAX's
``preferred_element_type=float32``; ``models.bert.tied_logits``'s
product).  Llama has no dropout.  ``remat`` recomputes each block in the
backward and ``scan_layers`` stacks the blocks' parameters ``[L, ...]``
under ``layers`` (``models.layer_stack``); the stacked layout is not
servable and a checkpoint does not move between the two layouts.  At
float32 the serving lane's numbers are unchanged.  ``seq_axis`` (the seq
group; ``models.bert``) shards the sequence: RoPE at the shard's global
positions, the sequence-sharded attention with GQA's ``kv_repeat``
(the un-repeated K/V on the wire).  The pipeline interface
(``pp_embed``, ``pp_layers``, ``pp_head``) and ``layer_range`` (a
pipeline stage's layers ``[lo, hi)``) are ``models.gpt``'s.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from tpu_hc_bench_torch.models import layer_stack
from tpu_hc_bench_torch.parallel.sequence import local_attention
from tpu_hc_bench_torch.parallel.tensor import copy_to, reduce_from

# std of a standard normal truncated at +-2, which lecun_normal divides out
_TRUNC_STD = 0.87962566103423978


class RMSNorm(nn.Module):
    """Float32 statistics and scale, output in ``dtype`` (None: the
    input's)."""

    def __init__(self, dim: int, eps: float = 1e-5,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.weight.float()).to(self.dtype or x.dtype)


class Linear(nn.Linear):
    """A bias-free ``nn.Linear`` whose product runs in ``dtype`` (Flax's
    ``Dense(dtype=...)`` over float32 parameters); ``tp_out``: the model
    group a row-parallel product is summed over."""

    def __init__(self, fan_in: int, out: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(fan_in, out, bias=False)
        self.dtype = dtype
        self.tp_out = None

    def forward(self, x):
        return reduce_from(F.linear(x.to(self.dtype),
                                    self.weight.to(self.dtype)),
                           self.tp_out)


def apply_rope(x, positions, theta: float = 10000.0):
    """Rotary position embedding over the trailing head_dim.

    ``x``: [batch, seq, heads, head_dim]; ``positions``: [seq] token
    positions shared across the batch, or [batch, seq] per-row positions
    (the decode step, where every request sits at its own cache depth).
    Split-half convention, float32 trig, output in x's dtype.
    """
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions.float()[..., None] * freqs
    if angles.dim() == 2:                            # [S, half]
        cos = torch.cos(angles)[None, :, None, :]    # [1, S, 1, half]
        sin = torch.sin(angles)[None, :, None, :]
    else:                                            # [B, S, half]
        cos = torch.cos(angles)[:, :, None, :]       # [B, S, 1, half]
        sin = torch.sin(angles)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    std = (1.0 / w.shape[1]) ** 0.5 / _TRUNC_STD    # Linear: [out, in]
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


class LlamaAttention(nn.Module):
    """Causal self-attention with RoPE and grouped-query KV heads."""

    def __init__(self, hidden: int, heads: int, num_kv_heads: int,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "dense", max_len: int = 2048,
                 seq_axis=None):
        super().__init__()
        if heads % num_kv_heads:
            raise ValueError(f"heads={heads} not divisible by "
                             f"num_kv_heads={num_kv_heads}")
        self.heads, self.kv_heads = heads, num_kv_heads
        self.head_dim = hidden // heads
        self.attention_impl = attention_impl
        self.max_len, self.seq_axis = max_len, seq_axis
        self.tp_group = None     # tensor parallel: heads / tp a rank
        d = self.head_dim
        self.wq = Linear(hidden, heads * d, dtype)
        self.wk = Linear(hidden, num_kv_heads * d, dtype)
        self.wv = Linear(hidden, num_kv_heads * d, dtype)
        self.wo = Linear(heads * d, hidden, dtype)

    def qkv(self, x, positions):
        """``x`` [b, s, hidden] -> q [b, s, heads, d], k and v
        [b, s, kv_heads, d], q and k rotated at ``positions``."""
        b, s, _ = x.shape
        d = self.head_dim
        x = copy_to(x, self.tp_group)
        q = self.wq(x).view(b, s, self.heads, d)
        k = self.wk(x).view(b, s, self.kv_heads, d)
        v = self.wv(x).view(b, s, self.kv_heads, d)
        return apply_rope(q, positions), apply_rope(k, positions), v

    def out(self, ctx):
        """``ctx`` [b, s, heads, d] -> [b, s, hidden]."""
        return self.wo(ctx.reshape(*ctx.shape[:2], -1))

    def forward(self, x):
        from tpu_hc_bench_torch.models.bert import global_position_ids

        q, k, v = self.qkv(x, global_position_ids(
            x.shape[1], self.seq_axis, self.max_len, x.device))
        # GQA: the K/V heads repeated up front, or by the sharded impls
        # after (or inside) their exchange
        return self.out(local_attention(
            q, k, v, impl=self.attention_impl, seq_group=self.seq_axis,
            causal=True, kv_repeat=self.heads // self.kv_heads))


class LlamaBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, num_kv_heads: int,
                 ffn: int, dtype: torch.dtype = torch.float32,
                 attention_impl: str = "dense", max_len: int = 2048,
                 seq_axis=None):
        super().__init__()
        self.attn_norm = RMSNorm(hidden, dtype=dtype)
        self.attn = LlamaAttention(hidden, heads, num_kv_heads, dtype,
                                   attention_impl, max_len, seq_axis)
        self.mlp_norm = RMSNorm(hidden, dtype=dtype)
        self.tp_group = None     # tensor parallel: ffn / tp columns a rank
        self.gate = Linear(hidden, ffn, dtype)
        self.up = Linear(hidden, ffn, dtype)
        self.down = Linear(ffn, hidden, dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for lin in (self.attn.wq, self.attn.wk, self.attn.wv, self.attn.wo,
                    self.gate, self.up, self.down):
            lecun_normal_(lin.weight, generator)
        self.attn_norm.weight.fill_(1.0)
        self.mlp_norm.weight.fill_(1.0)

    def ffn(self, h):
        """SwiGLU on the normed stream."""
        h = copy_to(h, self.tp_group)
        return self.down(F.silu(self.gate(h)) * self.up(h))

    def forward(self, x):
        x = x + self.attn(self.attn_norm(x))
        return x + self.ffn(self.mlp_norm(x))


class LlamaLM(nn.Module):
    def __init__(self, vocab_size: int = 32000, hidden: int = 2048,
                 num_layers: int = 16, heads: int = 32,
                 num_kv_heads: int = 8, ffn: int = 8192,
                 max_len: int = 2048, dtype: torch.dtype = torch.float32,
                 attention_impl: str = "dense", remat: bool = False,
                 scan_layers: bool = False, seq_axis=None,
                 layer_range: tuple[int, int] | None = None):
        super().__init__()
        self.seq_axis = seq_axis
        self.layer_range = layer_range or (0, num_layers)
        self.vocab_size, self.hidden = vocab_size, hidden
        self.num_layers, self.heads = num_layers, heads
        self.num_kv_heads, self.ffn = num_kv_heads, ffn
        self.max_len, self.dtype = max_len, dtype
        self.remat, self.scan_layers = remat, scan_layers
        self._block_kw = dict(hidden=hidden, heads=heads,
                              num_kv_heads=num_kv_heads, ffn=ffn,
                              dtype=dtype, attention_impl=attention_impl,
                              max_len=max_len, seq_axis=seq_axis)
        self.tok_embed = nn.Embedding(vocab_size, hidden)
        if scan_layers:
            self.layers = layer_stack.stack_parameters_(self.make_layer(),
                                                        num_layers)
        else:
            lo, hi = self.layer_range
            self.layers = nn.ModuleList(self.make_layer()
                                        for _ in range(hi - lo))
        self.final_norm = RMSNorm(hidden, dtype=dtype)
        self.lm_head = nn.Parameter(torch.empty(hidden, vocab_size))

    def make_layer(self) -> LlamaBlock:
        return LlamaBlock(**self._block_kw)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Flax's default initialiser families, drawn from ``generator``
        in a fixed module order."""
        nn.init.normal_(self.tok_embed.weight, 0.0, self.hidden ** -0.5,
                        generator=generator)
        if self.scan_layers:
            layer_stack.init_stacked_(self.layers, self.make_layer,
                                      self.num_layers, generator)
        else:
            layer_stack.init_layers_(self.layers, self.make_layer,
                                     self.num_layers, self.layer_range,
                                     generator)
        self.final_norm.weight.fill_(1.0)
        nn.init.normal_(self.lm_head, 0.0, 0.02, generator=generator)

    def head(self, x):
        """Final norm + untied LM head; float32 logits."""
        x = self.final_norm(x)
        if self.dtype == torch.float32:
            return x.float() @ self.lm_head.float()
        from tpu_hc_bench_torch.models.bert import tied_logits

        return tied_logits(x, self.lm_head.t(), self.dtype)

    def _block(self, i: int, x, slices):
        if self.scan_layers:
            fn = functools.partial(layer_stack.call_layer, self.layers,
                                   slices[i])
        else:
            fn = self.layers[i]
        if self.remat and torch.is_grad_enabled():
            return layer_stack.remat(fn, None, x)
        return fn(x)

    def pp_embed(self, token_ids):
        """``[b, s]`` ids -> ``[b, s, hidden]`` in ``dtype``."""
        from tpu_hc_bench_torch.models.bert import global_position_ids

        # the global length against max_len (raises)
        global_position_ids(token_ids.shape[1], self.seq_axis, self.max_len)
        return F.embedding(token_ids, self.tok_embed.weight).to(self.dtype)

    def pp_layers(self, x):
        """The blocks this model holds, in order: ``(x, None, None)``
        (no MoE terms)."""
        slices = (layer_stack.layer_slices(self.layers) if self.scan_layers
                  else None)
        for i in range(len(self.layers) if not self.scan_layers
                       else self.num_layers):
            x = self._block(i, x, slices)
        return x, None, None

    def pp_head(self, x):
        return self.head(x)

    def forward(self, token_ids):
        """Full-context causal forward: ``[b, s]`` ids -> ``[b, s, vocab]``
        float32 logits."""
        return self.head(self.pp_layers(self.pp_embed(token_ids))[0])


def llama_1b(dtype: torch.dtype = torch.float32,
             attention_impl: str = "dense", max_len: int | None = None,
             remat: bool = False, scan_layers: bool = False,
             seq_axis=None, layer_range=None) -> LlamaLM:
    """Llama-3.2-1B-shaped decoder (16L/2048H, 32q/8kv heads, SwiGLU
    8192, 32k vocab; ~1.1B params)."""
    return LlamaLM(max_len=max(2048, max_len or 0), dtype=dtype,
                   attention_impl=attention_impl, remat=remat,
                   scan_layers=scan_layers, seq_axis=seq_axis,
                   layer_range=layer_range)


def llama_tiny(dtype: torch.dtype = torch.float32,
               attention_impl: str = "dense", max_len: int | None = None,
               remat: bool = False, scan_layers: bool = False,
               seq_axis=None, layer_range=None) -> LlamaLM:
    """4-layer/128-hidden 8q/2kv variant for tests and CPU smoke runs."""
    return LlamaLM(vocab_size=1024, hidden=128, num_layers=4, heads=8,
                   num_kv_heads=2, ffn=256, max_len=max(128, max_len or 0),
                   dtype=dtype, attention_impl=attention_impl, remat=remat,
                   scan_layers=scan_layers, seq_axis=seq_axis,
                   layer_range=layer_range)
