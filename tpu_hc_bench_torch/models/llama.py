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
"""

from __future__ import annotations

import torch
from torch import nn

from tpu_hc_bench_torch.parallel.sequence import dense_attention

# std of a standard normal truncated at +-2, which lecun_normal divides out
_TRUNC_STD = 0.87962566103423978


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.weight.float()).to(x.dtype)


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

    def __init__(self, hidden: int, heads: int, num_kv_heads: int):
        super().__init__()
        if heads % num_kv_heads:
            raise ValueError(f"heads={heads} not divisible by "
                             f"num_kv_heads={num_kv_heads}")
        self.heads, self.kv_heads = heads, num_kv_heads
        self.head_dim = hidden // heads
        d = self.head_dim
        self.wq = nn.Linear(hidden, heads * d, bias=False)
        self.wk = nn.Linear(hidden, num_kv_heads * d, bias=False)
        self.wv = nn.Linear(hidden, num_kv_heads * d, bias=False)
        self.wo = nn.Linear(heads * d, hidden, bias=False)

    def qkv(self, x, positions):
        """``x`` [b, s, hidden] -> q [b, s, heads, d], k and v
        [b, s, kv_heads, d], q and k rotated at ``positions``."""
        b, s, _ = x.shape
        d = self.head_dim
        q = self.wq(x).view(b, s, self.heads, d)
        k = self.wk(x).view(b, s, self.kv_heads, d)
        v = self.wv(x).view(b, s, self.kv_heads, d)
        return apply_rope(q, positions), apply_rope(k, positions), v

    def out(self, ctx):
        """``ctx`` [b, s, heads, d] -> [b, s, hidden]."""
        return self.wo(ctx.reshape(*ctx.shape[:2], -1))

    def forward(self, x):
        q, k, v = self.qkv(x, torch.arange(x.shape[1], device=x.device))
        group = self.heads // self.kv_heads
        if group > 1:
            k = k.repeat_interleave(group, dim=2)
            v = v.repeat_interleave(group, dim=2)
        return self.out(dense_attention(q, k, v, causal=True))


class LlamaBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, num_kv_heads: int,
                 ffn: int):
        super().__init__()
        self.attn_norm = RMSNorm(hidden)
        self.attn = LlamaAttention(hidden, heads, num_kv_heads)
        self.mlp_norm = RMSNorm(hidden)
        self.gate = nn.Linear(hidden, ffn, bias=False)
        self.up = nn.Linear(hidden, ffn, bias=False)
        self.down = nn.Linear(ffn, hidden, bias=False)

    def ffn(self, h):
        """SwiGLU on the normed stream."""
        return self.down(nn.functional.silu(self.gate(h)) * self.up(h))

    def forward(self, x):
        x = x + self.attn(self.attn_norm(x))
        return x + self.ffn(self.mlp_norm(x))


class LlamaLM(nn.Module):
    def __init__(self, vocab_size: int = 32000, hidden: int = 2048,
                 num_layers: int = 16, heads: int = 32,
                 num_kv_heads: int = 8, ffn: int = 8192):
        super().__init__()
        self.vocab_size, self.hidden = vocab_size, hidden
        self.num_layers, self.heads = num_layers, heads
        self.num_kv_heads, self.ffn = num_kv_heads, ffn
        self.tok_embed = nn.Embedding(vocab_size, hidden)
        self.layers = nn.ModuleList(
            LlamaBlock(hidden, heads, num_kv_heads, ffn)
            for _ in range(num_layers))
        self.final_norm = RMSNorm(hidden)
        self.lm_head = nn.Parameter(torch.empty(hidden, vocab_size))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Flax's default initialiser families, drawn from ``generator``
        in a fixed module order."""
        nn.init.normal_(self.tok_embed.weight, 0.0, self.hidden ** -0.5,
                        generator=generator)
        for blk in self.layers:
            for lin in (blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo,
                        blk.gate, blk.up, blk.down):
                lecun_normal_(lin.weight, generator)
            blk.attn_norm.weight.fill_(1.0)
            blk.mlp_norm.weight.fill_(1.0)
        self.final_norm.weight.fill_(1.0)
        nn.init.normal_(self.lm_head, 0.0, 0.02, generator=generator)

    def head(self, x):
        """Final norm + untied LM head; float32 logits."""
        return self.final_norm(x).float() @ self.lm_head.float()

    def forward(self, token_ids):
        """Full-context causal forward: ``[b, s]`` ids -> ``[b, s, vocab]``
        float32 logits."""
        x = self.tok_embed(token_ids)
        for blk in self.layers:
            x = blk(x)
        return self.head(x)


def llama_1b() -> LlamaLM:
    """Llama-3.2-1B-shaped decoder (16L/2048H, 32q/8kv heads, SwiGLU
    8192, 32k vocab; ~1.1B params)."""
    return LlamaLM()


def llama_tiny() -> LlamaLM:
    """4-layer/128-hidden 8q/2kv variant for tests and CPU smoke runs."""
    return LlamaLM(vocab_size=1024, hidden=128, num_layers=4, heads=8,
                   num_kv_heads=2, ffn=256)
