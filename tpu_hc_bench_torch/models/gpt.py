"""GPT-2-style causal LM: the port of the JAX package's ``models/gpt.py``.

A pre-LN decoder with learned positions and a tied output embedding,
sized to GPT-2 small (12L/768H, vocab 50257, ctx 1024, ~124M params) and
medium (24L/1024H, ~355M).  The dense MLP only: the MoE members, scanned
layers, rematerialisation and the pipeline interface come with later
slices and raise here.

What must match the Flax modules, and how (``Dense``, ``LayerNorm``,
``dropout`` and ``tied_logits`` live in ``models/bert.py``, which both
families use):

- **Dtype policy.** Parameters float32; the compute ``dtype`` (float32
  or bfloat16) for activations, with every product in ``dtype`` and
  float32 accumulation.  LayerNorm (eps 1e-6) takes its statistics and
  applies its scale and shift in float32 and rounds to ``dtype``.  The
  embeddings are gathered from the float32 tables and rounded to
  ``dtype`` (the same values as Flax's gather from a rounded table);
  ``wte + wpe`` is summed in ``dtype``.  GELU is the tanh approximation.
- **The tied head** takes ``dtype`` operands and returns float32 logits
  with float32 accumulation, as the JAX einsum with
  ``preferred_element_type=float32``: on the card a bf16 product on the
  tensor cores with a float32 result (``torch.mm(..., out_dtype=
  float32)``), elsewhere a float32 product of the rounded operands (the
  same sums).  Its backward rounds the float32 logit cotangent to
  ``dtype`` before the two products (JAX keeps it float32), which keeps
  them on the tensor cores.
- **Dropout** 0.1 on the embedding and on both residual branches, in
  training mode only, drawn from ``model.dropout_generator`` (an explicit
  ``torch.Generator``; ``create_model`` seeds it from the run's seed).
  Flax's rule: keep with probability 0.9 and scale the kept values by
  1/0.9.  The numbers differ from JAX's keys; the rate matches.
- **The causal mask** is ``qpos >= kpos``, both counted from 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpu_hc_bench_torch.models.bert import (
    Dense, LayerNorm, MultiHeadAttention, dropout, global_position_ids,
    tied_logits)

GPT2_VOCAB = 50257
GPT2_CTX = 1024
EMBED_DROPOUT = 0.1
RESID_DROPOUT = 0.1


class DecoderLayer(nn.Module):
    """Pre-LN (GPT-2): x + attn(LN(x)), then x + mlp(LN(x))."""

    def __init__(self, hidden: int, heads: int, ffn: int,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "dense", num_experts: int = 0,
                 causal: bool = True):
        super().__init__()
        if num_experts:
            raise ValueError("MoE FFNs (num_experts > 0) are not ported "
                             "yet (the dense MLP only)")
        self.ln1 = LayerNorm(hidden, dtype)
        self.attn = MultiHeadAttention(hidden, heads, dtype, attention_impl,
                                       causal)
        self.ln2 = LayerNorm(hidden, dtype)
        self.fc = Dense(hidden, ffn, dtype)
        self.proj = Dense(ffn, hidden, dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        self.ln1.init_weights()
        self.attn.init_weights(generator)
        self.ln2.init_weights()
        self.fc.init_weights(generator)
        self.proj.init_weights(generator)

    def forward(self, x, generator: torch.Generator | None = None):
        h = self.attn(self.ln1(x))
        x = x + dropout(h, RESID_DROPOUT, generator, self.training)
        h = self.proj(F.gelu(self.fc(self.ln2(x)), approximate="tanh"))
        return x + dropout(h, RESID_DROPOUT, generator, self.training)


class GPTLM(nn.Module):
    def __init__(self, vocab_size: int = GPT2_VOCAB, hidden: int = 768,
                 num_layers: int = 12, heads: int = 12, ffn: int = 3072,
                 max_len: int = GPT2_CTX, dtype: torch.dtype = torch.float32,
                 attention_impl: str = "dense", remat: bool = False,
                 scan_layers: bool = False):
        super().__init__()
        if remat or scan_layers:
            raise ValueError("remat (--gradient_checkpointing) and "
                             "scan_layers are not ported yet")
        self.vocab_size, self.hidden = vocab_size, hidden
        self.num_layers, self.heads, self.max_len = num_layers, heads, max_len
        self.dtype = dtype
        self.wte = nn.Embedding(vocab_size, hidden)
        self.wpe = nn.Embedding(max_len, hidden)
        self.layers = nn.ModuleList(
            DecoderLayer(hidden, heads, ffn, dtype, attention_impl)
            for _ in range(num_layers))
        self.ln_f = LayerNorm(hidden, dtype)
        self.dropout_generator: torch.Generator | None = None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Flax's default initialiser families, drawn from ``generator``
        in module order: ``nn.Embed``'s normal(1/sqrt(hidden)) for both
        tables, lecun-normal kernels, zero biases, unit LayerNorms."""
        for table in (self.wte.weight, self.wpe.weight):
            nn.init.normal_(table, 0.0, self.hidden ** -0.5,
                            generator=generator)
        for layer in self.layers:
            layer.init_weights(generator)
        self.ln_f.init_weights()

    def forward(self, token_ids):
        """``[b, s]`` ids -> ``[b, s, vocab]`` float32 logits."""
        b, s = token_ids.shape
        pos = global_position_ids(s, None, self.max_len, token_ids.device)
        x = (F.embedding(token_ids, self.wte.weight).to(self.dtype)
             + F.embedding(pos, self.wpe.weight).to(self.dtype)[None])
        gen = self.dropout_generator
        x = dropout(x, EMBED_DROPOUT, gen, self.training)
        for layer in self.layers:
            x = layer(x, gen)
        return tied_logits(self.ln_f(x), self.wte.weight, self.dtype)


def gpt2(dtype: torch.dtype = torch.float32, attention_impl: str = "dense",
         max_len: int | None = None) -> GPTLM:
    """GPT-2 small (124M)."""
    return GPTLM(dtype=dtype, attention_impl=attention_impl,
                 max_len=max(GPT2_CTX, max_len or 0))


def gpt2_medium(dtype: torch.dtype = torch.float32,
                attention_impl: str = "dense",
                max_len: int | None = None) -> GPTLM:
    """GPT-2 medium (~355M: 24L/1024H/16 heads)."""
    return GPTLM(hidden=1024, num_layers=24, heads=16, ffn=4096,
                 dtype=dtype, attention_impl=attention_impl,
                 max_len=max(GPT2_CTX, max_len or 0))
