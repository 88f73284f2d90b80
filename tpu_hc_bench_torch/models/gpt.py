"""GPT-2-style causal LM: the port of the JAX package's ``models/gpt.py``.

A pre-LN decoder with learned positions and a tied output embedding,
sized to GPT-2 small (12L/768H, vocab 50257, ctx 1024, ~124M params) and
medium (24L/1024H, ~355M), and the MoE members ``gpt2_moe`` (the small
trunk with 8-expert top-2 FFNs) and ``moe_tiny``, whose layers swap the
dense MLP for ``models.moe.MoEFFN`` (``moe_impl`` einsum|ragged).
``remat`` (``--gradient_checkpointing``) recomputes each layer in the
backward and ``scan_layers`` stacks the trunk's parameters ``[L, ...]``
under ``layers`` (``models.layer_stack``).  ``seq_axis`` (the seq group;
``models.bert``) shards the sequence: learned positions at the shard's
global offsets, sequence-sharded attention in every layer (the MoE
members' too; each shard routes its own tokens, as JAX's).  The pipeline
interface (``pp_embed``, ``pp_layers``, ``pp_head``; JAX's
``pp_embed``/``pp_layer_module``/``pp_head``) is the forward cut in three,
and ``forward`` is their composition; ``layer_range`` builds a pipeline
stage: only layers ``[lo, hi)`` of the trunk (``layers.<i - lo>``), with
the whole embedding, ``ln_f`` and tied head, every layer's weights drawn
as the whole model draws them (``layer_stack.init_layers_``).

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
- **MoE**: each forward leaves ``aux_loss`` (the layers' Switch aux
  terms summed, in the graph; None without experts) and ``moe_dropped``
  (the layers' mean fraction of dropped (token, choice) pairs, detached)
  on the model, where ``train.step`` adds ``AUX_LOSS_COEF * aux_loss`` to
  the loss as the JAX step adds the sown ``"losses"``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from tpu_hc_bench_torch.models import layer_stack
from tpu_hc_bench_torch.models.bert import (
    Dense, LayerNorm, MultiHeadAttention, dropout, global_position_ids,
    tied_logits)
from tpu_hc_bench_torch.models.moe import MoEFFN
from tpu_hc_bench_torch.parallel.tensor import copy_to

GPT2_VOCAB = 50257
GPT2_CTX = 1024
EMBED_DROPOUT = 0.1
RESID_DROPOUT = 0.1


class DecoderLayer(nn.Module):
    """Pre-LN (GPT-2): x + attn(LN(x)), then x + mlp(LN(x)); with
    ``num_experts`` the MLP is a ``MoEFFN`` (``moe``)."""

    def __init__(self, hidden: int, heads: int, ffn: int,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "dense", num_experts: int = 0,
                 causal: bool = True, top_k: int = 2,
                 moe_impl: str = "einsum", moe_capacity_factor: float = 1.25,
                 moe_f_chunk: int = 0, seq_axis=None):
        super().__init__()
        self.tp_group = None      # the model group of a TP dense MLP
        self.ln1 = LayerNorm(hidden, dtype)
        self.attn = MultiHeadAttention(hidden, heads, dtype, attention_impl,
                                       causal, seq_axis)
        self.ln2 = LayerNorm(hidden, dtype)
        if num_experts:
            self.moe = MoEFFN(hidden, ffn, num_experts, top_k=top_k,
                              capacity_factor=moe_capacity_factor,
                              dtype=dtype, impl=moe_impl,
                              ragged_f_chunk=moe_f_chunk)
        else:
            self.fc = Dense(hidden, ffn, dtype)
            self.proj = Dense(ffn, hidden, dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        self.ln1.init_weights()
        self.attn.init_weights(generator)
        self.ln2.init_weights()
        if hasattr(self, "moe"):
            self.moe.init_weights(generator)
        else:
            self.fc.init_weights(generator)
            self.proj.init_weights(generator)

    def forward(self, x, generator: torch.Generator | None = None,
                with_stats: bool = False):
        """The layer's output; with ``with_stats`` ``(out, aux,
        dropped)``, the MoE terms None for a dense MLP."""
        h = self.attn(self.ln1(x))
        x = x + dropout(h, RESID_DROPOUT, generator, self.training)
        aux = dropped = None
        if hasattr(self, "moe"):
            h, aux, dropped = self.moe(self.ln2(x))
        else:
            h = self.proj(F.gelu(self.fc(copy_to(self.ln2(x),
                                                 self.tp_group)),
                                 approximate="tanh"))
        out = x + dropout(h, RESID_DROPOUT, generator, self.training)
        return (out, aux, dropped) if with_stats else out


class GPTLM(nn.Module):
    def __init__(self, vocab_size: int = GPT2_VOCAB, hidden: int = 768,
                 num_layers: int = 12, heads: int = 12, ffn: int = 3072,
                 max_len: int = GPT2_CTX, dtype: torch.dtype = torch.float32,
                 attention_impl: str = "dense", remat: bool = False,
                 scan_layers: bool = False, num_experts: int = 0,
                 top_k: int = 2, moe_impl: str = "einsum",
                 moe_capacity_factor: float = 1.25, moe_f_chunk: int = 0,
                 seq_axis=None, layer_range: tuple[int, int] | None = None):
        super().__init__()
        self.seq_axis = seq_axis
        self.layer_range = layer_range or (0, num_layers)
        self.vocab_size, self.hidden = vocab_size, hidden
        self.num_layers, self.heads, self.max_len = num_layers, heads, max_len
        self.ffn, self.dtype = ffn, dtype
        self.num_experts, self.top_k = num_experts, top_k
        self.remat, self.scan_layers = remat, scan_layers
        self.wte = nn.Embedding(vocab_size, hidden)
        self.wpe = nn.Embedding(max_len, hidden)
        self._layer_kw = dict(
            hidden=hidden, heads=heads, ffn=ffn, dtype=dtype,
            attention_impl=attention_impl, num_experts=num_experts,
            top_k=top_k, moe_impl=moe_impl,
            moe_capacity_factor=moe_capacity_factor, moe_f_chunk=moe_f_chunk,
            seq_axis=seq_axis)
        if scan_layers:
            self.layers = layer_stack.stack_parameters_(
                self.make_layer(), num_layers)
        else:
            lo, hi = self.layer_range
            self.layers = nn.ModuleList(self.make_layer()
                                        for _ in range(hi - lo))
        self.ln_f = LayerNorm(hidden, dtype)
        self.dropout_generator: torch.Generator | None = None
        self.aux_loss: torch.Tensor | None = None
        self.moe_dropped: torch.Tensor | None = None

    def make_layer(self) -> DecoderLayer:
        return DecoderLayer(**self._layer_kw)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Flax's default initialiser families, drawn from ``generator``
        in module order: ``nn.Embed``'s normal(1/sqrt(hidden)) for both
        tables, lecun-normal kernels, zero biases, unit LayerNorms."""
        for table in (self.wte.weight, self.wpe.weight):
            nn.init.normal_(table, 0.0, self.hidden ** -0.5,
                            generator=generator)
        if self.scan_layers:
            layer_stack.init_stacked_(self.layers, self.make_layer,
                                      self.num_layers, generator)
        else:
            layer_stack.init_layers_(self.layers, self.make_layer,
                                     self.num_layers, self.layer_range,
                                     generator)
        self.ln_f.init_weights()

    def _layer(self, i: int, x, gen, slices):
        """Layer ``i``: ``(out, aux, dropped)``; ``slices``: the stacked
        parameters' per-layer views under ``scan_layers``."""
        if self.scan_layers:
            fn = functools.partial(layer_stack.call_layer, self.layers,
                                   slices[i], generator=gen,
                                   with_stats=True)
        else:
            fn = functools.partial(self.layers[i], generator=gen,
                                   with_stats=True)
        if self.remat and torch.is_grad_enabled():
            return layer_stack.remat(fn, gen, x)
        return fn(x)

    def pp_embed(self, token_ids):
        """Token and learned-position embeddings, then the embedding
        dropout: ``[b, s]`` ids -> ``[b, s, hidden]`` in ``dtype``."""
        b, s = token_ids.shape
        pos = global_position_ids(s, self.seq_axis, self.max_len,
                                  token_ids.device)
        x = (F.embedding(token_ids, self.wte.weight).to(self.dtype)
             + F.embedding(pos, self.wpe.weight).to(self.dtype)[None])
        return dropout(x, EMBED_DROPOUT, self.dropout_generator,
                       self.training)

    def pp_layers(self, x):
        """The layers this model holds, in order: ``(x, aux, dropped)``,
        the MoE terms summed over them (None for a dense MLP)."""
        gen = self.dropout_generator
        aux = dropped = None
        slices = (layer_stack.layer_slices(self.layers) if self.scan_layers
                  else None)
        for i in range(len(self.layers) if not self.scan_layers
                       else self.num_layers):
            x, a, d = self._layer(i, x, gen, slices)
            if a is not None:
                aux = a if aux is None else aux + a
                dropped = d if dropped is None else dropped + d
        return x, aux, dropped

    def pp_head(self, x):
        """``ln_f`` and the tied head: float32 logits."""
        return tied_logits(self.ln_f(x), self.wte.weight, self.dtype)

    def forward(self, token_ids):
        """``[b, s]`` ids -> ``[b, s, vocab]`` float32 logits."""
        x, aux, dropped = self.pp_layers(self.pp_embed(token_ids))
        self.aux_loss = aux
        self.moe_dropped = (None if dropped is None
                            else dropped.detach() / self.num_layers)
        return self.pp_head(x)


def gpt2(dtype: torch.dtype = torch.float32, attention_impl: str = "dense",
         max_len: int | None = None, remat: bool = False,
         scan_layers: bool = False, seq_axis=None,
         layer_range=None) -> GPTLM:
    """GPT-2 small (124M)."""
    return GPTLM(dtype=dtype, attention_impl=attention_impl,
                 max_len=max(GPT2_CTX, max_len or 0), remat=remat,
                 scan_layers=scan_layers, seq_axis=seq_axis,
                 layer_range=layer_range)


def gpt2_medium(dtype: torch.dtype = torch.float32,
                attention_impl: str = "dense",
                max_len: int | None = None, remat: bool = False,
                scan_layers: bool = False, seq_axis=None,
                layer_range=None) -> GPTLM:
    """GPT-2 medium (~355M: 24L/1024H/16 heads)."""
    return GPTLM(hidden=1024, num_layers=24, heads=16, ffn=4096,
                 dtype=dtype, attention_impl=attention_impl,
                 max_len=max(GPT2_CTX, max_len or 0), remat=remat,
                 scan_layers=scan_layers, seq_axis=seq_axis,
                 layer_range=layer_range)


def gpt2_moe(dtype: torch.dtype = torch.float32,
             attention_impl: str = "dense", max_len: int | None = None,
             remat: bool = False, moe_impl: str = "einsum",
             moe_capacity_factor: float = 1.25, scan_layers: bool = False,
             moe_f_chunk: int = 0, seq_axis=None,
             layer_range=None) -> GPTLM:
    """GPT-2-small trunk with 8-expert top-2 MoE FFNs (~520M parameters,
    ~180M active a token)."""
    return GPTLM(dtype=dtype, attention_impl=attention_impl,
                 max_len=max(GPT2_CTX, max_len or 0), remat=remat,
                 num_experts=8, top_k=2, moe_impl=moe_impl,
                 moe_capacity_factor=moe_capacity_factor,
                 scan_layers=scan_layers, moe_f_chunk=moe_f_chunk,
                 seq_axis=seq_axis, layer_range=layer_range)


def moe_tiny(dtype: torch.dtype = torch.float32,
             attention_impl: str = "dense", max_len: int | None = None,
             remat: bool = False, moe_impl: str = "einsum",
             moe_capacity_factor: float = 1.25, scan_layers: bool = False,
             moe_f_chunk: int = 0, seq_axis=None,
             layer_range=None) -> GPTLM:
    """4-layer/128-hidden 4-expert decoder for tests and CPU smoke runs."""
    return GPTLM(vocab_size=1024, hidden=128, num_layers=4, heads=4,
                 ffn=256, dtype=dtype, attention_impl=attention_impl,
                 max_len=max(128, max_len or 0), remat=remat,
                 num_experts=4, top_k=2, moe_impl=moe_impl,
                 moe_capacity_factor=moe_capacity_factor,
                 scan_layers=scan_layers, moe_f_chunk=moe_f_chunk,
                 seq_axis=seq_axis, layer_range=layer_range)
