"""BERT masked-LM: the port of the JAX package's ``models/bert.py``, and
the transformer pieces the decoder family (``models/gpt.py``) shares.

- ``Dense`` is Flax's ``nn.Dense`` / ``nn.DenseGeneral`` as the port keeps
  it: float32 parameters, the weight ``[out, in]`` as ``nn.Linear`` has
  it, and the product in the compute ``dtype`` with the bias added after
  it in ``dtype`` (Flax rounds the product, then adds the bias).
- ``LayerNorm`` is Flax's ``nn.LayerNorm(dtype=...)`` (eps 1e-6):
  float32 statistics, scale and shift, output rounded to ``dtype``.
- ``dropout`` is Flax's ``nn.Dropout``: keep with probability ``1 -
  rate`` and scale the kept values by ``1 / (1 - rate)``, in training
  only, drawn from an explicit ``torch.Generator`` (``create_model`` seeds
  the model's ``dropout_generator`` from the run's seed).  The numbers
  differ from JAX's keys; the rate matches.
- ``tied_logits`` is the tied output head: ``dtype`` operands, float32
  logits with float32 sums, as the JAX einsum with
  ``preferred_element_type=float32``.  On the card a bf16 product on the
  tensor cores with a float32 result (``torch.mm(..., out_dtype=
  float32)``), elsewhere a float32 product of the rounded operands (the
  same sums).  Its backward rounds the float32 logit cotangent to
  ``dtype`` before the two products (JAX keeps it float32), which keeps
  them on the tensor cores.
- ``MultiHeadAttention`` and ``global_position_ids``.

``BertMLM`` is the encoder (BERT-base: 12 post-LN layers, hidden 768, 12
heads, FFN 3072, vocab 30522; ``bert_large_mlm`` and ``bert_tiny_mlm``
the other members): token plus learned position embeddings (both rounded
to ``dtype`` and summed there), LayerNorm and dropout, then the layers
(``TransformerLayer``: attention, dropout, add, LayerNorm; dense, tanh
GELU, dense, dropout, add, LayerNorm; dropout 0.1, no attention mask,
non-causal ``dense|flash`` attention through ``local_attention``), then
the MLM head: ``mlm_dense``, GELU, ``mlm_ln``, the tied product against
the token table (float32 logits) plus the float32 ``mlm_bias``.  The
masking lives in the loss (the weights of the MLM batch).  ``remat``
(``--gradient_checkpointing``) recomputes each layer in the backward
with the forward's dropout masks (``models.layer_stack.remat``).

Sequence parallelism (``seq_axis``: the seq group, a
``torch.distributed`` process group; None without): the model sees its
rank's slice of the sequence, the positions are global
(``global_position_ids``: the shard's offset ``seq_index x s``) and the
attention is one of the sequence-sharded impls over the group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tpu_hc_bench_torch.models import layer_stack
from tpu_hc_bench_torch.models.llama import lecun_normal_
from tpu_hc_bench_torch.parallel.sequence import local_attention
from tpu_hc_bench_torch.parallel.tensor import copy_to, reduce_from

BERT_BASE_VOCAB = 30522
BERT_MAX_LEN = 512
DROPOUT = 0.1
LN_EPS = 1e-6           # Flax LayerNorm's default


class Dense(nn.Module):
    """``tp_out``: the model group of a row-parallel projection, whose
    partial products are summed over it before the (replicated) bias is
    added once."""

    def __init__(self, fan_in: int, out: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out, fan_in))
        self.bias = nn.Parameter(torch.empty(out))
        self.tp_out = None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Flax's defaults: lecun-normal kernel, zero bias."""
        lecun_normal_(self.weight, generator)
        self.bias.zero_()

    def forward(self, x):
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return reduce_from(y, self.tp_out) + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(dtype=...)``: float32 statistics, scale and
    shift, output in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator | None = None) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, LN_EPS).to(self.dtype)


def dropout(x, rate: float, generator: torch.Generator | None,
            training: bool):
    """Flax ``nn.Dropout``: keep with probability ``1 - rate``, kept
    values scaled by ``1 / (1 - rate)``; the identity outside training."""
    if not training or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def _mm_f32(a, b):
    """``a @ b`` of two ``dtype`` matrices as float32, float32 sums."""
    if a.dtype == torch.bfloat16 and a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _TiedHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w.t())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return _mm_f32(g, w).to(x.dtype), _mm_f32(g.t(), x).to(w.dtype)


def tied_logits(x, table, dtype: torch.dtype):
    """``[b, s, hidden]`` against the float32 ``[vocab, hidden]`` table,
    both in ``dtype``: float32 ``[b, s, vocab]`` logits."""
    b, s, hidden = x.shape
    out = _TiedHead.apply(x.to(dtype).reshape(b * s, hidden),
                          table.to(dtype))
    return out.view(b, s, -1)


class MultiHeadAttention(nn.Module):
    """Self-attention through ``local_attention``, so one parameter
    layout serves every impl (``dense``, ``flash``).  No dropout on the
    probabilities (a flash kernel never materializes them).

    ``qkv`` is Flax's ``DenseGeneral((3, heads, d))`` (kernel ``[hidden,
    3, heads, d]``, bias ``[3, heads, d]``) flattened to ``[3*hidden,
    hidden]``; ``out`` is ``DenseGeneral(hidden, axis=(-2, -1))`` (kernel
    ``[heads, d, hidden]``) as ``[hidden, hidden]``.  q, k and v are views
    of the one projection, which the flash kernels read through their
    strides.  Under tensor parallelism (``tp_group``) a rank holds
    ``heads`` of the model's heads (``parallel.tensor.shard_model_``):
    the input enters through ``copy_to`` and ``out`` sums the heads'
    partial products over the group.
    """

    def __init__(self, hidden: int, heads: int,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "dense", causal: bool = False,
                 seq_axis=None):
        super().__init__()
        if hidden % heads:
            raise ValueError(f"hidden={hidden} not divisible by "
                             f"heads={heads}")
        self.heads, self.head_dim = heads, hidden // heads
        self.attention_impl, self.causal = attention_impl, causal
        self.seq_axis = seq_axis
        self.tp_group = None
        self.qkv = Dense(hidden, 3 * hidden, dtype)
        self.out = Dense(hidden, hidden, dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        self.qkv.init_weights(generator)
        self.out.init_weights(generator)

    def forward(self, x):
        b, s, _ = x.shape
        qkv = self.qkv(copy_to(x, self.tp_group)).view(
            b, s, 3, self.heads, self.head_dim)
        q, k, v = qkv.unbind(2)
        out = local_attention(q, k, v, impl=self.attention_impl,
                              seq_group=self.seq_axis, causal=self.causal)
        return self.out(out.reshape(b, s, self.heads * self.head_dim))


def global_position_ids(s: int, seq_axis, max_len: int,
                        device: str | torch.device = "cpu") -> torch.Tensor:
    """Position ids of a block of ``s`` tokens: ``0 .. s-1``, or under
    sequence parallelism (``seq_axis``, the seq group) the shard's offset
    ``seq_index x s`` plus those; the global length is checked against
    the position table (the JAX ``nn.Embed`` would clamp)."""
    pos = torch.arange(s, device=device)
    if seq_axis is None:
        if s > max_len:
            raise ValueError(f"sequence {s} exceeds max_len {max_len}")
        return pos
    global_s = s * dist.get_world_size(seq_axis)
    if global_s > max_len:
        raise ValueError(
            f"global sequence {global_s} exceeds max_len {max_len} "
            f"(nn.Embed would silently clamp)")
    return pos + dist.get_rank(seq_axis) * s


class TransformerLayer(nn.Module):
    """Post-LN (original BERT): x = LN(x + dropout(attn(x))), then
    LN(x + dropout(dense(gelu(dense(x))))).  Flax names: ``attn`` is
    ``MultiHeadAttention_0``, ``ln1``/``ln2`` ``LayerNorm_0``/``_1``,
    ``fc``/``proj`` ``Dense_0``/``_1``; ``tp_group``: the model group of
    a tensor-parallel FFN (``fc`` column-parallel, ``proj`` row-parallel)."""

    def __init__(self, hidden: int, heads: int, ffn: int,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "dense", seq_axis=None):
        super().__init__()
        self.tp_group = None
        self.attn = MultiHeadAttention(hidden, heads, dtype, attention_impl,
                                       seq_axis=seq_axis)
        self.ln1 = LayerNorm(hidden, dtype)
        self.fc = Dense(hidden, ffn, dtype)
        self.proj = Dense(ffn, hidden, dtype)
        self.ln2 = LayerNorm(hidden, dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        self.attn.init_weights(generator)
        self.ln1.init_weights()
        self.fc.init_weights(generator)
        self.proj.init_weights(generator)
        self.ln2.init_weights()

    def forward(self, x, mask=None, generator: torch.Generator | None = None):
        if mask is not None:
            raise ValueError("attention masks are not supported: the MLM "
                             "protocol uses fixed-length sequences (masking "
                             "lives in the loss); pass mask=None")
        a = dropout(self.attn(x), DROPOUT, generator, self.training)
        x = self.ln1(x + a)
        y = self.proj(F.gelu(self.fc(copy_to(x, self.tp_group)),
                             approximate="tanh"))
        y = dropout(y, DROPOUT, generator, self.training)
        return self.ln2(x + y)


class BertMLM(nn.Module):
    def __init__(self, vocab_size: int = BERT_BASE_VOCAB, hidden: int = 768,
                 num_layers: int = 12, heads: int = 12, ffn: int = 3072,
                 max_len: int = BERT_MAX_LEN,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "dense", remat: bool = False,
                 seq_axis=None):
        super().__init__()
        self.remat, self.seq_axis = remat, seq_axis
        self.vocab_size, self.hidden = vocab_size, hidden
        self.num_layers, self.heads, self.max_len = num_layers, heads, max_len
        self.dtype = dtype
        self.tok_embed = nn.Embedding(vocab_size, hidden)
        self.pos_embed = nn.Embedding(max_len, hidden)
        self.ln_embed = LayerNorm(hidden, dtype)
        self.layers = nn.ModuleList(
            TransformerLayer(hidden, heads, ffn, dtype, attention_impl,
                             seq_axis)
            for _ in range(num_layers))
        self.mlm_dense = Dense(hidden, hidden, dtype)
        self.mlm_ln = LayerNorm(hidden, dtype)
        self.mlm_bias = nn.Parameter(torch.empty(vocab_size))
        self.dropout_generator: torch.Generator | None = None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Flax's default initialiser families, drawn from ``generator``
        in module order: ``nn.Embed``'s normal(1/sqrt(hidden)) for both
        tables, lecun-normal kernels, zero biases (``mlm_bias`` too),
        unit LayerNorms."""
        for table in (self.tok_embed.weight, self.pos_embed.weight):
            nn.init.normal_(table, 0.0, self.hidden ** -0.5,
                            generator=generator)
        self.ln_embed.init_weights()
        for layer in self.layers:
            layer.init_weights(generator)
        self.mlm_dense.init_weights(generator)
        self.mlm_ln.init_weights()
        self.mlm_bias.zero_()

    def forward(self, token_ids):
        """``[b, s]`` ids -> ``[b, s, vocab]`` float32 logits."""
        b, s = token_ids.shape
        pos = global_position_ids(s, self.seq_axis, self.max_len,
                                  token_ids.device)
        x = (F.embedding(token_ids, self.tok_embed.weight).to(self.dtype)
             + F.embedding(pos, self.pos_embed.weight).to(self.dtype)[None])
        gen = self.dropout_generator
        x = dropout(self.ln_embed(x), DROPOUT, gen, self.training)
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = layer_stack.remat(
                    lambda h, layer=layer: layer(h, None, gen), gen, x)
            else:
                x = layer(x, None, gen)
        x = self.mlm_ln(F.gelu(self.mlm_dense(x), approximate="tanh"))
        return tied_logits(x, self.tok_embed.weight, self.dtype) \
            + self.mlm_bias


def bert_base_mlm(dtype: torch.dtype = torch.float32,
                  attention_impl: str = "dense",
                  max_len: int | None = None,
                  remat: bool = False, seq_axis=None) -> BertMLM:
    """BERT-base (~110M).  ``max_len`` only ever grows the position table
    past the canonical 512."""
    return BertMLM(dtype=dtype, attention_impl=attention_impl,
                   max_len=max(BERT_MAX_LEN, max_len or 0), remat=remat,
                   seq_axis=seq_axis)


def bert_large_mlm(dtype: torch.dtype = torch.float32,
                   attention_impl: str = "dense",
                   max_len: int | None = None,
                   remat: bool = False, seq_axis=None) -> BertMLM:
    """BERT-large (24L/1024H/16 heads/4096 FFN, ~335M)."""
    return BertMLM(hidden=1024, num_layers=24, heads=16, ffn=4096,
                   max_len=max(BERT_MAX_LEN, max_len or 0), dtype=dtype,
                   attention_impl=attention_impl, remat=remat,
                   seq_axis=seq_axis)


def bert_tiny_mlm(dtype: torch.dtype = torch.float32,
                  attention_impl: str = "dense",
                  max_len: int | None = None,
                  remat: bool = False, seq_axis=None) -> BertMLM:
    """4-layer/128-hidden variant for tests and CPU smoke runs (head dim
    32: its flash arm runs the kernels at head dim 64, zero-padded)."""
    return BertMLM(vocab_size=1024, hidden=128, num_layers=4, heads=4,
                   ffn=512, max_len=max(128, max_len or 0), dtype=dtype,
                   attention_impl=attention_impl, remat=remat,
                   seq_axis=seq_axis)
