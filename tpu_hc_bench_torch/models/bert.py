"""The transformer pieces of the JAX package's ``models/bert.py`` that the
decoder family shares: ``MultiHeadAttention`` and ``global_position_ids``
(without sequence parallelism).  The BERT MLM model itself comes with a
later slice.

``Dense`` is Flax's ``nn.Dense`` / ``nn.DenseGeneral`` as the port keeps
it: float32 parameters, the weight ``[out, in]`` as ``nn.Linear`` has it,
and the product in the compute ``dtype`` with the bias added after it in
``dtype`` (Flax rounds the product, then adds the bias).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpu_hc_bench_torch.models.llama import lecun_normal_
from tpu_hc_bench_torch.parallel.sequence import local_attention


class Dense(nn.Module):
    def __init__(self, fan_in: int, out: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out, fan_in))
        self.bias = nn.Parameter(torch.empty(out))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Flax's defaults: lecun-normal kernel, zero bias."""
        lecun_normal_(self.weight, generator)
        self.bias.zero_()

    def forward(self, x):
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return y + self.bias.to(self.dtype)


class MultiHeadAttention(nn.Module):
    """Self-attention through ``local_attention``, so one parameter
    layout serves every impl (``dense``, ``flash``).  No dropout on the
    probabilities (a flash kernel never materializes them).

    ``qkv`` is Flax's ``DenseGeneral((3, heads, d))`` (kernel ``[hidden,
    3, heads, d]``, bias ``[3, heads, d]``) flattened to ``[3*hidden,
    hidden]``; ``out`` is ``DenseGeneral(hidden, axis=(-2, -1))`` (kernel
    ``[heads, d, hidden]``) as ``[hidden, hidden]``.  q, k and v are views
    of the one projection, which the flash kernels read through their
    strides.
    """

    def __init__(self, hidden: int, heads: int,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "dense", causal: bool = False):
        super().__init__()
        if hidden % heads:
            raise ValueError(f"hidden={hidden} not divisible by "
                             f"heads={heads}")
        self.heads, self.head_dim = heads, hidden // heads
        self.attention_impl, self.causal = attention_impl, causal
        self.qkv = Dense(hidden, 3 * hidden, dtype)
        self.out = Dense(hidden, hidden, dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        self.qkv.init_weights(generator)
        self.out.init_weights(generator)

    def forward(self, x):
        b, s, hidden = x.shape
        qkv = self.qkv(x).view(b, s, 3, self.heads, self.head_dim)
        q, k, v = qkv.unbind(2)
        out = local_attention(q, k, v, impl=self.attention_impl,
                              causal=self.causal)
        return self.out(out.reshape(b, s, hidden))


def global_position_ids(s: int, seq_axis: str | None, max_len: int,
                        device: str | torch.device = "cpu") -> torch.Tensor:
    """Position ids ``0 .. s-1`` of an unsharded block; ``s`` is checked
    against the position table (the JAX ``nn.Embed`` would clamp).
    Sequence-sharded blocks come with sequence parallelism."""
    if seq_axis is not None:
        raise ValueError("sequence parallelism is not ported yet "
                         "(seq_axis must be None)")
    if s > max_len:
        raise ValueError(f"sequence {s} exceeds max_len {max_len}")
    return torch.arange(s, device=device)
