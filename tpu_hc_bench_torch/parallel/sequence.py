"""The single-device half of the JAX package's ``parallel.sequence``.

- ``dense_attention``: plain softmax attention, the reference.  The
  prefill program attends with it, as the JAX prefill does.  It is plain
  tensor code, not a kernel.
- ``local_attention``: the one attention entry point model code calls,
  dispatching to ``dense`` or ``flash`` (the CUDA flash kernels,
  ``ops.flash_attention``).  Ring and Ulysses sequence parallelism
  belong to a later slice and raise.
"""

from __future__ import annotations

import torch

from tpu_hc_bench_torch.flags import ATTENTION_IMPLS, SEQ_SHARDED_IMPLS
from tpu_hc_bench_torch.ops.flash_attention import flash_attention

_NEG_INF = -1e30  # mask value: large-negative, not -inf (keeps exp() clean)


def dense_attention(q, k, v, causal: bool = False,
                    scale: float | None = None):
    """``q``/``k``/``v``: [batch, seq, heads, head_dim] (k/v already
    repeated to the query-head count).  Scores and softmax in float32;
    probabilities cast back to the value dtype."""
    d = q.shape[-1]
    scale = (1.0 / d ** 0.5) if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device)
        kpos = torch.arange(k.shape[1], device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s,
                        torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def local_attention(q, k, v, impl: str = "dense", causal: bool = False,
                    scale: float | None = None, kv_repeat: int = 1):
    """Attention over ``[batch, seq, heads, head_dim]`` by ``impl``.

    ``kv_repeat > 1`` (GQA): k and v arrive with ``heads / kv_repeat``
    heads and are repeated up front, as the JAX single-device impls do.
    """
    if impl in SEQ_SHARDED_IMPLS:
        raise ValueError(f"attention impl {impl!r} is not ported yet "
                         "(dense|flash)")
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; have "
                         f"{list(ATTENTION_IMPLS + SEQ_SHARDED_IMPLS)}")
    if kv_repeat > 1:
        k = k.repeat_interleave(kv_repeat, dim=2)
        v = v.repeat_interleave(kv_repeat, dim=2)
    if impl == "dense":
        return dense_attention(q, k, v, causal=causal, scale=scale)
    return flash_attention(q, k, v, causal=causal, scale=scale)
