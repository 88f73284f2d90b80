"""Plain softmax attention: the single-device reference of the JAX
package's ``parallel.sequence.dense_attention``.

The prefill program attends with it, as the JAX prefill does.  It is
plain tensor code, not a kernel.  Ring and Ulysses sequence parallelism
belong to a later slice.
"""

from __future__ import annotations

import torch

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
