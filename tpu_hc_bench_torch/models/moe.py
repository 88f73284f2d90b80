"""Mixture-of-Experts FFN: the port of the JAX package's ``models/moe.py``.

A sparse FFN for the decoder family (GShard/Switch style): a float32
router, top-k experts a token, expert-major weights ``wi [E, H, F]`` and
``wo [E, F, H]`` (Flax's ``lecun_normal(batch_axis=0)``: fan-in over the
middle axis), a tanh-GELU between them.  Two dispatch impls:

- ``einsum`` (the default): GShard's dense ``dispatch``/``combine``
  tensors ``[B, S, E, C]`` (``C`` = the per-row capacity ``max(4,
  ceil(cf * k * S / E))``), stored in the compute dtype, and the data
  moved by four einsums.  Tokens past an expert's capacity are dropped
  (their combine weight is zero; the residual carries them).
- ``ragged``: the (token, choice) pairs sorted by expert and each expert
  run as a product over its contiguous segment (JAX's
  ``jax.lax.ragged_dot``).  No capacity and no drops.  The route on
  every device is one ``torch.matmul`` an expert over the segments that
  ``torch.split`` cuts: the group sizes are read to the host once a
  layer (one device sync a layer), which then cuts the pairs into
  ``ragged_chunk``-row chunks and each chunk's segments.  ``ragged_f_chunk``
  tiles the FFN dim: the second product's contraction over F is a sum of
  slices, accumulated in the compute dtype.  ``host_reads`` counts the
  group-size reads (the route's host syncs).

The Switch load-balance auxiliary loss (``E * sum_e f_e * p_e`` over the
k = 0 assignment) comes back from ``MoEFFN.forward`` beside the output,
in place of Flax's ``sow("losses", ...)``, with the fraction of (token,
choice) pairs the einsum dispatch dropped; ``models.gpt.GPTLM`` sums both
over its layers for the train step.

Expert and tensor parallelism (``parallel.tensor.shard_model_``; the
einsum dispatch only): a rank holds ``local_experts`` of the ``E``
experts, from ``expert_offset``.  The router, the routing and the aux
loss stay replicated over the model group (``tp_group``), whose ranks
see the same tokens; each rank runs its experts' slice of ``dispatch``
and ``combine``, and the combined output is summed over the group
(``reduce_from``).  The routing's probabilities enter through
``copy_to`` (each rank's gradient of the gates is its experts' part),
the aux loss's through the replicated path.  With ``data_group`` (the
arm's data axis) the aux loss and the dropped fraction are the global
batch's, as JAX's GSPMD step takes them: the expert counts and the
probability sums are summed over the data group, and the aux loss's
gradient reaches each rank's tokens as that of the global mean.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tpu_hc_bench_torch.parallel.tensor import copy_to, reduce_from

# Switch-Transformer convention: the aux term weighted into the loss
AUX_LOSS_COEF = 0.01
MOE_IMPLS = ("einsum", "ragged")
RAGGED_CHUNK = 8192
# std of a standard normal truncated at +-2, which lecun_normal divides out
_TRUNC_STD = 0.87962566103423978
# the ragged route's group-size reads to the host, one a layer a forward
host_reads = 0


def _global_aux(mask0: torch.Tensor, probs: torch.Tensor, token_axes,
                group, size: int) -> torch.Tensor:
    """The Switch aux of the global batch from this rank's tokens: the
    expert counts and probability sums summed over ``group`` (``size``
    ranks); the value is the global one on every rank, and its gradient
    reaches this rank's probabilities as ``size`` times that of the
    global mean (the data axis averages the gradients)."""
    e = probs.shape[-1]
    psum = probs.sum(token_axes)
    tot = torch.cat([mask0.sum(token_axes).detach().float(),
                     psum.detach().float(),
                     psum.new_full((1,), float(math.prod(
                         probs.shape[:-1])), dtype=torch.float32)])
    dist.all_reduce(tot, group=group)
    n = tot[2 * e]
    f = tot[:e] / n
    value = e * torch.sum(f * (tot[e:2 * e] / n))
    carrier = e * torch.sum(f * psum) * size / n
    return value + (carrier - carrier.detach())


def topk_select(probs: torch.Tensor, top_k: int, aux_probs=None,
                data_group=None, data_size: int = 1):
    """The one top-k selection both impls derive from (JAX
    ``topk_select``): ``(masks, gates, choices, aux)``: per-k one-hot
    masks ``[..., E]``, per-k gates ``[...]`` normalized to sum to 1 a
    token, per-k argmax indices ``[...]`` (the first maximum, as
    ``jnp.argmax``), and the Switch aux over every leading axis (taken
    from ``aux_probs`` where given, the same values by another autograd
    path; over the global batch with ``data_group``)."""
    e = probs.shape[-1]
    masks, gates, choices = [], [], []
    p = probs
    for _ in range(top_k):
        idx = torch.argmax(p, dim=-1)
        mask = F.one_hot(idx, e).to(probs.dtype)
        choices.append(idx)
        gates.append((p * mask).sum(-1))
        masks.append(mask)
        p = p * (1.0 - mask)
    token_axes = tuple(range(probs.dim() - 1))
    aux_p = probs if aux_probs is None else aux_probs
    if data_group is None:
        aux = e * torch.sum(masks[0].mean(token_axes)
                            * aux_p.mean(token_axes))
    else:
        aux = _global_aux(masks[0], aux_p, token_axes, data_group,
                          data_size)
    denom = torch.clamp_min(sum(gates), 1e-9)
    return masks, [g / denom for g in gates], choices, aux


def top_k_routing(probs: torch.Tensor, top_k: int, capacity: int,
                  **aux_kw):
    """``(dispatch, combine, aux)`` of ``probs [B, S, E]`` (JAX
    ``top_k_routing``): per row, each expert takes at most ``capacity``
    tokens, in sequence order with the earlier choices first (GShard's
    position-in-expert cumsum with a running offset); ``aux_kw``:
    ``topk_select``'s aux arguments."""
    b, s, e = probs.shape
    masks, gates, _, aux = topk_select(probs, top_k, **aux_kw)
    dispatch = probs.new_zeros((b, s, e, capacity))
    combine = probs.new_zeros((b, s, e, capacity))
    offset = probs.new_zeros((b, 1, e))
    for mask, gate in zip(masks, gates):
        pos = torch.cumsum(mask, dim=1) - mask + offset      # [B, S, E]
        offset = offset + mask.sum(dim=1, keepdim=True)
        mask = mask * (pos < capacity)                       # drop overflow
        pos_tok = (pos * mask).sum(-1).long()                # [B, S]
        slot = F.one_hot(pos_tok, capacity).to(probs.dtype)
        placed = mask[..., None] * slot[:, :, None, :]       # [B, S, E, C]
        dispatch = dispatch + placed
        combine = combine + gate[..., None, None] * placed
    return dispatch, combine, aux


def capacity(capacity_factor: float, top_k: int, seq: int,
             num_experts: int) -> int:
    """The einsum dispatch's slots an expert a row, at least 4."""
    return max(4, math.ceil(capacity_factor * top_k * seq / num_experts))


class MoEFFN(nn.Module):
    """The sparse FFN block; parameters float32 (``router.weight [E, H]``
    as ``nn.Linear`` holds it, ``wi``, ``wo``), the router's product in
    float32, the experts in ``dtype``."""

    def __init__(self, hidden: int, ffn: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.float32, impl: str = "einsum",
                 ragged_chunk: int = RAGGED_CHUNK, ragged_f_chunk: int = 0):
        super().__init__()
        if impl not in MOE_IMPLS:
            raise ValueError(f"unknown moe impl {impl!r}; have "
                             f"{list(MOE_IMPLS)}")
        self.hidden, self.ffn = hidden, ffn
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor, self.dtype, self.impl = (capacity_factor,
                                                       dtype, impl)
        self.ragged_chunk, self.ragged_f_chunk = ragged_chunk, ragged_f_chunk
        self.router = nn.Linear(hidden, num_experts, bias=False)
        # expert/tensor parallelism (parallel.tensor.shard_model_)
        self.tp_group, self.data_group, self.data_size = None, None, 1
        self.local_experts, self.expert_offset = num_experts, 0
        self.wi = nn.Parameter(torch.empty(num_experts, hidden, ffn))
        self.wo = nn.Parameter(torch.empty(num_experts, ffn, hidden))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Flax's families: lecun-normal for the router and, per expert,
        for ``wi``/``wo`` (fan-in the middle axis)."""
        for w, fan_in in ((self.router.weight, self.hidden),
                          (self.wi, self.hidden), (self.wo, self.ffn)):
            std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)

    def route(self, x):
        """The float32 router softmax ``[..., E]``."""
        return torch.softmax(F.linear(x.float(), self.router.weight), -1)

    def forward(self, x, impl: str | None = None):
        """``x [B, S, H]`` -> ``(y [B, S, H] in x's dtype, aux, dropped)``:
        the aux loss and the fraction of (token, choice) pairs dropped
        (0 for ragged), both 0-dim float32 tensors.  ``impl`` overrides
        the module's (serving always runs ragged)."""
        impl = impl or self.impl
        probs = self.route(x)
        if impl == "ragged":
            if self.tp_group is not None:
                raise ValueError("the ragged dispatch is single-shard: "
                                 "expert parallelism runs einsum")
            y, aux = self._ragged(x, probs)
            dropped = probs.new_zeros(())
        elif impl == "einsum":
            y, aux, dropped = self._einsum(x, probs)
        else:
            raise ValueError(f"unknown moe impl {impl!r}")
        return y.to(x.dtype), aux, dropped

    def _einsum(self, x, probs):
        b, s, _ = x.shape
        cap = capacity(self.capacity_factor, self.top_k, s, self.num_experts)
        g = self.tp_group
        dispatch, combine, aux = top_k_routing(
            copy_to(probs, g), self.top_k, cap, aux_probs=probs,
            data_group=self.data_group, data_size=self.data_size)
        if self.data_group is None:
            dropped = 1.0 - dispatch.detach().sum() / (b * s * self.top_k)
        else:                       # the global batch's pairs
            placed = dispatch.detach().sum().reshape(1)
            placed = torch.cat([placed, placed.new_full(
                (1,), float(b * s * self.top_k))])
            dist.all_reduce(placed, group=self.data_group)
            dropped = 1.0 - placed[0] / placed[1]
        if g is not None:
            e0, el = self.expert_offset, self.local_experts
            dispatch, combine = dispatch[:, :, e0:e0 + el], \
                combine[:, :, e0:e0 + el]
            x = copy_to(x, g)
        dt = self.dtype
        # dispatch is 0/1 exactly; combine loses bf16 rounding only
        dispatch, combine = dispatch.to(dt), combine.to(dt)
        xin = torch.einsum("bsec,bsh->ebch", dispatch, x.to(dt))
        act = F.gelu(torch.einsum("ebch,ehf->ebcf", xin, self.wi.to(dt)),
                     approximate="tanh")
        out = torch.einsum("ebcf,efh->ebch", act, self.wo.to(dt))
        return (reduce_from(torch.einsum("bsec,ebch->bsh", combine, out), g),
                aux, dropped)

    def _ragged(self, x, probs):
        b, s, h = x.shape
        e, k = self.num_experts, self.top_k
        n = b * s
        flat = x.reshape(n, h).to(self.dtype)
        _, gate_list, choices, aux = topk_select(probs.reshape(n, e), k)
        gates = torch.stack(gate_list, 1)                    # [N, k]
        pair_expert = torch.stack(choices, 1).reshape(n * k)
        pair_token = torch.arange(n, device=x.device).repeat_interleave(k)
        order = torch.argsort(pair_expert, stable=True)
        xs = flat[pair_token[order]]                         # [N*k, H]
        # the one host read a layer: every segment's length
        global host_reads
        host_reads += 1
        sizes = torch.bincount(pair_expert, minlength=e).tolist()
        out = torch.cat([self._grouped_ffn(xc, sz)
                         for xc, sz in _chunks(xs, sizes,
                                               self.ragged_chunk)])
        inv = torch.argsort(order)
        out = out[inv].reshape(n, k, h)
        y = (out * gates[..., None].to(self.dtype)).sum(dim=1)
        return y.reshape(b, s, h), aux

    def _grouped_ffn(self, xs, sizes: list[int]):
        """The experts over one expert-sorted row block: a product an
        expert over its segment, the FFN dim in ``ragged_f_chunk`` slices
        (0: whole)."""
        dt = self.dtype
        f = self.ffn
        fc = self.ragged_f_chunk if 0 < self.ragged_f_chunk < f else f
        outs = []
        for ex, seg in enumerate(torch.split(xs, sizes)):
            if not seg.shape[0]:
                continue
            acc = None
            for f0 in range(0, f, fc):
                wi = self.wi[ex, :, f0:f0 + fc].to(dt)
                wo = self.wo[ex, f0:f0 + fc].to(dt)
                part = torch.matmul(
                    F.gelu(torch.matmul(seg, wi), approximate="tanh"), wo)
                acc = part if acc is None else acc + part
            outs.append(acc)
        if not outs:
            return xs.new_zeros(xs.shape)
        return torch.cat(outs)


def _chunks(xs, sizes: list[int], chunk: int):
    """``(rows, segment sizes)`` of each ``chunk``-row block of the
    expert-sorted ``xs``: a contiguous block of sorted pairs is still
    sorted, so each block is a grouped product of its own (JAX's chunked
    ``ragged_dot``; a whole-block call when the rows fit one chunk)."""
    total = xs.shape[0]
    if total <= chunk:
        yield xs, sizes
        return
    bounds = [0]
    for sz in sizes:
        bounds.append(bounds[-1] + sz)
    for c0 in range(0, total, chunk):
        c1 = min(c0 + chunk, total)
        yield xs[c0:c1], [max(0, min(c1, bounds[ex + 1]) - max(c0, bounds[ex]))
                          for ex in range(len(sizes))]
