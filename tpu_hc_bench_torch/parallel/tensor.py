"""Tensor and expert parallelism over a model group of processes: the
port's counterpart of the JAX package's GSPMD arm (``train/step.py``
``tp_param_spec``, ``shard_state_tp``, ``_build_gspmd_step(
follow_inputs=True)``).

JAX marks each transformer parameter with a ``PartitionSpec`` over the
mesh's ``model`` axis and lets XLA's partitioner insert the collectives.
The port writes Megatron's layout by hand:

- **The rules** (``tp_param_rule``, keyed on the port's parameter names;
  ``convert`` maps them to JAX's): column-parallel, the output features
  split, ``attn.qkv`` (the fused ``[3*hidden, hidden]`` projection in
  ``(3, heads, d)`` row order, so a rank's heads are three strided blocks,
  one of each of q, k and v), the FFN's ``fc`` (Flax ``Dense_0``/``fc``),
  llama's ``wq``/``wk``/``wv`` and ``gate``/``up``, each with its bias;
  row-parallel, the input features split, ``attn.out``, ``proj``
  (``Dense_1``), ``wo`` and ``down``, whose biases stay whole (JAX's
  rules leave them replicated); the expert tensors ``moe.wi``/``moe.wo``
  split on the expert dim.  ``mode="ep"`` keeps the expert rules alone.
  Every other parameter is replicated.  A rule is ``(dim, blocks)``: the
  dim viewed as ``blocks`` equal blocks, each cut into ``size`` equal
  pieces, rank ``i`` keeping piece ``i`` of every block.
- **The two conjugate functions** (``copy_to``, ``reduce_from``): the
  identity forward with an all-reduce of the gradient backward, at the
  entry of a column-parallel region (its input is replicated, each
  rank's gradient of it partial), and the all-reduce forward with the
  identity backward at the exit of a row-parallel one, before the
  replicated bias.  In a one-rank group both are copies.  Every rank of
  a group enters them in one order: twice a layer forward and twice
  backward.
- ``shard_model_`` cuts a built (or loaded) full model in place and sets
  each module's group and local head count; ``cut_state_dict`` and
  ``full_state_dict`` move a ``state_dict`` between the full form (what a
  checkpoint holds, JAX's host layout) and a rank's shard, the optimizer
  state likewise.

The MoE layers (``models.moe``) keep the router, the routing and the aux
loss replicated and run their ``E / size`` experts' slice of the
dispatch; under this arm the aux loss and the text loss are taken over
the global batch (JAX's GSPMD step computes them on the whole batch), by
sums over the data group (``data_group``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

# (name suffix, ndim) -> (dim, blocks); torch's Linear weights are
# [out, in]: a column-parallel weight splits dim 0, a row-parallel dim 1
_TP_RULES = (
    ("attn.qkv.weight", 2, (0, 3)),      # [3 * heads * d, hidden]
    ("attn.qkv.bias", 1, (0, 3)),        # [3 * heads * d]
    ("attn.out.weight", 2, (1, 1)),      # [hidden, heads * d]
    ("fc.weight", 2, (0, 1)),            # FFN in [ffn, hidden]
    ("fc.bias", 1, (0, 1)),
    ("proj.weight", 2, (1, 1)),          # FFN out [hidden, ffn]
    ("attn.wq.weight", 2, (0, 1)),
    ("attn.wk.weight", 2, (0, 1)),
    ("attn.wv.weight", 2, (0, 1)),
    ("attn.wo.weight", 2, (1, 1)),
    ("gate.weight", 2, (0, 1)),
    ("up.weight", 2, (0, 1)),
    ("down.weight", 2, (1, 1)),
    ("moe.wi", 3, (0, 1)),               # [E, hidden, ffn]
    ("moe.wo", 3, (0, 1)),               # [E, ffn, hidden]
)
TP_MODES = ("tp", "ep")


def tp_param_rule(name: str, ndim: int, mode: str = "tp"
                  ) -> tuple[int, int] | None:
    """``(dim, blocks)`` of the parameter ``name`` under ``mode``, or
    None where it is replicated (JAX's ``tp_param_spec`` on the port's
    names)."""
    for suffix, rank, rule in _TP_RULES:
        if mode == "ep" and not suffix.startswith("moe."):
            continue
        if (name == suffix or name.endswith("." + suffix)) and ndim == rank:
            return rule
    return None


def cut(t: torch.Tensor, rule: tuple[int, int], size: int,
        index: int) -> torch.Tensor:
    """Rank ``index``'s piece of the full tensor ``t`` (a new tensor)."""
    dim, blocks = rule
    v = t.unflatten(dim, (blocks, t.shape[dim] // blocks))
    n = v.shape[dim + 1]
    if n % size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} ({blocks} "
                         f"block(s) of {n}) does not split {size} ways")
    piece = n // size
    return v.narrow(dim + 1, index * piece, piece).flatten(
        dim, dim + 1).clone()


def join(pieces: list[torch.Tensor], rule: tuple[int, int]) -> torch.Tensor:
    """The full tensor from every rank's piece, in rank order: ``cut``'s
    inverse."""
    dim, blocks = rule
    parts = [p.unflatten(dim, (blocks, p.shape[dim] // blocks))
             for p in pieces]
    return torch.cat(parts, dim + 1).flatten(dim, dim + 1)


def gather(t: torch.Tensor, rule: tuple[int, int], group) -> torch.Tensor:
    """The full tensor from this rank's piece ``t``, gathered over
    ``group`` (a collective)."""
    size = dist.get_world_size(group)
    if size == 1:
        return t.detach().clone()
    pieces = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(pieces, t.detach().contiguous(), group=group)
    return join(pieces, rule)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """The entry of a parallel region: ``x`` forward, its gradient summed
    over ``group`` backward; ``x`` itself where ``group`` is None."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The exit of a parallel region: ``x`` summed over ``group``
    forward, the gradient passed through backward; ``x`` itself where
    ``group`` is None."""
    return x if group is None else _ReduceFrom.apply(x, group)


@dataclasses.dataclass
class TensorParallel:
    """A model's sharding over its model group: ``rules`` maps each split
    parameter's ``state_dict`` name to its rule; ``data_group`` and
    ``dp``: the data axis the global losses are summed over."""

    group: object
    size: int
    index: int
    mode: str
    rules: dict
    data_group: object = None
    dp: int = 1

    def param_rules(self, model: torch.nn.Module) -> dict:
        """The rule of each parameter by its index in
        ``model.parameters()`` (the optimizer's ``state_dict`` keys)."""
        return {i: self.rules[n]
                for i, (n, _) in enumerate(model.named_parameters())
                if n in self.rules}


def _check_rules(rules: dict, mode: str) -> None:
    """JAX's loud errors where no parameter matches a rule."""
    if rules:
        return
    if mode == "ep":
        raise ValueError(
            "expert_parallel > 1 but no param matched an expert rule: "
            "the model has no MoE layers (use an moe member, e.g. "
            "gpt2_moe), so EP would only halve the data-parallel degree")
    raise ValueError(
        "model_parallel > 1 but no param matched a tensor-parallel "
        "rule: this model's param names have no TP layout (only the "
        "transformer families do), so TP would silently replicate "
        "every param and degrade to DP with a smaller global batch")


def model_rules(model: torch.nn.Module, mode: str = "tp") -> dict:
    """Every split parameter of ``model`` by ``state_dict`` name."""
    if mode not in TP_MODES:
        raise ValueError(f"mode must be tp|ep: {mode!r}")
    return {n: r for n, p in model.named_parameters()
            if (r := tp_param_rule(n, p.dim(), mode)) is not None}


@torch.no_grad()
def shard_model_(model: torch.nn.Module, group, mode: str = "tp",
                 data_group=None) -> TensorParallel:
    """Cut ``model`` (full, identical on every rank of ``group``) in
    place to this rank's shard and wire its modules to ``group``: each
    attention holds ``heads / size`` heads (llama's KV heads likewise),
    each FFN ``ffn / size`` columns, each MoE layer ``E / size``
    experts; under ``mode="ep"`` only the experts split.  Raises JAX's
    errors where no parameter matches, and where a head, column or
    expert count does not split."""
    from tpu_hc_bench_torch.models import bert, gpt, llama, moe

    rules = model_rules(model, mode)
    _check_rules(rules, mode)
    size, index = dist.get_world_size(group), dist.get_rank(group)
    for m in model.modules():
        if (mode == "tp" and isinstance(m, llama.LlamaAttention)
                and m.kv_heads % size):
            raise ValueError(
                f"model_parallel={size} must divide num_kv_heads="
                f"{m.kv_heads}: the KV heads shard like the query heads")
        if isinstance(m, moe.MoEFFN) and m.num_experts % size:
            raise ValueError(f"{size}-way sharding does not split "
                             f"{m.num_experts} experts")
    params = dict(model.named_parameters())
    for name, rule in rules.items():
        params[name].data = cut(params[name].data, rule, size, index)
    dp = dist.get_world_size(data_group) if data_group is not None else 1
    for m in model.modules():
        if isinstance(m, moe.MoEFFN):
            m.tp_group, m.local_experts = group, m.num_experts // size
            m.expert_offset = index * m.local_experts
            m.data_group, m.data_size = data_group, dp
        if mode != "tp":
            continue
        if isinstance(m, bert.MultiHeadAttention):
            m.heads //= size
            m.tp_group, m.out.tp_out = group, group
        elif isinstance(m, llama.LlamaAttention):
            m.heads //= size
            m.kv_heads //= size
            m.tp_group, m.wo.tp_out = group, group
        elif isinstance(m, llama.LlamaBlock):
            m.tp_group, m.down.tp_out = group, group
        elif (isinstance(m, (bert.TransformerLayer, gpt.DecoderLayer))
              and not hasattr(m, "moe")):
            m.tp_group, m.proj.tp_out = group, group
    return TensorParallel(group, size, index, mode, rules, data_group, dp)


def cut_state_dict(sd: dict, tp: TensorParallel | None) -> dict:
    """A full ``state_dict`` cut to this rank's shard (unchanged without
    ``tp``)."""
    if tp is None:
        return sd
    return {k: cut(v, tp.rules[k], tp.size, tp.index) if k in tp.rules
            else v for k, v in sd.items()}


def full_state_dict(model: torch.nn.Module,
                    tp: TensorParallel | None) -> dict:
    """``model``'s ``state_dict`` with every split parameter gathered
    over the model group (a collective; the model's own without
    ``tp``)."""
    sd = model.state_dict()
    if tp is None:
        return sd
    return {k: gather(v, tp.rules[k], tp.group) if k in tp.rules else v
            for k, v in sd.items()}


def _map_optimizer_state(opt_sd: dict, rules: dict, fn) -> dict:
    """``opt_sd`` with ``fn(tensor, rule)`` applied to each per-parameter
    tensor of a split parameter (the scalars, Adam's step count, pass
    through)."""
    state = {}
    for i, st in opt_sd["state"].items():
        rule = rules.get(i)
        state[i] = {k: fn(v, rule) if rule is not None
                    and isinstance(v, torch.Tensor) and v.dim() > 0 else v
                    for k, v in st.items()}
    return {**opt_sd, "state": state}


def full_optimizer_state(optimizer: torch.optim.Optimizer,
                         model: torch.nn.Module,
                         tp: TensorParallel | None) -> dict:
    """The optimizer's ``state_dict`` with every split parameter's state
    gathered (a collective)."""
    sd = optimizer.state_dict()
    if tp is None:
        return sd
    return _map_optimizer_state(sd, tp.param_rules(model),
                                lambda v, r: gather(v, r, tp.group))


def cut_optimizer_state(opt_sd: dict, model: torch.nn.Module,
                        tp: TensorParallel | None) -> dict:
    """A full optimizer ``state_dict`` cut to this rank's shard."""
    if tp is None:
        return opt_sd
    return _map_optimizer_state(opt_sd, tp.param_rules(model),
                                lambda v, r: cut(v, r, tp.size, tp.index))
