"""Pipeline parallelism: GPipe microbatching over a pipe group of
processes, the port's counterpart of the JAX package's
``parallel/pipeline.py`` (``pipeline_apply``, ``build_pp_train_step``,
``build_pp_eval_step``, ``stack_layer_params``).

JAX writes the schedule as one ``lax.scan`` of ``M + n - 1`` ticks whose
activations hop with ``ppermute``, and lets autodiff transpose it into
the backward.  The port writes GPipe's loop by hand, over
``torch.distributed`` send and receive (NCCL on the card, gloo on the
CPU), with the same arithmetic:

- **The stage.** Stage ``s`` of ``n`` holds layers ``cut_stage(L, n,
  s)`` (``models.create_model(pipeline=(n, s))`` builds only those),
  and, as in JAX, the whole embedding and head, replicated: the model's
  ``pp_embed``, ``pp_layers`` and ``pp_head`` are its forward cut in
  three.
- **The schedule** (``_forward``): all M forwards, microbatch ``m`` in
  order, each received from stage ``s - 1`` (embedded, on stage 0),
  run through the stage's layers and sent to ``s + 1``, its input and
  output kept; then all M backwards in reverse order, each receiving
  its output's gradient from ``s + 1``, running ``torch.autograd.
  backward`` and sending its input's gradient to ``s - 1``.  Every stage
  issues its hops in one microbatch order both ways, so the blocking
  chain cannot deadlock; the hops stay out of any autograd function,
  whose backward order autograd does not fix.  JAX's bubble ticks
  compute values its gate throws away; the port runs none.  A one-stage
  pipeline skips the hops.
- **The loss** (JAX's gate): the task loss counts on the last stage
  only, the weighted cross-entropy of all M microbatches over the
  weights of the rank's whole batch (optax's cross-entropy, as JAX's PP
  step: ``--fused_xent`` does not apply).  The MoE aux loss is not
  gated: each stage adds ``AUX_LOSS_COEF x`` its layers' aux summed over
  the M microbatches ``/ M``, JAX's grouped estimator.  The loss is
  summed over the pipe group and averaged over the data group.
- **The gradients**: the stage's trunk is averaged over the data group
  (the ranks of this stage and model index); the replicated embedding,
  ``ln_f``/``final_norm`` and head are summed over the pipe group first
  (stage 0 holds the embedding's part, the last stage the head's; GPT's
  tied ``wte`` gets both), on every rank, so every copy stays equal.
- **Tensor parallelism inside a stage** (DP x PP x TP): the stage's
  layers are cut over its model group (``parallel.tensor``); a hop goes
  from each model rank to the same model index of the next stage (the
  activations are replicated), and every rank of a model group runs its
  microbatches in the same order, so its all-reduces pair up.

``stack_layer_params``/``unstack_layer_params`` and
``pp_state_from_train_state``/``train_state_from_pp`` move a
``state_dict`` (and a params-shaped optimizer state: name -> per-tensor
state) between the unrolled ``layers.<i>.<name>`` layout and JAX's
stacked ``trunk.<name>`` ``[L, ...]`` one.  ``full_state_dict``/
``cut_state_dict`` and the optimizer pair move a stage's state to and
from the whole model's (JAX's host layout, the checkpoint's), gathering
over the pipe group.
"""

from __future__ import annotations

import dataclasses
import re

import torch
import torch.distributed as dist
import torch.nn.functional as F

_LAYER = re.compile(r"layers\.(\d+)\.(.+)")
TRUNK = "trunk."


def cut_stage(num_layers: int, stages: int, stage: int) -> tuple[int, int]:
    """Layers ``[lo, hi)`` of stage ``stage`` of ``stages``."""
    if num_layers % stages:
        raise ValueError(f"{num_layers} layers not divisible by "
                         f"pipeline_parallel={stages}")
    n = num_layers // stages
    return stage * n, (stage + 1) * n


def default_microbatches(batch_size: int, stages: int) -> int:
    """JAX's default ``--num_microbatches``: ``2 x stages`` where it
    divides the per-worker batch, else ``stages``."""
    return 2 * stages if batch_size % (2 * stages) == 0 else stages


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """This rank's stage: ``stages`` and ``stage``, the pipe ``group``
    (None for one stage), the neighbours' global ranks (None at the
    ends), the microbatches a step and the layers held."""

    stages: int
    stage: int
    group: object
    prev: int | None
    next: int | None
    num_microbatches: int
    layers: tuple[int, int]
    writes_rows: bool = True       # pp-native saves: the stage's first
                                   # data rank (model index 0) writes

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.stages - 1

    def src(self, stage: int) -> int:
        """The global rank of ``stage`` in this rank's pipe group."""
        return (dist.get_global_rank(self.group, stage)
                if self.group is not None else dist.get_rank())


def make_pipeline(mesh, num_layers: int, num_microbatches: int) -> Pipeline:
    """The pipeline of ``mesh`` (``distributed.build_mesh``), or of one
    stage without a mesh."""
    if mesh is None:
        return Pipeline(1, 0, None, None, None, num_microbatches,
                        (0, num_layers))
    return Pipeline(mesh.pp, mesh.pipe_index, mesh.pipe_group,
                    mesh.pipe_prev, mesh.pipe_next, num_microbatches,
                    cut_stage(num_layers, mesh.pp, mesh.pipe_index),
                    mesh.data_index == 0 and mesh.model_index == 0)


# --- the schedule ------------------------------------------------------------


def _send(t: torch.Tensor, dst: int, group) -> None:
    dist.send(t.detach().contiguous(), dst, group=group)


def _recv(shape, dtype, device, src: int, group) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype, device=device)
    dist.recv(t, src, group=group)
    return t


def _forward(model, pipe: Pipeline, tokens, targets, weights,
             backward: bool):
    """GPipe's M forwards (and, where ``backward``, its M backwards):
    ``(loss, metrics)``, this stage's share of the objective (the task
    loss on the last stage, the aux terms on every stage) and, on the
    last stage, ``weighted_text_metrics`` summed over the microbatches
    (zeros elsewhere)."""
    from tpu_hc_bench_torch.models.moe import AUX_LOSS_COEF
    from tpu_hc_bench_torch.train.step import weighted_text_metrics

    m_count = pipe.num_microbatches
    b, s = tokens.shape
    if b % m_count:
        raise ValueError(f"per-worker batch {b} not divisible by "
                         f"num_microbatches={m_count}")
    mb = b // m_count
    dev = tokens.device
    act = (mb, s, model.hidden)
    wsum = weights.sum().float().clamp_min(1.0)
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    metrics = torch.zeros(3, dtype=torch.float32, device=dev)
    aux_sum = dropped_sum = None
    held = []
    for m in range(m_count):
        rows = slice(m * mb, (m + 1) * mb)
        x_in = None
        if pipe.first:
            x = model.pp_embed(tokens[rows])
        else:
            x = x_in = _recv(act, model.dtype, dev, pipe.prev, pipe.group)
            x_in.requires_grad_(backward)
        y, aux, dropped = model.pp_layers(x)
        terms = []
        if aux is not None:
            aux_term = AUX_LOSS_COEF * aux.float() / m_count
            terms.append(aux_term)
            loss += aux_term.detach()
            aux_sum = (aux.detach() if aux_sum is None
                       else aux_sum + aux.detach())
            dropped_sum = (dropped.detach() if dropped_sum is None
                           else dropped_sum + dropped.detach())
        if pipe.last:
            logits = model.pp_head(y)
            losses = F.cross_entropy(
                logits.flatten(0, -2).float(), targets[rows].flatten(),
                reduction="none").view(targets[rows].shape)
            task = (losses * weights[rows]).sum() / wsum
            terms.append(task)
            loss += task.detach()
            if not backward:
                metrics += weighted_text_metrics(logits, targets[rows],
                                                 weights[rows])
            held.append((x_in, None, terms))
        else:
            _send(y, pipe.next, pipe.group)
            held.append((x_in, y, terms))
    if aux_sum is not None:
        model.aux_loss = aux_sum / m_count
        model.moe_dropped = dropped_sum / (m_count * len(model.layers))
    if backward:
        for m in reversed(range(m_count)):
            x_in, y, terms = held.pop()
            outs = list(terms)
            grads = [None] * len(terms)
            if y is not None:
                outs.append(y)
                grads.append(_recv(act, model.dtype, dev, pipe.next,
                                   pipe.group))
            torch.autograd.backward(outs, grads)
            if x_in is not None:
                _send(x_in.grad, pipe.prev, pipe.group)
    return loss, metrics


def _pipe_sum_(tensors: list[torch.Tensor], pipe: Pipeline) -> None:
    """``tensors`` summed over the pipe group in place, in one
    all-reduce."""
    from tpu_hc_bench_torch.parallel import collectives

    if pipe.group is None or not tensors:
        return
    flat = collectives.pack(tensors)
    dist.all_reduce(flat, group=pipe.group)
    collectives.unpack(flat, tensors)


def replicated_params(model) -> list:
    """The parameters every stage holds whole (embedding, final norm,
    head), in order."""
    return [p for n, p in model.named_parameters()
            if not n.startswith("layers.")]


def train_step(state, batch):
    """One GPipe step of ``state`` (``TrainState.pipe``) on this rank's
    ``(tokens, targets, weights)``; returns the state and ``{"loss"}``,
    summed over the pipe group and averaged over the data group."""
    model, pipe, dp = state.model, state.pipe, state.dp
    state.optimizer.zero_grad(set_to_none=True)
    loss, _ = _forward(model, pipe, *batch, backward=True)
    if pipe.group is not None:
        shared = replicated_params(model)
        for p in shared:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        _pipe_sum_([p.grad for p in shared] + [loss.view(1)], pipe)
    if dp is not None:
        if dp.grads is not None:
            dp.grads.arm()
        dp.reduce(model, loss)
    state.optimizer.step()
    state.step += 1
    return state, {"loss": loss}


def forward_step(state, batch):
    """``--forward_only``: the training-mode loss (dropout drawn) of the
    pipeline with no update, summed over pipe and averaged over data."""
    with torch.no_grad():
        loss, _ = _forward(state.model, state.pipe, *batch, backward=False)
        _pipe_sum_([loss.view(1)], state.pipe)
        if state.dp is not None:
            loss = state.dp.sum_(loss) / state.dp.world
    return state, {"loss": loss}


def eval_step(state, batch):
    """JAX ``build_pp_eval_step``: ``(loss, top-1 count)`` from
    ``weighted_text_metrics`` on the last stage, summed over pipe and
    data; every rank returns the same numbers, which are DP eval's on
    the same weights."""
    with torch.no_grad():
        _, m = _forward(state.model, state.pipe, *batch, backward=False)
        _pipe_sum_([m], state.pipe)
        if state.dp is not None:
            m = state.dp.sum_(m)
    return m[0] / m[1].clamp_min(1.0), m[2]


# --- stacked and stage layouts -------------------------------------------------


def stack_layer_params(sd: dict, num_layers: int) -> dict:
    """A ``state_dict`` with ``layers.<i>.<name>`` -> ``trunk.<name>``
    stacked ``[L, ...]`` (JAX's ``stack_layer_params``); the other
    entries unchanged."""
    from tpu_hc_bench_torch.models import layer_stack

    return {TRUNK + k[len("layers."):] if k.startswith("layers.") else k: v
            for k, v in layer_stack.stack_state_dict(sd, num_layers).items()}


def unstack_layer_params(sd: dict, num_layers: int) -> dict:
    """``stack_layer_params``' inverse."""
    out = {k: v for k, v in sd.items() if not k.startswith(TRUNK)}
    for k, v in sd.items():
        if k.startswith(TRUNK):
            if v.shape[0] != num_layers:
                raise ValueError(f"{k}: {v.shape[0]} rows, want "
                                 f"{num_layers}")
            for i, t in enumerate(v.unbind(0)):
                out[f"layers.{i}.{k[len(TRUNK):]}"] = t
    return out


def _restack_state(opt: dict, fn) -> dict:
    """A params-shaped optimizer state (parameter name -> its state
    dict) with ``fn`` applied to each state key's name -> tensor map."""
    keys = sorted({k for st in opt.values() for k in st})
    per_key = {k: fn({n: st[k] for n, st in opt.items() if k in st})
               for k in keys}
    names = {n for d in per_key.values() for n in d}
    return {n: {k: d[n] for k, d in per_key.items() if n in d}
            for n in names}


def pp_state_from_train_state(params: dict, opt: dict,
                              num_layers: int) -> tuple[dict, dict]:
    """The unrolled ``(state_dict, name -> optimizer state)`` restacked:
    the layers' parameters and their momentum (or Adam's moments) into
    ``trunk.<name>`` ``[L, ...]`` (JAX's ``pp_state_from_train_state``)."""
    return (stack_layer_params(params, num_layers),
            _restack_state(opt, lambda d: stack_layer_params(d, num_layers)))


def train_state_from_pp(params: dict, opt: dict,
                        num_layers: int) -> tuple[dict, dict]:
    """``pp_state_from_train_state``'s inverse."""
    return (unstack_layer_params(params, num_layers),
            _restack_state(opt,
                           lambda d: unstack_layer_params(d, num_layers)))


def named_optimizer_state(opt_sd: dict, names: list[str]) -> dict:
    """An optimizer ``state_dict`` (keyed by parameter index) as
    parameter name -> its state."""
    return {names[i]: st for i, st in opt_sd["state"].items()}


def global_name(name: str, lo: int) -> str:
    """A stage's ``layers.<j>.`` name as the whole model's
    ``layers.<lo + j>.``."""
    m = _LAYER.fullmatch(name)
    return name if m is None else f"layers.{lo + int(m.group(1))}.{m.group(2)}"


def full_names(names: list[str], lo: int, num_layers: int) -> list[str]:
    """The whole model's parameter (or ``state_dict``) names in its
    order, from a stage's ``names``: the stage's layer block widened to
    all ``num_layers`` layers."""
    suffixes = [m.group(2) for n in names
                if (m := _LAYER.fullmatch(n)) and m.group(1) == "0"]
    out, placed = [], False
    for n in names:
        if _LAYER.fullmatch(n) is None:
            out.append(n)
        elif not placed:
            out += [f"layers.{i}.{x}" for i in range(num_layers)
                    for x in suffixes]
            placed = True
    return out


def _gather_layers(local: dict, pipe: Pipeline, num_layers: int,
                   order: list[str]) -> dict:
    """The whole model's entries from each stage's ``local`` (a stage's
    ``layers.<j>.<name>`` -> tensor, and the replicated entries): every
    stage's layer tensors broadcast over the pipe group (a collective;
    each stage's layers have the same names and shapes), copied to the
    host, in ``order``."""
    lo, hi = pipe.layers
    n = hi - lo
    out = {}
    for k, v in local.items():
        if _LAYER.fullmatch(k) is None:
            out[k] = v.detach().to("cpu", copy=True) \
                if isinstance(v, torch.Tensor) else v
    layer_keys = [k for k in local if _LAYER.fullmatch(k)]
    for s in range(pipe.stages):
        for k in layer_keys:
            v = local[k]
            if pipe.group is None:
                t = v.detach()
            else:
                t = (v.detach().contiguous() if s == pipe.stage
                     else torch.empty_like(v))
                dist.broadcast(t, pipe.src(s), group=pipe.group)
            out[global_name(k, s * n)] = t.to("cpu", copy=True)
    return {k: out[k] for k in order if k in out}


def full_state_dict(model, tp, pipe: Pipeline | None) -> dict:
    """``model``'s whole ``state_dict``, gathered over its model group
    (``tp``) and then its pipe group, on the host (collectives)."""
    from tpu_hc_bench_torch.parallel import tensor

    sd = tensor.full_state_dict(model, tp)
    if pipe is None:
        return sd
    order = full_names(list(sd), pipe.layers[0], model.num_layers)
    return _gather_layers(sd, pipe, model.num_layers, order)


def full_optimizer_state(optimizer, model, tp, pipe: Pipeline | None
                         ) -> dict:
    """The optimizer's ``state_dict`` as the whole model's (keyed by
    the whole model's parameter indexes), gathered over the model group
    and the pipe group (collectives)."""
    from tpu_hc_bench_torch.parallel import tensor

    opt = tensor.full_optimizer_state(optimizer, model, tp)
    if pipe is None:
        return opt
    names = [n for n, _ in model.named_parameters()]
    order = full_names(names, pipe.layers[0], model.num_layers)
    per = named_optimizer_state(opt, names)
    keys = sorted({k for st in per.values() for k in st})
    gathered = {k: _gather_layers({n: st[k] for n, st in per.items()
                                   if k in st}, pipe, model.num_layers,
                                  order)
                for k in keys}
    index = {n: i for i, n in enumerate(order)}
    state = {index[n]: {k: gathered[k][n] for k in keys if n in gathered[k]}
             for n in order if any(n in gathered[k] for k in keys)}
    groups = [{**g, "params": list(range(len(order)))}
              for g in opt["param_groups"]]
    return {"state": dict(sorted(state.items())), "param_groups": groups}


def cut_state_dict(sd: dict, model, pipe: Pipeline | None) -> dict:
    """The whole model's ``state_dict`` cut to this stage's entries
    (its layers renamed ``layers.<j>.``)."""
    if pipe is None:
        return sd
    lo = pipe.layers[0]
    return {k: sd[global_name(k, lo)] for k in model.state_dict()}


def cut_optimizer_state(opt_sd: dict, model, pipe: Pipeline | None) -> dict:
    """The whole model's optimizer ``state_dict`` cut to this stage's
    parameters, keyed by the stage model's indexes."""
    if pipe is None:
        return opt_sd
    names = [n for n, _ in model.named_parameters()]
    index = {n: i for i, n in enumerate(
        full_names(names, pipe.layers[0], model.num_layers))}
    lo = pipe.layers[0]
    state = {}
    for i, n in enumerate(names):
        st = opt_sd["state"].get(index[global_name(n, lo)])
        if st is not None:
            state[i] = st
    groups = [{**g, "params": list(range(len(names)))}
              for g in opt_sd["param_groups"]]
    return {"state": state, "param_groups": groups}
