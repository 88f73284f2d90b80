"""The training step of the port, on one worker or data parallel over
``torch.distributed``, with its forward-only and eval arms.

The counterpart of the JAX package's ``train/step.py``
(``build_train_step``, ``_loss_and_updates``, ``_accumulated_grads``,
``make_optimizer``): forward in training mode (BatchNorm normalizes with
the batch's statistics and updates its running averages as a side effect
of the forward; a text model draws its dropout masks), the loss,
backward, optimizer update.  Three loss arms, by the model's spec (the
state's ``ctc``, JAX's ``ctc`` flag) and then the batch: ``(images,
labels)`` takes the integer-label softmax cross-entropy averaged over
the batch (an id batch, ``ncf``'s, too); ``(tokens, targets, weights)``
the per-token cross-entropy on float32 logits, weighted and averaged
over the weights (the text arm), where ``--fused_xent`` swaps
``F.cross_entropy`` for the blocked kernels of ``ops.xent.softmax_xent``,
as in the JAX step; the image arm keeps ``F.cross_entropy`` either way.
``(features, labels, label_paddings)`` of the CTC member, a 3-tuple like
a text batch, takes ``optax.ctc_loss(...).mean()`` (``ctc_loss_fn``).

Data parallel (``DataParallel``, over the default process group; every
rank holds the same state and its own rows of the batch):

- **fast fabric** (``ib|ici|dcn``): the gradients are averaged through
  the fusion buckets of ``parallel.collectives.GradReducer`` (``psum``;
  ``replicated``: one all-reduce a tensor), the BatchNorm running
  statistics through the same buckets, and the loss, each rank's own
  mean, averaged over the ranks (JAX's ``pmean``; for MLM weights that
  is not the global weighted mean).
- **host fabric** (``sock|host``): gradients, statistics and loss in one
  host round trip (``fabric.host_allreduce``).  It takes no gradient
  accumulation, as in JAX.
- **BatchNorm**: under ``psum`` (and ``horovod``) each worker normalizes
  with its own batch, as Horovod's does.  Under ``replicated`` every
  BatchNorm takes its statistics over the global batch, as JAX's GSPMD
  arm does: each layer all-reduces its per-channel ``(sum, sumsq,
  count)`` in the forward and the gradient of those sums in the backward
  (``models.resnet.sync_sum``), so the running averages come out equal
  on every rank and are not all-reduced again (JAX's GSPMD step has no
  such all-reduce either).

**ZeRO-1** (``--variable_update=zero1``, the fast fabric; JAX's zero1
arm): each rank keeps the optimizer state of its 1/N flat shard of every
parameter only (``collectives.Zero1Reducer``: the momentum traces, the
Adam and RMSprop slots are built over the shards).  The step
reduce-scatters the mean gradients into the shards (the same fusion
buckets and ``--overlap_grad_comm`` order as ``psum``), steps the
optimizer on the shards, and all-gathers the updated shards into the
parameters; the BatchNorm statistics and the loss are averaged through
the fused buckets as under ``psum``.  Under ``--on_nonfinite`` the
gradient's squared norm is this rank's shards' summed over the group,
so every rank computes the same flag.

**Multislice** (``fabric=dcn --num_slices=S``; JAX reduces over
``(dcn, data)``): every sum over the data axis (the gradient buckets,
the statistics, the loss, sync-BN, the eval sums) is the hierarchical
all-reduce of ``collectives.all_reduce_`` over the mesh's ``hier``:
reduce-scatter in the slice, all-reduce across slices, all-gather in
the slice.

**Tensor and expert parallelism** (``--model_parallel``,
``--expert_parallel``; JAX's GSPMD arm, ``_build_gspmd_step(
follow_inputs=True)``): the model is cut over its model group
(``parallel.tensor``; ``TrainState.tp``), the ranks of a model group see
the same rows, and the gradients, the loss and the statistics are
averaged over the data group only (the ranks with the same model
index), through the same buckets.  The text loss is the global batch's
weighted mean, as the GSPMD step takes it over the whole batch: each
rank's weighted sum over the weights summed over the data group, times
the data degree (the data axis averages it); an MoE layer's aux loss is
the global batch's likewise (``models.moe``).  Under ``--on_nonfinite``
the finite flag is taken over the whole world (each rank sees only its
shards' gradients), so one rank's NaN stops every rank.

Sequence parallelism needs nothing of its own here: the gradients, the
loss and the statistics are averaged over the (data, seq) ranks of this
rank's model index (``mesh.grad_group``; without TP the whole world, the
default group), as under ``psum``; the loss is each rank's local
weighted mean, averaged over those ranks (JAX's approximation, not the
exact global weighted mean), and each rank's dropout generator is
seeded by the first rank of its model group, distinct by both its data
and its seq index.  Under DP x SP x TP the model is cut over its model
group as under TP, but the loss stays SP's local mean and the
gradients keep their fused buckets (JAX reduces per tensor there: the
sums are the same).

**Pipeline parallelism** (``--pipeline_parallel``; ``TrainState.pipe``):
``train_step``, ``forward_step`` and ``eval_step`` hand the step to
``parallel.pipeline``'s GPipe schedule; its gradients are averaged over
the data group after the schedule (the buckets launch once, after the
last backward) and ``--fused_xent`` does not apply, as in JAX's PP
step.

``--gradient_accumulation_steps=N`` splits a rank's batch into N
microbatches: a forward and backward each, the gradients summed in
``.grad`` (float32: parameters are float32) and divided by N, the loss
averaged, and the running statistics advanced by ONE decay toward the
mean of the microbatches' statistics: each microbatch starts from the
step's starting statistics and their results are averaged, as JAX's
scan does (a plain loop would chain N decays).  The gradient buckets
launch only during the last microbatch's backward.

``--accum_dtype=bf16`` (JAX's accumulator for the parameter-bound
members): each microbatch's gradient is rounded to bf16 as it lands
(a post-accumulate-grad hook folds it into a bf16 accumulator of its own
and frees ``.grad``, so no float32 gradient tree outlives its
microbatch) and summed there in bf16; the mean is taken in float32 and
rounded to bf16, averaged over the ranks in bf16 fusion buckets
(``GradReducer.reduce_tree``, after the backward), and stepped from
that bf16 list by ``apply_bf16_grads`` with optax's promotions, one
parameter at a time, so no float32 gradient tree is ever built: plain
``sgd`` adds ``round_bf16(bf16(-lr) * g)`` to the float32 parameter (optax
casts the weak-typed ``-lr`` to the gradient's dtype), and the other
optimizers promote ``g`` against their float32 state (momentum's trace,
Adam's and RMSprop's moments).

The MoE members add ``AUX_LOSS_COEF`` times the layers' summed Switch
aux terms (the model's ``aux_loss``) to the text loss in the train and
forward-only steps, as the JAX step adds the sown ``"losses"``; the eval
step does not, as in JAX.

Real images arrive on the card as uint8 (``--wire_dtype=uint8``):
``prep_inputs`` normalizes them there, ``(x - MEAN) / STD`` in float32,
JAX's order (a subtraction, then a division by the float32 ``STD``), so
the normalized inputs are JAX's bit for bit on the CPU.

``--forward_only`` (``forward_step``): the training-mode loss (batch
statistics, dropout) with no update; the parameters, the optimizer state
and the BatchNorm running statistics stay as they are (JAX's step throws
the new statistics away).  ``--eval`` (``eval_step``): the loss and the
top-1 count with running statistics and no dropout, summed over the
ranks (the image loss averaged, the text loss the global weighted mean).

``--on_nonfinite`` (``TrainState.guard``, ``resilience.guards.guard_mode``;
JAX's in-step guard): under ``skip`` and ``rewind`` the step computes
``ok = isfinite(loss) & isfinite(global_norm(grads))`` on the device,
after the gradient all-reduce (every rank computes the same flag) and
from what the optimizer steps from (the reduced ``.grad``, or the bf16
accumulator's list), and returns it as ``metrics["nonfinite"]`` (int32
0/1, left on the device).  ``skip`` also drops a bad update: the step
holds a copy of the parameters, the BatchNorm buffers and the optimizer
state before its forward (``HeldState``, buffers made once) and selects
``where(ok, new, held)`` in place after the update, so a bad step leaves
them bit-equal to its input and the loop never syncs.  Adam and AdamW
keep their step count on the device under ``skip`` on the card
(``capturable``), so the select covers it too.

The optimizers are optax's (``make_optimizer``):

- ``optax.sgd(lr, momentum=m)`` keeps ``trace = g + m * trace`` and
  steps ``-lr * trace``, which is ``torch.optim.SGD(lr, momentum=m)``
  with no dampening and no Nesterov (its first buffer is ``g``, optax's
  ``g + m * 0``);
- ``optax.adam(lr)`` and ``optax.adamw(lr)`` (b1 0.9, b2 0.999, eps 1e-8
  outside the root; adamw's weight decay 1e-4 on every parameter) are
  ``torch.optim.Adam``/``AdamW`` so configured, equal up to rounding
  (torch divides by the bias corrections in another order);
- ``optax.rmsprop(lr, decay=0.9, eps=1.0)`` (tf_cnn_benchmarks' values)
  puts eps inside the root, ``g * rsqrt(nu + eps)``, with ``nu`` from 0:
  ``OptaxRMSprop``.  ``torch.optim.RMSprop`` divides by ``sqrt(nu) +
  eps``, which at eps 1.0 is another optimizer.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpu_hc_bench_torch.data.imagenet import IMAGENET_MEAN, IMAGENET_STD
from tpu_hc_bench_torch.flags import BenchmarkConfig
from tpu_hc_bench_torch.models import get_model_spec, resnet
from tpu_hc_bench_torch.models.moe import AUX_LOSS_COEF
from tpu_hc_bench_torch.models.resnet import running_stats_frozen
from tpu_hc_bench_torch.ops.xent import softmax_xent
from tpu_hc_bench_torch.parallel import collectives
from tpu_hc_bench_torch.parallel.fabric import Fabric, host_allreduce
from tpu_hc_bench_torch.parallel.tensor import TensorParallel
from tpu_hc_bench_torch.resilience import guards


@dataclasses.dataclass
class DataParallel:
    """A step's data-parallel arm over ``group`` (None: the default
    process group; under TP/EP the data group): the fast fabric's
    gradient buckets (``grads``), or the host round trip when ``grads``
    is None; ``hier``: the multislice hierarchy of every sum over the
    data axis; ``sync_bn``: BatchNorm statistics over the global batch
    (``replicated``), whose running averages then need no all-reduce;
    ``allreduce_calls`` counts the last step's all-reduce calls, sync-BN's
    included."""

    fuse: bool
    threshold_bytes: int
    grads: collectives.GradReducer | None
    sync_bn: bool = False
    allreduce_calls: int = 0
    group: object = None
    hier: collectives.Hierarchy | None = None

    @property
    def world(self) -> int:
        return dist.get_world_size(self.group)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data axis in place (JAX's ``psum``):
        NCCL on the fast fabric, a gloo sum through host memory on the
        host fabric."""
        if self.grads is None:
            host = t.cpu()
            dist.all_reduce(host, group=self.group)
            t.copy_(host)
            return t
        collectives.all_reduce_(t.view(-1), self.group, self.hier)
        return t

    @property
    def zero1(self) -> bool:
        return isinstance(self.grads, collectives.Zero1Reducer)

    def reduce(self, model: torch.nn.Module, loss: torch.Tensor,
               grads_reduced: bool = False) -> None:
        """Average the gradients (unless ``grads_reduced``: the bf16
        accumulator's went through ``GradReducer.reduce_tree``), the
        running statistics (not under ``sync_bn``) and ``loss`` over the
        ranks, in place, after the backward."""
        stats = [] if self.sync_bn else list(model.buffers())
        if self.grads is None:
            params = [p for p in model.parameters() if p.requires_grad]
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            host_allreduce([p.grad for p in params] + stats + [loss],
                           self.group)
            self.allreduce_calls = 1
            return
        n = (self.grads.tree_calls if grads_reduced
             else self.grads.finish())
        if stats:
            n += collectives.allreduce_mean_(
                stats, self.group, threshold_bytes=self.threshold_bytes,
                fuse=self.fuse, hier=self.hier)
        n += collectives.allreduce_mean_([loss], self.group, hier=self.hier)
        self.allreduce_calls = n


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN running statistics), its optimizer
    and the step count, which ``train_step`` updates in place; the text
    arm's loss route (``--fused_xent``), the microbatches a step and the
    data-parallel arm (None on one worker)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    fused_xent: bool = False
    accum: int = 1
    dp: DataParallel | None = None
    accum_dtype: str = "f32"
    ctc: bool = False
    guard: str = "off"               # --on_nonfinite: off | flag | skip
    held: guards.HeldState | None = None   # skip: the pre-step copy
    tp: TensorParallel | None = None       # TP/EP: the model's sharding
    pipe: object = None                    # PP: parallel.pipeline.Pipeline


class OptaxRMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr, decay, eps)`` (not centered, no momentum):
    ``nu = decay * nu + (1 - decay) * g^2`` from ``nu = 0``, then ``p -=
    lr * g * rsqrt(nu + eps)``, eps inside the root."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, decay, eps = group["lr"], group["decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu, g = state["nu"], p.grad
                nu.mul_(decay).add_(g * g, alpha=1.0 - decay)
                p.add_(g * torch.rsqrt(nu + eps), alpha=-lr)


def make_optimizer(cfg: BenchmarkConfig,
                   params) -> torch.optim.Optimizer:
    """--optimizer dispatch: JAX ``make_optimizer``'s optax optimizers.
    Under ``--on_nonfinite=skip`` on the card Adam and AdamW keep their
    step count on the device (``capturable``), where the skip's select
    reaches it without a host sync."""
    lr = cfg.init_learning_rate
    params = list(params)
    if cfg.optimizer == "momentum":
        return torch.optim.SGD(params, lr=lr, momentum=cfg.momentum)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr)
    capturable = (getattr(cfg, "on_nonfinite", "abort") == "skip"
                  and bool(params) and params[0].is_cuda)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                capturable=capturable)
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=1e-4,
                                 capturable=capturable)
    if cfg.optimizer == "rmsprop":
        return OptaxRMSprop(params, lr=lr, decay=0.9, eps=1.0)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def check_arm(cfg: BenchmarkConfig, fabric: Fabric) -> None:
    """The arms the fabric cannot run (JAX ``build_train_step``)."""
    if cfg.gradient_accumulation_steps > 1 and fabric is Fabric.HOST:
        raise ValueError("--gradient_accumulation_steps is not supported "
                         "on the host (sock) fabric step")
    if cfg.variable_update == "zero1" and fabric is Fabric.HOST:
        raise ValueError(
            "--variable_update=zero1 needs a device fabric (ici): the "
            "host (sock-analog) path has no sharded optimizer")


def make_train_state(model: torch.nn.Module, cfg: BenchmarkConfig,
                     fabric: Fabric | None = None, mesh=None,
                     tp: TensorParallel | None = None,
                     pipe=None) -> TrainState:
    """The state of a one-worker step (``fabric`` None: no reduction), or
    of the data-parallel arm of ``fabric`` over the default process
    group, which must be up; with ``mesh`` (``distributed.build_mesh``)
    over its multislice hierarchy, and under a model or pipe axis over
    its gradient group only (``mesh.grad_group``: the seq ranks of
    sequence parallelism hold the same parameters and average with the
    data ranks); ``tp`` the sharding of a model cut by
    ``parallel.tensor.shard_model_``; ``pipe`` a pipeline stage's
    ``parallel.pipeline.Pipeline``."""
    dp = None
    group = mesh.grad_group if mesh is not None else None
    hier = mesh.hier if mesh is not None else None
    zero1 = cfg.variable_update == "zero1"
    if zero1 and fabric is None:
        raise ValueError("--variable_update=zero1 shards the optimizer "
                         "state over a process group; there is none")
    if fabric is not None:
        check_arm(cfg, fabric)
        # the TP/EP arm averages over the data group in fused buckets too
        fuse = cfg.variable_update in ("psum", "zero1") or tp is not None
        # the pipeline reduces once, after its last backward
        overlap = cfg.overlap_grad_comm == "on" and pipe is None
        if zero1:
            if hier is not None:
                raise ValueError(
                    "--variable_update=zero1 composes with single-slice "
                    "data parallelism only (the multislice (dcn, data) "
                    "hierarchical reduce has no reduce-scatter layout yet)")
            grads = collectives.Zero1Reducer(
                model.parameters(), group,
                threshold_bytes=cfg.fusion_threshold_bytes, overlap=overlap)
        elif fabric.is_fast:
            grads = collectives.GradReducer(
                model.parameters(), group,
                threshold_bytes=cfg.fusion_threshold_bytes, fuse=fuse,
                overlap=overlap, hier=hier)
        else:
            grads = None
        dp = DataParallel(fuse, cfg.fusion_threshold_bytes, grads,
                          sync_bn=cfg.variable_update == "replicated",
                          group=group, hier=hier)
        for m in model.modules():
            if isinstance(m, resnet.BatchNorm):
                m.sync = dp.sync_bn
                m.sync_axis = (group, hier)
    guard = guards.guard_mode(cfg)
    stepped = dp.grads.shards if zero1 else model.parameters()
    return TrainState(model.train(), make_optimizer(cfg, stepped),
                      fused_xent=cfg.fused_xent,
                      accum=cfg.gradient_accumulation_steps, dp=dp,
                      accum_dtype=cfg.accum_dtype,
                      ctc=get_model_spec(cfg.model).ctc, guard=guard,
                      held=guards.HeldState() if guard == "skip" else None,
                      tp=tp, pipe=pipe)


def optimizer_state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """The bytes of this rank's optimizer state (its tensors)."""
    return sum(v.numel() * v.element_size()
               for st in optimizer.state.values() for v in st.values()
               if isinstance(v, torch.Tensor))


def loss_fn(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.softmax_cross_entropy_with_integer_labels(...).mean()``
    on float32 logits."""
    return F.cross_entropy(logits.float(), labels)


def lm_loss_fn(logits: torch.Tensor, targets: torch.Tensor,
               weights: torch.Tensor, fused_xent: bool = False,
               tp: TensorParallel | None = None) -> torch.Tensor:
    """The JAX text arm: the per-token cross-entropy on float32 logits
    (``optax.softmax_cross_entropy_with_integer_labels``, or with
    ``fused_xent`` the blocked kernels' ``softmax_xent``), then
    ``(losses * weights).sum() / max(weights.sum(), 1)``; under TP/EP
    (``tp`` with a data group) the weights' sum is the global batch's and
    the result is scaled by the data degree, so its mean over the data
    axis is the global weighted mean."""
    flat, labels = logits.flatten(0, -2), targets.flatten()
    if fused_xent:
        losses = softmax_xent(flat, labels)
    else:
        losses = F.cross_entropy(flat.float(), labels, reduction="none")
    losses = losses.view(targets.shape)
    if tp is None or tp.data_group is None:
        return (losses * weights).sum() / weights.sum().clamp_min(1.0)
    total = weights.sum().detach().float().clone()
    dist.all_reduce(total, group=tp.data_group)
    return (losses * weights).sum() * tp.dp / total.clamp_min(1.0)


def ctc_loss_fn(logits: torch.Tensor, labels: torch.Tensor,
                label_paddings: torch.Tensor) -> torch.Tensor:
    """The JAX CTC arm, ``optax.ctc_loss(logits, zeros, labels,
    label_paddings).mean()``: log-softmax over float32 logits ``[B, T,
    C]``, blank 0, every frame valid, each utterance's negative
    log-likelihood over its ``sum(1 - label_paddings)`` labels, averaged
    over the batch (``reduction="mean"`` would also divide each by its
    label count)."""
    b, t = logits.shape[:2]
    logp = F.log_softmax(logits.float(), -1).transpose(0, 1)
    frames = torch.full((b,), t, dtype=torch.int64, device=logits.device)
    lengths = (1.0 - label_paddings).sum(-1).round().to(torch.int64)
    return F.ctc_loss(logp, labels, frames, lengths, blank=0,
                      reduction="none").mean()


@functools.lru_cache(maxsize=None)
def _norm_consts(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """ImageNet's mean and std (x 255) as float32 ``[1, 3, 1, 1]`` on
    ``device``, copied there once."""
    return tuple(torch.from_numpy(a).to(device).view(1, 3, 1, 1)
                 for a in (IMAGENET_MEAN, IMAGENET_STD))


def prep_inputs(images: torch.Tensor) -> torch.Tensor:
    """JAX ``prep_inputs``: a uint8 image batch (an NCHW view of NHWC
    crops) to float32 ``(x - MEAN) / STD`` on its device, in
    ``channels_last`` memory like the batch; float images pass
    through."""
    if images.dtype != torch.uint8:
        return images
    mean, std = _norm_consts(images.device)
    return (images.float() - mean) / std


def batch_loss(model: torch.nn.Module, batch, fused_xent: bool = False,
               ctc: bool = False, tp: TensorParallel | None = None
               ) -> torch.Tensor:
    """The forward and the loss arm: CTC where ``ctc`` (the spec's),
    else the one ``batch`` calls for; ``fused_xent`` applies to the text
    arm only, where an MoE model's aux term joins the loss."""
    if ctc:
        feats, labels, paddings = batch
        return ctc_loss_fn(model(feats), labels, paddings)
    if len(batch) == 3:
        tokens, targets, weights = batch
        loss = lm_loss_fn(model(tokens), targets, weights, fused_xent, tp)
        aux = getattr(model, "aux_loss", None)
        return loss if aux is None else loss + AUX_LOSS_COEF * aux
    images, labels = batch
    return loss_fn(model(prep_inputs(images)), labels)


@torch.no_grad()
def apply_bf16_grads(optimizer: torch.optim.Optimizer, params: list,
                     grads: list) -> None:
    """optax's update from the bf16 accumulator's gradients ``grads``
    (one a parameter of ``params``), freed as it goes: plain ``sgd``
    adds ``bf16(-lr) * g``, rounded to bf16, to the float32 parameter;
    the other optimizers step on ``g`` widened to float32, one
    parameter's ``.grad`` at a time (the promotion optax applies against
    their float32 state)."""
    group = optimizer.param_groups[0]
    plain_sgd = (isinstance(optimizer, torch.optim.SGD)
                 and not group["momentum"])
    for i, (p, g) in enumerate(zip(params, grads)):
        if plain_sgd:
            p.add_(g * torch.tensor(-group["lr"], dtype=torch.bfloat16,
                                    device=g.device))
        else:
            p.grad = g.float()
            optimizer.step()
            p.grad = None
        grads[i] = None


def _accumulated_backward(state: TrainState, batch,
                          grads: collectives.GradReducer | None
                          ) -> tuple[torch.Tensor, tuple | None]:
    """``state.accum`` microbatches' forwards and backwards (JAX
    ``_accumulated_grads``); returns the mean loss and, under the bf16
    accumulator, ``(params, their mean bf16 gradients)`` for
    ``apply_bf16_grads`` (else None: the mean gradients are left in
    ``.grad``, ``grads`` dividing them as it packs them), and leaves
    the averaged running statistics."""
    n, model = state.accum, state.model
    bf16 = state.accum_dtype == "bf16"
    if bf16:
        params = [p for p in model.parameters() if p.requires_grad]
        acc: list = [None] * len(params)

        def fold(i: int, p) -> None:
            g = p.grad.to(torch.bfloat16)
            if acc[i] is None:
                acc[i] = g
            else:
                acc[i].add_(g)
            p.grad = None

        hooks = [p.register_post_accumulate_grad_hook(
            functools.partial(fold, i)) for i, p in enumerate(params)]
    stats = list(model.buffers())
    start = [t.clone() for t in stats]
    sums = [torch.zeros_like(t, dtype=torch.promote_types(
        t.dtype, torch.float32)) for t in stats]
    total = None
    for i, micro in enumerate(zip(*(t.chunk(n) for t in batch))):
        if i:
            for t, t0 in zip(stats, start):
                t.copy_(t0)
        if grads is not None and i == n - 1 and not bf16:
            grads.arm(divisor=n)
        loss = batch_loss(model, micro, state.fused_xent, state.ctc,
                          state.tp)
        try:
            loss.backward()
        except BaseException:
            if bf16:
                for h in hooks:
                    h.remove()
            raise
        loss = loss.detach().float()
        total = loss if total is None else total + loss
        for a, t in zip(sums, stats):
            a.add_(t)
    for t, a in zip(stats, sums):
        t.copy_(a / n)
    if bf16:
        for h in hooks:
            h.remove()
        for i, (a, p) in enumerate(zip(acc, params)):
            acc[i] = (torch.zeros(p.shape, dtype=torch.bfloat16,
                                  device=p.device) if a is None
                      else (a.float() / n).to(torch.bfloat16))
        if grads is not None:
            grads.reduce_tree(acc)
        return total / n, (params, acc)
    if grads is None:
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(n)
    return total / n, None


def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
    """One optimizer step on this rank's ``batch``, ``(images, labels)``,
    ``(tokens, targets, weights)`` or ``(features, labels,
    label_paddings)``; returns the state and ``{"loss":
    tensor}``, averaged over the ranks (left on the device: reading it
    is a host sync, which the driver does at display steps only), plus
    ``"nonfinite"`` under a guard."""
    if state.pipe is not None:
        from tpu_hc_bench_torch.parallel import pipeline

        return pipeline.train_step(state, batch)
    if state.guard == "skip":
        state.held.hold(state.model, state.optimizer)
    dp = state.dp
    grads = dp.grads if dp is not None else None
    zero1 = dp is not None and dp.zero1
    if zero1:
        state.model.zero_grad(set_to_none=True)
        grads.refresh()
    state.optimizer.zero_grad(set_to_none=True)
    resnet.sync_calls = 0
    # the bf16 accumulator's gradients are reduced inside, in bf16
    reduced = grads is not None and state.accum > 1 \
        and state.accum_dtype == "bf16"
    bf16_grads = None
    if state.accum > 1:
        loss, bf16_grads = _accumulated_backward(state, batch, grads)
    else:
        if grads is not None:
            grads.arm()
        loss = batch_loss(state.model, batch, state.fused_xent, state.ctc,
                          state.tp)
        loss.backward()
        loss = loss.detach()
    if dp is not None:
        dp.reduce(state.model, loss, grads_reduced=reduced)
        dp.allreduce_calls += resnet.sync_calls
    if zero1 and bf16_grads is not None:
        bf16_grads = (grads.shards, grads.tree_shards)
    ok = None
    if state.guard != "off":
        if zero1:
            ok = guards.finite_flag(loss) & torch.isfinite(
                grads.grad_sq_sum(bf16_grads[1] if bf16_grads else None))
        else:
            ok = guards.finite_flag(loss, bf16_grads[1] if bf16_grads else [
                p.grad for p in state.model.parameters()])
        if state.tp is not None:
            ok = guards.world_flag(ok)
    if bf16_grads is not None:
        apply_bf16_grads(state.optimizer, *bf16_grads)
    else:
        state.optimizer.step()
    if zero1:
        dp.allreduce_calls += grads.gather()
    state.step += 1
    if ok is None:
        return state, {"loss": loss}
    if state.guard == "skip":
        state.held.select(ok, state.model, state.optimizer)
    return state, {"loss": loss, "nonfinite": guards.nonfinite_metric(ok)}


def _ranks_sum(dp: DataParallel | None, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data axis (JAX's ``psum``)."""
    return t if dp is None else dp.sum_(t)


def forward_step(state: TrainState, batch) -> tuple[TrainState, dict]:
    """``--forward_only``: the loss in training mode (batch statistics,
    dropout drawn) with no backward and no update; the parameters, the
    optimizer state, the step count and the running statistics are left
    as they were.  The loss is averaged over the ranks."""
    if state.pipe is not None:
        from tpu_hc_bench_torch.parallel import pipeline

        return pipeline.forward_step(state, batch)
    with torch.no_grad(), running_stats_frozen(state.model):
        loss = batch_loss(state.model, batch, state.fused_xent,
                          state.ctc, state.tp).float()
    if state.dp is not None:
        loss = _ranks_sum(state.dp, loss) / state.dp.world
    return state, {"loss": loss}


def weighted_text_metrics(logits: torch.Tensor, targets: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """JAX ``weighted_text_metrics``: ``[sum of weighted losses, sum of
    weights, weighted top-1 count]`` of one rank's tokens, float32."""
    losses = F.cross_entropy(logits.flatten(0, -2).float(),
                             targets.flatten(), reduction="none")
    w = weights.flatten()
    correct = ((logits.argmax(-1).flatten() == targets.flatten()) * w).sum()
    return torch.stack([(losses * w).sum(), w.sum(), correct.float()])


def eval_step(state: TrainState, batch) -> tuple[torch.Tensor,
                                                 torch.Tensor]:
    """JAX ``build_eval_step``: ``(loss, top-1 count)`` of ``batch`` with
    the model as it is (``run_benchmark`` puts it in eval mode: running
    statistics, no dropout).  Images: the mean cross-entropy averaged
    over the ranks; text: the weighted mean over every rank's tokens.
    The count is summed over the ranks."""
    if state.pipe is not None:
        from tpu_hc_bench_torch.parallel import pipeline

        return pipeline.eval_step(state, batch)
    model = state.model
    with torch.no_grad():
        if len(batch) == 3:
            tokens, targets, weights = batch
            m = _ranks_sum(state.dp, weighted_text_metrics(
                model(tokens), targets, weights))
            return m[0] / m[1].clamp_min(1.0), m[2]
        images, labels = batch
        logits = model(prep_inputs(images))
        m = _ranks_sum(state.dp, torch.stack([
            loss_fn(logits, labels),
            (logits.argmax(-1) == labels).sum().float()]))
    world = state.dp.world if state.dp is not None else 1
    return m[0] / world, m[1]
