"""The training step of the port: momentum SGD, on one worker or data
parallel over ``torch.distributed``.

The counterpart of the JAX package's ``train/step.py``
(``build_train_step``, ``_loss_and_updates``, ``_accumulated_grads``,
``make_optimizer``): forward in training mode (BatchNorm normalizes with
the batch's statistics and updates its running averages as a side effect
of the forward; a text model draws its dropout masks), the loss,
backward, optimizer update.  Two loss arms, by the batch: ``(images,
labels)`` takes the integer-label softmax cross-entropy averaged over
the batch; ``(tokens, targets, weights)`` the per-token cross-entropy on
float32 logits, weighted and averaged over the weights (the text arm),
where ``--fused_xent`` swaps ``F.cross_entropy`` for the blocked kernels
of ``ops.xent.softmax_xent``, as in the JAX step; the image arm keeps
``F.cross_entropy`` either way.

Data parallel (``DataParallel``, over the default process group; every
rank holds the same state and its own rows of the batch):

- **fast fabric** (``ib|ici|dcn``): the gradients are averaged through
  the fusion buckets of ``parallel.collectives.GradReducer`` (``psum``;
  ``replicated``: one all-reduce a tensor), the BatchNorm running
  statistics through the same buckets (per tensor under
  ``replicated``), and the loss, each rank's own mean, averaged over the
  ranks (JAX's ``pmean``; for MLM weights that is not the global
  weighted mean).  BatchNorm normalizes with each worker's own batch, as
  Horovod's does; JAX's GSPMD ``replicated`` arm normalizes over the
  global batch, which a per-tensor all-reduce cannot.
- **host fabric** (``sock|host``): gradients, statistics and loss in one
  host round trip (``fabric.host_allreduce``).  It takes no gradient
  accumulation, as in JAX.

``--gradient_accumulation_steps=N`` splits a rank's batch into N
microbatches: a forward and backward each, the gradients summed in
``.grad`` (float32: parameters are float32) and divided by N, the loss
averaged, and the running statistics advanced by ONE decay toward the
mean of the microbatches' statistics: each microbatch starts from the
step's starting statistics and their results are averaged, as JAX's
scan does (a plain loop would chain N decays).  The gradient buckets
launch only during the last microbatch's backward.

``optax.sgd(lr, momentum=m)`` keeps ``trace = g + m * trace`` and steps
``-lr * trace``, which is ``torch.optim.SGD(lr, momentum=m)`` with no
dampening and no Nesterov (its first buffer is ``g``, optax's
``g + m * 0``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from tpu_hc_bench_torch.flags import BenchmarkConfig
from tpu_hc_bench_torch.ops.xent import softmax_xent
from tpu_hc_bench_torch.parallel import collectives
from tpu_hc_bench_torch.parallel.fabric import Fabric, host_allreduce


@dataclasses.dataclass
class DataParallel:
    """A step's data-parallel arm over the default process group: the
    fast fabric's gradient buckets (``grads``), or the host round trip
    when ``grads`` is None; ``allreduce_calls`` counts the last step's
    all-reduce calls."""

    fuse: bool
    threshold_bytes: int
    grads: collectives.GradReducer | None
    allreduce_calls: int = 0

    def reduce(self, model: torch.nn.Module, loss: torch.Tensor) -> None:
        """Average the gradients, the running statistics and ``loss`` over
        the ranks, in place, after the backward."""
        stats = list(model.buffers())
        if self.grads is None:
            params = [p for p in model.parameters() if p.requires_grad]
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            host_allreduce([p.grad for p in params] + stats + [loss], None)
            self.allreduce_calls = 1
            return
        n = self.grads.finish()
        n += collectives.allreduce_mean_(
            stats, threshold_bytes=self.threshold_bytes, fuse=self.fuse)
        n += collectives.allreduce_mean_([loss])
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


def make_optimizer(cfg: BenchmarkConfig,
                   params) -> torch.optim.Optimizer:
    """--optimizer dispatch, for the ported arms."""
    lr = cfg.init_learning_rate
    if cfg.optimizer == "momentum":
        return torch.optim.SGD(params, lr=lr, momentum=cfg.momentum)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr)
    raise ValueError(f"--optimizer={cfg.optimizer} is not ported yet "
                     "(momentum|sgd)")


def check_arm(cfg: BenchmarkConfig, fabric: Fabric) -> None:
    """The arms the fabric cannot run (JAX ``build_train_step``)."""
    if cfg.gradient_accumulation_steps > 1 and fabric is Fabric.HOST:
        raise ValueError("--gradient_accumulation_steps is not supported "
                         "on the host (sock) fabric step")


def make_train_state(model: torch.nn.Module, cfg: BenchmarkConfig,
                     fabric: Fabric | None = None) -> TrainState:
    """The state of a one-worker step (``fabric`` None: no reduction), or
    of the data-parallel arm of ``fabric`` over the default process
    group, which must be up."""
    dp = None
    if fabric is not None:
        fuse = cfg.variable_update == "psum"
        grads = collectives.GradReducer(
            model.parameters(), threshold_bytes=cfg.fusion_threshold_bytes,
            fuse=fuse, overlap=cfg.overlap_grad_comm == "on",
        ) if fabric.is_fast else None
        dp = DataParallel(fuse, cfg.fusion_threshold_bytes, grads)
    return TrainState(model.train(),
                      make_optimizer(cfg, model.parameters()),
                      fused_xent=cfg.fused_xent,
                      accum=cfg.gradient_accumulation_steps, dp=dp)


def loss_fn(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.softmax_cross_entropy_with_integer_labels(...).mean()``
    on float32 logits."""
    return F.cross_entropy(logits.float(), labels)


def lm_loss_fn(logits: torch.Tensor, targets: torch.Tensor,
               weights: torch.Tensor, fused_xent: bool = False
               ) -> torch.Tensor:
    """The JAX text arm: the per-token cross-entropy on float32 logits
    (``optax.softmax_cross_entropy_with_integer_labels``, or with
    ``fused_xent`` the blocked kernels' ``softmax_xent``), then
    ``(losses * weights).sum() / max(weights.sum(), 1)``."""
    flat, labels = logits.flatten(0, -2), targets.flatten()
    if fused_xent:
        losses = softmax_xent(flat, labels)
    else:
        losses = F.cross_entropy(flat.float(), labels, reduction="none")
    losses = losses.view(targets.shape)
    return (losses * weights).sum() / weights.sum().clamp_min(1.0)


def batch_loss(model: torch.nn.Module, batch,
               fused_xent: bool = False) -> torch.Tensor:
    """The forward and the loss arm that ``batch`` calls for;
    ``fused_xent`` applies to the text arm only."""
    if len(batch) == 3:
        tokens, targets, weights = batch
        return lm_loss_fn(model(tokens), targets, weights, fused_xent)
    images, labels = batch
    return loss_fn(model(images), labels)


def _accumulated_backward(state: TrainState, batch,
                          grads: collectives.GradReducer | None
                          ) -> torch.Tensor:
    """``state.accum`` microbatches' forwards and backwards (JAX
    ``_accumulated_grads``); returns the mean loss and leaves the mean
    gradients (``grads`` divides them as it packs them) and the averaged
    running statistics."""
    n, model = state.accum, state.model
    stats = list(model.buffers())
    start = [t.clone() for t in stats]
    sums = [torch.zeros_like(t, dtype=torch.promote_types(
        t.dtype, torch.float32)) for t in stats]
    total = None
    for i, micro in enumerate(zip(*(t.chunk(n) for t in batch))):
        if i:
            for t, t0 in zip(stats, start):
                t.copy_(t0)
        if grads is not None and i == n - 1:
            grads.arm(divisor=n)
        loss = batch_loss(model, micro, state.fused_xent)
        loss.backward()
        loss = loss.detach().float()
        total = loss if total is None else total + loss
        for a, t in zip(sums, stats):
            a.add_(t)
    for t, a in zip(stats, sums):
        t.copy_(a / n)
    if grads is None:
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(n)
    return total / n


def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
    """One optimizer step on this rank's ``batch``, ``(images, labels)``
    or ``(tokens, targets, weights)``; returns the state and ``{"loss":
    tensor}``, averaged over the ranks (left on the device: reading it
    is a host sync, which the driver does at display steps only)."""
    state.optimizer.zero_grad(set_to_none=True)
    dp = state.dp
    grads = dp.grads if dp is not None else None
    if state.accum > 1:
        loss = _accumulated_backward(state, batch, grads)
    else:
        if grads is not None:
            grads.arm()
        loss = batch_loss(state.model, batch, state.fused_xent)
        loss.backward()
        loss = loss.detach()
    if dp is not None:
        dp.reduce(state.model, loss)
    state.optimizer.step()
    state.step += 1
    return state, {"loss": loss}
