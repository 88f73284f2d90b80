"""The training step of the port: one worker, momentum SGD.

The single-device arm of the JAX package's ``train/step.py``
(``build_train_step`` with a world of one, ``_loss_and_updates`` and
``make_optimizer``): forward in training mode (BatchNorm normalizes with
the batch's statistics and updates its running averages as a side effect
of the forward; a text model draws its dropout masks), the loss, backward,
optimizer update.  Two loss arms, by the batch: ``(images, labels)``
takes the integer-label softmax cross-entropy averaged over the batch;
``(tokens, targets, weights)`` the per-token cross-entropy on float32
logits, weighted and averaged over the weights (the text arm), where
``--fused_xent`` swaps ``F.cross_entropy`` for the blocked kernels of
``ops.xent.softmax_xent``, as in the JAX step; the image arm keeps
``F.cross_entropy`` either way.  With one
worker there is no gradient reduction; the NCCL arm comes with the
multi-card slice.

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


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN running statistics), its optimizer
    and the step count, which ``train_step`` updates in place, and the
    text arm's loss route (``--fused_xent``)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    fused_xent: bool = False


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


def make_train_state(model: torch.nn.Module,
                     cfg: BenchmarkConfig) -> TrainState:
    return TrainState(model.train(),
                      make_optimizer(cfg, model.parameters()),
                      fused_xent=cfg.fused_xent)


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


def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
    """One optimizer step on ``batch``, ``(images, labels)`` or
    ``(tokens, targets, weights)``; returns the state and ``{"loss":
    tensor}`` (left on the device: reading it is a host sync, which the
    driver does at display steps only)."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = batch_loss(state.model, batch, state.fused_xent)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return state, {"loss": loss.detach()}
