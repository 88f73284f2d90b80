"""Non-finite step guards: detect a NaN/inf loss or gradient in the step
(the port's copy of the JAX package's ``resilience/guards.py``).

The detection runs on the device, inside the train step, after the
gradient all-reduce (so every rank computes the same flag): ``ok`` is
``isfinite(loss) & isfinite(global_norm(grads))``.  The ``skip`` policy
drops the update without a host sync: the step holds a copy of the
state it is about to change (parameters, BatchNorm buffers, optimizer
state) in buffers made once, steps, and then selects ``where(ok, new,
held)`` in place, so a bad step leaves every tensor bit-equal to its
input.  JAX selects inside one compiled program; here the select is a
handful of elementwise launches a tensor.

Budget accounting (``GuardTracker``) stays on the device as three int32
scalars advanced by a few tiny launches a step.  The driver reads them
once per sync window through a snapshot copied to pinned host memory
behind the window's steps (``handles``) and read one window later, when
the copy has long landed, so the loop never waits on the device;
saves, preemption and the final step settle synchronously (``poll``).
"""

from __future__ import annotations

import torch


class NonFiniteError(RuntimeError):
    """A non-finite loss/gradient was detected and policy says die."""


class GuardBudgetError(NonFiniteError):
    """The --max_bad_steps consecutive-failure budget was exhausted."""


def finite_flag(loss: torch.Tensor, grads=None) -> torch.Tensor:
    """0-dim bool on ``loss``'s device: the loss (and, when given, the
    gradients' global norm) are finite.  No host sync."""
    ok = torch.isfinite(loss.detach().float())
    grads = [g for g in (grads or ()) if g is not None]
    if grads:
        norms = torch.stack([n.float() for n in torch._foreach_norm(grads)])
        ok = ok & torch.isfinite(norms.square().sum().sqrt())
    return ok


def world_flag(ok: torch.Tensor) -> torch.Tensor:
    """``ok`` and-ed over every rank of the default group (a MIN
    all-reduce on the device): under tensor parallelism each rank sees
    its own shards' gradients, and one rank's NaN must stop them all."""
    import torch.distributed as dist

    flag = ok.to(torch.float32).reshape(1)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return flag[0] > 0.5


def nonfinite_metric(ok: torch.Tensor) -> torch.Tensor:
    """The per-step guard metric: int32 1 when the step was bad, else 0."""
    return (~ok).to(torch.int32)


def state_tensors(model: torch.nn.Module,
                  optimizer: torch.optim.Optimizer) -> list[torch.Tensor]:
    """Every tensor a train step changes in place: the parameters, the
    buffers (BatchNorm statistics) and the optimizer's state."""
    out = list(model.parameters())
    out += list(model.buffers())
    for st in optimizer.state.values():
        out += [v for v in st.values() if isinstance(v, torch.Tensor)]
    return out


class HeldState:
    """The ``skip`` policy's copy of the state before a step.

    ``hold`` copies the state tensors into buffers made when the set of
    state tensors changes (one more copy of the state, reused every
    step; one multi-tensor copy launch); ``select`` puts the held values
    back where ``ok`` is False, in place, one select a tensor.
    Optimizer state a step creates (a momentum buffer, Adam's moments
    and count) had no value to hold: ``select`` zeroes it, which is the
    state a fresh optimizer steps from."""

    def __init__(self):
        self._live: list[torch.Tensor] = []
        self._held: list[torch.Tensor] = []

    @torch.no_grad()
    def hold(self, model, optimizer) -> None:
        live = state_tensors(model, optimizer)
        if len(live) != len(self._live) or any(
                a is not b for a, b in zip(live, self._live)):
            kept = {id(t): h for t, h in zip(self._live, self._held)}
            self._held = [kept.get(id(t)) if id(t) in kept
                          and kept[id(t)].shape == t.shape
                          else torch.empty_like(t) for t in live]
            self._live = live
        if live:
            torch._foreach_copy_(self._held, self._live)

    @torch.no_grad()
    def select(self, ok: torch.Tensor, model, optimizer) -> None:
        select_state(ok, self._live, self._held)
        held = {id(t) for t in self._live}
        for t in state_tensors(model, optimizer)[len(self._live):]:
            if id(t) not in held:
                torch.where(ok, t, torch.zeros_like(t), out=t)


def select_state(ok: torch.Tensor, new: list[torch.Tensor],
                 old: list[torch.Tensor]) -> None:
    """In place: each of ``new`` keeps its value where ``ok``, else takes
    its ``old`` counterpart's (the JAX ``select_state`` over lists)."""
    for n, o in zip(new, old):
        torch.where(ok, n, o, out=n)


class GuardTracker:
    """Device-side (streak, total, peak) counters over the per-step
    guard flag.

    ``update`` launches a few tiny elementwise kernels a step (no host
    round trip); ``poll`` reads the scalars, the one deliberate sync,
    paid by the driver where it must.  ``peak`` is the longest streak
    ever seen, so a consecutive-failure run that ends inside a window
    still trips the --max_bad_steps budget.
    """

    def __init__(self, device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        self.reset()

    def update(self, bad: torch.Tensor) -> None:
        bad = (bad > 0).to(torch.int32).to(self.device)
        streak = torch.where(bad > 0, self._streak + 1,
                             torch.zeros_like(self._streak))
        self._total = self._total + bad
        self._peak = torch.maximum(self._peak, streak)
        self._streak = streak

    def poll(self) -> tuple[int, int, int]:
        """``(consecutive_bad, total_bad, peak_consecutive)``; syncs."""
        streak, total, peak = torch.stack(
            [self._streak, self._total, self._peak]).tolist()
        return int(streak), int(total), int(peak)

    def handles(self):
        """A snapshot of the live counters, read later by ``fetch``
        without stalling the loop: on the card a copy into pinned host
        memory queued behind the steps so far, and the event that marks
        it landed."""
        vals = torch.stack([self._streak, self._total, self._peak])
        if self.device.type != "cuda":
            return vals.clone(), None
        host = torch.empty(3, dtype=torch.int32, pin_memory=True)
        host.copy_(vals, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    @staticmethod
    def fetch(handles) -> tuple[int, int, int]:
        host, ev = handles
        if ev is not None:
            ev.synchronize()
        streak, total, peak = host.tolist()
        return int(streak), int(total), int(peak)

    def reset(self) -> None:
        z = torch.zeros((), dtype=torch.int32, device=self.device)
        self._streak, self._total, self._peak = z, z.clone(), z.clone()


def guard_mode(cfg) -> str:
    """The step's guard wiring for a resolved config (JAX's rule).

    ``"skip"``: detect and drop bad updates (the held-state select);
    ``"flag"``: detect only (``rewind`` restores a checkpoint, so the
    poisoned update needs no select); ``"off"``: no guard ops in the
    step (``abort`` checks the display-step losses the loop already
    reads; forward-only and eval steps have no update to protect)."""
    policy = getattr(cfg, "on_nonfinite", "abort")
    if getattr(cfg, "forward_only", False) or getattr(cfg, "eval", False):
        return "off"
    if policy == "skip":
        return "skip"
    if policy == "rewind":
        return "flag"
    return "off"
