"""Deterministic fault injection: ``--inject_fault=CLASS@WHERE[,...]``
(the port's copy of the JAX package's ``resilience/inject.py``, its
training lane; the serving lane's ``--serve_faults`` is
``serve/faults.py``).

- ``nan_loss@N``    poison timed step N's batch (float leaves x NaN), so
                    the loss and gradients of that step are non-finite:
                    the ``--on_nonfinite`` guard end to end.
- ``hang@N:S``      sleep S seconds before dispatching step N (no step
                    completes: the watchdog's signature).
- ``sigterm@N``     ``kill(self, SIGTERM)`` before step N: preemption,
                    the emergency checkpoint, resume.
- ``io_error@ckpt`` the next checkpoint save raises ``OSError`` once: the
                    bounded retry (``resilience.retry``).

Entries may repeat (``nan_loss@3,nan_loss@4``).  Parsing is loud and
happens at flag time; each fired fault is printed and written as an
``injected_fault`` record into the metrics stream.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time

import torch

#: the two lanes' fault vocabularies, named together in every parse
#: error (a valid spelling handed to the wrong flag is the usual mistake)
TRAIN_VOCAB = "nan_loss@STEP | hang@STEP:SECONDS | sigterm@STEP | io_error@ckpt"
SERVE_VOCAB = ("hang@STEP:SECONDS | nan_logits@RID | sigterm@T_SECONDS"
               " | pool_squeeze@T_SECONDS:PAGES")


def malformed(entry: str, lane: str = "train") -> str:
    """The parse-error message both lanes raise (JAX's words)."""
    return (f"malformed fault entry {entry!r} for the {lane} lane; "
            f"train grammar (--inject_fault): {TRAIN_VOCAB}; "
            f"serve grammar (--serve_faults): {SERVE_VOCAB}")


def split_entries(spec: str | None, lane: str = "train") -> list[tuple]:
    """``CLASS@WHERE[:ARG]`` entries -> ``(cls, where, arg, entry)``
    tuples (``arg`` None without a ``:`` part), loud on structural
    malformation."""
    out: list[tuple] = []
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        cls, sep, rest = entry.partition("@")
        if not sep or not cls or not rest:
            raise ValueError(malformed(entry, lane))
        where, sep2, arg = rest.partition(":")
        if not where or (sep2 and not arg):
            raise ValueError(malformed(entry, lane))
        out.append((cls, where, arg if sep2 else None, entry))
    return out


def _leaves(batch) -> list:
    if isinstance(batch, (tuple, list)):
        return [x for b in batch for x in _leaves(b)]
    if isinstance(batch, dict):
        return [x for b in batch.values() for x in _leaves(b)]
    return [batch]


def _poison(batch):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_poison(b) for b in batch)
    if isinstance(batch, dict):
        return {k: _poison(v) for k, v in batch.items()}
    if isinstance(batch, torch.Tensor) and batch.is_floating_point():
        return batch * float("nan")        # a new tensor: the batch may
                                           # be the one fed every step
    return batch


@dataclasses.dataclass
class FaultPlan:
    nan_loss: frozenset[int]
    hang: dict[int, float]          # step -> seconds
    sigterm: frozenset[int]
    io_error: set[str]              # targets, one-shot (disarmed on fire)

    def __bool__(self) -> bool:
        return bool(self.nan_loss or self.hang or self.sigterm
                    or self.io_error)

    def fire_step_faults(self, step: int, print_fn, obs_writer=None) -> None:
        """Host-side faults that fire before step ``step`` dispatches."""
        if step in self.hang:
            seconds = self.hang[step]
            self._announce(print_fn, obs_writer, "hang", step,
                           seconds=seconds)
            time.sleep(seconds)
        if step in self.sigterm:
            self._announce(print_fn, obs_writer, "sigterm", step)
            os.kill(os.getpid(), signal.SIGTERM)

    def poison_batch(self, step: int, batch, print_fn, obs_writer=None):
        """nan_loss: every float leaf of step ``step``'s batch times NaN
        (integer leaves, labels and token ids, pass through)."""
        if step not in self.nan_loss:
            return batch
        if not any(isinstance(x, torch.Tensor) and x.is_floating_point()
                   for x in _leaves(batch)):
            raise ValueError(
                f"inject_fault=nan_loss@{step}: the batch has no float "
                "leaves to poison (token/id inputs are integers); use an "
                "image or speech model")
        self._announce(print_fn, obs_writer, "nan_loss", step)
        return _poison(batch)

    def maybe_io_error(self, target: str) -> None:
        """One-shot OSError for ``io_error@<target>`` (disarms on fire);
        called from inside the retried I/O path."""
        if target in self.io_error:
            self.io_error.discard(target)
            raise OSError(f"injected io_error@{target}")

    @staticmethod
    def _announce(print_fn, obs_writer, fault: str, step: int,
                  **fields) -> None:
        detail = "".join(f" {k}={v}" for k, v in fields.items())
        print_fn(f"inject: {fault} at timed step {step}{detail}")
        if obs_writer is not None:
            obs_writer.event("injected_fault", fault=fault, step=step,
                             **fields)


def parse_plan(spec: str | None) -> FaultPlan | None:
    """Parse the --inject_fault grammar; None/empty spec -> None."""
    if not spec:
        return None
    nan_loss: set[int] = set()
    hang: dict[int, float] = {}
    sigterm: set[int] = set()
    io_error: set[str] = set()
    for cls, where, arg, entry in split_entries(spec, lane="train"):
        try:
            if cls == "nan_loss":
                if arg is not None:
                    raise ValueError
                nan_loss.add(_step(where))
            elif cls == "hang":
                if arg is None:
                    raise ValueError
                hang[_step(where)] = _seconds(arg)
            elif cls == "sigterm":
                if arg is not None:
                    raise ValueError
                sigterm.add(_step(where))
            elif cls == "io_error":
                if where != "ckpt" or arg is not None:
                    raise ValueError
                io_error.add(where)
            else:
                raise ValueError
        except ValueError:
            raise ValueError(malformed(entry, "train")) from None
    return FaultPlan(nan_loss=frozenset(nan_loss), hang=hang,
                     sigterm=frozenset(sigterm), io_error=io_error)


def _step(s: str) -> int:
    step = int(s)
    if step < 1:
        raise ValueError
    return step


def _seconds(s: str) -> float:
    seconds = float(s)
    if seconds <= 0:
        raise ValueError
    return seconds
