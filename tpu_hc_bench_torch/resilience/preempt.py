"""SIGTERM/SIGINT as a flag polled at a consistent point (the port's
copy of the JAX package's ``resilience/preempt.py``).

The handler only sets a flag.  The training loop reads it at each step
boundary, the one place its state is consistent, then writes one
emergency checkpoint and raises ``PreemptedError``, which the launcher
maps to ``EXIT_PREEMPTED``; ``--resume=auto`` continues the run.  The
serving engine reads it at the top of each scheduler iteration and
drains into its journal.  A second signal while the first is being
honored restores the previous disposition and delivers the signal
again, so a second Ctrl-C still ends a run stuck in its emergency save.

Several ranks: a checkpoint written by part of the group is garbage, so
the decision to stop is collective (``agreed``, a MAX all-reduce of the
flag through ``utils.sync.all_processes_any``), taken at sync-window
boundaries, the same step on every rank.
"""

from __future__ import annotations

import signal
import threading
from typing import Callable


class PreemptedError(RuntimeError):
    """The run stopped at a step boundary to honor a preemption signal;
    the launcher maps it to ``resilience.EXIT_PREEMPTED`` (75)."""

    def __init__(self, step: int, checkpoint_saved: bool,
                 signum: int | None = None,
                 topology: dict | None = None):
        self.step = step
        self.checkpoint_saved = checkpoint_saved
        self.signum = signum
        self.topology = topology
        if checkpoint_saved:
            world = (topology or {}).get("world")
            saved_as = f" (world {world})" if world else ""
            ckpt = (f"emergency checkpoint saved{saved_as}; relaunch "
                    f"with --resume=auto to continue")
        else:
            ckpt = "no --train_dir, nothing saved"
        super().__init__(
            f"preempted after timed step {step} "
            f"(signal {signum}): {ckpt}")


class PreemptionHandler:
    """Installable SIGTERM/SIGINT flag; poll with ``requested`` (or
    ``agreed`` across ranks).

    ``install`` does nothing outside the main thread (CPython delivers
    signals only there) and ``uninstall`` restores the handlers it
    replaced.  ``action`` names what the run does next in the line the
    handler prints.
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, print_fn: Callable[[str], None] = print,
                 action: str = "drain and exit at the next scheduler "
                               "iteration"):
        self._event = threading.Event()
        self._print = print_fn
        self._action = action
        self._saved: dict[int, object] = {}
        self.signum: int | None = None

    def install(self) -> "PreemptionHandler":
        if threading.current_thread() is not threading.main_thread():
            return self
        for sig in self.SIGNALS:
            self._saved[sig] = signal.signal(sig, self._on_signal)
        return self

    def uninstall(self) -> None:
        for sig, old in self._saved.items():
            try:
                signal.signal(sig, old)
            except (ValueError, TypeError):
                pass
        self._saved.clear()

    def _on_signal(self, signum, frame) -> None:
        if self._event.is_set():
            self.uninstall()
            signal.raise_signal(signum)
            return
        self.signum = signum
        self._event.set()
        self._print(
            f"signal {signum} received: will {self._action} "
            f"(send again to force default handling)")

    def requested(self) -> bool:
        return self._event.is_set()

    def agreed(self, world: int) -> bool:
        """True iff any rank requested a stop.  At ``world > 1`` a
        collective: every rank calls it at the same step boundary."""
        if world <= 1:
            return self.requested()
        from tpu_hc_bench_torch.utils.sync import all_processes_any

        return all_processes_any(self.requested())
