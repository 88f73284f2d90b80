"""SIGTERM/SIGINT as a flag the serving engine polls.

The handler only sets a flag; ``ServeEngine.run`` reads it at the top
of each scheduler iteration, the one place its state is consistent, and
then drains: every unfinished request goes into the journal and the CLI
exits with ``EXIT_PREEMPTED``.  A second signal while the first is being
honored restores the previous disposition and delivers the signal again,
so a second Ctrl-C still ends a run stuck in its drain.
"""

from __future__ import annotations

import signal
import threading
from typing import Callable


class PreemptionHandler:
    """Installable SIGTERM/SIGINT flag; poll with ``requested``.

    ``install`` does nothing outside the main thread (CPython delivers
    signals only there) and ``uninstall`` restores the handlers it
    replaced.
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, print_fn: Callable[[str], None] = print):
        self._event = threading.Event()
        self._print = print_fn
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
            f"signal {signum} received: will drain and exit at the next "
            f"scheduler iteration (send again to force default handling)")

    def requested(self) -> bool:
        return self._event.is_set()
