"""Scheduler-iteration watchdog: end a wedged run with its stacks
instead of hanging.

A monitor thread reads the wall time of the last completed scheduler
iteration; when none completes within the timeout it writes every
Python thread's stack to stderr (``faulthandler``, which works while the
main thread is stuck in native code) and ends the process with
``EXIT_WATCHDOG``, or calls the caller's ``on_timeout`` instead (tests).

``resolve_timeout("auto", warmup_step_s)`` calibrates from the warmup:
``AUTO_TIMEOUT_MULT`` times its mean step, at least
``AUTO_TIMEOUT_MIN_S``.
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
from typing import Any, Callable

from tpu_hc_bench_torch.resilience import EXIT_WATCHDOG

AUTO_TIMEOUT_MULT = 10.0
AUTO_TIMEOUT_MIN_S = 60.0


def resolve_timeout(spec: str | float | None,
                    warmup_step_s: float | None = None) -> float | None:
    """``--serve_step_timeout_s`` -> seconds, or None (watchdog off).

    Accepts a positive number, ``"auto"`` (needs ``warmup_step_s``;
    None until it is known), or None/""/"0"/"off"/"none" to disable.
    Loud on anything else (the JAX package's messages).
    """
    if spec is None:
        return None
    if isinstance(spec, str):
        s = spec.strip().lower()
        if s in ("", "0", "off", "none"):
            return None
        if s == "auto":
            if warmup_step_s is None:
                return None
            return max(AUTO_TIMEOUT_MIN_S,
                       AUTO_TIMEOUT_MULT * warmup_step_s)
        spec = s
    try:
        timeout = float(spec)
    except ValueError:
        raise ValueError(
            f"--step_timeout_s must be a positive number, 'auto', or "
            f"unset/off: {spec!r}") from None
    if timeout <= 0:
        raise ValueError(
            f"--step_timeout_s must be > 0 (use unset/off to disable): "
            f"{spec!r}")
    return timeout


class Watchdog:
    """Monitor thread: no progress for ``timeout_s`` -> dump and abort.

    ``progress_fn`` returns the ``time.perf_counter`` instant of the last
    completed iteration, or None before the first (the arming instant
    stands in).  ``on_timeout(age_s)`` replaces ``os._exit``.  On a
    metrics run the firing path also prints ``last_record_fn()`` (the
    stream's newest record), runs ``forensics_fn`` (the flight
    recorder's and memory dumps; bounded, best-effort) and writes a
    ``watchdog_dump`` record into ``obs_writer`` before closing it.
    """

    def __init__(self, timeout_s: float,
                 progress_fn: Callable[[], float | None],
                 on_timeout: Callable[[float], None] | None = None,
                 poll_s: float | None = None,
                 last_record_fn: Callable[[], Any] | None = None,
                 obs_writer: Any = None,
                 forensics_fn: Callable[[], Any] | None = None):
        self.timeout_s = float(timeout_s)
        self._progress = progress_fn
        self._on_timeout = on_timeout
        self._last_record = last_record_fn
        self._obs = obs_writer
        self._forensics = forensics_fn
        self._poll_s = poll_s or max(0.05, min(5.0, self.timeout_s / 4))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._armed_t = 0.0
        self.fired = False

    def start(self) -> "Watchdog":
        self._armed_t = time.perf_counter()
        self._thread = threading.Thread(
            target=self._run, name="tpu-hc-bench-torch-watchdog",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self._poll_s)

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            last = self._progress()
            if last is None or last < self._armed_t:
                last = self._armed_t
            age = time.perf_counter() - last
            if age > self.timeout_s:
                self._fire(age)
                return

    def _fire(self, age: float) -> None:
        self.fired = True
        sys.stderr.write(
            f"\nwatchdog: no scheduler iteration completed in {age:.1f}s "
            f"(timeout {self.timeout_s:.1f}s) — dumping all thread "
            f"stacks and aborting (exit {EXIT_WATCHDOG})\n")
        try:
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        except Exception:
            pass
        if self._last_record is not None:
            try:
                rec = self._last_record()
                if rec is not None:
                    sys.stderr.write(f"watchdog: last metrics record: "
                                     f"{rec}\n")
            except Exception:
                pass
        if self._forensics is not None:
            # a daemon thread with a capped join: the abort stays
            # guaranteed even when the probe hangs on the wedged runtime
            try:
                t = threading.Thread(target=self._forensics,
                                     name="tpu-hc-bench-torch-forensics",
                                     daemon=True)
                t.start()
                t.join(timeout=10.0)
            except Exception:
                pass
        if self._obs is not None:
            try:
                self._obs.event("watchdog_dump", age_s=age,
                                timeout_s=self.timeout_s)
                self._obs.close()
            except Exception:
                pass
        sys.stderr.flush()
        if self._on_timeout is not None:
            self._on_timeout(age)
            return
        os._exit(EXIT_WATCHDOG)
