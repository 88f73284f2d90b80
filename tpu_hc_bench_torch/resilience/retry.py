"""Bounded retry-with-backoff for run-critical I/O (the port's copy of
the JAX package's ``resilience/retry.py``).

Metrics writes (and later checkpoint saves) hit real filesystems
(network and fuse mounts) whose transient errors should not kill a
multi-hour run.  ``retry_io`` retries ``OSError`` a bounded number of times with
exponential backoff, loudly: every retry is printed and (when a writer
is supplied) emitted as an ``io_retry`` record into the metrics stream.
Anything that still fails after the budget re-raises — bounded means the
run terminates instead of retrying a dead filesystem forever.
"""

from __future__ import annotations

import time
from typing import Any, Callable

DEFAULT_ATTEMPTS = 3
DEFAULT_BASE_DELAY_S = 0.1


def retry_io(
    fn: Callable[[], Any],
    what: str,
    attempts: int = DEFAULT_ATTEMPTS,
    base_delay_s: float = DEFAULT_BASE_DELAY_S,
    print_fn: Callable[[str], None] | None = None,
    obs_writer: Any = None,
) -> Any:
    """Run ``fn()``, retrying ``OSError`` with exponential backoff.

    Returns ``fn()``'s value; re-raises the last error once ``attempts``
    are exhausted.  Non-OSError exceptions propagate immediately — a
    shape mismatch or keyboard interrupt is not a transient I/O fault.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1: {attempts}")
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except OSError as e:
            if attempt == attempts:
                raise
            delay = base_delay_s * (2 ** (attempt - 1))
            if print_fn is not None:
                print_fn(
                    f"WARNING: {what} failed (attempt {attempt}/{attempts}: "
                    f"{e}); retrying in {delay:.2f}s")
            if obs_writer is not None:
                try:
                    obs_writer.event("io_retry", what=what, attempt=attempt,
                                     error=str(e), delay_s=delay)
                except Exception:
                    pass  # the metrics stream may be the failing device
            time.sleep(delay)
