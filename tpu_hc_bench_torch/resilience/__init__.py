"""The port's survival pieces, copies of the JAX package's
``resilience`` modules:

- ``guards``: the non-finite step guard (``finite_flag``,
  ``select_state``, ``GuardTracker``, ``guard_mode``) behind
  ``--on_nonfinite=abort|skip|rewind`` and ``--max_bad_steps``;
- ``inject``: ``--inject_fault=nan_loss@N,hang@N:S,sigterm@N,
  io_error@ckpt``, deterministic fault injection for the training lane;
- ``preempt``: ``PreemptionHandler``, a SIGTERM/SIGINT flag the training
  loop polls at step boundaries (then one emergency checkpoint) and the
  serving engine once a scheduler iteration (then a drain);
- ``watchdog``: ``resolve_timeout`` and ``Watchdog``, a monitor thread
  that ends a wedged run with ``EXIT_WATCHDOG`` and every thread's
  stack on stderr;
- ``retry``: ``retry_io``, bounded retry-with-backoff for checkpoint and
  metrics I/O.

Exit codes (the JAX lane's): ``EXIT_ZERO_THROUGHPUT`` 1 when a run
measured no progress; ``EXIT_WATCHDOG`` 70 when no step (or scheduler
iteration) completed within the timeout; ``EXIT_PREEMPTED`` 75 when a
SIGTERM was honored (an emergency checkpoint, or a drain).
"""

EXIT_OK = 0
EXIT_ZERO_THROUGHPUT = 1
EXIT_WATCHDOG = 70
EXIT_PREEMPTED = 75
