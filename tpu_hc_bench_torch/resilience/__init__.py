"""The serving lane's survival pieces, copies of the JAX package's
``resilience`` modules in the depth the serving engine needs:

- ``preempt``: ``PreemptionHandler``, a SIGTERM/SIGINT flag the engine
  polls once a scheduler iteration (then drains into a journal);
- ``watchdog``: ``resolve_timeout`` and ``Watchdog``, a monitor thread
  that ends a wedged run with ``EXIT_WATCHDOG`` and every thread's
  stack on stderr (plus the last metrics record, a ``watchdog_dump``
  record and the flight recorder's and memory forensics on metrics
  runs);
- ``retry``: ``retry_io``, the metrics stream's bounded write retry.

Exit codes (the JAX lane's): ``EXIT_WATCHDOG`` 70 when no scheduler
iteration completed within ``--serve_step_timeout_s``;
``EXIT_PREEMPTED`` 75 when a SIGTERM was honored by a drain.
"""

EXIT_WATCHDOG = 70
EXIT_PREEMPTED = 75
