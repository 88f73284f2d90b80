"""Parallelism of the port: ``sequence`` (the attention entry point),
``fabric`` (the ``ib|sock`` switch and the host all-reduce),
``distributed`` (the hostfile contract and the worker spawn) and
``collectives`` (the fusion buckets and the collective primitives)."""
