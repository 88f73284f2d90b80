"""A CPU share for the port's torch tests under pytest-xdist.

Each worker of ``pytest -n N`` is a process of its own, and PyTorch
sizes its intra-op pool to every core in each of them: N pools of
spinning OpenMP threads on one machine's cores, where a full-width
ResNet-50 step runs tens of times slower than alone.  ``cpu_share``
(autouse, module scope: a test module imports it) gives the module's
tests ``cores // N`` threads (at least one), in this process and in the
processes they start (``OMP_NUM_THREADS``), while the module runs under
N > 1 workers, and restores both afterwards; in one process it changes
nothing.

``jax_private_cache`` (autouse, module scope: a test module that runs
JAX imports it too) keeps the module's JAX compiles out of the
conftest's persistent compile-cache directory
(``no_shared_compile_cache``): the JAX serving engine's tests count that
directory's entries as their own compiles, and every xdist worker shares
it.
"""

from __future__ import annotations

import contextlib
import os

import pytest
import torch


def _cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


@pytest.fixture(autouse=True, scope="module")
def cpu_share():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers <= 1:
        yield
        return
    threads = max(1, _cores() // workers)
    before, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(threads)
    os.environ["OMP_NUM_THREADS"] = str(threads)
    try:
        yield
    finally:
        torch.set_num_threads(before)
        if env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env


@contextlib.contextmanager
def no_shared_compile_cache():
    """JAX's compiles kept out of the conftest's persistent cache
    directory for the duration."""
    import jax

    old = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", old)


@pytest.fixture(autouse=True, scope="module")
def jax_private_cache():
    with no_shared_compile_cache():
        yield
