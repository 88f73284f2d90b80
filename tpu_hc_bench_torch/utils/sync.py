"""Device synchronization and cross-rank agreement (the port's copy of
the JAX package's ``utils/sync.py``).

``drain`` waits for the device: ``torch.cuda.synchronize`` on the card,
nothing on the CPU (every op has finished when it returns).  JAX's
value-fetch workaround for tunneled platforms has no counterpart here:
a CUDA synchronize is exact.

``all_processes_any`` is the run-control agreement (stop now, the
emergency save): a MAX all-reduce of one int over the default process
group, NCCL through the card or gloo through host memory, whichever the
group runs.  A collective: every rank calls it at the same point.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def drain(device: torch.device | str) -> None:
    """Wait until ``device`` has finished everything queued so far (a
    CUDA synchronize on the card; nothing on the CPU, where every op has
    finished when it returns)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _group_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_processes_any(flag: bool) -> bool:
    """True iff any rank passed True; the flag itself without a group.
    A collective over the default process group."""
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                     device=_group_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
