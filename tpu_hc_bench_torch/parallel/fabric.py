"""Fabric selection, the reference's ``ib|sock`` switch, and the ``sock``
arm's host all-reduce: the port's copy of the JAX package's
``parallel/fabric.py``.

The reference launchers take a 4th positional argument ``fabric`` in
``{ib, sock}``: ``ib`` is the fast path (UCX, HCOLL collectives) and
``sock`` plain TCP, a slow fallback that doubles as the
no-InfiniBand smoke test.  On the card:

- ``ib`` / ``ici`` / ``dcn`` (``Fabric.is_fast``): gradients are reduced
  by NCCL collectives on the device (gloo when the run is on the CPU, by
  request), through the fusion buckets of ``parallel.collectives``.
  ``dcn`` is the multislice layout (JAX's round 3): ``--num_slices``
  slices (default one a host) split the data axis into ``(dcn, data)``
  and every sum over it is hierarchical (a reduce-scatter in the slice,
  an all-reduce across slices, an all-gather in the slice;
  ``collectives.all_reduce_``).  One slice is the flat all-reduce of
  ``ib``.
- ``sock`` / ``host``: gradients, BatchNorm statistics and the loss are
  copied into one host buffer, summed over a gloo group and copied back
  (``host_allreduce``).  Deliberately slow: the slow arm of the
  reference's ib-vs-sock A/B.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import torch
import torch.distributed as dist

from tpu_hc_bench_torch.parallel.collectives import pack, unpack


class Fabric(enum.Enum):
    ICI = "ici"    # fast path: device collectives (reference: ib)
    DCN = "dcn"    # the multislice layout: (dcn, data), hierarchical
    HOST = "host"  # slow path: host-mediated reduce (reference: sock)

    @property
    def is_fast(self) -> bool:
        return self is not Fabric.HOST


_ALIASES = {
    "ib": Fabric.ICI,      # reference fast path
    "ici": Fabric.ICI,
    "dcn": Fabric.DCN,
    "sock": Fabric.HOST,   # reference slow/TCP path
    "host": Fabric.HOST,
}

# the launcher's FABRIC positional accepts exactly these names
FABRICS = tuple(_ALIASES)


def resolve_fabric(name: str) -> Fabric:
    """Accept both the reference's (``ib|sock``) and the JAX package's
    (``ici|dcn|host``) names."""
    try:
        return _ALIASES[name.strip().lower()]
    except KeyError:
        raise ValueError(
            f"unknown fabric {name!r}; expected one of {sorted(_ALIASES)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """The launch-time fabric settings a run registers (JAX's
    ``FabricConfig``): the launcher writes ``env_exports`` into the env
    registry's ``launcher`` block (``envfile``)."""

    fabric: Fabric
    fusion_threshold_bytes: int

    def env_exports(self) -> dict[str, str]:
        return {
            "TPU_HC_BENCH_FABRIC": self.fabric.value,
            "TPU_HC_BENCH_FUSION_THRESHOLD": str(self.fusion_threshold_bytes),
        }


def host_allreduce(tensors: Sequence[torch.Tensor], group) -> None:
    """The ``sock`` slow path: average ``tensors`` over ``group`` through
    host memory, in place.

    The tensors are packed into one flat float32 buffer, copied to the
    host, summed with one gloo ``all_reduce``, divided by the world size
    and copied back into each tensor (cast to its dtype): one host round
    trip a call, as the JAX arm's one flat ``process_allgather``."""
    if not tensors:
        return
    flat = pack(tensors, torch.float32).cpu()
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    unpack(flat.to(tensors[0].device), tensors)
