"""Collective wrappers and the Horovod fusion buckets over
``torch.distributed``: the port's copy of the JAX package's
``parallel/collectives.py`` (``fused_psum_tree``,
``allreduce_gradients``).

The reference averages gradients with Horovod's tensor fusion: small
gradient tensors are concatenated into buffers of at most
``fusion_threshold_bytes`` (128 MiB, ``HOROVOD_FUSION_THRESHOLD``) so
each all-reduce moves one large buffer.  The port keeps JAX's rule
(``flatten_to_buckets``: greedy, a tensor at or over the threshold gets
a bucket of its own) and its order (``bucket_order``), and writes the
buckets itself instead of wrapping the model in
``DistributedDataParallel``, whose buckets follow its own rule after the
first step and carry no BatchNorm statistics.

- ``GradReducer`` averages a model's gradients in place: per bucket, the
  gradients packed at the widest dtype (``torch.promote_types``, JAX's
  ``jnp.result_type`` rule), one ``all_reduce``, a division by the world
  size, and the result copied back into ``.grad``.  ``fuse=False`` gives
  every tensor a bucket of its own (``--variable_update=replicated``, the
  analog of JAX's per-leaf ``pmean``).
- ``overlap=True`` (``--overlap_grad_comm=on``) packs the buckets in
  reverse ``parameters()`` order, which approximates the order in which
  the backward finishes the gradients, and launches a bucket's
  ``all_reduce(async_op=True)`` from
  ``Tensor.register_post_accumulate_grad_hook`` as soon as its last
  gradient has landed; ``overlap=False`` reduces every bucket after
  ``backward()`` returns (JAX's ``_serialize_after_backward``).  Buckets
  launch in index order on every rank, so the ranks issue their
  collectives in one order.
- ``GradReducer.reduce_tree`` averages a tree the step hands it, one
  tensor a parameter, in buckets planned on that tree's own sizes and
  dtype: ``--accum_dtype=bf16``'s accumulated mean, reduced in bf16 (JAX
  keeps that tree bf16 through the all-reduce) after the backward.
- ``allreduce_mean_`` averages a list of tensors in place through the
  same buckets: the BatchNorm running statistics and the loss.
- ``psum``, ``pmean``, ``all_gather``, ``reduce_scatter`` and
  ``ppermute_ring``: the primitives of the OSU sweep.

Which element rides in which bucket never changes its value, only the
schedule.  A ``wait()`` on NCCL makes the current stream wait, not the
host.
"""

from __future__ import annotations

import functools
from typing import Iterable, Sequence

import torch
import torch.distributed as dist

from tpu_hc_bench_torch.flags import DEFAULT_FUSION_THRESHOLD_BYTES


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the group, in place: MPI_Allreduce(SUM)."""
    dist.all_reduce(x, group=group)
    return x


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over the group, in place: Horovod's gradient averaging."""
    return psum(x, group).div_(dist.get_world_size(group))


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 (MPI_Allgather)."""
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],
                       *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's 1/N slice along dim 0 of the sum of every rank's
    ``x`` (MPI_Reduce_scatter)."""
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 ({x.shape[0]}) is not divisible by the "
                         f"world size {n}")
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def ppermute_ring(x: torch.Tensor, group=None,
                  shift: int = 1) -> torch.Tensor:
    """Send ``x`` to the rank ``shift`` ahead on the ring and return what
    the rank ``shift`` behind sent (the point-to-point primitive)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return x.clone()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), (r + shift) % n, group),
           dist.P2POp(dist.irecv, out, (r - shift) % n, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def flatten_to_buckets(sizes: Sequence[int], itemsizes: Sequence[int],
                       threshold_bytes: int,
                       order: Sequence[int] | None = None
                       ) -> list[list[int]]:
    """Greedily group tensor indices into buckets of <= threshold bytes.

    JAX's ``_flatten_to_buckets`` on element counts and item sizes: a
    tensor larger than the threshold gets its own bucket (Horovod's
    oversized tensors bypass the fusion buffer); ``order`` packs the
    tensors in that index order (default: index order)."""
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    for i in (order if order is not None else range(len(sizes))):
        nbytes = sizes[i] * itemsizes[i]
        if cur and cur_bytes + nbytes > threshold_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
        if cur_bytes >= threshold_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(cur)
    return buckets


def bucket_order(num_tensors: int, overlap: bool) -> list[int]:
    """Packing order: reversed (backward-completion) when overlapping,
    index order otherwise."""
    idx = list(range(num_tensors))
    return idx[::-1] if overlap else idx


def plan_buckets(tensors: Sequence[torch.Tensor], threshold_bytes: int,
                 fuse: bool = True, overlap: bool = True
                 ) -> list[list[int]]:
    """The buckets of ``tensors``: JAX's rule when ``fuse``, else one
    tensor a bucket, in ``bucket_order``."""
    order = bucket_order(len(tensors), overlap)
    if not fuse:
        return [[i] for i in order]
    return flatten_to_buckets([t.numel() for t in tensors],
                              [t.element_size() for t in tensors],
                              threshold_bytes, order)


def _wire_dtype(tensors: Iterable[torch.Tensor]) -> torch.dtype:
    return functools.reduce(torch.promote_types, (t.dtype for t in tensors))


def pack(tensors: Sequence[torch.Tensor],
         dtype: torch.dtype | None = None) -> torch.Tensor:
    """``tensors`` flattened into one new buffer at ``dtype`` (default:
    the widest of their dtypes)."""
    dtype = dtype or _wire_dtype(tensors)
    return torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])


def unpack(flat: torch.Tensor, dst: Sequence[torch.Tensor]) -> None:
    """Copy the consecutive slices of ``flat`` into ``dst``, in place
    (cast to each tensor's dtype): the inverse of ``pack``."""
    off = 0
    for t in dst:
        n = t.numel()
        t.copy_(flat[off:off + n].view(t.shape))
        off += n


def allreduce_mean_(tensors: Sequence[torch.Tensor], group=None,
                    threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES,
                    fuse: bool = True) -> int:
    """Average ``tensors`` over ``group`` in place through the fusion
    buckets, packed in reverse order as JAX's ``fused_psum_tree`` packs
    the BatchNorm statistics (``fuse=False``: one all-reduce a tensor);
    returns the number of all-reduce calls."""
    if not tensors:
        return 0
    buckets = plan_buckets(tensors, threshold_bytes, fuse)
    for bucket in buckets:
        members = [tensors[i] for i in bucket]
        unpack(pmean(pack(members), group), members)
    return len(buckets)


class GradReducer:
    """Averages the gradients of ``params`` over ``group`` in place,
    through fusion buckets, once a step.

    A step calls ``arm()`` just before the backward that leaves the
    final gradients (the last microbatch's, under accumulation), then
    ``finish()`` after it and before ``optimizer.step()``.  With
    ``overlap`` the hooks launch each bucket as its last gradient lands;
    ``finish`` launches whatever has not been launched (a parameter the
    backward never reached contributes zeros, as JAX's zero leaf does,
    and gets the reduced zeros as its ``.grad``), waits on every
    handle, and unpacks.  ``scale`` of ``arm`` divides the gradients
    before they are packed (1 / the microbatch count)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], group=None,
                 threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES,
                 fuse: bool = True, overlap: bool = True):
        self.params = [p for p in params if p.requires_grad]
        self.group = group
        self.world = dist.get_world_size(group)
        self.buckets = plan_buckets(self.params, threshold_bytes, fuse,
                                    overlap)
        self._bucket_of = {i: b for b, idx in enumerate(self.buckets)
                           for i in idx}
        self._hooks = []
        if overlap:
            for i, p in enumerate(self.params):
                self._hooks.append(p.register_post_accumulate_grad_hook(
                    functools.partial(self._on_grad, i)))
        self._armed = False
        self._divisor = 1
        self._fuse, self._overlap = fuse, overlap
        self._threshold = threshold_bytes
        self._tree_buckets: list[list[int]] | None = None
        self.tree_calls = 0

    def reduce_tree(self, tree: Sequence[torch.Tensor]) -> int:
        """Average ``tree`` (one tensor a parameter, in ``params`` order)
        over the group in place, in buckets planned on the tree's own
        sizes and dtype; returns the all-reduce calls (also kept in
        ``tree_calls``)."""
        if self._tree_buckets is None:
            self._tree_buckets = plan_buckets(tree, self._threshold,
                                              self._fuse, self._overlap)
        for idx in self._tree_buckets:
            members = [tree[i] for i in idx]
            unpack(pmean(pack(members), self.group), members)
        self.tree_calls = len(self._tree_buckets)
        return self.tree_calls

    def arm(self, divisor: int = 1) -> None:
        self._pending = [len(b) for b in self.buckets]
        self._work: list = [None] * len(self.buckets)
        self._next = 0
        self._divisor = divisor
        self._armed = True

    def _on_grad(self, i: int, _param) -> None:
        if not self._armed:
            return
        b = self._bucket_of[i]
        self._pending[b] -= 1
        while (self._next < len(self.buckets)
               and self._pending[self._next] == 0):
            self._launch(self._next)

    def _launch(self, b: int) -> None:
        members = [self.params[i] for i in self.buckets[b]]
        flat = pack([p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in members])
        if self._divisor != 1:
            flat.div_(self._divisor)
        self._work[b] = (flat, dist.all_reduce(flat, group=self.group,
                                               async_op=True))
        self._next = b + 1

    def finish(self) -> int:
        """Launch the buckets still pending, wait on all of them and
        unpack the means into ``.grad``; returns the all-reduce calls."""
        if not self._armed:
            raise RuntimeError("GradReducer.finish() without arm()")
        self._armed = False
        while self._next < len(self.buckets):
            self._launch(self._next)
        for b, (flat, work) in enumerate(self._work):
            work.wait()
            flat.div_(self.world)
            members = [self.params[i] for i in self.buckets[b]]
            for p in members:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            unpack(flat, [p.grad for p in members])
        self._work = []
        return len(self.buckets)

    def close(self) -> None:
        """Remove the hooks."""
        for h in self._hooks:
            h.remove()
        self._hooks = []
