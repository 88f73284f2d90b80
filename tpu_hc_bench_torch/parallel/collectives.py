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
- **Multislice** (``fabric=dcn --num_slices=S``): the data axis is
  ``(dcn, data)``, and every sum over it (``all_reduce_`` with a
  ``Hierarchy``: the gradient buckets, hooks included, the statistics,
  the loss, sync-BN, the eval sums) takes three steps, JAX's
  hierarchical all-reduce: a reduce-scatter inside the slice, an
  all-reduce across the slices over the ranks holding the same shard,
  and an all-gather inside the slice.  The buffer is zero-padded to a
  multiple of the slice's ranks.
- ``psum``, ``all_gather``, ``reduce_scatter`` and
  ``ppermute_ring``: the primitives of the OSU sweep.
- ``ring_shift`` and ``all_to_all``: the differentiable collectives of
  sequence parallelism (``parallel.sequence``).  ``ring_shift`` sends
  to the next rank of the group and receives from the previous one; its
  backward shifts the cotangent the other way (JAX's transpose of
  ``ppermute``).  ``all_to_all`` is JAX's tiled ``all_to_all``: the
  ``split`` dim cut into one chunk a rank, the received chunks
  concatenated on the ``concat`` dim in rank order; its backward is the
  inverse exchange.  In a one-rank group both are copies.
- **ZeRO-1** (``--variable_update=zero1``): ``zero1_shard_len``,
  ``leaf_to_rows`` (a tensor padded to ``[N, k]``, row ``i`` rank
  ``i``'s shard of its flat elements), ``reduce_scatter_tree`` and
  ``all_gather_tree`` (JAX's layout functions over the same buckets,
  one collective a bucket) and ``Zero1Reducer``, ``GradReducer``'s
  counterpart that reduce-scatters each bucket of gradients (from the
  hooks under overlap) into this rank's shards and all-gathers the
  updated parameter shards after the optimizer step.
- **Elastic resume** (``--resume=elastic``): ``zero1_resplit_rows``
  (JAX's: one tensor's ``[n_old, k]`` rows, the old padding stripped,
  re-padded and restacked ``[n_new, k']``) and ``resplit_zero1_opt``
  (every rank's optimizer ``state_dict`` of its shards, as a zero1
  checkpoint holds them, resplit for another world), host code only.

Which element rides in which bucket never changes its value, only the
schedule.  A ``wait()`` on NCCL makes the current stream wait, not the
host.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterable, Sequence

import numpy as np

import torch
import torch.distributed as dist

from tpu_hc_bench_torch.flags import DEFAULT_FUSION_THRESHOLD_BYTES


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """The multislice data axis ``(dcn, data)`` of one rank: its slice's
    group (``slice_size`` ranks) and the group of the ranks at its place
    in every slice (``num_slices`` ranks)."""

    slice_group: object
    cross_group: object
    slice_size: int
    num_slices: int


class _HierWork:
    """The three steps of the hierarchical all-reduce of a flat buffer:
    the reduce-scatter in the slice is launched here; ``wait`` finishes
    it, sums the shard across the slices and gathers it back."""

    def __init__(self, flat: torch.Tensor, h: Hierarchy):
        m, n = h.slice_size, flat.numel()
        k = -(-n // m)
        self.flat, self.h, self.n = flat, h, n
        self.buf = (flat if m * k == n
                    else torch.cat([flat, flat.new_zeros(m * k - n)]))
        self.shard = flat.new_empty(k)
        self.work = dist.reduce_scatter_tensor(
            self.shard, self.buf, group=h.slice_group, async_op=True)

    def wait(self) -> bool:
        self.work.wait()
        dist.all_reduce(self.shard, group=self.h.cross_group)
        # all_gather_single where this torch has it (it deprecates the
        # older name)
        getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
            self.buf, self.shard, group=self.h.slice_group)
        if self.buf is not self.flat:
            self.flat.copy_(self.buf[:self.n])
        return True


def all_reduce_(flat: torch.Tensor, group=None,
                hier: Hierarchy | None = None, async_op: bool = False):
    """Sum the contiguous 1-D ``flat`` over ``group`` in place, or with
    ``hier`` over ``(dcn, data)`` in its three steps; returns the work
    handle under ``async_op``, else None."""
    if hier is None:
        return dist.all_reduce(flat, group=group, async_op=async_op)
    work = _HierWork(flat, hier)
    if async_op:
        return work
    work.wait()
    return None


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the group, in place: MPI_Allreduce(SUM)."""
    dist.all_reduce(x, group=group)
    return x


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
    group = group or dist.group.WORLD

    def peer(i: int) -> int:        # the point-to-point ops take global ranks
        return dist.get_global_rank(group, i % n)

    ops = [dist.P2POp(dist.isend, x.contiguous(), peer(r + shift), group),
           dist.P2POp(dist.irecv, out, peer(r - shift), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ppermute_ring(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return ppermute_ring(g, ctx.group, -1), None


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """``ppermute_ring(x, group, 1)``, differentiable: the gradient goes
    back one rank."""
    return _RingShift.apply(x, group)


def _tiled_all_to_all(x: torch.Tensor, group, split: int,
                      concat: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    if x.shape[split] % n:
        raise ValueError(f"dim {split} ({x.shape[split]}) is not divisible "
                         f"by the group size {n}")
    chunks = x.unflatten(split, (n, x.shape[split] // n)).movedim(
        split, 0).contiguous()
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=group)
    return out.movedim(0, concat).flatten(concat, concat + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.args = (group, split, concat)
        return _tiled_all_to_all(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        group, split, concat = ctx.args
        return _tiled_all_to_all(g, group, concat, split), None, None, None


def all_to_all(x: torch.Tensor, group, split: int,
               concat: int) -> torch.Tensor:
    """JAX's ``all_to_all(x, axis, split, concat, tiled=True)`` over
    ``group``, differentiable."""
    return _AllToAll.apply(x, group, split, concat)


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
                    fuse: bool = True, hier: Hierarchy | None = None) -> int:
    """Average ``tensors`` over ``group`` (``hier``: hierarchically) in
    place through the fusion buckets, packed in reverse order as JAX's
    ``fused_psum_tree`` packs the BatchNorm statistics (``fuse=False``:
    one all-reduce a tensor); returns the number of all-reduce calls."""
    if not tensors:
        return 0
    buckets = plan_buckets(tensors, threshold_bytes, fuse)
    n = dist.get_world_size(group)
    for bucket in buckets:
        members = [tensors[i] for i in bucket]
        flat = pack(members)
        all_reduce_(flat, group, hier)
        unpack(flat.div_(n), members)
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
                 fuse: bool = True, overlap: bool = True,
                 hier: Hierarchy | None = None):
        self.params = [p for p in params if p.requires_grad]
        self.group, self.hier = group, hier
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
            flat = pack(members)
            all_reduce_(flat, self.group, self.hier)
            unpack(flat.div_(self.world), members)
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
        self._work[b] = (flat, all_reduce_(flat, self.group, self.hier,
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


# --- ZeRO-1: the sharded optimizer's wire pair ------------------------------


def zero1_shard_len(size: int, num_shards: int) -> int:
    """A ``size``-element tensor's shard length on each of
    ``num_shards`` ranks, ceil-divided (JAX's rule: the layout depends
    on the shapes and N only, not on the fusion threshold)."""
    return -(-size // num_shards)


def leaf_to_rows(t: torch.Tensor, num_shards: int,
                 dtype: torch.dtype | None = None) -> torch.Tensor:
    """``t`` flattened (at ``dtype``), zero-padded to ``num_shards * k``
    and viewed ``[num_shards, k]``: row ``i`` is rank ``i``'s shard
    (JAX's ``_leaf_to_rows``)."""
    k = zero1_shard_len(t.numel(), num_shards)
    flat = t.detach().reshape(-1).to(dtype or t.dtype)
    pad = num_shards * k - t.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(num_shards, k)


def reduce_scatter_tree(tree: Sequence[torch.Tensor], group=None,
                        threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES,
                        average: bool = False, overlap: bool = True
                        ) -> list[torch.Tensor]:
    """This rank's 1-D shard (``zero1_shard_len`` elements, the tensor's
    dtype) of the sum (``average``: the mean) of every rank's tensor of
    ``tree``, one ``reduce_scatter`` a bucket of JAX's buckets (the
    rows of a bucket's tensors side by side, at their widest dtype)."""
    n = dist.get_world_size(group)
    out: list = [None] * len(tree)
    for bucket in plan_buckets(tree, threshold_bytes, True, overlap):
        wire = _wire_dtype(tree[i] for i in bucket)
        rows = torch.cat([leaf_to_rows(tree[i], n, wire) for i in bucket],
                         dim=1)
        reduced = reduce_scatter(rows, group).view(-1)
        if average:
            reduced = reduced / n
        off = 0
        for i in bucket:
            k = zero1_shard_len(tree[i].numel(), n)
            out[i] = reduced[off:off + k].to(tree[i].dtype)
            off += k
    return out


def all_gather_tree(shards: Sequence[torch.Tensor],
                    templates: Sequence[torch.Tensor], group=None,
                    threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES,
                    overlap: bool = True) -> list[torch.Tensor]:
    """The return leg: every rank's shards (``reduce_scatter_tree``'s
    layout) gathered back into tensors of ``templates``' shapes and
    dtypes, one ``all_gather`` a bucket (the buckets of the
    templates)."""
    n = dist.get_world_size(group)
    out: list = [None] * len(shards)
    for bucket in plan_buckets(templates, threshold_bytes, True, overlap):
        flat = torch.cat([shards[i].reshape(-1) for i in bucket])
        gathered = all_gather(flat, group).view(n, -1)
        off = 0
        for i in bucket:
            t = templates[i]
            k = zero1_shard_len(t.numel(), n)
            out[i] = gathered[:, off:off + k].reshape(-1)[:t.numel()] \
                .view(t.shape).to(t.dtype)
            off += k
    return out


class Zero1Reducer(GradReducer):
    """``--variable_update=zero1``: each rank keeps the optimizer state
    of its 1/N flat shard of every parameter only.

    ``shards`` holds, for each parameter, this rank's
    ``zero1_shard_len`` elements of it (a float32 leaf the optimizer
    steps); ``refresh()`` copies them from the parameters (the step
    calls it first, as JAX slices its replicated parameters each step,
    so a restored model needs nothing more).  ``arm``/``finish`` are
    ``GradReducer``'s, with a ``reduce_scatter`` a bucket in place of the
    all-reduce (launched from the hooks under overlap): after
    ``finish`` each shard's ``.grad`` is its slice of the mean gradient.
    ``gather()`` all-gathers the updated shards, bucket by bucket, into
    the parameters.  ``reduce_tree`` reduce-scatters a tree (the bf16
    accumulator's) into ``tree_shards``."""

    def __init__(self, params: Iterable[torch.nn.Parameter], group=None,
                 threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES,
                 overlap: bool = True):
        super().__init__(params, group, threshold_bytes, fuse=True,
                         overlap=overlap)
        self.rank = dist.get_rank(group)
        self.shard_lens = [zero1_shard_len(p.numel(), self.world)
                           for p in self.params]
        self.shards = [torch.nn.Parameter(p.new_empty(k))
                       for p, k in zip(self.params, self.shard_lens)]
        self.tree_shards: list[torch.Tensor] = []
        self.refresh()

    @torch.no_grad()
    def refresh(self) -> None:
        """Each shard from its parameter's current values."""
        for p, s in zip(self.params, self.shards):
            s.copy_(leaf_to_rows(p, self.world)[self.rank])

    def _launch(self, b: int) -> None:
        members = [self.params[i] for i in self.buckets[b]]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in members]
        wire = _wire_dtype(grads)
        rows = torch.cat([leaf_to_rows(g, self.world, wire) for g in grads],
                         dim=1)
        if self._divisor != 1:
            rows.div_(self._divisor)
        out = rows.new_empty((1, rows.shape[1]))
        self._work[b] = (out.view(-1), dist.reduce_scatter_tensor(
            out, rows, group=self.group, async_op=True))
        self._next = b + 1

    def finish(self) -> int:
        """Launch the buckets still pending, wait on all of them and put
        this rank's slice of each mean gradient in its shard's
        ``.grad``; returns the reduce-scatter calls."""
        if not self._armed:
            raise RuntimeError("Zero1Reducer.finish() without arm()")
        self._armed = False
        while self._next < len(self.buckets):
            self._launch(self._next)
        for b, (flat, work) in enumerate(self._work):
            work.wait()
            flat.div_(self.world)
            off = 0
            for i in self.buckets[b]:
                k = self.shard_lens[i]
                self.shards[i].grad = flat[off:off + k].to(
                    self.shards[i].dtype)
                off += k
        self._work = []
        return len(self.buckets)

    def reduce_tree(self, tree: Sequence[torch.Tensor]) -> int:
        """This rank's shards of the mean of ``tree`` (one tensor a
        parameter) over the group, in ``tree_shards``; returns the
        reduce-scatter calls."""
        self.tree_shards = reduce_scatter_tree(
            tree, self.group, self._threshold, average=True,
            overlap=self._overlap)
        self.tree_calls = len(plan_buckets(tree, self._threshold, True,
                                           self._overlap))
        return self.tree_calls

    @torch.no_grad()
    def gather(self) -> int:
        """The updated shards all-gathered into the parameters; returns
        the all-gather calls."""
        full = all_gather_tree([s.detach() for s in self.shards],
                               self.params, self.group, self._threshold,
                               self._overlap)
        for p, t in zip(self.params, full):
            p.copy_(t)
        return len(self.buckets)

    def grad_sq_sum(self, grads: Sequence[torch.Tensor] | None = None
                    ) -> torch.Tensor:
        """The squared global norm of the mean gradient: this rank's
        shards' squares summed, then summed over the group (JAX's
        zero1 guard), float32."""
        grads = grads if grads is not None else [s.grad for s in
                                                 self.shards]
        gsq = torch.stack([g.float().square().sum() for g in grads
                           if g is not None]).sum()
        dist.all_reduce(gsq, group=self.group)
        return gsq


# --- elastic resume: zero1's rows for another world -------------------------


def zero1_resplit_rows(rows, size: int, num_shards: int) -> np.ndarray:
    """One tensor's stacked shards ``[n_old, k_old]`` (``leaf_to_rows``'
    layout of a ``size``-element tensor) laid out for ``num_shards``
    ranks: the old padding stripped, re-padded to ``num_shards x
    zero1_shard_len(size, num_shards)`` and restacked (JAX's
    ``zero1_resplit_rows``): host numpy, bit for bit on the ``size``
    real elements."""
    k = zero1_shard_len(size, num_shards)
    flat = np.asarray(rows).reshape(-1)[:size]
    pad = num_shards * k - size
    if pad:
        flat = np.pad(flat, (0, pad))
    return flat.reshape(num_shards, k)


def resplit_zero1_opt(shards: Sequence[dict], sizes: Sequence[int],
                      n_new: int) -> list[dict]:
    """The optimizer ``state_dict``s of ``n_old = len(shards)`` zero1
    ranks (each over its shards of the parameters, ``sizes`` their
    element counts in ``state_dict`` order) resplit for ``n_new`` ranks
    (JAX's ``resplit_zero1_opt``): each per-parameter tensor of the
    old shard length is stacked ``[n_old, k]`` over the ranks and
    resplit by ``zero1_resplit_rows``; the rest (Adam's step count,
    equal on every rank, and the hyperparameters) is rank 0's.  At
    ``n_new == n_old`` the state comes back unchanged."""
    n_old = len(shards)
    out = [{"state": {}, "param_groups": [dict(g) for g in
                                          shards[0]["param_groups"]]}
           for _ in range(n_new)]
    for idx, first in shards[0]["state"].items():
        k_old = zero1_shard_len(sizes[idx], n_old)
        for key, v in first.items():
            if (isinstance(v, torch.Tensor) and v.dim() == 1
                    and v.numel() == k_old):
                rows = torch.stack([s["state"][idx][key] for s in shards])
                new = torch.from_numpy(np.ascontiguousarray(
                    zero1_resplit_rows(rows.numpy(), sizes[idx], n_new)))
                for r in range(n_new):
                    out[r]["state"].setdefault(idx, {})[key] = \
                        new[r].clone()
            else:
                for r in range(n_new):
                    out[r]["state"].setdefault(idx, {})[key] = (
                        v.clone() if isinstance(v, torch.Tensor) else v)
    return out
