"""Host batches onto the card: the port's counterpart of the JAX driver's
``_prefetch`` (``jax.device_put`` of the next batches while the step
runs).

``DeviceFeeder(host_batches, device, depth)`` iterates device batches,
keeping ``depth`` of them in flight.  A host batch is a tuple of numpy
arrays (images NHWC, labels; or token ids, targets, weights); each lands
as the port's models take it: a 4-D image array as an NCHW view of its
NHWC memory (``channels_last``, uint8 stays uint8 for ``prep_inputs``),
int32 arrays as int64, float arrays unchanged.

A feeder thread pulls the host batches, so the step loop's thread does
not pay for their host copies.  On the card the thread copies each array
into a pinned host buffer, then to the card with ``non_blocking=True``
on a copy stream, and records an event after the copy.  When the step
loop takes the batch, its stream waits on that event and the allocator
is told that stream uses the tensors (``record_stream``).  The pinned
buffers form a ring of ``depth + 1`` slots, and a slot is refilled only
after its last copy's event has completed, so no batch is overwritten in
flight.  On the CPU the arrays are wrapped as they are.  The thread owns
the host iterator: it closes it when it stops (at the end of the
batches, on ``close()``, or on an error, which the step loop re-raises).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

_END = object()                  # the host batches ran out


def _as_model_input(t: torch.Tensor) -> torch.Tensor:
    if t.dim() == 4:
        return t.permute(0, 3, 1, 2)
    if t.dtype == torch.int32:
        return t.long()
    return t


class _Slot:
    """One batch's pinned host buffers and the event of their last copy."""

    def __init__(self):
        self.bufs: list[torch.Tensor] | None = None
        self.copied: torch.cuda.Event | None = None


class DeviceFeeder:
    """Device batches from ``host_batches``, ``depth`` in flight."""

    def __init__(self, host_batches: Iterable[tuple[np.ndarray, ...]],
                 device: torch.device, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1: {depth}")
        self.host = iter(host_batches)
        self.depth = depth
        self.cuda = device.type == "cuda"
        if self.cuda:
            # the thread has its own current device: name the card
            self.device = torch.device("cuda", device.index if device.index
                                       is not None
                                       else torch.cuda.current_device())
            self.copy_stream = torch.cuda.Stream(self.device)
            self.slots = [_Slot() for _ in range(depth + 1)]
            self.next_slot = 0
        else:
            self.device = device
        self.stop = threading.Event()
        self.thread: threading.Thread | None = None

    def _put(self, arrays: tuple[np.ndarray, ...]):
        """Start one batch's copy (in the feeder thread); returns what
        ``_take`` hands out."""
        if not self.cuda:
            return tuple(torch.from_numpy(np.ascontiguousarray(a))
                         for a in arrays)
        slot = self.slots[self.next_slot]
        self.next_slot = (self.next_slot + 1) % len(self.slots)
        if slot.copied is not None:
            slot.copied.synchronize()       # its last copy has landed
        if slot.bufs is None or any(
                b.shape != a.shape or b.numpy().dtype != a.dtype
                for b, a in zip(slot.bufs, arrays)):
            slot.bufs = [torch.empty(a.shape, dtype=torch.from_numpy(
                a[:0]).dtype, pin_memory=True) for a in arrays]
        for b, a in zip(slot.bufs, arrays):
            b.numpy()[...] = a
        with torch.cuda.stream(self.copy_stream):
            dev = tuple(b.to(self.device, non_blocking=True)
                        for b in slot.bufs)
            slot.copied = torch.cuda.Event()
            slot.copied.record(self.copy_stream)
        return dev, slot.copied

    def _take(self, item) -> tuple[torch.Tensor, ...]:
        """Hand one batch to the step loop's stream."""
        if not self.cuda:
            return tuple(_as_model_input(t.to(self.device)) for t in item)
        dev, copied = item
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(copied)
        for t in dev:
            t.record_stream(compute)
        return tuple(_as_model_input(t) for t in dev)

    def _offer(self, q: queue.Queue, item) -> bool:
        """Put ``item`` unless the feeder is stopping."""
        while not self.stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, q: queue.Queue) -> None:
        try:
            if self.cuda:
                torch.cuda.set_device(self.device)
            for arrays in self.host:
                if not self._offer(q, self._put(arrays)):
                    return
            self._offer(q, _END)
        except Exception as e:          # re-raised by the step loop
            self._offer(q, e)
        finally:
            close = getattr(self.host, "close", None)
            if close is not None:
                close()

    def __iter__(self) -> Iterator[tuple[torch.Tensor, ...]]:
        if self.thread is not None:
            raise RuntimeError("a DeviceFeeder is iterated once")
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        self.thread = threading.Thread(target=self._produce, args=(q,),
                                       daemon=True)
        self.thread.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, Exception):
                    raise item
                yield self._take(item)
        finally:
            self.close()

    def close(self, timeout: float = 60.0) -> None:
        """Stop the feeder thread, which closes the host iterator (a
        dataset's decode pool with it)."""
        self.stop.set()
        if self.thread is None:                 # never iterated
            close = getattr(self.host, "close", None)
            if close is not None:
                close()
        elif self.thread is not threading.current_thread():
            self.thread.join(timeout)
