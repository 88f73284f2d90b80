"""The host's shared input service: one decode pool per host, feeding
every local worker through shared-memory rings.

A copy of the JAX package's ``data/service.py``.  The per-process
pipeline (``data/imagenet.py``) gives every worker its own decode pool;
at several workers a host the pools oversubscribe its CPUs, and each
shares a GIL with its own step loop.  Here one owner a host (rank 0 of
the host's workers, ``train/driver.py``) runs:

- **one stream a worker, bit for bit the per-process one**: worker
  ``w``'s stream is the ``ImageNetDataset(worker=w, num_workers=W)``
  stream it would have built itself, all of them on one shared decode
  pool; each image's augmentation is keyed by ``(seed, stream index)``,
  so the pool's width and scheduling change nothing;
- **shared-memory rings** (``ShmRing``): ``depth`` preallocated batch
  slots a worker in ``multiprocessing.shared_memory``, handed over by a
  seqlock: the producer writes the payload, then publishes ``head``; the
  consumer reads the slot and publishes ``tail``.  One writer a counter,
  aligned 8-byte stores, no lock across processes; batch ``n`` lives in
  slot ``n % depth``, so delivery order is stream order;
- **backpressure counters** in each ring's header: the producer's stall
  (ring full) and the consumer's wait (ring empty) in nanoseconds, and
  an occupancy histogram sampled at each publish; ``stats()`` folds
  them (the JAX package's timeline spans are not ported: the counters
  are the record);
- **mixing** (``weighted_mixture``): several shard sets interleaved on
  a counter-keyed schedule, independent of the consumer's pace;
- **packed token batches** (``make_packed_token_service``): the
  fixed-bucket ``PackedTokenDataset`` batches, at the API level;
- **the owner's processes** (``ServiceProcess``): the image service
  run in processes of its own, the JAX package's other owner ("a
  dedicated process"), the workers' streams and the pool's width split
  over them.  The training driver uses it, one process a worker: eager
  PyTorch's step loop needs the GIL for every kernel it launches, so a
  decode thread in a step's process slows that step, and one process's
  GIL caps what one process can decode.

Memory order: the counters are aligned uint64 cells with one writer
each; on x86-64 (TSO) the payload-then-counter store order holds.
"""

from __future__ import annotations

import atexit
import dataclasses
import hashlib
import json
import os
import select
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from multiprocessing import shared_memory
from typing import Callable, Iterator, Sequence

import numpy as np

__all__ = [
    "ArraySpec", "BatchLayout", "ShmRing", "InputService", "ServiceClient",
    "image_batch_layout", "packed_token_layout", "make_image_service",
    "make_packed_token_service", "weighted_mixture", "mixture_schedule",
    "service_name", "default_service_pool_width", "ServiceProcess",
]

_ALIGN = 64

# ring header cells (uint64 each); single writer per cell:
#   producer: HEAD, STALL_NS, CLOSED, and the occupancy histogram
#   consumer: TAIL, WAIT_NS
#   creator (once, before any peer attaches): DEPTH, SLOT_NBYTES
_H_HEAD = 0        # batches published
_H_TAIL = 1        # batches consumed
_H_STALL_NS = 2    # producer ns blocked on a full ring
_H_WAIT_NS = 3     # consumer ns blocked on an empty ring
_H_CLOSED = 4      # 0 live, 1 clean end-of-stream, 2 producer error
_H_DEPTH = 5       # creator's ring depth (attach verifies)
_H_SLOT = 6        # creator's slot_nbytes (attach verifies)
_H_HIST = 7        # occupancy histogram: depth+1 cells (occ 0..depth)

CLOSED_OK = 1
CLOSED_ERROR = 2


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """One fixed-shape array of the batch wire format."""

    name: str
    shape: tuple[int, ...]
    dtype: str

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)
                   * np.dtype(self.dtype).itemsize)


class BatchLayout:
    """Fixed slot layout for a tuple-of-arrays batch.

    Slots are preallocated: every array lives at a fixed 64-byte-aligned
    offset, so producer writes and consumer views are plain numpy
    operations over the shared buffer (no pickling, no per-batch
    allocation on the wire).
    """

    def __init__(self, arrays: Sequence[ArraySpec]):
        self.arrays = tuple(arrays)
        off = 0
        self.offsets = []
        for a in self.arrays:
            self.offsets.append(off)
            off += -(-a.nbytes // _ALIGN) * _ALIGN
        self.slot_nbytes = max(off, _ALIGN)

    def views(self, buf, base: int) -> tuple[np.ndarray, ...]:
        """Numpy views of one slot's arrays (zero-copy)."""
        out = []
        for a, off in zip(self.arrays, self.offsets):
            out.append(np.ndarray(a.shape, dtype=a.dtype, buffer=buf,
                                  offset=base + off))
        return tuple(out)

    def check(self, batch: Sequence[np.ndarray]) -> None:
        if len(batch) != len(self.arrays):
            raise ValueError(
                f"batch has {len(batch)} arrays, layout expects "
                f"{len(self.arrays)} ({[a.name for a in self.arrays]})")
        for arr, spec in zip(batch, self.arrays):
            if tuple(arr.shape) != spec.shape or \
                    np.dtype(arr.dtype) != np.dtype(spec.dtype):
                raise ValueError(
                    f"array {spec.name!r}: got {arr.shape}/{arr.dtype}, "
                    f"layout expects {spec.shape}/{spec.dtype}")


def image_batch_layout(global_batch: int, image_size: int,
                       wire_dtype: str = "uint8") -> BatchLayout:
    """The (images, labels) wire format of ``ImageNetDataset``."""
    img_dtype = "float32" if wire_dtype == "float32" else "uint8"
    return BatchLayout([
        ArraySpec("images", (global_batch, image_size, image_size, 3),
                  img_dtype),
        ArraySpec("labels", (global_batch,), "int32"),
    ])


def packed_token_layout(global_batch: int, seq_len: int) -> BatchLayout:
    """The (tokens, targets, weights, segment_ids) packed-sequence wire
    format of ``data.tokens.PackedTokenDataset`` — one fixed bucket, so
    service consumers always see one shape."""
    return BatchLayout([
        ArraySpec("tokens", (global_batch, seq_len), "int32"),
        ArraySpec("targets", (global_batch, seq_len), "int32"),
        ArraySpec("weights", (global_batch, seq_len), "float32"),
        ArraySpec("segment_ids", (global_batch, seq_len), "int32"),
    ])


# segments THIS process created (tracker claims on those are legit and
# must survive a same-process attach — the rank-0 worker that hosts the
# service also consumes from it)
_OWNED_NAMES: set[str] = set()


def _unregister_tracker(shm) -> None:
    """Drop this process's resource_tracker claim on an ATTACHED
    segment: on 3.8-3.12 attaching registers the name too, so a
    consumer process exiting would unlink shm the producer still owns
    (observed: the segment vanishes under the service).  Never drops
    the claim of the process that CREATED the segment."""
    if shm._name in _OWNED_NAMES:
        return
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


class ShmRing:
    """Single-producer single-consumer shared-memory ring of batch slots.

    Batch ``n`` always lands in slot ``n % depth`` (the deterministic
    round-robin assignment); ``head``/``tail`` are monotonically
    increasing batch counts, each written by exactly one side.
    """

    # blocked-side poll: start fine, back off exponentially to the cap —
    # a stalled ring must not burn GIL/CPU at kHz in the very process
    # that is trying to decode its way out of the stall
    _POLL_S = 1e-4
    _POLL_MAX_S = 2e-3

    def __init__(self, shm, layout: BatchLayout, depth: int, owner: bool):
        self._shm = shm
        self.layout = layout
        self.depth = depth
        self.owner = owner
        n_hdr = _H_HIST + depth + 1
        self._hdr = np.ndarray((n_hdr,), dtype=np.uint64, buffer=shm.buf)
        self._data_base = -(-(n_hdr * 8) // _ALIGN) * _ALIGN

    # -- construction --------------------------------------------------

    @classmethod
    def _size(cls, layout: BatchLayout, depth: int) -> int:
        n_hdr = _H_HIST + depth + 1
        return (-(-(n_hdr * 8) // _ALIGN) * _ALIGN
                + depth * layout.slot_nbytes)

    @classmethod
    def create(cls, name: str, layout: BatchLayout,
               depth: int) -> "ShmRing":
        if depth < 1:
            raise ValueError(f"ring depth must be >= 1: {depth}")
        try:        # reclaim a stale segment from a crashed prior run
            stale = shared_memory.SharedMemory(name=name)
            stale.close()
            stale.unlink()
        except FileNotFoundError:
            pass
        shm = shared_memory.SharedMemory(
            name=name, create=True, size=cls._size(layout, depth))
        _OWNED_NAMES.add(shm._name)
        ring = cls(shm, layout, depth, owner=True)
        ring._hdr[:] = 0
        ring._hdr[_H_DEPTH] = np.uint64(depth)
        ring._hdr[_H_SLOT] = np.uint64(layout.slot_nbytes)
        return ring

    @classmethod
    def attach(cls, name: str, layout: BatchLayout, depth: int,
               timeout: float = 30.0) -> "ShmRing":
        deadline = time.monotonic() + timeout
        while True:
            try:
                shm = shared_memory.SharedMemory(name=name)
                break
            except FileNotFoundError:
                if time.monotonic() >= deadline:
                    raise FileNotFoundError(
                        f"input service ring {name!r} did not appear "
                        f"within {timeout:.0f}s — is the service host "
                        f"(lowest local rank) running?") from None
                time.sleep(0.05)
        _unregister_tracker(shm)
        want = cls._size(layout, depth)
        if shm.size < want:
            shm.close()
            raise ValueError(
                f"ring {name!r}: shm segment is {shm.size}B, layout "
                f"needs {want}B — producer/consumer batch shapes or "
                f"depth disagree")
        ring = cls(shm, layout, depth, owner=False)
        # geometry handshake: a size check alone lets a SMALLER
        # depth/slot attach 'succeed' and read wrong offsets silently.
        # All-zero cells mean the creator has the segment but hasn't
        # stamped the header yet — retry inside the deadline instead of
        # dying on a microsecond startup race.
        while True:
            got = (int(ring._hdr[_H_DEPTH]), int(ring._hdr[_H_SLOT]))
            if got == (depth, layout.slot_nbytes):
                return ring
            if got != (0, 0) or time.monotonic() >= deadline:
                shm.close()
                raise ValueError(
                    f"ring {name!r}: producer geometry depth={got[0]} "
                    f"slot={got[1]}B != consumer depth={depth} "
                    f"slot={layout.slot_nbytes}B — batch shapes/dtypes "
                    f"or ring depth disagree between service and client")
            time.sleep(0.01)

    # -- producer side -------------------------------------------------

    def put(self, batch: Sequence[np.ndarray],
            stop: threading.Event | None = None,
            timeout: float | None = None) -> bool:
        """Copy one batch into the next slot; block while the ring is
        full (stall time accounted).  False when ``stop`` fired or
        ``timeout`` expired before a slot freed."""
        if self._hdr is None:       # ring torn down under the feeder
            return False            # (stop() join timeout expired)
        self.layout.check(batch)
        head = int(self._hdr[_H_HEAD])
        deadline = None if timeout is None else time.monotonic() + timeout
        t0 = None
        flushed = 0
        poll = self._POLL_S
        while head - int(self._hdr[_H_TAIL]) >= self.depth:
            if t0 is None:
                t0 = time.perf_counter()
            if (stop is not None and stop.is_set()) or (
                    deadline is not None and time.monotonic() > deadline):
                return False
            time.sleep(poll)
            poll = min(2 * poll, self._POLL_MAX_S)
            # flush incrementally: a stats() reader sees an in-progress
            # stall, not only completed ones
            el = int(1e9 * (time.perf_counter() - t0))
            self._hdr[_H_STALL_NS] += np.uint64(el - flushed)
            flushed = el
        base = self._data_base + (head % self.depth) * self.layout.slot_nbytes
        for dst, src in zip(self.layout.views(self._shm.buf, base), batch):
            np.copyto(dst, src)
        self._hdr[_H_HEAD] = np.uint64(head + 1)        # publish
        occ = min(head + 1 - int(self._hdr[_H_TAIL]), self.depth)
        self._hdr[_H_HIST + occ] += np.uint64(1)
        return True

    def close_producer(self, error: bool = False) -> None:
        if self._hdr is None:       # already torn down — nothing to mark
            return
        self._hdr[_H_CLOSED] = np.uint64(
            CLOSED_ERROR if error else CLOSED_OK)

    # -- consumer side -------------------------------------------------

    def get(self, stop: threading.Event | None = None,
            timeout: float | None = None) -> tuple[np.ndarray, ...] | None:
        """Views of the oldest unconsumed slot (zero-copy; call
        ``advance()`` when done with them).  None on clean end-of-stream
        or stop/timeout; raises on a dead producer."""
        tail = int(self._hdr[_H_TAIL])
        deadline = None if timeout is None else time.monotonic() + timeout
        t0 = None
        flushed = 0
        poll = self._POLL_S
        while int(self._hdr[_H_HEAD]) <= tail:
            closed = int(self._hdr[_H_CLOSED])
            if closed == CLOSED_ERROR:
                raise RuntimeError(
                    "input service producer died — see the service "
                    "host's log for the stream traceback")
            if closed == CLOSED_OK:
                return None
            if t0 is None:
                t0 = time.perf_counter()
            if (stop is not None and stop.is_set()) or (
                    deadline is not None and time.monotonic() > deadline):
                return None
            time.sleep(poll)
            poll = min(2 * poll, self._POLL_MAX_S)
            el = int(1e9 * (time.perf_counter() - t0))
            self._hdr[_H_WAIT_NS] += np.uint64(el - flushed)
            flushed = el
        base = self._data_base + (tail % self.depth) * self.layout.slot_nbytes
        return self.layout.views(self._shm.buf, base)

    def advance(self) -> None:
        self._hdr[_H_TAIL] += np.uint64(1)

    # -- both sides ----------------------------------------------------

    @property
    def occupancy(self) -> int:
        return int(self._hdr[_H_HEAD]) - int(self._hdr[_H_TAIL])

    def stats(self) -> dict:
        if self._hdr is None:       # torn down: a zeroed account beats
            hist = [0] * (self.depth + 1)       # a crash in telemetry
            return {"produced": 0, "consumed": 0, "depth": self.depth,
                    "producer_stall_s": 0.0, "consumer_wait_s": 0.0,
                    "occ_hist": hist, "occ_p50": 0, "occ_p99": 0}
        hist = [int(v) for v in self._hdr[_H_HIST:_H_HIST + self.depth + 1]]
        return {
            "produced": int(self._hdr[_H_HEAD]),
            "consumed": int(self._hdr[_H_TAIL]),
            "depth": self.depth,
            "producer_stall_s": round(int(self._hdr[_H_STALL_NS]) / 1e9, 4),
            "consumer_wait_s": round(int(self._hdr[_H_WAIT_NS]) / 1e9, 4),
            "occ_hist": hist,
            "occ_p50": _hist_percentile(hist, 0.50),
            "occ_p99": _hist_percentile(hist, 0.99),
        }

    def close(self) -> None:
        self._hdr = None
        try:
            self._shm.close()
        except (OSError, BufferError):
            pass

    def unlink(self) -> None:
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass
        _OWNED_NAMES.discard(self._shm._name)


def _hist_percentile(hist: list[int], q: float) -> int:
    """The ``q`` quantile of the ring's occupancy histogram: the first
    occupancy whose cumulative count passes ``q * (n - 1)`` (the JAX
    package's sketch gives the same integers); 0 when empty."""
    n = sum(hist)
    if not n:
        return 0
    rank = q * (n - 1)
    seen = 0
    for occ, k in enumerate(hist):
        seen += k
        if seen > rank:
            return occ
    return len(hist) - 1


def _fold_stats(rings: Sequence[ShmRing], depth: int, decode_workers: int,
                errors: int) -> dict:
    """Every ring's counters folded into one account."""
    per_ring = [r.stats() for r in rings]
    hist = [0] * (depth + 1)
    for s in per_ring:
        for occ, n in enumerate(s["occ_hist"]):
            hist[occ] += n
    return {
        "workers": len(per_ring),
        "depth": depth,
        "decode_workers": decode_workers,
        "produced": sum(s["produced"] for s in per_ring),
        "consumed": sum(s["consumed"] for s in per_ring),
        "producer_stall_s": round(
            sum(s["producer_stall_s"] for s in per_ring), 4),
        "consumer_wait_s": round(
            sum(s["consumer_wait_s"] for s in per_ring), 4),
        "occ_p50": _hist_percentile(hist, 0.50),
        "occ_p99": _hist_percentile(hist, 0.99),
        "errors": errors,
    }


def service_name(*parts) -> str:
    """Deterministic shm name prefix all local workers can derive from
    their own (identical) config — no rendezvous channel needed."""
    h = hashlib.blake2b("|".join(str(p) for p in parts).encode(),
                        digest_size=6).hexdigest()
    return f"thbsvc{h}"


def default_service_pool_width() -> int:
    """One decode pool per HOST gets the WHOLE host budget (the same
    figure the per-process pipeline divides by its local worker count
    — one home, ``imagenet.host_decode_budget``)."""
    from tpu_hc_bench_torch.data.imagenet import host_decode_budget

    return host_decode_budget()


# ---------------------------------------------------------------------
# dataset mixing


def _mixture_probs(weights: Sequence[float]) -> np.ndarray:
    w = np.asarray(weights, np.float64)
    if (w < 0).any() or w.sum() <= 0:
        raise ValueError(f"mixture weights must be >=0 and sum > 0: "
                         f"{list(weights)}")
    return w / w.sum()


def _mixture_draw(seed, i: int, p: np.ndarray) -> int:
    """The ONE home of the counter-keyed draw: ``mixture_schedule`` and
    the live ``weighted_mixture`` must agree forever."""
    return int(np.random.default_rng((seed, i)).choice(len(p), p=p))


def mixture_schedule(weights: Sequence[float], seed, n: int) -> np.ndarray:
    """First ``n`` source indices of the deterministic mixture schedule.

    Counter-keyed: draw ``i`` depends only on ``(seed, i)`` and the
    weights, so every worker/restart sees the same interleave
    regardless of consumer pacing."""
    p = _mixture_probs(weights)
    return np.asarray([_mixture_draw(seed, i, p) for i in range(n)],
                      np.int64)


def weighted_mixture(streams: Sequence[Iterator], weights: Sequence[float],
                     seed=0) -> Iterator:
    """Weighted interleave of batch iterators on the deterministic
    ``mixture_schedule`` (one draw per delivered batch).  Validation is
    EAGER — a bad config dies at construction, not as a cryptic
    producer-died error on the first feeder-thread next()."""
    if len(streams) != len(weights):
        raise ValueError(f"{len(streams)} streams vs {len(weights)} weights")
    p = _mixture_probs(weights)

    def gen():
        i = 0
        while True:
            yield next(streams[_mixture_draw(seed, i, p)])
            i += 1

    return gen()


# ---------------------------------------------------------------------
# service (producer side)


class InputService:
    """The per-host producer: one feeder thread per local worker, all
    sharing one decode pool, each filling that worker's shm ring.

    ``make_stream(worker) -> iterator of tuple-of-arrays`` builds worker
    ``w``'s logical stream; it must be deterministic in ``w`` so the
    service delivers exactly what the per-process pipeline would have.
    ``workers``: the worker indices this service feeds, by default all
    ``num_workers`` (a ``ServiceProcess`` splits them over processes).
    """

    def __init__(self, name: str, layout: BatchLayout, num_workers: int,
                 make_stream: Callable[[int], Iterator], depth: int = 2,
                 pool: ThreadPoolExecutor | None = None,
                 decode_workers: int | None = None,
                 workers: Sequence[int] | None = None):
        self.name = name
        self.layout = layout
        self.num_workers = num_workers
        self.workers = list(range(num_workers) if workers is None
                            else workers)
        self.depth = depth
        self.decode_workers = decode_workers or 0
        self._make_stream = make_stream
        self._pool = pool
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self.errors: list[str] = []
        self.rings = [ShmRing.create(f"{name}-w{w}", layout, depth)
                      for w in self.workers]
        atexit.register(self._cleanup)

    def start(self) -> "InputService":
        for i, w in enumerate(self.workers):
            t = threading.Thread(target=self._feed, args=(i,), daemon=True,
                                 name=f"input-service-feed-{w}")
            t.start()
            self._threads.append(t)
        return self

    def _feed(self, i: int) -> None:
        ring, w = self.rings[i], self.workers[i]
        gen = None
        try:
            # built inside the try: a stream that cannot be built (no
            # shards) closes its ring on an error, as a failing one does
            gen = self._make_stream(w)
            while True:
                try:
                    batch = next(gen)
                except StopIteration:
                    ring.close_producer()   # finite stream drained cleanly
                    return
                if not ring.put(batch, stop=self._stop):
                    # service stopping: still mark the stream closed so
                    # a consumer blocked in get() unblocks instead of
                    # polling a dead ring forever
                    ring.close_producer()
                    return
        except Exception:
            self.errors.append(
                f"worker {w} stream: {traceback.format_exc()}")
            # the log the consumer's "producer died" points at
            print(f"input service: {self.errors[-1]}", file=sys.stderr,
                  flush=True)
            ring.close_producer(error=True)
        finally:
            if hasattr(gen, "close"):
                gen.close()

    def stats(self) -> dict:
        """The backpressure account over every ring (the result's
        ``data`` record): batches produced and consumed, stall and wait
        seconds, occupancy percentiles."""
        return _fold_stats(self.rings, self.depth, self.decode_workers,
                           len(self.errors))

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10.0)
        self._cleanup()

    def _cleanup(self) -> None:
        atexit.unregister(self._cleanup)
        self._stop.set()
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
        for r in self.rings:
            # consumers still mapping the segment must see end-of-
            # stream, not an eternally-empty live ring (this runs on
            # the rank-0 error/preemption exit path via atexit too; a
            # SIGKILLed service host is the one case a consumer's own
            # get() timeout must cover)
            r.close_producer()
            r.close()
            r.unlink()
        self.rings = []


class ServiceClient:
    """One worker's consumer handle: attach to my ring, iterate batches.

    Iteration yields zero-copy numpy views into the shm slot; the slot
    is released when the iterator is advanced again, so a consumer must
    finish with (or copy) a batch before asking for the next — the
    driver's copy to the card satisfies this.  Pass
    ``copy=True`` to yield owned copies instead.
    """

    def __init__(self, name: str, layout: BatchLayout, worker: int,
                 depth: int = 2, timeout: float = 30.0, copy: bool = False,
                 stall_timeout_s: float | None = None):
        self.worker = worker
        self.copy = copy
        # None = wait forever on an empty ring; a finite value turns a
        # SIGKILLed service host (whose atexit close_producer never ran)
        # into a loud error instead of an eternal data wait
        self.stall_timeout_s = stall_timeout_s
        self.ring = ShmRing.attach(f"{name}-w{worker}", layout, depth,
                                   timeout=timeout)
        self._last_wait_ns = 0

    def __iter__(self) -> Iterator[tuple[np.ndarray, ...]]:
        while True:
            views = self.ring.get(timeout=self.stall_timeout_s)
            if views is None:
                if not int(self.ring._hdr[_H_CLOSED]):
                    raise RuntimeError(
                        f"input service ring stalled: no batch for "
                        f"{self.stall_timeout_s:.0f}s and the producer "
                        f"never closed the stream — is the service "
                        f"host (lowest local rank) alive?")
                return
            if self.copy:
                batch = tuple(v.copy() for v in views)
                self.ring.advance()     # copy owns the data: free the
                yield batch             # slot NOW, not a full step later
            else:
                yield views
                self.ring.advance()

    def stats(self) -> dict:
        """Consumer-side counters in the shape of the per-process
        ``ImageNetDataset.stats()`` data record, plus ring fields."""
        s = self.ring.stats()
        b = self.ring.layout.arrays[0].shape[0]
        return {
            "batches": s["consumed"],
            "examples": s["consumed"] * b,
            "decode_workers": 0,      # decode lives in the service host
            "input_service": True,
            "ring_depth": s["depth"],
            "ring_occ_p50": s["occ_p50"],
            "ring_occ_p99": s["occ_p99"],
            "consumer_wait_s": s["consumer_wait_s"],
            "producer_stall_s": s["producer_stall_s"],
        }

    def window_stats(self) -> dict:
        """The ring's occupancy now and the consumer's wait since the
        last call."""
        wait_ns = int(self.ring._hdr[_H_WAIT_NS])
        delta_ms = (wait_ns - self._last_wait_ns) / 1e6
        self._last_wait_ns = wait_ns
        return {"ring_occ": self.ring.occupancy,
                "ring_depth": self.ring.depth,
                "wait_ms": round(delta_ms, 3)}

    def close(self) -> None:
        self.ring.close()


# ---------------------------------------------------------------------
# stream factories


def make_image_service(
    data_dirs: Sequence[str],
    num_workers: int,
    global_batch: int,
    image_size: int,
    *,
    mix_weights: Sequence[float] | None = None,
    split: str = "train",
    train: bool = True,
    seed: int = 0,
    wire_dtype: str = "uint8",
    decode_workers: int = 0,
    depth: int = 2,
    name: str | None = None,
    labels_zero_based: bool = False,
    slice_per_worker: bool = False,
    workers: Sequence[int] | None = None,
) -> InputService:
    """The image TFRecord service: per-worker ``ImageNetDataset``
    streams (bitwise-identical to the per-process pipeline) over one
    shared decode pool; several ``data_dirs`` are weighted-interleaved
    with ``weighted_mixture``.

    ``slice_per_worker=True`` is the redundancy-free serving mode: the
    multi-process driver has each worker decode the FULL global batch
    while its devices consume slice ``w`` — W-fold redundant decode per
    host.  Here worker ``w``'s ring instead carries only rows
    ``[w*b, (w+1)*b)`` of its stream (``b = global_batch //
    num_workers``), decoded once; the per-row RNG keying keeps those
    rows bitwise-identical to the full pipeline's, so the pixels that
    reach devices are unchanged while host decode work drops W-fold.
    """
    from tpu_hc_bench_torch.data.imagenet import ImageNetDataset

    width = decode_workers or default_service_pool_width()
    pool = ThreadPoolExecutor(width, thread_name_prefix="svc-decode")
    rows = None
    ring_batch = global_batch
    if slice_per_worker:
        if global_batch % num_workers:
            raise ValueError(
                f"slice_per_worker: global_batch {global_batch} not "
                f"divisible by {num_workers} workers")
        ring_batch = global_batch // num_workers
        rows = lambda w: (w * ring_batch, (w + 1) * ring_batch)
    layout = image_batch_layout(ring_batch, image_size, wire_dtype)
    if mix_weights is None:
        mix_weights = [1.0] * len(data_dirs)
    if name is None:
        name = service_name(*data_dirs, split, seed, global_batch,
                            image_size, wire_dtype, train, os.getpid())

    def make_stream(w: int) -> Iterator:
        streams = [
            ImageNetDataset(
                d, global_batch=global_batch, image_size=image_size,
                split=split, train=train, worker=w,
                num_workers=num_workers, seed=seed,
                wire_dtype=wire_dtype, labels_zero_based=labels_zero_based,
                decode_pool=pool,
                decode_rows=rows(w) if rows is not None else None,
            )._batches()
            for d in data_dirs
        ]
        base = (streams[0] if len(streams) == 1
                else weighted_mixture(streams, mix_weights, seed=(seed, w)))
        if rows is None:
            return base
        lo, hi = rows(w)

        def sliced():
            for img, lab in base:
                yield img[lo:hi], lab[lo:hi]
        return sliced()

    return InputService(name, layout, num_workers, make_stream,
                        depth=depth, pool=pool, decode_workers=width,
                        workers=workers)


def make_packed_token_service(
    data_dir: str,
    num_workers: int,
    global_batch: int,
    seq_len: int,
    *,
    eod_id: int = 0,
    split: str = "train",
    seed: int = 0,
    depth: int = 2,
    name: str | None = None,
) -> InputService:
    """Packed-sequence token service: variable-length documents are
    packed into ONE fixed bucket service-side, so consumers see a
    single batch shape."""
    from tpu_hc_bench_torch.data.tokens import PackedTokenDataset

    layout = packed_token_layout(global_batch, seq_len)
    if name is None:
        name = service_name(data_dir, split, seed, global_batch, seq_len,
                            "packed", os.getpid())

    def make_stream(w: int) -> Iterator:
        return iter(PackedTokenDataset(
            data_dir, global_batch, seq_len, eod_id=eod_id, split=split,
            worker=w, num_workers=num_workers, seed=seed))

    return InputService(name, layout, num_workers, make_stream, depth=depth)


# ---------------------------------------------------------------------
# the owner as a process of its own


class ServiceProcess:
    """``make_image_service(**spec)``'s owner as processes of their own
    (the JAX package's other owner, "a dedicated process"), one a
    worker's stream, so no decode thread shares a GIL with a step loop:
    each serves its worker with an equal share of the pool's width
    (``decode_workers``, else the host budget), creates its ring, prints
    ``ready <pool width>`` and serves until its standard input closes
    (``stop()``, or this process's exit); this side attaches to every
    ring for ``stats()`` alone."""

    def __init__(self, spec: dict, timeout: float = 300.0):
        n = spec["num_workers"]
        width = spec.get("decode_workers") or default_service_pool_width()
        self.procs: list[subprocess.Popen] = []
        self.rings: list[ShmRing] = []
        try:
            for w in range(n):
                sub = dict(spec, workers=[w],
                           decode_workers=max(1, width // n))
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "tpu_hc_bench_torch.data.service",
                     json.dumps(sub)],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE))
            self.decode_workers = sum(self._ready(p, timeout)
                                      for p in self.procs)
        except BaseException:
            self.stop()
            raise
        self.name, self.depth = spec["name"], spec["depth"]
        batch = spec["global_batch"]
        if spec.get("slice_per_worker"):
            batch //= n
        layout = image_batch_layout(batch, spec["image_size"],
                                    spec.get("wire_dtype", "uint8"))
        self.rings = [ShmRing.attach(f"{self.name}-w{w}", layout,
                                     self.depth) for w in range(n)]

    @staticmethod
    def _ready(proc: subprocess.Popen, timeout: float) -> int:
        """The pool width a process printed when its rings were up."""
        ready, _, _ = select.select([proc.stdout], [], [], timeout)
        line = proc.stdout.readline().decode() if ready else ""
        if not line.startswith("ready "):
            raise RuntimeError(
                f"an input service process did not come up within "
                f"{timeout:.0f}s (exit code {proc.poll()}); its error is "
                f"on this run's stderr")
        return int(line.split()[1])

    def stats(self) -> dict:
        """``InputService.stats()`` over every process's rings, read from
        their headers; a ring its producer closed on an error counts as
        one error."""
        errors = sum(int(r._hdr[_H_CLOSED]) == CLOSED_ERROR
                     for r in self.rings if r._hdr is not None)
        return _fold_stats(self.rings, self.depth, self.decode_workers,
                           errors)

    def stop(self, timeout: float = 30.0) -> None:
        """Close each process's input, wait for it to end (killed past
        ``timeout``), and let go of the rings."""
        for r in self.rings:
            r.close()
        self.rings = []
        for p in self.procs:
            if not p.stdin.closed:
                p.stdin.close()
        for p in self.procs:
            try:
                p.wait(timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            p.stdout.close()


def _serve(argv: list[str]) -> int:
    """The service process: serve ``make_image_service(**json spec)``
    until standard input closes."""
    service = make_image_service(**json.loads(argv[0])).start()
    try:
        print(f"ready {service.decode_workers}", flush=True)
        sys.stdin.buffer.read()
    finally:
        service.stop()
    return 0


if __name__ == "__main__":
    sys.exit(_serve(sys.argv[1:]))
