"""Sharded ImageNet TFRecord input pipeline of the port.

A copy of the JAX package's ``data/imagenet.py``.  It reproduces the
reference's real-data contract: ``--data_dir`` points at a directory of
ImageNet TFRecord shards, records carry JPEG bytes in ``image/encoded``
and a 1-based label in ``image/class/label`` (the ilsvrc2012 TFRecord
schema tf_cnn_benchmarks consumes), and each data-parallel worker reads
its own slice of the shard list (``shards_for_worker``).

Decode and resize run on the host in a *parallel decode pool* behind a
background thread (prefetch), delivering ready NHWC batches.  The pool is
a ThreadPoolExecutor: the native decoder runs outside the GIL (ctypes
releases it for the C call).  Each image's augmentation RNG is keyed by
its global stream index, ``default_rng((seed, stream_idx))``, so the
pixel stream is deterministic per seed and independent of pool size;
training takes the random-resized crop and flip, eval the central 87.5 %
crop.

What differs from the JAX package, where it cannot be the same:

- Shards are read by the native scanner (``native.tfrecord_scanner``,
  CRC-verified); there is no fallback to the pure-Python reader, and
  ``reader`` says so.
- JPEGs are decoded by ``native.jpeg_decoder()``: libjpeg, the JAX
  package's decoder (the same pixels), or where libjpeg's headers are
  missing nvJPEG on the GPU (its crops differ by decoder rounding and
  resize from full resolution: see ``native/nvjpeg_decoder.cpp``).
  ``decoder`` names it.  As in JAX, a stream the native decoder rejects
  (ImageNet has a few CMYK JPEGs and one PNG) goes to PIL; ``stats()``
  counts those as ``pil_fallbacks``.
- ``make_synthetic_shards`` takes a ``split``, so it can write the
  validation shards of a fixture too.
"""

from __future__ import annotations

import glob
import io
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator

import numpy as np

from tpu_hc_bench_torch import native
from tpu_hc_bench_torch.data import tfrecord

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32) * 255.0


def host_decode_budget() -> int:
    """The host decode budget: ``cpu_count()-1`` threads (one core left
    for step loops), capped at 32.  A per-process pipeline's auto width
    is this divided by the local worker count."""
    return max(1, min(32, (os.cpu_count() or 2) - 1))


def find_shards(data_dir: str | Path, split: str = "train") -> list[str]:
    """Locate TFRecord shards (`train-00000-of-01024` style, or any files
    matching `<split>*`)."""
    data_dir = str(data_dir)
    patterns = [f"{data_dir}/{split}-*-of-*", f"{data_dir}/{split}*"]
    for pat in patterns:
        shards = sorted(glob.glob(pat))
        if shards:
            return shards
    raise FileNotFoundError(f"no {split} TFRecord shards under {data_dir}")


def count_examples(data_dir: str | Path, split: str = "train") -> int:
    """Total example count across ALL of a split's shards (the epoch size
    for --num_epochs — the per-worker shard split jointly covers the full
    dataset once per epoch)."""
    return sum(tfrecord.count_records(s) for s in find_shards(data_dir, split))


def shards_for_worker(
    shards: list[str], worker: int, num_workers: int
) -> list[str]:
    """Round-robin shard assignment — the per-rank input sharding."""
    mine = shards[worker::num_workers]
    return mine if mine else [shards[worker % len(shards)]]


def _decode_and_crop(
    jpeg_bytes: bytes, image_size: int, rng: np.random.Generator,
    train: bool, normalize: bool, decoder: native.JpegDecoder,
    on_fallback=None,
) -> np.ndarray:
    """Decode -> (random-resized | central) crop -> [size, size, 3].

    The native ``decoder`` does decode+crop+resize in one C call; the
    crop box and flip are drawn HERE so the augmentation stream is
    identical to the PIL fallback (same rng draws in the same order).
    ``on_fallback()`` is called when the stream goes to PIL.
    """
    try:
        w, h = decoder.dims(jpeg_bytes)
        if train:
            crop, flip = _sample_train_crop(w, h, rng)
        else:
            # central 87.5% square crop (the eval standard), resized
            cs = int(round(0.875 * min(w, h)))
            crop = ((w - cs) // 2, (h - cs) // 2, cs, cs)
            flip = False
        arr = decoder.decode_crop_resize(jpeg_bytes, crop, image_size, flip)
    except ValueError:
        # not a baseline RGB JPEG (ImageNet has a few CMYK files and one
        # mislabeled PNG) -- PIL handles those
        if on_fallback is not None:
            on_fallback()
        return _decode_and_crop_pil(jpeg_bytes, image_size, rng, train,
                                    normalize)
    if not normalize:
        return arr
    return (arr.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD


def _sample_train_crop(w, h, rng):
    """Random-resized-crop box + flip (benchmark-standard: area 8%-100%,
    aspect 3/4..4/3, 5 attempts, fall back to the full image).  The ONLY
    sampler for both decode paths, so their augmentation RNG streams are
    identical by construction."""
    crop = (0, 0, w, h)
    area = w * h
    for _ in range(5):
        target_area = area * rng.uniform(0.08, 1.0)
        aspect = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if cw <= w and ch <= h:
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            crop = (x0, y0, cw, ch)
            break
    return crop, bool(rng.random() < 0.5)


def _decode_and_crop_pil(
    jpeg_bytes: bytes, image_size: int, rng: np.random.Generator,
    train: bool, normalize: bool = True,
) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(jpeg_bytes)).convert("RGB")
    w, h = img.size
    if train:
        (x0, y0, cw, ch), flip = _sample_train_crop(w, h, rng)
        img = img.crop((x0, y0, x0 + cw, y0 + ch))
        img = img.resize((image_size, image_size), Image.BILINEAR)
        arr = np.asarray(img)
        if flip:
            arr = arr[:, ::-1]
    else:
        # central crop at 87.5% then resize (eval standard)
        scale = image_size / (0.875 * min(w, h))
        img = img.resize((int(w * scale), int(h * scale)), Image.BILINEAR)
        w2, h2 = img.size
        x0, y0 = (w2 - image_size) // 2, (h2 - image_size) // 2
        img = img.crop((x0, y0, x0 + image_size, y0 + image_size))
        arr = np.asarray(img)
    if not normalize:          # uint8 wire format: normalize on device
        return arr
    return (arr.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD


class ImageNetDataset:
    """Iterator of (images, labels) global batches from TFRecord shards.

    ``worker``/``num_workers`` shard the file list (per-rank input
    sharding); the iterator yields the full *global* batch of this
    worker's shards, of which ``train/driver.py`` keeps the worker's rows.
    """

    def __init__(
        self,
        data_dir: str | Path,
        global_batch: int,
        image_size: int = 224,
        split: str = "train",
        train: bool = True,
        worker: int = 0,
        num_workers: int = 1,
        seed: int = 0,
        prefetch: int = 2,
        labels_zero_based: bool = False,
        wire_dtype: str = "float32",
        decode_workers: int | None = None,
        local_workers: int | None = None,
        decode_rows: tuple[int, int] | None = None,
    ):
        if wire_dtype not in ("float32", "uint8"):
            raise ValueError(f"wire_dtype must be float32|uint8: {wire_dtype}")
        self.shards = shards_for_worker(
            find_shards(data_dir, split), worker, num_workers
        )
        self.global_batch = global_batch
        self.image_size = image_size
        self.train = train
        self.seed = seed
        self.prefetch = prefetch
        self.label_offset = 0 if labels_zero_based else 1  # ilsvrc is 1-based
        # "uint8" ships raw crops (4x less host->device traffic; the
        # normalize runs on the card: train.step.prep_inputs)
        self.wire_dtype = wire_dtype
        # decode pool width (tf_cnn_benchmarks --datasets_num_private_threads
        # analog); 0/None = auto-size to the host's cores (matching the CLI
        # flag's 0=auto convention), 1 = serial.  ``local_workers``: how many
        # worker processes share this host — the auto width divides the host
        # budget by it, so N private pools never claim N*(cpu-1) threads.
        if not decode_workers:
            share = max(1, int(local_workers or 1))
            decode_workers = max(1, host_decode_budget() // share)
        self.decode_workers = decode_workers
        # decode only batch rows [lo, hi): at world > 1 each worker
        # builds the global batch of its own shards and keeps one slice;
        # sliced mode decodes just that slice (records are still read/parsed
        # and the per-row RNG stream still advances, so the decoded
        # rows are bitwise-identical to the full pipeline's).  Rows
        # outside the slice are UNDEFINED memory — the caller must
        # slice them away before delivery.
        if decode_rows is not None:
            lo, hi = decode_rows
            if not (0 <= lo < hi <= global_batch):
                raise ValueError(
                    f"decode_rows {decode_rows} out of range for "
                    f"global_batch {global_batch}")
        self.decode_rows = decode_rows
        # decode-pool counters (the result's "data" record): written by
        # the producer thread alone, read by ``run_benchmark`` after the run
        self._batches_decoded = 0
        self._examples_decoded = 0
        self._decode_wall_s = 0.0
        # the native scanner and decoder, built (or refused) here, in the
        # caller's thread, before any producer thread starts
        self._scanner = native.tfrecord_scanner()
        self._decoder = native.jpeg_decoder()
        self.reader = self._scanner.name
        self.decoder = self._decoder.name
        self._pil_fallbacks = 0
        self._pil_lock = threading.Lock()

    def _count_pil(self) -> None:
        with self._pil_lock:
            self._pil_fallbacks += 1

    def _read_shard(self, path: str) -> Iterator[bytes]:
        """One shard's records, read by the native scanner (CRC-verified,
        ~GB/s)."""
        return iter(self._scanner.read_records(path, verify=True))

    def _example_stream(self) -> Iterator[tuple[bytes, int]]:
        """Endless stream of (jpeg_bytes, zero_based_label)."""
        epoch = 0
        while True:
            order = np.random.default_rng(self.seed + epoch).permutation(
                len(self.shards)
            ) if self.train else np.arange(len(self.shards))
            for si in order:
                for rec in self._read_shard(self.shards[si]):
                    ex = tfrecord.parse_example(rec)
                    jpeg = ex["image/encoded"][0]
                    label = int(ex["image/class/label"][0]) - self.label_offset
                    yield jpeg, label
            epoch += 1

    def _batches(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        stream = self._example_stream()
        s = self.image_size
        normalize = self.wire_dtype == "float32"
        dtype = np.float32 if normalize else np.uint8

        def decode_into(images, labels, i, jpeg, label, stream_idx):
            # per-image rng: deterministic for (seed, position-in-stream)
            # regardless of decode order / pool width
            rng = np.random.default_rng((self.seed, stream_idx))
            images[i] = _decode_and_crop(jpeg, s, rng, self.train,
                                         normalize=normalize,
                                         decoder=self._decoder,
                                         on_fallback=self._count_pil)
            labels[i] = label

        pool = (ThreadPoolExecutor(self.decode_workers)
                if self.decode_workers > 1 else None)
        stream_idx = 0
        try:
            while True:
                t0 = time.perf_counter()
                images = np.empty((self.global_batch, s, s, 3), dtype)
                labels = np.empty((self.global_batch,), np.int32)
                items = []
                for i in range(self.global_batch):
                    jpeg, label = next(stream)
                    labels[i] = label
                    items.append((i, jpeg, label, stream_idx))
                    stream_idx += 1
                if self.decode_rows is not None:
                    # sliced mode: the RNG stream above advanced over
                    # EVERY row (bitwise alignment with the full
                    # pipeline); only the consumed rows pay decode
                    lo, hi = self.decode_rows
                    items = [it for it in items if lo <= it[0] < hi]
                if pool is None:
                    for it in items:
                        decode_into(images, labels, *it)
                else:
                    # one task per pool thread, not per image: executor
                    # submit/result costs ~50-100us of GIL each, and
                    # per-image futures convoy the GIL.  Chunking is
                    # invisible to the output: each image's augmentation
                    # RNG is keyed by its stream index, not by task
                    # placement.
                    step_ = -(-len(items) // self.decode_workers)
                    chunks = [items[i:i + step_]
                              for i in range(0, len(items), step_)]

                    def decode_chunk(chunk):
                        for it in chunk:
                            decode_into(images, labels, *it)

                    futs = [pool.submit(decode_chunk, c) for c in chunks]
                    for f in futs:
                        f.result()   # re-raises decode errors here
                self._batches_decoded += 1
                self._examples_decoded += len(items)   # sliced mode: only
                                                       # the decoded rows
                self._decode_wall_s += time.perf_counter() - t0
                yield images, labels
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)

    def stats(self) -> dict:
        """Decode-pool counters for the run's result (its ``data``).

        ``decode_wall_s`` is the producer thread's wall time building
        batches (shard read + parse + parallel JPEG decode) — it
        overlaps the device step via the prefetch queue, so it bounds
        the host-side input rate rather than adding to step time.
        """
        return {
            "batches": self._batches_decoded,
            "examples": self._examples_decoded,
            "decode_wall_s": self._decode_wall_s,
            "decode_workers": self.decode_workers,
            "reader": self.reader,
            "decoder": self.decoder,
            "pil_fallbacks": self._pil_fallbacks,
        }

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Prefetching iterator: decode runs in a daemon thread."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that notices consumer abandonment: a plain
            # q.put would block forever once the consumer stops draining,
            # pinning the generator frame and leaking the decode pool
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            gen = self._batches()
            try:
                for batch in gen:
                    if not put(batch):
                        return
            except Exception as e:  # surface decode errors to the consumer
                put(e)
            finally:
                gen.close()        # runs _batches' finally -> pool.shutdown

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def make_synthetic_shards(
    out_dir: str | Path,
    num_shards: int = 4,
    examples_per_shard: int = 16,
    image_size: int = 32,
    num_classes: int = 1000,
    seed: int = 0,
    split: str = "train",
) -> list[str]:
    """Generate tiny valid ImageNet-schema TFRecord shards (test fixtures /
    no-dataset smoke runs) -- JPEG-encoded random images, 1-based labels,
    named ``<split>-SSSSS-of-NNNNN``.  Needs PIL (imported here only)."""
    from PIL import Image

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for s in range(num_shards):
        path = out_dir / f"{split}-{s:05d}-of-{num_shards:05d}"
        records = []
        for _ in range(examples_per_shard):
            arr = rng.integers(0, 256, (image_size, image_size, 3), np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG")
            label = int(rng.integers(1, num_classes + 1))
            records.append(
                tfrecord.build_example({
                    "image/encoded": [buf.getvalue()],
                    "image/class/label": [label],
                    "image/height": [image_size],
                    "image/width": [image_size],
                })
            )
        tfrecord.write_records(path, records)
        paths.append(str(path))
    return paths
