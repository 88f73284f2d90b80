"""Token inputs: the serving lane's prompt sampler and the training
lane's pre-tokenized corpus, copies of the JAX package's
``data/tokens.py``.

- ``PromptSampler``: the JAX sampler: corpus windows cut at the first
  end-of-document (``data_dir``), or uniform synthetic ids over ``[1,
  vocab_size)``, from a numpy counter rng keyed ``(seed, 11, rid)``.
  The keys are kept verbatim, so a trace here equals the JAX lane's for
  the same seed and corpus.
- ``TokenDataset``: the text models' ``--data_dir``, a memory-mapped
  ``<data_dir>/<split>.bin`` holding a raw little-endian uint16 (vocab
  <= 65536) or uint32 token stream (the nanoGPT/Megatron convention;
  ``write_token_file`` writes one with a small dtype sidecar).  Worker
  ``w`` of ``W`` owns the ``w``-th of ``W`` contiguous stripes; window
  starts come from a counter rng keyed ``(seed, worker, step)``; causal
  members take next-token targets from a ``seq_len + 1`` window, MLM
  members BERT's 15 % masking from the same rng: the batch contract of
  ``SyntheticTokens``, ``(tokens, targets, weights)``.
- ``split_documents``, ``pack_sequences``, ``PackedTokenDataset``: the
  packed-sequence batches of the input service (``data.service
  .make_packed_token_service``): documents split on an end-of-document
  id, packed greedily first-fit into one fixed ``(batch, seq_len)``
  bucket, long ones chunked, with segment ids; the weights drop padding
  and the targets that would cross a document.  As in JAX they exist at
  the API level; no driver path serves them yet.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class PromptSampler:
    """The serving lane's per-request prompts, deterministic per
    ``(seed, rid)`` through a counter rng keyed ``(seed, 11, rid)``:

    - **corpus** (``data_dir`` set): a window drawn from the
      memory-mapped ``<data_dir>/<split>.bin`` and cut at its first
      end-of-document id by ``split_documents``, so a prompt may be
      shorter than asked;
    - **synthetic** (``data_dir`` None): uniform ids over ``[1,
      vocab_size)`` at exactly the asked length (0 is the eod/pad id).
    """

    vocab_size: int
    data_dir: str | Path | None = None
    split: str = "train"
    eod_id: int = 0
    seed: int = 0

    def __post_init__(self):
        self._data = None
        if self.data_dir is not None:
            path, dtype = _resolve(self.data_dir, self.split)
            self._data = np.memmap(path, dtype=dtype, mode="r")
            if len(self._data) < 2:
                raise ValueError(f"{path}: corpus too small to sample "
                                 f"prompts from")

    def sample(self, rid: int, length: int) -> np.ndarray:
        """The prompt for request ``rid`` at (up to) ``length`` tokens."""
        if length < 1:
            raise ValueError(f"prompt length must be >= 1: {length}")
        rng = np.random.default_rng((self.seed, 11, rid))
        if self._data is None:
            return rng.integers(1, max(2, self.vocab_size), size=(length,),
                                dtype=np.int64).astype(np.int32)
        span = min(length, len(self._data))
        start = int(rng.integers(0, len(self._data) - span + 1))
        window = np.asarray(self._data[start:start + span])
        docs = split_documents(window, self.eod_id)
        prompt = docs[0] if docs else window
        out = np.clip(np.asarray(prompt, dtype=np.int64), 0,
                      self.vocab_size - 1)
        return out.astype(np.int32)


def write_token_file(path: str | Path, tokens: np.ndarray,
                     vocab_size: int | None = None) -> Path:
    """Write a flat token stream in the wire format (uint16 when the
    vocab fits, else uint32) + a small sidecar recording the dtype."""
    path = Path(path)
    tokens = np.asarray(tokens)
    hi = int(vocab_size if vocab_size is not None
             else (tokens.max() + 1 if tokens.size else 1))
    dtype = np.uint16 if hi <= (1 << 16) else np.uint32
    path.parent.mkdir(parents=True, exist_ok=True)
    tokens.astype(dtype).tofile(path)
    meta = {"dtype": np.dtype(dtype).name, "num_tokens": int(tokens.size),
            "vocab_size": hi}
    path.with_suffix(path.suffix + ".meta.json").write_text(
        json.dumps(meta))
    return path


def _resolve(data_dir: str | Path, split: str) -> tuple[Path, np.dtype]:
    path = Path(data_dir) / f"{split}.bin"
    if not path.exists():
        raise FileNotFoundError(
            f"no {split}.bin token file under {data_dir} (write one with "
            f"data.tokens.write_token_file)")
    meta_path = path.with_suffix(path.suffix + ".meta.json")
    if meta_path.exists():
        dtype = np.dtype(json.loads(meta_path.read_text())["dtype"])
    else:
        dtype = np.dtype(np.uint16)        # the common convention
    return path, dtype


@dataclasses.dataclass
class TokenDataset:
    """Endless iterator of ``(tokens, targets, weights)`` global batches
    drawn from a memory-mapped pre-tokenized corpus."""

    data_dir: str | Path
    global_batch: int
    seq_len: int
    split: str = "train"
    causal_lm: bool = True
    mask_rate: float = 0.15            # MLM members (BERT's 15%)
    worker: int = 0
    num_workers: int = 1
    seed: int = 0
    vocab_size: int | None = None      # when set, reject out-of-range ids

    def __post_init__(self):
        path, dtype = _resolve(self.data_dir, self.split)
        data = np.memmap(path, dtype=dtype, mode="r")
        window = self.seq_len + 1 if self.causal_lm else self.seq_len
        shard = len(data) // self.num_workers
        lo = self.worker * shard
        self._data = data[lo:lo + shard]
        if len(self._data) < window:
            raise ValueError(
                f"{path}: worker shard has {len(self._data)} tokens < "
                f"window {window} (corpus too small for "
                f"{self.num_workers} workers at seq_len {self.seq_len})")
        self._window = window
        if self.vocab_size is not None:
            probe = np.asarray(self._data[: min(len(self._data), 1 << 20)])
            if probe.size and int(probe.max()) >= self.vocab_size:
                raise ValueError(
                    f"{path}: token id {int(probe.max())} >= vocab_size "
                    f"{self.vocab_size} — corpus/model vocab mismatch")

    def batch(self, step: int = 0) -> tuple[np.ndarray, ...]:
        rng = np.random.default_rng((self.seed, self.worker, step))
        starts = rng.integers(
            0, len(self._data) - self._window + 1,
            size=(self.global_batch,))
        win = np.stack([
            np.asarray(self._data[s:s + self._window]) for s in starts
        ]).astype(np.int32)
        if self.causal_lm:
            tokens, targets = win[:, :-1], win[:, 1:]
            weights = np.ones_like(tokens, np.float32)
            return tokens, targets, weights
        targets = win
        mask = rng.random(win.shape) < self.mask_rate
        tokens = np.where(mask, 0, targets).astype(np.int32)
        return tokens, targets, mask.astype(np.float32)

    def __iter__(self) -> Iterator[tuple[np.ndarray, ...]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


# --- packed sequences (the input service's packed-token batches) ---------


def split_documents(tokens: np.ndarray, eod_id: int) -> list[np.ndarray]:
    """A flat token stream split into documents on ``eod_id``; each keeps
    its trailing end-of-document token, a trailing partial document is
    kept, and empty documents (consecutive eods) are dropped."""
    tokens = np.asarray(tokens)
    ends = np.flatnonzero(tokens == eod_id)
    docs: list[np.ndarray] = []
    start = 0
    for e in ends:
        if e > start:
            docs.append(tokens[start:e + 1])
        start = e + 1
    if start < len(tokens):
        docs.append(tokens[start:])
    return docs


def pack_sequences(docs: list[np.ndarray], seq_len: int,
                   pad_id: int = 0) -> dict[str, np.ndarray]:
    """Documents packed into rows of ``seq_len`` (greedy first-fit in
    arrival order; longer documents chunked): ``tokens``, ``segment_ids``
    (1-based document index in the row, 0 = padding) and ``positions``
    (offset in the segment), each ``[N, seq_len]`` int32."""
    if seq_len < 1:
        raise ValueError(f"seq_len must be >= 1: {seq_len}")
    rows: list[list[np.ndarray]] = []
    space: list[int] = []           # free slots per row
    for doc in docs:
        doc = np.asarray(doc)
        for i in range(0, len(doc), seq_len):
            chunk = doc[i:i + seq_len]
            for r, free in enumerate(space):
                if len(chunk) <= free:
                    rows[r].append(chunk)
                    space[r] -= len(chunk)
                    break
            else:
                rows.append([chunk])
                space.append(seq_len - len(chunk))
    n = len(rows)
    tokens = np.full((n, seq_len), pad_id, np.int32)
    segment_ids = np.zeros((n, seq_len), np.int32)
    positions = np.zeros((n, seq_len), np.int32)
    for r, segs in enumerate(rows):
        off = 0
        for s, seg in enumerate(segs, start=1):
            tokens[r, off:off + len(seg)] = seg
            segment_ids[r, off:off + len(seg)] = s
            positions[r, off:off + len(seg)] = np.arange(len(seg))
            off += len(seg)
    return {"tokens": tokens, "segment_ids": segment_ids,
            "positions": positions}


@dataclasses.dataclass
class PackedTokenDataset:
    """Endless fixed-shape packed causal batches ``(tokens, targets,
    weights, segment_ids)``, each ``[global_batch, seq_len]``, from a
    memory-mapped corpus whose documents end in ``eod_id``; a window of
    the worker's stripe drawn from a counter rng keyed ``(seed, worker,
    step)``, as ``TokenDataset``'s."""

    data_dir: str | Path
    global_batch: int
    seq_len: int
    eod_id: int = 0
    split: str = "train"
    worker: int = 0
    num_workers: int = 1
    seed: int = 0

    def __post_init__(self):
        path, dtype = _resolve(self.data_dir, self.split)
        data = np.memmap(path, dtype=dtype, mode="r")
        shard = len(data) // self.num_workers
        lo = self.worker * shard
        self._data = data[lo:lo + shard]
        # enough of the stream to fill the bucket after packing losses
        # (first-fit wastes less than one document a row)
        self._draw = min(len(self._data),
                         2 * self.global_batch * (self.seq_len + 1))
        if len(self._data) < self.seq_len + 1:
            raise ValueError(
                f"{path}: worker shard has {len(self._data)} tokens < "
                f"window {self.seq_len + 1}")

    def batch(self, step: int = 0) -> tuple[np.ndarray, ...]:
        rng = np.random.default_rng((self.seed, self.worker, step))
        start = int(rng.integers(0, len(self._data) - self._draw + 1))
        window = np.asarray(self._data[start:start + self._draw])
        packed = pack_sequences(split_documents(window, self.eod_id),
                                self.seq_len + 1)
        b, lw = self.global_batch, self.seq_len + 1
        toks = np.zeros((b, lw), np.int32)
        segs = np.zeros((b, lw), np.int32)
        n = min(b, len(packed["tokens"]))
        toks[:n] = packed["tokens"][:n]
        segs[:n] = packed["segment_ids"][:n]
        tokens, targets = toks[:, :-1], toks[:, 1:]
        seg_t, seg_n = segs[:, :-1], segs[:, 1:]
        # a target counts where it continues the same document
        weights = ((seg_t != 0) & (seg_t == seg_n)).astype(np.float32)
        return (np.ascontiguousarray(tokens),
                np.ascontiguousarray(targets), weights,
                np.ascontiguousarray(seg_t))

    def __iter__(self) -> Iterator[tuple[np.ndarray, ...]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
