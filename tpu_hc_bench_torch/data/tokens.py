"""Token inputs: the serving lane's prompt sampler and the training
lane's pre-tokenized corpus, copies of the JAX package's
``data/tokens.py``.

- ``PromptSampler``: the synthetic branch of the JAX sampler: uniform
  ids over ``[1, vocab_size)`` at exactly the requested length (0 is the
  reserved eod/pad id), from a numpy counter rng keyed ``(seed, 11,
  rid)``.  The keys are kept verbatim, so a trace here equals the JAX
  lane's for the same seed.  The corpus branch (``data_dir``) is not
  ported yet.
- ``TokenDataset``: the text models' ``--data_dir``, a memory-mapped
  ``<data_dir>/<split>.bin`` holding a raw little-endian uint16 (vocab
  <= 65536) or uint32 token stream (the nanoGPT/Megatron convention;
  ``write_token_file`` writes one with a small dtype sidecar).  Worker
  ``w`` of ``W`` owns the ``w``-th of ``W`` contiguous stripes; window
  starts come from a counter rng keyed ``(seed, worker, step)``; causal
  members take next-token targets from a ``seq_len + 1`` window, MLM
  members BERT's 15 % masking from the same rng: the batch contract of
  ``SyntheticTokens``, ``(tokens, targets, weights)``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class PromptSampler:
    vocab_size: int
    data_dir: str | Path | None = None
    seed: int = 0

    def __post_init__(self):
        if self.data_dir is not None:
            raise NotImplementedError(
                "corpus prompts (data_dir) are not ported yet; the port "
                "samples synthetic prompts")

    def sample(self, rid: int, length: int) -> np.ndarray:
        """The prompt for request ``rid`` at ``length`` tokens."""
        if length < 1:
            raise ValueError(f"prompt length must be >= 1: {length}")
        rng = np.random.default_rng((self.seed, 11, rid))
        return rng.integers(1, max(2, self.vocab_size), size=(length,),
                            dtype=np.int64).astype(np.int32)


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
