"""Synthetic inputs, tf_cnn_benchmarks' default data mode: one
deterministic random batch made once on the host from ``seed`` and fed
every step, so the benchmark measures the step and not an input
pipeline.  ``SyntheticImages``, ``SyntheticSpeech``, ``SyntheticIds``
and ``SyntheticTokens`` are copies of the JAX package's
``data/synthetic.py`` (numpy only, the same draws in the same order), so
both lanes see the same bytes.

With several workers every rank builds the same global batch from
``seed`` and keeps its own rows (``rank_rows``), the layout the JAX
lane's ``shard_batch`` gives over the data axis.  Under sequence
parallelism a rank keeps its data group's rows and then its seq group's
slice of every sequence (``seq_slice``), JAX's ``P(data, seq)`` layout:
the targets and weights are sliced from the global batch, never rebuilt
a shard, so the next-token target at a shard's edge is the next shard's
first token.

``to_device`` hands an image batch to the port's models: the NHWC float32
images as an NCHW tensor in ``channels_last`` memory (a view of the same
bytes) and the labels as int64, on ``device``, once.
``tokens_to_device`` does the same for a token batch: ids and targets as
int64, weights as float32; ``speech_to_device`` for a spectrogram batch:
the ``[B, T, F]`` features as they are (float32), labels int64 and
paddings float32; ``ids_to_device`` for an id batch: the ``[B, 2]``
pairs and the labels as int64, which ``nn.Embedding`` takes.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticImages:
    """Fixed random image batch: NHWC float32 images + int labels."""

    global_batch: int
    image_shape: tuple[int, int, int]  # (H, W, C)
    num_classes: int = 1000
    seed: int = 0

    def batch(self) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed)
        images = rng.standard_normal(
            (self.global_batch, *self.image_shape), dtype=np.float32
        )
        labels = rng.integers(
            0, self.num_classes, size=(self.global_batch,), dtype=np.int32
        )
        return images, labels

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        batch = self.batch()
        while True:
            yield batch


@dataclasses.dataclass
class SyntheticSpeech:
    """Fixed random spectrogram batch for the CTC member (deepspeech2):
    ``(features [B, T, F], labels [B, L] int32, label_paddings [B, L]
    float32)``: labels in [1, vocab) (0 is the CTC blank), each
    transcript's length drawn in [L/2, L], its padding marked 1.0."""

    global_batch: int
    frames: int
    freq: int
    max_label: int
    vocab_size: int = 29
    seed: int = 0

    def batch(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed)
        feats = rng.standard_normal(
            (self.global_batch, self.frames, self.freq), dtype=np.float32)
        labels = rng.integers(
            1, self.vocab_size,
            size=(self.global_batch, self.max_label)).astype(np.int32)
        lengths = rng.integers(self.max_label // 2, self.max_label + 1,
                               size=(self.global_batch,))
        paddings = (np.arange(self.max_label)[None, :]
                    >= lengths[:, None]).astype(np.float32)
        return feats, labels, paddings


@dataclasses.dataclass
class SyntheticIds:
    """Fixed random id-pair batch for the NCF member: ``[B, 2] int32``
    (user, item) ids and binary implicit-feedback labels."""

    global_batch: int
    num_users: int
    num_items: int
    seed: int = 0

    def batch(self) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed)
        ids = np.stack([
            rng.integers(0, self.num_users, self.global_batch),
            rng.integers(0, self.num_items, self.global_batch),
        ], axis=1).astype(np.int32)
        labels = rng.integers(0, 2, self.global_batch).astype(np.int32)
        return ids, labels


def rank_rows(batch: tuple[np.ndarray, ...], rank: int,
              rows: int) -> tuple[np.ndarray, ...]:
    """Rows ``[rank * rows, (rank + 1) * rows)`` of every array of a
    global batch."""
    if (rank + 1) * rows > len(batch[0]):
        raise ValueError(f"rank {rank} x {rows} rows is outside a batch "
                         f"of {len(batch[0])}")
    return tuple(a[rank * rows:(rank + 1) * rows] for a in batch)


def seq_slice(batch: tuple[np.ndarray, ...], seq_index: int,
              sp: int) -> tuple[np.ndarray, ...]:
    """Slice ``seq_index`` of ``sp`` along dim 1 (the sequence) of every
    array of a token batch."""
    s = batch[0].shape[1]
    if s % sp:
        raise ValueError(f"sequence length {s} not divisible by "
                         f"sequence_parallel={sp}")
    k = s // sp
    return tuple(a[:, seq_index * k:(seq_index + 1) * k] for a in batch)


def to_device(batch: tuple[np.ndarray, np.ndarray],
              device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(images NCHW channels_last float32, labels int64)`` on
    ``device``."""
    images, labels = batch
    x = torch.from_numpy(images).to(device).permute(0, 3, 1, 2)
    return x, torch.from_numpy(labels).to(device=device, dtype=torch.int64)


def speech_to_device(batch: tuple[np.ndarray, np.ndarray, np.ndarray],
                     device: torch.device
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(features float32 [B, T, F], labels int64, label_paddings
    float32)`` on ``device``."""
    feats, labels, paddings = batch
    return (torch.from_numpy(feats).to(device),
            torch.from_numpy(labels).to(device=device, dtype=torch.int64),
            torch.from_numpy(paddings).to(device))


def ids_to_device(batch: tuple[np.ndarray, np.ndarray],
                  device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ids int64 [B, 2], labels int64)`` on ``device``."""
    return tuple(torch.from_numpy(a).to(device=device, dtype=torch.int64)
                 for a in batch)


@dataclasses.dataclass
class SyntheticTokens:
    """Fixed random token batch for MLM: ids, targets, mask weights.

    15% of positions are selected as prediction targets (BERT's masking
    rate); selected input positions carry the [MASK]-style corruption (id 0).
    """

    global_batch: int
    seq_len: int
    vocab_size: int = 30522
    mask_rate: float = 0.15
    seed: int = 0
    causal_lm: bool = False            # next-token objective (GPT members)
                                       # instead of masked-LM

    def batch(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed)
        if self.causal_lm:
            tokens = rng.integers(
                1, self.vocab_size, size=(self.global_batch, self.seq_len),
                dtype=np.int32,
            )
            # predict token t+1 at position t; final position has no target
            targets = np.roll(tokens, -1, axis=1)
            weights = np.ones_like(tokens, np.float32)
            weights[:, -1] = 0.0
            return tokens, targets, weights
        targets = rng.integers(
            1, self.vocab_size, size=(self.global_batch, self.seq_len),
            dtype=np.int32,
        )
        mask = rng.random((self.global_batch, self.seq_len)) < self.mask_rate
        inputs = np.where(mask, 0, targets).astype(np.int32)
        weights = mask.astype(np.float32)
        return inputs, targets, weights

    def __iter__(self):
        batch = self.batch()
        while True:
            yield batch


def tokens_to_device(batch: tuple[np.ndarray, np.ndarray, np.ndarray],
                     device: torch.device
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(ids int64, targets int64, weights float32)`` on ``device``."""
    ids, targets, weights = batch
    return (torch.from_numpy(ids).to(device=device, dtype=torch.int64),
            torch.from_numpy(targets).to(device=device, dtype=torch.int64),
            torch.from_numpy(weights).to(device))
