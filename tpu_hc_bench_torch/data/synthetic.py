"""Synthetic inputs, tf_cnn_benchmarks' default data mode: one
deterministic random batch made once on the host from ``seed`` and fed
every step, so the benchmark measures the step and not an input
pipeline.  ``SyntheticImages`` is a copy of the JAX package's
``data/synthetic.py`` (numpy only), so both lanes see the same bytes.

``to_device`` hands the batch to the port's models: the NHWC float32
images as an NCHW tensor in ``channels_last`` memory (a view of the same
bytes) and the labels as int64, on ``device``, once.
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


def to_device(batch: tuple[np.ndarray, np.ndarray],
              device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(images NCHW channels_last float32, labels int64)`` on
    ``device``."""
    images, labels = batch
    x = torch.from_numpy(images).to(device).permute(0, 3, 1, 2)
    return x, torch.from_numpy(labels).to(device=device, dtype=torch.int64)
