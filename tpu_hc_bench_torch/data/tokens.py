"""Per-request prompt sampler for the serving lane.

A copy of the synthetic branch of the JAX package's
``data.tokens.PromptSampler``: uniform ids over ``[1, vocab_size)`` at
exactly the requested length (0 is the reserved eod/pad id), from a
numpy counter rng keyed ``(seed, 11, rid)``.  The keys are kept
verbatim, so a trace here equals the JAX lane's for the same seed.  The
corpus branch (``data_dir``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

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
