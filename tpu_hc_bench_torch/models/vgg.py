"""VGG-11/16/19: the port of the JAX package's ``models/vgg.py``.

Five stages of 3x3 SAME convs with biases and relu (64, 128, 256, 512,
512 filters; ``conv<stage>_<i>`` as in Flax), each closed by a 2x2/2
max-pool; the map flattened in Flax's NHWC order; ``fc6`` and ``fc7``
(4096, relu, dropout 0.5) in the compute dtype and a float32 ``fc8``.
No BatchNorm.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tpu_hc_bench_torch.models.bert import Dense, dropout
from tpu_hc_bench_torch.models.resnet import (
    Conv, FlaxInit, flatten_nhwc, max_pool)

FILTERS = (64, 128, 256, 512, 512)
DROPOUT = 0.5


class VGG(FlaxInit):
    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, image_size: int = 224):
        super().__init__()
        self.dtype = dtype
        self.stages: list[list[str]] = []
        cin = 3
        for stage, n_convs in enumerate(stage_sizes):
            names = []
            for i in range(n_convs):
                name = f"conv{stage + 1}_{i + 1}"
                self.add_module(name, Conv(cin, FILTERS[stage], 3,
                                           dtype=dtype, bias=True))
                cin = FILTERS[stage]
                names.append(name)
            self.stages.append(names)
        side = image_size // 2 ** len(stage_sizes)
        self.fc6 = Dense(side * side * cin, 4096, dtype)
        self.fc7 = Dense(4096, 4096, dtype)
        self.fc8 = nn.Linear(4096, num_classes)
        self.dropout_generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for names in self.stages:
            for name in names:
                x = torch.relu(getattr(self, name)(x))
            x = max_pool(x, 2, 2, "VALID")
        gen, train = self.dropout_generator, self.training
        x = dropout(torch.relu(self.fc6(flatten_nhwc(x))), DROPOUT, gen,
                    train)
        x = dropout(torch.relu(self.fc7(x)), DROPOUT, gen, train)
        return self.fc8(x.float())


def vgg11(num_classes: int = 1000, dtype: torch.dtype = torch.float32):
    return VGG([1, 1, 2, 2, 2], num_classes=num_classes, dtype=dtype)


def vgg16(num_classes: int = 1000, dtype: torch.dtype = torch.float32):
    return VGG([2, 2, 3, 3, 3], num_classes=num_classes, dtype=dtype)


def vgg19(num_classes: int = 1000, dtype: torch.dtype = torch.float32):
    return VGG([2, 2, 4, 4, 4], num_classes=num_classes, dtype=dtype)
