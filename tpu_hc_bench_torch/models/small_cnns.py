"""LeNet and OverFeat: the port of the JAX package's
``models/small_cnns.py``.

- ``lenet`` (tf_cnn_benchmarks' lenet5, 28 px): two 5x5 SAME conv-relu
  stages, each with a 2x2/2 max-pool, the map flattened in Flax's NHWC
  order, a 512-wide ``fc1`` (relu) in the compute dtype and a float32
  ``fc2``.  No dropout.
- ``overfeat`` (the "fast" network, 231 px): an 11x11/4 VALID conv,
  then 5x5 and three 3x3 SAME convs (all with biases and relu) with
  2x2/2 max-pools, ``fc6`` (3072) and ``fc7`` (4096), relu and dropout
  0.5 in the compute dtype, and a float32 ``fc8``.
"""

from __future__ import annotations

import torch
from torch import nn

from tpu_hc_bench_torch.models.bert import Dense, dropout
from tpu_hc_bench_torch.models.resnet import (
    Conv, FlaxInit, flatten_nhwc, max_pool)

DROPOUT = 0.5


class LeNet(FlaxInit):
    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, image_size: int = 28):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(3, 32, 5, dtype=dtype, bias=True)
        self.conv2 = Conv(32, 64, 5, dtype=dtype, bias=True)
        side = image_size // 4
        self.fc1 = Dense(side * side * 64, 512, dtype)
        self.fc2 = nn.Linear(512, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool(torch.relu(self.conv1(x.to(self.dtype))), 2, 2, "VALID")
        x = max_pool(torch.relu(self.conv2(x)), 2, 2, "VALID")
        x = torch.relu(self.fc1(flatten_nhwc(x)))
        return self.fc2(x.float())


class OverFeat(FlaxInit):
    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, image_size: int = 231):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(3, 96, 11, 4, dtype, padding="VALID", bias=True)
        self.conv2 = Conv(96, 256, 5, dtype=dtype, bias=True)
        self.conv3 = Conv(256, 512, 3, dtype=dtype, bias=True)
        self.conv4 = Conv(512, 1024, 3, dtype=dtype, bias=True)
        self.conv5 = Conv(1024, 1024, 3, dtype=dtype, bias=True)
        side = ((image_size - 11) // 4 + 1) // 8
        self.fc6 = Dense(side * side * 1024, 3072, dtype)
        self.fc7 = Dense(3072, 4096, dtype)
        self.fc8 = nn.Linear(4096, num_classes)
        self.dropout_generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool(torch.relu(self.conv1(x.to(self.dtype))), 2, 2, "VALID")
        x = max_pool(torch.relu(self.conv2(x)), 2, 2, "VALID")
        x = torch.relu(self.conv3(x))
        x = torch.relu(self.conv4(x))
        x = max_pool(torch.relu(self.conv5(x)), 2, 2, "VALID")
        gen, train = self.dropout_generator, self.training
        x = dropout(torch.relu(self.fc6(flatten_nhwc(x))), DROPOUT, gen,
                    train)
        x = dropout(torch.relu(self.fc7(x)), DROPOUT, gen, train)
        return self.fc8(x.float())


def lenet(num_classes: int = 1000, dtype: torch.dtype = torch.float32):
    return LeNet(num_classes=num_classes, dtype=dtype)


def overfeat(num_classes: int = 1000, dtype: torch.dtype = torch.float32):
    return OverFeat(num_classes=num_classes, dtype=dtype)
