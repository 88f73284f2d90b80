"""AlexNet: the port of the JAX package's ``models/alexnet.py``.

One tower (the one-GPU variant tf_cnn_benchmarks drives): an 11x11/4
conv padded (2, 2) on each side, so 224 px gives the 55 -> 27 -> 13 -> 6
maps of the canonical 227 px input, 3x3/2 VALID max-pools, four more
convs (all with biases and relu), the 6x6x256 map flattened in Flax's
NHWC order into ``fc6`` and ``fc7`` (4096, relu, dropout 0.5, in the
compute dtype) and a float32 ``fc8``.
"""

from __future__ import annotations

import torch
from torch import nn

from tpu_hc_bench_torch.models.bert import Dense, dropout
from tpu_hc_bench_torch.models.resnet import (
    Conv, FlaxInit, flatten_nhwc, max_pool)

DROPOUT = 0.5


def _pool3(n: int) -> int:
    return (n - 3) // 2 + 1


class AlexNet(FlaxInit):
    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, image_size: int = 224):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(3, 64, 11, 4, dtype, padding=((2, 2), (2, 2)),
                          bias=True)
        self.conv2 = Conv(64, 192, 5, dtype=dtype, bias=True)
        self.conv3 = Conv(192, 384, 3, dtype=dtype, bias=True)
        self.conv4 = Conv(384, 256, 3, dtype=dtype, bias=True)
        self.conv5 = Conv(256, 256, 3, dtype=dtype, bias=True)
        side = _pool3(_pool3(_pool3((image_size + 4 - 11) // 4 + 1)))
        self.fc6 = Dense(side * side * 256, 4096, dtype)
        self.fc7 = Dense(4096, 4096, dtype)
        self.fc8 = nn.Linear(4096, num_classes)
        self.dropout_generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool(torch.relu(self.conv1(x.to(self.dtype))), 3, 2, "VALID")
        x = max_pool(torch.relu(self.conv2(x)), 3, 2, "VALID")
        x = torch.relu(self.conv3(x))
        x = torch.relu(self.conv4(x))
        x = max_pool(torch.relu(self.conv5(x)), 3, 2, "VALID")
        gen, train = self.dropout_generator, self.training
        x = dropout(torch.relu(self.fc6(flatten_nhwc(x))), DROPOUT, gen,
                    train)
        x = dropout(torch.relu(self.fc7(x)), DROPOUT, gen, train)
        return self.fc8(x.float())


def alexnet(num_classes: int = 1000, dtype: torch.dtype = torch.float32):
    return AlexNet(num_classes=num_classes, dtype=dtype)
