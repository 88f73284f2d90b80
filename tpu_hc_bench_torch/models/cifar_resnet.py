"""The CIFAR ResNets (resnet20/32/44/56/110_cifar): the port of the JAX
package's ``models/cifar_resnet.py``.

The depth-6n+2 networks for 32 px inputs: a 3x3/16 stem with BN and
relu, three stages of n ``BasicBlock``s at 16, 32 and 64 filters (stride
2 entering the second and third), a global mean-pool and a float32
head.  The blocks, convs and BatchNorms are ``models/resnet.py``'s.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tpu_hc_bench_torch.models.resnet import (
    BasicBlock, BatchNorm, Conv, FlaxInit, global_pool)


class CifarResNet(FlaxInit):
    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv_init = Conv(3, 16, 3, dtype=dtype)
        self.bn_init = BatchNorm(16, dtype)
        blocks, cin = [], 16
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                filters = 16 * 2 ** i
                blocks.append(BasicBlock(cin, filters,
                                         2 if i > 0 and j == 0 else 1, dtype))
                cin = filters
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn_init(self.conv_init(x.to(self.dtype))))
        for block in self.blocks:
            x = block(x)
        return self.head(global_pool(x, self.dtype).float())


def _make(depth: int):
    n = (depth - 2) // 6

    def create(num_classes: int = 10, dtype: torch.dtype = torch.float32):
        return CifarResNet([n, n, n], num_classes=num_classes, dtype=dtype)

    create.__name__ = f"resnet{depth}_cifar"
    return create


resnet20_cifar = _make(20)
resnet32_cifar = _make(32)
resnet44_cifar = _make(44)
resnet56_cifar = _make(56)
resnet110_cifar = _make(110)
