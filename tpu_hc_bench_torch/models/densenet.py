"""The CIFAR DenseNets (densenet40_k12, densenet100_k12): the port of
the JAX package's ``models/densenet.py``.

A 3x3 stem to 16 channels, three dense blocks of ``(depth - 4) / 3``
layers, each BN -> relu -> 3x3 conv to ``growth`` channels concatenated
onto its input, two transitions (BN -> relu -> 1x1 conv keeping the
channels -> 2x2/2 average pool), then BN -> relu, a global mean-pool
and a float32 head.  Convs have no bias; BatchNorm momentum 0.9,
epsilon 1e-5.  Module names are Flax's (``b<block>_l<layer>_bn``, ...).
"""

from __future__ import annotations

import torch
from torch import nn

from tpu_hc_bench_torch.models.resnet import (
    BatchNorm, Conv, FlaxInit, avg_pool, global_pool)


class DenseNetCifar(FlaxInit):
    def __init__(self, depth: int = 40, growth: int = 12,
                 num_classes: int = 10, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layers_per_block = (depth - 4) // 3
        self.conv_init = Conv(3, 16, 3, dtype=dtype)
        c = 16
        for b in range(3):
            for l in range(self.layers_per_block):
                self.add_module(f"b{b}_l{l}_bn", BatchNorm(c, dtype))
                self.add_module(f"b{b}_l{l}_conv", Conv(c, growth, 3,
                                                        dtype=dtype))
                c += growth
            if b < 2:
                self.add_module(f"t{b}_bn", BatchNorm(c, dtype))
                self.add_module(f"t{b}_conv", Conv(c, c, 1, dtype=dtype))
        self.bn_final = BatchNorm(c, dtype)
        self.head = nn.Linear(c, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_init(x.to(self.dtype))
        for b in range(3):
            for l in range(self.layers_per_block):
                y = torch.relu(getattr(self, f"b{b}_l{l}_bn")(x))
                y = getattr(self, f"b{b}_l{l}_conv")(y)
                x = torch.cat([x, y], dim=1)
            if b < 2:
                x = torch.relu(getattr(self, f"t{b}_bn")(x))
                x = avg_pool(getattr(self, f"t{b}_conv")(x), 2, 2)
        x = torch.relu(self.bn_final(x))
        return self.head(global_pool(x, self.dtype).float())


def densenet40_k12(num_classes: int = 10,
                   dtype: torch.dtype = torch.float32):
    return DenseNetCifar(depth=40, growth=12, num_classes=num_classes,
                         dtype=dtype)


def densenet100_k12(num_classes: int = 10,
                    dtype: torch.dtype = torch.float32):
    return DenseNetCifar(depth=100, growth=12, num_classes=num_classes,
                         dtype=dtype)
