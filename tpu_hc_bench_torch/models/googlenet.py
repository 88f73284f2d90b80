"""GoogLeNet (Inception-v1): the port of the JAX package's
``models/googlenet.py``.

The stem (7x7/2 conv, 3x3/2 SAME max-pool, 1x1 and 3x3 convs, another
pool), nine ``InceptionModule``s (1x1, 3x3 and 5x5 branches and a
pooled projection, concatenated on the channels) with 3x3/2 SAME
max-pools after 3b and 4e, a global mean-pool, dropout 0.4 and a
float32 head.  Every conv has a bias and a relu; no BatchNorm, and no
auxiliary heads (as in the JAX model).
"""

from __future__ import annotations

import torch
from torch import nn

from tpu_hc_bench_torch.models.bert import dropout
from tpu_hc_bench_torch.models.resnet import (
    Conv, FlaxInit, global_pool, max_pool)

DROPOUT = 0.4
# (f1, f3r, f3, f5r, f5, fp) of modules 3a, 3b, 4a-4e, 5a, 5b
MODULES = ((64, 96, 128, 16, 32, 32), (128, 128, 192, 32, 96, 64),
           (192, 96, 208, 16, 48, 64), (160, 112, 224, 24, 64, 64),
           (128, 128, 256, 24, 64, 64), (112, 144, 288, 32, 64, 64),
           (256, 160, 320, 32, 128, 128), (256, 160, 320, 32, 128, 128),
           (384, 192, 384, 48, 128, 128))
POOL_AFTER = (1, 6)           # a 3x3/2 max-pool after 3b and after 4e


class InceptionModule(nn.Module):
    def __init__(self, cin: int, f1: int, f3r: int, f3: int, f5r: int,
                 f5: int, fp: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.b1 = Conv(cin, f1, 1, dtype=dtype, bias=True)
        self.b3r = Conv(cin, f3r, 1, dtype=dtype, bias=True)
        self.b3 = Conv(f3r, f3, 3, dtype=dtype, bias=True)
        self.b5r = Conv(cin, f5r, 1, dtype=dtype, bias=True)
        self.b5 = Conv(f5r, f5, 5, dtype=dtype, bias=True)
        self.bp = Conv(cin, fp, 1, dtype=dtype, bias=True)
        self.out_channels = f1 + f3 + f5 + fp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = torch.relu(self.b1(x))
        b3 = torch.relu(self.b3(torch.relu(self.b3r(x))))
        b5 = torch.relu(self.b5(torch.relu(self.b5r(x))))
        bp = torch.relu(self.bp(max_pool(x, 3, 1)))
        return torch.cat([b1, b3, b5, bp], dim=1)


class GoogLeNet(FlaxInit):
    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(3, 64, 7, 2, dtype, bias=True)
        self.conv2r = Conv(64, 64, 1, dtype=dtype, bias=True)
        self.conv2 = Conv(64, 192, 3, dtype=dtype, bias=True)
        mods, cin = [], 192
        for f in MODULES:
            mods.append(InceptionModule(cin, *f, dtype=dtype))
            cin = mods[-1].out_channels
        self.inception = nn.ModuleList(mods)
        self.head = nn.Linear(cin, num_classes)
        self.dropout_generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool(torch.relu(self.conv1(x.to(self.dtype))))
        x = torch.relu(self.conv2(torch.relu(self.conv2r(x))))
        x = max_pool(x)
        for i, mod in enumerate(self.inception):
            x = mod(x)
            if i in POOL_AFTER:
                x = max_pool(x)
        x = dropout(global_pool(x, self.dtype), DROPOUT,
                    self.dropout_generator, self.training)
        return self.head(x.float())


def googlenet(num_classes: int = 1000, dtype: torch.dtype = torch.float32):
    return GoogLeNet(num_classes=num_classes, dtype=dtype)
