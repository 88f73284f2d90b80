"""MobileNet v1 (width 1.0): the port of the JAX package's
``models/mobilenet.py``.

A 3x3/2 stem to 32 channels, then 13 depthwise-separable blocks: a 3x3
depthwise conv (``groups`` = its channels, Flax's
``feature_group_count``) at the block's stride and a 1x1 pointwise conv,
each followed by BatchNorm (momentum 0.9, epsilon 1e-3) and relu6; a
global mean-pool and a float32 head.  Convs have no bias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpu_hc_bench_torch.models.resnet import (
    BatchNorm, Conv, FlaxInit, global_pool)

BN_EPS = 1e-3
# (pointwise output channels, stride of the depthwise conv)
V1_BLOCKS = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
             (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
             (1024, 2), (1024, 1))


class MobileNetV1(FlaxInit):
    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv_init = Conv(3, 32, 3, 2, dtype)
        self.bn_init = BatchNorm(32, dtype, eps=BN_EPS)
        cin = 32
        for i, (filters, stride) in enumerate(V1_BLOCKS):
            self.add_module(f"dw_{i}", Conv(cin, cin, 3, stride, dtype,
                                            groups=cin))
            self.add_module(f"dw_bn_{i}", BatchNorm(cin, dtype, eps=BN_EPS))
            self.add_module(f"pw_{i}", Conv(cin, filters, 1, dtype=dtype))
            self.add_module(f"pw_bn_{i}", BatchNorm(filters, dtype,
                                                    eps=BN_EPS))
            cin = filters
        self.head = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu6(self.bn_init(self.conv_init(x.to(self.dtype))))
        for i in range(len(V1_BLOCKS)):
            x = F.relu6(getattr(self, f"dw_bn_{i}")(
                getattr(self, f"dw_{i}")(x)))
            x = F.relu6(getattr(self, f"pw_bn_{i}")(
                getattr(self, f"pw_{i}")(x)))
        return self.head(global_pool(x, self.dtype).float())


def mobilenet(num_classes: int = 1000, dtype: torch.dtype = torch.float32):
    return MobileNetV1(num_classes=num_classes, dtype=dtype)
