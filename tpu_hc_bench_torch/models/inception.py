"""Inception-v3 and Inception-v4: the port of the JAX package's
``models/inception.py``.

Every conv is a ``ConvBN``: a conv with no bias (SAME or VALID, square
or 1x7 / 7x1 / 1x3 / 3x1 kernels), BatchNorm (momentum 0.9, epsilon
1e-3) and relu.  A block holds its ``ConvBN``s in ``convs``, in the
order the Flax block creates them (``ConvBN_<i>``).  Branches are
concatenated on the channels; the pooled branches take a 3x3/1 SAME
average pool (zero padding counted, as Flax's) or a 3x3/2 VALID
max-pool.  After the blocks: a global mean-pool, dropout (0.5 in v3, 0.2
in v4) and a float32 head; no auxiliary head (as in the JAX model).

- v3 at 299 px: a stem of five ``ConvBN``s and two max-pools (35x35x192),
  ``inception_a`` x3, ``reduction_b``, ``inception_c`` x4,
  ``reduction_d``, ``inception_e`` x2.
- v4 at 299 px: ``stem`` (``StemV4``), ``inception_a`` x4 (``InceptionA4``),
  ``reduction_a``, ``inception_b`` x7, ``reduction_b``, ``inception_c``
  x3.
"""

from __future__ import annotations

import torch
from torch import nn

from tpu_hc_bench_torch.models.bert import dropout
from tpu_hc_bench_torch.models.resnet import (
    BatchNorm, Conv, FlaxInit, avg_pool, global_pool, max_pool)

BN_EPS = 1e-3


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, k, stride: int = 1,
                 padding: str = "SAME", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride, dtype, padding=padding)
        self.bn = BatchNorm(cout, dtype, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class _Block(nn.Module):
    """A block whose ``ConvBN``s are made by ``self.c(cin, cout, k,
    ...)`` in the order the Flax block constructs them, which names
    them: a nested call ``c(a)(c(b)(x))`` constructs ``c(a)`` first, so
    a branch written that way lists its indices reversed
    (``[::-1]``) into the order they run; ``out_channels`` after
    construction."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.convs = nn.ModuleList()

    def c(self, cin: int, cout: int, k, stride: int = 1,
          padding: str = "SAME") -> int:
        """Append a ``ConvBN``; returns its index in ``convs``."""
        self.convs.append(ConvBN(cin, cout, k, stride, padding, self.dtype))
        return len(self.convs) - 1

    def chain(self, x: torch.Tensor, *idx: int) -> torch.Tensor:
        for i in idx:
            x = self.convs[i](x)
        return x


def _pool_branch(x: torch.Tensor) -> torch.Tensor:
    return avg_pool(x, 3, 1, "SAME")


class InceptionA(_Block):
    def __init__(self, cin: int, pool_features: int, dtype=torch.float32):
        super().__init__(dtype)
        self.b1 = (self.c(cin, 64, 1),)
        self.b2 = (self.c(48, 64, 5), self.c(cin, 48, 1))[::-1]
        self.b3 = (self.c(96, 96, 3), self.c(64, 96, 3),
                   self.c(cin, 64, 1))[::-1]
        self.b4 = (self.c(cin, pool_features, 1),)
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x):
        return torch.cat([self.chain(x, *self.b1), self.chain(x, *self.b2),
                          self.chain(x, *self.b3),
                          self.chain(_pool_branch(x), *self.b4)], dim=1)


class ReductionB(_Block):
    def __init__(self, cin: int, dtype=torch.float32):
        super().__init__(dtype)
        self.b1 = (self.c(cin, 384, 3, 2, "VALID"),)
        self.b2 = (self.c(cin, 64, 1), self.c(64, 96, 3),
                   self.c(96, 96, 3, 2, "VALID"))
        self.out_channels = 384 + 96 + cin

    def forward(self, x):
        return torch.cat([self.chain(x, *self.b1), self.chain(x, *self.b2),
                          max_pool(x, 3, 2, "VALID")], dim=1)


class InceptionC(_Block):
    def __init__(self, cin: int, channels_7x7: int, dtype=torch.float32):
        super().__init__(dtype)
        f = channels_7x7
        self.b1 = (self.c(cin, 192, 1),)
        self.b2 = (self.c(cin, f, 1), self.c(f, f, (1, 7)),
                   self.c(f, 192, (7, 1)))
        self.b3 = (self.c(cin, f, 1), self.c(f, f, (7, 1)),
                   self.c(f, f, (1, 7)), self.c(f, f, (7, 1)),
                   self.c(f, 192, (1, 7)))
        self.b4 = (self.c(cin, 192, 1),)
        self.out_channels = 4 * 192

    def forward(self, x):
        return torch.cat([self.chain(x, *self.b1), self.chain(x, *self.b2),
                          self.chain(x, *self.b3),
                          self.chain(_pool_branch(x), *self.b4)], dim=1)


class ReductionD(_Block):
    def __init__(self, cin: int, dtype=torch.float32):
        super().__init__(dtype)
        self.b1 = (self.c(cin, 192, 1), self.c(192, 320, 3, 2, "VALID"))
        self.b2 = (self.c(cin, 192, 1), self.c(192, 192, (1, 7)),
                   self.c(192, 192, (7, 1)), self.c(192, 192, 3, 2, "VALID"))
        self.out_channels = 320 + 192 + cin

    def forward(self, x):
        return torch.cat([self.chain(x, *self.b1), self.chain(x, *self.b2),
                          max_pool(x, 3, 2, "VALID")], dim=1)


class InceptionE(_Block):
    def __init__(self, cin: int, dtype=torch.float32):
        super().__init__(dtype)
        self.b1 = self.c(cin, 320, 1)
        self.b2 = self.c(cin, 384, 1)
        self.b2a, self.b2b = self.c(384, 384, (1, 3)), self.c(384, 384, (3, 1))
        self.b3 = (self.c(cin, 448, 1), self.c(448, 384, 3))
        self.b3a, self.b3b = self.c(384, 384, (1, 3)), self.c(384, 384, (3, 1))
        self.b4 = self.c(cin, 192, 1)
        self.out_channels = 320 + 768 + 768 + 192

    def forward(self, x):
        cv = self.convs
        b2 = cv[self.b2](x)
        b3 = self.chain(x, *self.b3)
        return torch.cat([cv[self.b1](x), cv[self.b2a](b2), cv[self.b2b](b2),
                          cv[self.b3a](b3), cv[self.b3b](b3),
                          cv[self.b4](_pool_branch(x))], dim=1)


class InceptionV3(FlaxInit):
    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        stem = ((3, 32, 3, 2, "VALID"), (32, 32, 3, 1, "VALID"),
                (32, 64, 3, 1, "SAME"), (64, 80, 1, 1, "VALID"),
                (80, 192, 3, 1, "VALID"))
        self.convs = nn.ModuleList(ConvBN(*s, dtype=dtype) for s in stem)
        self.inception_a = nn.ModuleList()
        c = 192
        for pf in (32, 64, 64):
            self.inception_a.append(InceptionA(c, pf, dtype))
            c = self.inception_a[-1].out_channels
        self.reduction_b = nn.ModuleList([ReductionB(c, dtype)])
        c = self.reduction_b[0].out_channels
        self.inception_c = nn.ModuleList()
        for f in (128, 160, 160, 192):
            self.inception_c.append(InceptionC(c, f, dtype))
            c = self.inception_c[-1].out_channels
        self.reduction_d = nn.ModuleList([ReductionD(c, dtype)])
        c = self.reduction_d[0].out_channels
        self.inception_e = nn.ModuleList()
        for _ in range(2):
            self.inception_e.append(InceptionE(c, dtype))
            c = self.inception_e[-1].out_channels
        self.head = nn.Linear(c, num_classes)
        self.dropout_generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if i in (2, 4):
                x = max_pool(x, 3, 2, "VALID")
        for blocks in (self.inception_a, self.reduction_b, self.inception_c,
                       self.reduction_d, self.inception_e):
            for block in blocks:
                x = block(x)
        x = dropout(global_pool(x, self.dtype), 0.5,
                    self.dropout_generator, self.training)
        return self.head(x.float())


class StemV4(_Block):
    def __init__(self, dtype=torch.float32):
        super().__init__(dtype)
        self.s = (self.c(3, 32, 3, 2, "VALID"), self.c(32, 32, 3, 1, "VALID"),
                  self.c(32, 64, 3))
        self.s2 = self.c(64, 96, 3, 2, "VALID")
        self.b1 = (self.c(64, 96, 3, 1, "VALID"), self.c(160, 64, 1))[::-1]
        self.b2 = (self.c(160, 64, 1), self.c(64, 64, (1, 7)),
                   self.c(64, 64, (7, 1)), self.c(64, 96, 3, 1, "VALID"))
        self.s3 = self.c(192, 192, 3, 2, "VALID")
        self.out_channels = 384

    def forward(self, x):
        x = self.chain(x, *self.s)
        x = torch.cat([max_pool(x, 3, 2, "VALID"), self.convs[self.s2](x)],
                      dim=1)
        x = torch.cat([self.chain(x, *self.b1), self.chain(x, *self.b2)],
                      dim=1)
        return torch.cat([self.convs[self.s3](x), max_pool(x, 3, 2, "VALID")],
                         dim=1)


class InceptionA4(_Block):
    def __init__(self, cin: int, dtype=torch.float32):
        super().__init__(dtype)
        self.b1 = (self.c(cin, 96, 1),)
        self.b2 = (self.c(64, 96, 3), self.c(cin, 64, 1))[::-1]
        self.b3 = (self.c(96, 96, 3), self.c(64, 96, 3),
                   self.c(cin, 64, 1))[::-1]
        self.b4 = (self.c(cin, 96, 1),)
        self.out_channels = 4 * 96

    def forward(self, x):
        return torch.cat([self.chain(x, *self.b1), self.chain(x, *self.b2),
                          self.chain(x, *self.b3),
                          self.chain(_pool_branch(x), *self.b4)], dim=1)


class ReductionA4(_Block):
    def __init__(self, cin: int, dtype=torch.float32):
        super().__init__(dtype)
        self.b1 = (self.c(cin, 384, 3, 2, "VALID"),)
        self.b2 = (self.c(cin, 192, 1), self.c(192, 224, 3),
                   self.c(224, 256, 3, 2, "VALID"))
        self.out_channels = 384 + 256 + cin

    def forward(self, x):
        return torch.cat([self.chain(x, *self.b1), self.chain(x, *self.b2),
                          max_pool(x, 3, 2, "VALID")], dim=1)


class InceptionB4(_Block):
    def __init__(self, cin: int, dtype=torch.float32):
        super().__init__(dtype)
        self.b1 = (self.c(cin, 384, 1),)
        self.b2 = (self.c(cin, 192, 1), self.c(192, 224, (1, 7)),
                   self.c(224, 256, (7, 1)))
        self.b3 = (self.c(cin, 192, 1), self.c(192, 192, (7, 1)),
                   self.c(192, 224, (1, 7)), self.c(224, 224, (7, 1)),
                   self.c(224, 256, (1, 7)))
        self.b4 = (self.c(cin, 128, 1),)
        self.out_channels = 384 + 256 + 256 + 128

    def forward(self, x):
        return torch.cat([self.chain(x, *self.b1), self.chain(x, *self.b2),
                          self.chain(x, *self.b3),
                          self.chain(_pool_branch(x), *self.b4)], dim=1)


class ReductionB4(_Block):
    def __init__(self, cin: int, dtype=torch.float32):
        super().__init__(dtype)
        self.b1 = (self.c(cin, 192, 1), self.c(192, 192, 3, 2, "VALID"))
        self.b2 = (self.c(cin, 256, 1), self.c(256, 256, (1, 7)),
                   self.c(256, 320, (7, 1)), self.c(320, 320, 3, 2, "VALID"))
        self.out_channels = 192 + 320 + cin

    def forward(self, x):
        return torch.cat([self.chain(x, *self.b1), self.chain(x, *self.b2),
                          max_pool(x, 3, 2, "VALID")], dim=1)


class InceptionC4(_Block):
    def __init__(self, cin: int, dtype=torch.float32):
        super().__init__(dtype)
        self.b1 = self.c(cin, 256, 1)
        self.b2 = self.c(cin, 384, 1)
        self.b2a, self.b2b = self.c(384, 256, (1, 3)), self.c(384, 256, (3, 1))
        self.b3 = (self.c(cin, 384, 1), self.c(384, 448, (1, 3)),
                   self.c(448, 512, (3, 1)))
        self.b3a, self.b3b = self.c(512, 256, (3, 1)), self.c(512, 256, (1, 3))
        self.b4 = self.c(cin, 256, 1)
        self.out_channels = 6 * 256

    def forward(self, x):
        cv = self.convs
        b2 = cv[self.b2](x)
        b3 = self.chain(x, *self.b3)
        return torch.cat([cv[self.b1](x), cv[self.b2a](b2), cv[self.b2b](b2),
                          cv[self.b3a](b3), cv[self.b3b](b3),
                          cv[self.b4](_pool_branch(x))], dim=1)


class InceptionV4(FlaxInit):
    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem = StemV4(dtype)
        c = self.stem.out_channels
        groups = []
        for cls, n in ((InceptionA4, 4), (ReductionA4, 1), (InceptionB4, 7),
                       (ReductionB4, 1), (InceptionC4, 3)):
            blocks = nn.ModuleList()
            for _ in range(n):
                blocks.append(cls(c, dtype))
                c = blocks[-1].out_channels
            groups.append(blocks)
        (self.inception_a, self.reduction_a, self.inception_b,
         self.reduction_b, self.inception_c) = groups
        self.head = nn.Linear(c, num_classes)
        self.dropout_generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x.to(self.dtype))
        for blocks in (self.inception_a, self.reduction_a, self.inception_b,
                       self.reduction_b, self.inception_c):
            for block in blocks:
                x = block(x)
        x = dropout(global_pool(x, self.dtype), 0.2,
                    self.dropout_generator, self.training)
        return self.head(x.float())


def inception_v3(num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
    return InceptionV3(num_classes=num_classes, dtype=dtype)


def inception_v4(num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
    return InceptionV4(num_classes=num_classes, dtype=dtype)
