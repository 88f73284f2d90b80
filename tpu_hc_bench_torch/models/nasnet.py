"""NASNet-A (nasnet: mobile, 4 @ 1056; nasnetlarge: 6 @ 4032): the port
of the JAX package's ``models/nasnet.py``.

The paper's cells from the JAX model's spec tables: a normal cell (five
blocks of two ops summed, six states concatenated) and a reduction cell
(the ops on the cell's two inputs at stride 2, four states
concatenated), stacked as a 3x3/2 VALID stem conv and BN, two reduction
cells, then three stacks of ``num_cells`` normal cells with a reduction
cell between stacks; relu, a global mean-pool, dropout 0.5 and a
float32 head.  Every BatchNorm has momentum 0.9997 and epsilon 1e-3;
convs have no bias.

- ``SepConv``: twice (relu -> depthwise k x k -> 1x1 -> BN), the stride
  on the first depthwise.
- A cell first brings its previous input to ``filters`` channels and its
  own input's size: ``_factorized_reduce`` where the sizes differ (relu,
  two 1x1 paths on stride-2 samples, the second shifted by one pixel,
  concatenated, BN), else ``_fit`` (relu, 1x1, BN) where the channels
  differ, else nothing; its own input always through ``_fit``
  (``base``).  The JAX cell decides from the arrays' shapes; the port
  decides at construction from each input's channels and the number of
  stride-2 reductions behind it, which give the same answer wherever a
  reduction changes the map's size (every map above 1 x 1).
- ``avg``/``max`` ops are 3x3 SAME pools (the average counts the zero
  padding, as Flax's); ``id`` passes its state through.

Module names are Flax's (``stem_reduce0``, ``s<stack>_cell<i>``,
``reduce<stack>``; in a cell ``adjust_prev_*``, ``base_*`` and
``b<block><l|r>_<op>``).
"""

from __future__ import annotations

import torch
from torch import nn

from tpu_hc_bench_torch.models.bert import dropout
from tpu_hc_bench_torch.models.resnet import (
    BatchNorm, Conv, FlaxInit, avg_pool, global_pool, max_pool)

BN_MOMENTUM = 0.9997
BN_EPS = 1e-3
DROPOUT = 0.5

# (op, state index) pairs, two a block; the states start [cell input
# after base, previous input after adjust], each block appends its sum
NORMAL = (("sep5", 0), ("sep3", 1), ("sep5", 1), ("sep3", 1),
          ("avg", 0), ("id", 1), ("avg", 1), ("avg", 1),
          ("sep3", 0), ("id", 0))
NORMAL_CONCAT = (1, 2, 3, 4, 5, 6)
REDUCTION = (("sep5", 0), ("sep7", 1), ("max", 0), ("sep7", 1),
             ("avg", 0), ("sep5", 1), ("id", 3), ("avg", 2),
             ("sep3", 2), ("max", 0))
REDUCTION_CONCAT = (3, 4, 5, 6)
SEP_KERNELS = {"sep3": 3, "sep5": 5, "sep7": 7}


def _bn(c: int, dtype: torch.dtype) -> BatchNorm:
    return BatchNorm(c, dtype, momentum=BN_MOMENTUM, eps=BN_EPS)


class SepConv(nn.Module):
    def __init__(self, cin: int, filters: int, kernel: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dw0 = Conv(cin, cin, kernel, stride, dtype, groups=cin)
        self.pw0 = Conv(cin, filters, 1, dtype=dtype)
        self.bn0 = _bn(filters, dtype)
        self.dw1 = Conv(filters, filters, kernel, dtype=dtype,
                        groups=filters)
        self.pw1 = Conv(filters, filters, 1, dtype=dtype)
        self.bn1 = _bn(filters, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn0(self.pw0(self.dw0(torch.relu(x))))
        return self.bn1(self.pw1(self.dw1(torch.relu(x))))


class Cell(nn.Module):
    """A normal or reduction cell over ``(x, prev)``: ``x`` with ``cin``
    channels, ``prev`` with ``prev_cin`` (None: the cell's input serves
    as both), ``prev_reduced``: ``prev`` lies one reduction above ``x``
    (a larger map)."""

    def __init__(self, filters: int, reduction: bool, cin: int,
                 prev_cin: int | None, prev_reduced: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.filters, self.reduction = filters, reduction
        self.spec = REDUCTION if reduction else NORMAL
        self.concat = REDUCTION_CONCAT if reduction else NORMAL_CONCAT
        prev_cin = cin if prev_cin is None else prev_cin
        self.adjust = None
        if prev_reduced:
            self.adjust = "reduce"
            half = filters // 2
            self.adjust_prev_p1 = Conv(prev_cin, half, 1, dtype=dtype)
            self.adjust_prev_p2 = Conv(prev_cin, filters - half, 1,
                                       dtype=dtype)
            self.adjust_prev_bn = _bn(filters, dtype)
        elif prev_cin != filters:
            self.adjust = "fit"
            self.adjust_prev_1x1 = Conv(prev_cin, filters, 1, dtype=dtype)
            self.adjust_prev_bn = _bn(filters, dtype)
        self.base_1x1 = Conv(cin, filters, 1, dtype=dtype)
        self.base_bn = _bn(filters, dtype)
        for b in range(5):
            for side, (op, i) in zip("lr", self.spec[2 * b:2 * b + 2]):
                if op in SEP_KERNELS:
                    stride = 2 if reduction and i < 2 else 1
                    self.add_module(f"b{b}{side}_{op}", SepConv(
                        filters, filters, SEP_KERNELS[op], stride, dtype))
        self.out_channels = len(self.concat) * filters

    def _op(self, kind: str, x: torch.Tensor, stride: int,
            name: str) -> torch.Tensor:
        if kind == "id":
            return x
        if kind == "avg":
            return avg_pool(x, 3, stride, "SAME")
        if kind == "max":
            return max_pool(x, 3, stride, "SAME")
        return getattr(self, name)(x)

    def forward(self, x: torch.Tensor,
                prev: torch.Tensor | None) -> torch.Tensor:
        if prev is None:
            prev = x
        if self.adjust == "reduce":
            p = torch.relu(prev)
            p1 = self.adjust_prev_p1(avg_pool(p, 1, 2))
            p2 = self.adjust_prev_p2(avg_pool(p[:, :, 1:, 1:], 1, 2,
                                              ((0, 1), (0, 1))))
            prev = self.adjust_prev_bn(torch.cat([p1, p2], dim=1))
        elif self.adjust == "fit":
            prev = self.adjust_prev_bn(self.adjust_prev_1x1(torch.relu(prev)))
        states = [self.base_bn(self.base_1x1(torch.relu(x))), prev]
        for b in range(5):
            outs = []
            for side, (op, i) in zip("lr", self.spec[2 * b:2 * b + 2]):
                stride = 2 if self.reduction and i < 2 else 1
                outs.append(self._op(op, states[i], stride,
                                     f"b{b}{side}_{op}"))
            states.append(outs[0] + outs[1])
        return torch.cat([states[i] for i in self.concat], dim=1)


class NASNetA(FlaxInit):
    def __init__(self, num_cells: int = 4, base_filters: int = 44,
                 stem_filters: int = 32, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        f = base_filters
        self.stem_conv = Conv(3, stem_filters, 3, 2, dtype, padding="VALID")
        self.stem_bn = _bn(stem_filters, dtype)
        # (name, cell); each cell's inputs tracked as (channels, reductions)
        self.order: list[str] = []
        cur, prev = (stem_filters, 0), None

        def add(name: str, filters: int, reduction: bool) -> None:
            nonlocal cur, prev
            cell = Cell(filters, reduction, cur[0],
                        None if prev is None else prev[0],
                        prev is not None and prev[1] < cur[1], dtype)
            self.add_module(name, cell)
            self.order.append(name)
            cur, prev = (cell.out_channels, cur[1] + reduction), cur

        add("stem_reduce0", f // 4, True)
        add("stem_reduce1", f // 2, True)
        for stack in range(3):
            filters = f * 2 ** stack
            for i in range(num_cells):
                add(f"s{stack}_cell{i}", filters, False)
            if stack < 2:
                add(f"reduce{stack}", filters * 2, True)
        self.head = nn.Linear(cur[0], num_classes)
        self.dropout_generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem_bn(self.stem_conv(x.to(self.dtype)))
        cur, prev = x, None
        for name in self.order:
            cur, prev = getattr(self, name)(cur, prev), cur
        x = global_pool(torch.relu(cur), self.dtype)
        x = dropout(x, DROPOUT, self.dropout_generator, self.training)
        return self.head(x.float())


def nasnet(num_classes: int = 1000, dtype: torch.dtype = torch.float32):
    """NASNet-A mobile, 4 @ 1056 (224 px)."""
    return NASNetA(num_cells=4, base_filters=44, stem_filters=32,
                   num_classes=num_classes, dtype=dtype)


def nasnetlarge(num_classes: int = 1000,
                dtype: torch.dtype = torch.float32):
    """NASNet-A large, 6 @ 4032 (331 px)."""
    return NASNetA(num_cells=6, base_filters=168, stem_filters=96,
                   num_classes=num_classes, dtype=dtype)
