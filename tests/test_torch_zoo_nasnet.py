"""The port's NASNet-A against the JAX package, on the CPU.

- **trees**: nasnet (mobile, 4 @ 1056) and nasnetlarge (6 @ 4032) at
  full width: every leaf of the Flax tree converts to the port's
  ``state_dict``, names, shapes and parameter counts equal, no weights
  made.
- **blocks**, float32, within 1e-4 of the largest magnitude, training
  mode (with every BatchNorm's updated statistics: momentum 0.9997,
  epsilon 1e-3) and eval mode: ``SepConv`` (k 3, 5, 7 at strides 1 and
  2, on a 9 x 9 map: SAME padded unevenly at stride 2), a normal cell
  whose previous input needs the factorized reduction (the shifted path
  and Flax's ``avg_pool``), one that needs the 1x1 fit, and a reduction
  cell (3x3/2 SAME average and max pools; the cell's input serving as
  both inputs).
- **the model**: a narrow ``NASNetA(num_cells=1, base_filters=8,
  stem_filters=8)`` at 64 px (its last maps 2 x 2: 8 values a channel
  for the last BatchNorms), logits in eval mode and the statistics in
  training mode (dropout 0.5 before the head).
"""

from __future__ import annotations

import pytest

from tpu_hc_bench.models import nasnet as jax_nasnet
from tpu_hc_bench_torch.models import nasnet

from test_torch_zoo_nets import check_block
from torch_zoo_common import check_forward, check_tree, images


@pytest.mark.parametrize("name", ["nasnet", "nasnetlarge"])
def test_full_width_tree_converts(name):
    check_tree(name)


@pytest.mark.parametrize("kernel,stride", [(3, 1), (5, 2), (7, 2)])
@pytest.mark.parametrize("train", [True, False])
def test_sepconv_matches_jax(kernel, stride, train):
    check_block(jax_nasnet.SepConv(8, kernel, stride),
                 nasnet.SepConv(8, 8, kernel, stride), "nasnet",
                 [images((2, 9, 9, 8), 7)], train)


# (reduction cell, x shape, prev shape or None); filters 8
CELLS = {
    "normal_factorized": (False, (2, 8, 8, 16), (2, 16, 16, 12)),
    "normal_fit": (False, (2, 8, 8, 16), (2, 8, 8, 24)),
    "reduction": (True, (2, 9, 9, 12), None),
}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("train", [True, False])
def test_nasnet_cells_match_jax(cell, train):
    reduction, xs, ps = CELLS[cell]
    spec = (jax_nasnet._REDUCTION, jax_nasnet._REDUCTION_CONCAT) \
        if reduction else (jax_nasnet._NORMAL, jax_nasnet._NORMAL_CONCAT)
    mod = jax_nasnet._CellCommon(8, tuple(spec[0]), tuple(spec[1]),
                                 reduction=reduction)
    port = nasnet.Cell(8, reduction, xs[-1], None if ps is None else ps[-1],
                       ps is not None and ps[1] != xs[1])
    assert port.adjust == {"normal_factorized": "reduce",
                           "normal_fit": "fit", "reduction": "fit"}[cell]
    check_block(mod, port, "nasnet",
                 [images(xs, 8), None if ps is None else images(ps, 9)],
                 train)


@pytest.mark.parametrize("train", [True, False])
def test_narrow_nasnet_matches_jax(train):
    kw = dict(num_cells=1, base_filters=8, stem_filters=8)
    check_forward(jax_nasnet.NASNetA(**kw), nasnet.NASNetA(**kw), "nasnet",
                  images((2, 64, 64, 3), 10), train, dropout=True)
