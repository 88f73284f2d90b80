"""The port's DenseNets and Inception-v3/v4 against the JAX package, on
the CPU, and the registry as a whole (NASNet-A: ``test_torch_zoo_nasnet.py``).

- **trees**: densenet40_k12, densenet100_k12, inception3 and inception4
  at full width: every leaf of the Flax tree converts to the port's
  ``state_dict``, names, shapes and parameter counts equal, no weights
  made.
- **forward**, float32, within 1e-4 of the largest magnitude, training
  mode (with every BatchNorm's updated statistics) and eval mode:
  densenet40_k12 at full width (32 px, batch 2) and a narrow
  ``DenseNetCifar(depth=10)``; inception block by block (v3's A-E, v4's
  stem, A, B, C and both reductions, at full channel width on small
  maps), and the model's eval forward at 75 px; NASNet's ``SepConv`` (k
  3, 5, 7 at strides 1 and 2), a normal cell whose previous input needs
  the factorized reduction, one that needs the 1x1 fit, a reduction
  cell, and a narrow ``NASNetA(num_cells=1, base_filters=8,
  stem_filters=8)`` at 64 px (its last maps 2 x 2: 8 values a channel
  for the last BatchNorms; logits in eval mode, dropout).
- **registry**: all 44 names of the JAX registry and its aliases
  resolve, the 28 image members build on the ``meta`` device (the
  speech and id members: ``test_torch_deepspeech.py``,
  ``test_torch_ncf.py``); the new modules import no JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_hc_bench.models import _ALIASES as JAX_ALIASES
from tpu_hc_bench.models import densenet as jax_densenet
from tpu_hc_bench.models import inception as jax_inception
from tpu_hc_bench.models import list_models as jax_list_models
from tpu_hc_bench_torch.models import (densenet, get_model_spec, inception,
                                       list_models)

from torch_zoo_common import (NET_TOL, check_forward, check_stats,
                              check_tree, close, flax_variables, images,
                              jax_apply, load, nchw, nhwc)
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
MEMBERS = ("densenet40_k12", "densenet100_k12", "inception3", "inception4")


@pytest.mark.parametrize("name", MEMBERS)
def test_full_width_tree_converts(name):
    check_tree(name)


def check_block(module, port, family: str, inputs, train: bool) -> None:
    """A block's output, and in training mode its statistics, against
    ``module.apply`` on the NHWC ``inputs`` (None passes through)."""
    variables = flax_variables(module, *inputs, seed=5, train=False)
    load(port, family, variables).train(train)
    y, stats = jax_apply(module, variables, *inputs, train=train)
    with torch.no_grad():
        got = port(*[None if a is None else nchw(a) for a in inputs])
    close(nhwc(got), y, NET_TOL, "block")
    if train:
        check_stats(port, family, variables, stats)


@pytest.mark.parametrize("train", [True, False])
def test_densenets_match_jax(train):
    check_forward(jax_densenet.densenet40_k12(num_classes=1000),
                  densenet.densenet40_k12(num_classes=1000), "densenet",
                  images((2, 32, 32, 3), 2), train)
    check_forward(jax_densenet.DenseNetCifar(depth=10),
                  densenet.DenseNetCifar(depth=10), "densenet",
                  images((4, 16, 16, 3), 3), train)


# (JAX block, port block, input NHWC shape); cin 16 on small maps
INCEPTION_BLOCKS = {
    "A": (lambda: jax_inception.InceptionA(32),
          lambda: inception.InceptionA(16, 32), (2, 9, 9, 16)),
    "B": (jax_inception.ReductionB, lambda: inception.ReductionB(16),
          (2, 9, 9, 16)),
    "C": (lambda: jax_inception.InceptionC(8),
          lambda: inception.InceptionC(16, 8), (2, 8, 8, 16)),
    "D": (jax_inception.ReductionD, lambda: inception.ReductionD(16),
          (2, 9, 9, 16)),
    "E": (jax_inception.InceptionE, lambda: inception.InceptionE(16),
          (2, 5, 5, 16)),
    "stem4": (jax_inception.StemV4, inception.StemV4, (2, 35, 35, 3)),
    "A4": (jax_inception.InceptionA4, lambda: inception.InceptionA4(16),
           (2, 7, 7, 16)),
    "redA4": (jax_inception.ReductionA4,
              lambda: inception.ReductionA4(16), (2, 9, 9, 16)),
    "B4": (jax_inception.InceptionB4, lambda: inception.InceptionB4(16),
           (2, 7, 7, 16)),
    "redB4": (jax_inception.ReductionB4,
              lambda: inception.ReductionB4(16), (2, 9, 9, 16)),
    "C4": (jax_inception.InceptionC4, lambda: inception.InceptionC4(16),
           (2, 5, 5, 16)),
}


@pytest.mark.parametrize("block", INCEPTION_BLOCKS)
@pytest.mark.parametrize("train", [True, False])
def test_inception_blocks_match_jax(block, train):
    jax_block, port_block, shape = INCEPTION_BLOCKS[block]
    port = port_block()
    check_block(jax_block(), port, "inception", [images(shape, 4)], train)
    with torch.no_grad():
        assert port(nchw(images(shape, 4))).shape[1] == port.out_channels


@pytest.mark.slow(reason="whole-model inception3 (JAX's tests/test_models.py "
                  "marks it slow); its blocks and full tree are held above "
                  "in tier 1")
def test_inception3_forward_matches_jax():
    check_forward(jax_inception.inception_v3(), inception.inception_v3(),
                  "inception", images((2, 75, 75, 3), 6), train=False)


def test_registry_names_aliases_and_later_slices():
    jax_names = jax_list_models()
    assert len(jax_names) == 44
    assert set(list_models()) == set(jax_names)      # every member
    with pytest.raises(ValueError, match="unknown model"):
        get_model_spec("resnet51")
    for alias, name in JAX_ALIASES.items():
        assert get_model_spec(alias).name == name
        assert get_model_spec(alias.upper()).name == name
    image = [n for n in list_models() if not (
        get_model_spec(n).is_text or get_model_spec(n).ctc
        or get_model_spec(n).integer_input)]
    assert len(image) == 31                  # 28 new, resnet50/101/152
    for name in image:
        spec = get_model_spec(name)
        with torch.device("meta"):
            model = spec.create(num_classes=spec.num_classes)
        assert spec.num_classes == 1000
        assert hasattr(model, "dropout_generator") == name.startswith((
            "vit", "alexnet", "vgg", "googlenet", "overfeat", "inception",
            "nasnet")), name


def test_zoo_modules_import_no_jax():
    mods = ", ".join(f"tpu_hc_bench_torch.models.{m}" for m in (
        "vit", "cifar_resnet", "vgg", "alexnet", "small_cnns", "googlenet",
        "mobilenet", "densenet", "inception", "nasnet", "resnet"))
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import sys, {mods}, tpu_hc_bench_torch.convert; "
         "assert 'jax' not in sys.modules; "
         "assert 'tpu_hc_bench' not in sys.modules"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode == 0, proc.stderr
