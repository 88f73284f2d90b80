"""The port's classic CNNs (trivial, lenet, overfeat, alexnet, the vggs,
googlenet, mobilenet) against the JAX package, on the CPU.

- **trees**: each member at full width: every leaf of the Flax tree
  converts to the port's ``state_dict``, names, shapes and parameter
  counts equal, no weights made.
- **forward**, float32, logits within 1e-4 of their largest magnitude:
  at full width ``trivial`` (16 px), ``lenet`` (28 px, training mode),
  ``alexnet`` at 96 px and ``overfeat`` at 71 px (their last maps 2 x 2,
  so the flatten into the first Dense is held in Flax's NHWC order),
  ``mobilenet`` at 32 px (training mode, with every BatchNorm's
  statistics, at batch 8, and eval mode) and googlenet's
  ``InceptionModule``; the
  vggs through a narrow ``VGG(stage_sizes=(1, 1, 1, 1, 1))`` at 64 px
  (a 2 x 2 map into ``fc6``).  Members with dropout run in eval mode.
- **two steps**: lenet (no dropout, every conv and Dense with a bias):
  two momentum-SGD steps against the JAX step.
"""

from __future__ import annotations

import pytest

from tpu_hc_bench.models import TrivialModel as JaxTrivial
from tpu_hc_bench.models import alexnet as jax_alexnet
from tpu_hc_bench.models import googlenet as jax_googlenet
from tpu_hc_bench.models import mobilenet as jax_mobilenet
from tpu_hc_bench.models import small_cnns as jax_small
from tpu_hc_bench.models import vgg as jax_vgg
from tpu_hc_bench_torch.data.synthetic import SyntheticImages
from tpu_hc_bench_torch.models import (TrivialModel, alexnet, googlenet,
                                       mobilenet, small_cnns, vgg)

from torch_zoo_common import (NET_TOL, check_forward, check_tree, close,
                              flax_variables, images, load, nchw, nhwc,
                              two_steps)

MEMBERS = ("trivial", "lenet", "overfeat", "alexnet", "vgg11", "vgg16",
           "vgg19", "googlenet", "mobilenet")


@pytest.mark.parametrize("name", MEMBERS)
def test_full_width_tree_converts(name):
    check_tree(name)


# mobilenet in training mode: 27 BatchNorms in a chain, the last stage's
# over 8 values a channel (batch 8 at 1 x 1), magnify the sums' rounding
# to 9.2e-5 of the largest logit (measured); 64 px at batch 2 gives
# 6.3e-5 at three times the cost
MOBILENET_TRAIN_TOL = 5e-4
# (member, JAX model, port model, image size, batch, training mode)
FORWARD = {
    "trivial": (JaxTrivial, lambda: TrivialModel(image_size=16), 16, 2,
                False),
    "lenet": (jax_small.lenet, small_cnns.lenet, 28, 2, True),
    "overfeat": (jax_small.overfeat, lambda: small_cnns.OverFeat(
        image_size=71), 71, 2, False),
    "alexnet": (jax_alexnet.alexnet, lambda: alexnet.AlexNet(
        image_size=96), 96, 2, False),
    "vgg": (lambda: jax_vgg.VGG(stage_sizes=(1, 1, 1, 1, 1)),
            lambda: vgg.VGG((1, 1, 1, 1, 1), image_size=64), 64, 2, False),
    "mobilenet_train": (jax_mobilenet.mobilenet, mobilenet.mobilenet, 32, 8,
                        True),
    "mobilenet": (jax_mobilenet.mobilenet, mobilenet.mobilenet, 32, 2,
                  False),
}


@pytest.mark.parametrize("case", FORWARD)
def test_forward_matches_jax(case):
    jax_model, port, size, batch, train = FORWARD[case]
    tol = MOBILENET_TRAIN_TOL if case == "mobilenet_train" else NET_TOL
    check_forward(jax_model(), port(), case.split("_")[0],
                  images((batch, size, size, 3), 11), train, tol=tol)


def test_inception_module_matches_jax():
    mod = jax_googlenet.InceptionModule(64, 96, 128, 16, 32, 32)
    x = images((2, 7, 7, 24), 12)
    variables = flax_variables(mod, x, seed=3)
    port = load(googlenet.InceptionModule(24, 64, 96, 128, 16, 32, 32),
                "googlenet", variables)
    close(nhwc(port(nchw(x))), mod.apply(variables, x), NET_TOL, "module")


def test_lenet_two_train_steps_match_jax():
    batch = SyntheticImages(4, (28, 28, 3), 1000, seed=3).batch()
    two_steps(jax_small.lenet(), small_cnns.lenet(), "lenet", batch)
