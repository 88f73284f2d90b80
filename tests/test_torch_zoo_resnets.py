"""The port's resnet18/34, v2 and CIFAR resnets against the JAX
package, on the CPU.

- **trees**: every new ResNet member at full width (resnet18/34, the
  three v2 members, the five CIFAR members): every leaf of the Flax tree
  converts to the port's ``state_dict``, names, shapes and parameter
  counts equal, no weights made.
- **blocks**: ``BasicBlock`` and ``PreactBottleneckBlock`` at strides 1
  and 2 (the projection shortcut on the preactivated input), training
  and eval mode: outputs and the BatchNorm statistics.
- **forward**: resnet18 and resnet50_v2 at full width on 64 px images
  (batch 2: the last stage's BatchNorms see 8 values a channel; over 2,
  at 32 px, rounding is magnified past any tolerance on both sides),
  ``--use_space_to_depth`` off and on, training mode (logits and every
  BatchNorm's updated statistics) and eval mode; resnet20_cifar the
  same at 32 px.
- **two steps**: resnet20_cifar, two momentum-SGD steps against the JAX
  step: losses, every parameter and BatchNorm statistic.
- **guards**: ``--fused_conv`` stays the v1 bottlenecks'.

Tolerances (float32): ``torch_zoo_common``'s, 1e-4 of the largest
magnitude (BatchNorm outputs of unit scale, sums in another order).
"""

from __future__ import annotations

import functools

import flax.linen as fnn
import pytest
import torch

from tpu_hc_bench.models import cifar_resnet as jax_cifar
from tpu_hc_bench.models import resnet as jax_resnet
from tpu_hc_bench_torch.data.synthetic import SyntheticImages
from tpu_hc_bench_torch.models import (cifar_resnet, create_model,
                                       get_model_spec, resnet)

from tpu_hc_bench_torch import convert

from torch_zoo_common import (NET_TOL, STATS_TOL, check_forward, check_tree,
                              close, flax_variables, images, jax_apply, nchw,
                              nhwc, two_steps)

NEW_RESNETS = ("resnet18", "resnet34", "resnet50_v2", "resnet101_v2",
               "resnet152_v2", "resnet20_cifar", "resnet32_cifar",
               "resnet44_cifar", "resnet56_cifar", "resnet110_cifar")


@pytest.mark.parametrize("name", NEW_RESNETS)
def test_full_width_tree_converts(name):
    check_tree(name)


@pytest.mark.parametrize("kind", ["basic", "preact"])
@pytest.mark.parametrize("strides", [1, 2])
@pytest.mark.parametrize("train", [True, False])
def test_blocks_match_jax(kind, strides, train):
    filters = 8
    cin = filters if kind == "basic" else 4 * filters  # identity at 1
    conv = functools.partial(fnn.Conv, use_bias=False, padding="SAME")
    norm = functools.partial(fnn.BatchNorm, use_running_average=not train,
                             momentum=0.9, epsilon=1e-5)
    jax_cls, port_cls = {
        "basic": (jax_resnet.BasicBlock, resnet.BasicBlock),
        "preact": (jax_resnet.PreactBottleneckBlock,
                   resnet.PreactBottleneckBlock)}[kind]
    mod = jax_cls(filters=filters, strides=strides, conv=conv, norm=norm,
                  act=fnn.relu)
    x = images((2, 9, 9, cin), 3)
    variables = flax_variables(mod, x, seed=5)
    y, stats = jax_apply(mod, variables, x, train=None)
    port = port_cls(cin, filters, strides).train(train)
    port.load_state_dict(convert.resnet_block_from_flax(
        variables["params"], variables["batch_stats"]), strict=True)
    assert (port.shortcut_conv is None) == (strides == 1)
    with torch.no_grad():
        got = port(nchw(x))
    close(nhwc(got), y, NET_TOL, "block")
    if train:
        want = convert.resnet_block_from_flax(variables["params"], stats)
        for name, buf in port.named_buffers():
            close(buf, want[name], STATS_TOL, name)


# resnet50_v2 in training mode: the residual stream is never normalized,
# and each block's batch statistics (E[x^2] - E[x]^2 on both sides)
# magnify the sums' rounding; the difference grows smoothly from 4e-6 of
# the largest output after the first block to 2e-4 after the sixteenth
# (the port's own two memory layouts differ by 6.7e-5 absolute, JAX's
# eager and jit forwards by 5.9e-5, at logits of 1.84)
V2_TRAIN_TOL = 1e-3


@pytest.mark.parametrize("name", ["resnet18", "resnet50_v2"])
@pytest.mark.parametrize("s2d", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_resnet_forward_matches_jax(name, s2d, train):
    tol = V2_TRAIN_TOL if train and name.endswith("v2") else NET_TOL
    check_forward(getattr(jax_resnet, name)(space_to_depth=s2d),
                  getattr(resnet, name)(space_to_depth=s2d), "resnet",
                  images((2, 64, 64, 3), 7), train, tol=tol)


@pytest.mark.parametrize("train", [True, False])
def test_resnet20_cifar_forward_matches_jax(train):
    check_forward(jax_cifar.resnet20_cifar(num_classes=1000),
                  cifar_resnet.resnet20_cifar(num_classes=1000), "resnet",
                  images((2, 32, 32, 3), 8), train)


def test_resnet20_cifar_two_train_steps_match_jax():
    batch = SyntheticImages(4, (32, 32, 3), 1000, seed=3).batch()
    two_steps(jax_cifar.resnet20_cifar(num_classes=1000),
              cifar_resnet.resnet20_cifar(num_classes=1000), "resnet",
              batch)


def test_fused_conv_stays_with_the_v1_bottlenecks():
    for name in ("resnet18", "resnet50_v2", "resnet20_cifar"):
        with pytest.raises(ValueError, match="v1 bottleneck"):
            create_model(name, device="cpu", fused_conv=True)
    with pytest.raises(ValueError, match="v1 bottleneck"):
        resnet.ResNet([1], resnet.BasicBlock, fused_conv=True)
    with pytest.raises(ValueError, match="s2d"):
        create_model("resnet20_cifar", device="cpu", space_to_depth=True)
    spec = get_model_spec("resnet18")
    assert spec.supports_s2d and not spec.fused_conv
    with torch.device("meta"):
        assert hasattr(spec.create(space_to_depth=True), "conv_init_s2d")
        v2 = resnet.resnet50_v2()
    assert not hasattr(v2, "bn_init") and hasattr(v2, "bn_final")
    # the v2 blocks' BatchNorms all start at scale 1 (no zero-init)
    narrow = resnet.ResNet([1, 1], resnet.PreactBottleneckBlock,
                           num_filters=8)
    narrow.init_weights(torch.Generator().manual_seed(0))
    assert all(bn.weight.detach().eq(1).all() for bn in narrow.modules()
               if isinstance(bn, resnet.BatchNorm))
    assert get_model_spec("resnet56").name == "resnet56_cifar"
    assert get_model_spec("resnet56").num_classes == 1000
