"""The port's training lane against the JAX package, on the CPU.

- **modules**: ``FusedBNReluConv3x3`` and ``FusedBottleneckBlock`` at an
  eligible shape (the kernel's path: Pallas in interpret mode on the JAX
  side, the plain version in the port), train and eval, with running
  stats and gradients; the SAME paddings of the stem, the strided 3x3
  and the max-pool at even and odd sizes.
- **weights**: ``convert.resnet_variables_from_flax`` on both Flax
  layouts, whose forward then matches ``ResNet.apply``.
- **the slice**: a narrow ``ResNet([1,1,1,1], num_filters=8)`` at 32x32,
  float32, two momentum-SGD steps against ``_loss_and_updates`` +
  ``make_optimizer``: losses, logits, params and ``batch_stats``.
- **host code**: synthetic data, the optimizer, flags, the launcher and
  driver on the CPU, the CUDA default, the no-JAX import rule.

Tolerances (float32): 1e-5 absolute on module outputs of unit scale,
1e-4 relative on losses, 1e-4 on whole-network logits, on gradients and
on parameters after two steps (sums in another order through ~20 layers
and a backward; the narrow net's last stage normalizes over 4 values at
1x1, which magnifies rounding).
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_hc_bench import flags as jax_flags
from tpu_hc_bench.data.synthetic import SyntheticImages as JaxSyntheticImages
from tpu_hc_bench.models import resnet as jax_resnet
from tpu_hc_bench.train import step as jax_step
from tpu_hc_bench_torch import convert, flags, launcher
from tpu_hc_bench_torch.data.synthetic import SyntheticImages, to_device
from tpu_hc_bench_torch.models import create_model, get_model_spec, resnet
from tpu_hc_bench_torch.train import driver, step as step_mod
from tpu_hc_bench_torch.utils import hw
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-4
NET_TOL = 1e-4
LOSS_RTOL = 1e-4
NARROW = dict(num_classes=10, num_filters=8)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(variables, seed):
    """Seeded noise on every leaf, so the last BN's zero scale, the unit
    running variance and the zero biases carry information through the
    comparison (running variances stay positive)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        noise = rng.standard_normal(x.shape).astype(np.float32)
        name = path[-1].key
        if name == "var":
            return x + 0.1 * np.abs(noise)
        if name == "kernel":
            return x * (1 + 0.1 * noise)
        return x + 0.1 * noise

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _jax_blocks(filters, strides, train):
    conv = functools.partial(fnn.Conv, use_bias=False, padding="SAME")
    norm = functools.partial(fnn.BatchNorm, use_running_average=not train,
                             momentum=0.9, epsilon=1e-5)
    kw = dict(filters=filters, strides=strides, conv=conv, norm=norm,
              act=fnn.relu)
    return (jax_resnet.FusedBottleneckBlock(use_running_average=not train,
                                            **kw),
            jax_resnet.BottleneckBlock(**kw))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    scale = max(float(np.abs(want).max()), 1.0)
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"


# --- the fused segment and block at an eligible shape --------------------


@pytest.mark.parametrize("train", [True, False])
def test_fused_segment_matches_jax_at_eligible_shape(train):
    """[2,14,14,128] -> 128: the kernel's route (Pallas interpret vs the
    port's plain version), y and the epilogue stats, running stats."""
    x = np.random.default_rng(0).standard_normal(
        (2, 14, 14, 128)).astype(np.float32)
    mod = jax_resnet.FusedBNReluConv3x3(128, use_running_average=not train)
    variables = _perturb(_np_tree(mod.init(jax.random.PRNGKey(1), x)), 2)
    (y, (s1, s2)), upd = mod.apply(variables, x, mutable=["batch_stats"])

    p, st = variables["params"], variables["batch_stats"]
    conv = resnet.FusedBNReluConv3x3(128, 128, 3).train(train)
    bn = resnet.BatchNorm(128).train(train)
    conv.load_state_dict(
        {"weight": torch.from_numpy(p["kernel"].transpose(3, 2, 0, 1))})
    bn.load_state_dict({
        "weight": torch.from_numpy(p["scale"]),
        "bias": torch.from_numpy(p["bias"]),
        "running_mean": torch.from_numpy(st["mean"]),
        "running_var": torch.from_numpy(st["var"])})
    assert resnet.fc.eligible(x.shape, (3, 3), 1, 128)
    ty, (ts1, ts2) = conv(_nchw(x), bn)
    _close(_nhwc(ty), y, ATOL, "y")
    _close(ts1.detach(), s1, ATOL, "s1")
    _close(ts2.detach(), s2, ATOL, "s2")
    new = upd["batch_stats"]
    _close(bn.running_mean, new["mean"], ATOL, "running mean")
    _close(bn.running_var, new["var"], ATOL, "running var")


@pytest.mark.parametrize("train", [True, False])
def test_fused_block_matches_jax_at_eligible_shape(train):
    """FusedBottleneckBlock(128 filters) on [2,14,14,256] (the kernel's
    route, with a projection shortcut): output, running stats of all four
    BNs, and in training the gradients of every parameter."""
    x = np.random.default_rng(3).standard_normal(
        (2, 14, 14, 256)).astype(np.float32)
    g = np.random.default_rng(4).standard_normal(
        (2, 14, 14, 512)).astype(np.float32)
    fused, _ = _jax_blocks(128, 1, train)
    variables = _perturb(_np_tree(fused.init(jax.random.PRNGKey(5), x)), 6)

    def loss(params):
        y, upd = fused.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             x, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd["batch_stats"])

    (_, (y, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])

    port = resnet.FusedBottleneckBlock(256, 128, 1).train(train)
    port.load_state_dict(convert.resnet_block_from_flax(
        variables["params"], variables["batch_stats"]))
    ty = port(_nchw(x))
    _close(_nhwc(ty), y, ATOL, "block output")
    want = convert.resnet_block_from_flax(_np_tree(grads), new_stats)
    for name, buf in port.named_buffers():
        _close(buf, want[name], ATOL, name)
    if train:
        (ty * _nchw(g)).sum().backward()
        for name, prm in port.named_parameters():
            _close(prm.grad, want[name], GRAD_TOL, f"grad {name}")


@pytest.mark.parametrize("strides", [1, 2])
def test_bottleneck_blocks_match_jax(strides):
    """Unfused and fused (off the kernel's window) blocks at 8x8x16."""
    x = np.random.default_rng(7).standard_normal(
        (2, 8, 8, 16)).astype(np.float32)
    for jax_block, cls in zip(_jax_blocks(4, strides, True),
                              (resnet.FusedBottleneckBlock,
                               resnet.BottleneckBlock)):
        variables = _perturb(
            _np_tree(jax_block.init(jax.random.PRNGKey(8), x)), 9)
        y, upd = jax_block.apply(variables, x, mutable=["batch_stats"])
        port = cls(16, 4, strides).train()
        port.load_state_dict(convert.resnet_block_from_flax(
            variables["params"], variables["batch_stats"]))
        _close(_nhwc(port(_nchw(x))), y, ATOL, cls.__name__)
        want = convert.resnet_block_from_flax(variables["params"],
                                              upd["batch_stats"])
        for name, buf in port.named_buffers():
            _close(buf, want[name], ATOL, f"{cls.__name__} {name}")


# --- SAME padding ---------------------------------------------------------


@pytest.mark.parametrize("size", [16, 15])
@pytest.mark.parametrize("k,s", [(7, 2), (3, 2), (1, 2), (3, 1)])
def test_conv_same_padding_matches_flax(size, k, s):
    """The stem (7x7/s2: (2,3) at even sizes), the v1.5 strided 3x3
    ((0,1)), the strided shortcut and the stride-1 3x3."""
    x = np.random.default_rng(size + k).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    mod = fnn.Conv(5, (k, k), strides=(s, s), use_bias=False,
                   padding="SAME")
    variables = _np_tree(mod.init(jax.random.PRNGKey(k), x))
    y = mod.apply(variables, x)
    conv = resnet.Conv(3, 5, k, s)
    conv.load_state_dict({"weight": torch.from_numpy(np.array(
        variables["params"]["kernel"].transpose(3, 2, 0, 1)))})
    ty = conv(_nchw(x))
    assert _nhwc(ty).shape == y.shape
    _close(_nhwc(ty), y, ATOL, f"conv {k}x{k}/s{s} at {size}")


@pytest.mark.parametrize("size", [16, 15, 112])
def test_max_pool_same_padding_matches_flax(size):
    x = np.random.default_rng(size).standard_normal(
        (2, size, size, 4)).astype(np.float32) - 3.0   # all negative-ish
    y = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME")
    ty = resnet.max_pool(_nchw(x))
    assert _nhwc(ty).shape == y.shape
    np.testing.assert_array_equal(_nhwc(ty), np.asarray(y))


def test_same_pads_are_xla_s():
    assert resnet.same_pads(224, 7, 2) == (2, 3)
    assert resnet.same_pads(56, 3, 2) == (0, 1)
    assert resnet.same_pads(112, 3, 2) == (0, 1)
    assert resnet.same_pads(28, 1, 2) == (0, 0)
    assert resnet.same_pads(14, 3, 1) == (1, 1)
    assert resnet.same_pads(15, 3, 2) == (1, 1)


# --- the converter on both layouts ---------------------------------------


@functools.lru_cache(maxsize=None)
def _narrow(fused: bool, s2d: bool = False):
    """A narrow Flax ResNet, its perturbed variables, and the port's twin
    carrying the converted weights."""
    model = jax_resnet.ResNet([1, 1, 1, 1], jax_resnet.BottleneckBlock,
                              fused_conv=fused, space_to_depth=s2d, **NARROW)
    variables = _perturb(_np_tree(model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)),
        10 + fused)
    return model, variables


def _port_twin(variables, fused, s2d=False):
    port = resnet.ResNet([1, 1, 1, 1], resnet.BottleneckBlock,
                         fused_conv=fused, space_to_depth=s2d, **NARROW)
    port.load_state_dict(convert.resnet_variables_from_flax(
        variables["params"], variables["batch_stats"]))   # strict
    return port


@pytest.mark.parametrize("fused", [False, True])
def test_converter_maps_both_flax_layouts(fused):
    _, variables = _narrow(fused)
    sd = convert.resnet_variables_from_flax(variables["params"],
                                            variables["batch_stats"])
    port = resnet.ResNet([1, 1, 1, 1], resnet.BottleneckBlock,
                         fused_conv=fused, **NARROW)
    assert set(sd) == set(port.state_dict())
    p = variables["params"]
    blk = p["FusedBottleneckBlock_1" if fused else "BottleneckBlock_1"]
    third_conv = blk["Conv_1" if fused else "Conv_2"]["kernel"]
    third_bn = blk["BatchNorm_0" if fused else "BatchNorm_2"]["scale"]
    np.testing.assert_array_equal(sd["blocks.1.conv3.weight"].numpy(),
                                  third_conv.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["blocks.1.bn3.weight"].numpy(),
                                  third_bn)
    bn1 = blk["FusedBNReluConv3x3_0" if fused else "BatchNorm_0"]["scale"]
    np.testing.assert_array_equal(sd["blocks.1.bn1.weight"].numpy(), bn1)
    np.testing.assert_array_equal(sd["head.weight"].numpy(),
                                  p["head"]["kernel"].T)


@pytest.mark.parametrize("fused,s2d,train", [
    (False, False, True), (False, False, False), (True, False, True),
    (True, False, False), (False, True, True)])
def test_resnet_forward_matches_jax(fused, s2d, train):
    model, variables = _narrow(fused, s2d)
    x = np.random.default_rng(11).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    logits, upd = model.apply(variables, x, train=train,
                              mutable=["batch_stats"])
    port = _port_twin(variables, fused, s2d).train(train)
    _close(port(_nchw(x)).detach(), logits, NET_TOL, "logits")
    if train:
        want = convert.resnet_variables_from_flax(variables["params"],
                                                  upd["batch_stats"])
        for name, buf in port.named_buffers():
            _close(buf, want[name], ATOL, name)


# --- the slice: two momentum-SGD steps ------------------------------------


@pytest.mark.parametrize("fused", [False, True])
def test_two_train_steps_match_jax(fused):
    model, variables = _narrow(fused)
    images, labels = SyntheticImages(4, (32, 32, 3), 10, seed=3).batch()
    jcfg = jax_flags.BenchmarkConfig(optimizer="momentum",
                                     init_learning_rate=0.05, momentum=0.9)
    tx = jax_step.make_optimizer(jcfg)
    state = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), apply_fn=model.apply, tx=tx)

    @jax.jit
    def jax_step_fn(state):
        def loss_fn(p):
            return jax_step._loss_and_updates(
                state, p, (images, labels), jax.random.PRNGKey(0), False)
        (loss, stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        updates, opt = state.tx.update(grads, state.opt_state, state.params)
        return state.replace(params=optax.apply_updates(state.params,
                                                        updates),
                             batch_stats=stats, opt_state=opt), loss

    cfg = flags.BenchmarkConfig(optimizer="momentum", init_learning_rate=0.05,
                                momentum=0.9, device="cpu").resolve()
    port_state = step_mod.make_train_state(_port_twin(variables, fused), cfg)
    batch = to_device((images, labels), torch.device("cpu"))
    for i in range(2):
        state, loss = jax_step_fn(state)
        port_state, metrics = step_mod.train_step(port_state, batch)
        got = float(metrics["loss"])
        assert abs(got - float(loss)) <= LOSS_RTOL * abs(float(loss)), i
    assert port_state.step == 2
    want = convert.resnet_variables_from_flax(_np_tree(state.params),
                                              _np_tree(state.batch_stats))
    for name, t in port_state.model.state_dict().items():
        _close(t, want[name], PARAM_TOL, name)
    # logits after the steps, in eval mode (the running statistics)
    logits = model.apply({"params": state.params,
                          "batch_stats": state.batch_stats}, images,
                         train=False)
    out = port_state.model.eval()(batch[0]).detach()
    _close(out, logits, NET_TOL, "eval logits")


def test_momentum_sgd_is_optax_sgd():
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal(6).astype(np.float32)
    grads = [rng.standard_normal(6).astype(np.float32) for _ in range(3)]
    for opt_name in ("momentum", "sgd"):
        jcfg = jax_flags.BenchmarkConfig(optimizer=opt_name,
                                         init_learning_rate=0.1)
        tx = jax_step.make_optimizer(jcfg)
        w, s = jnp.asarray(w0), tx.init(jnp.asarray(w0))
        p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        opt = step_mod.make_optimizer(flags.BenchmarkConfig(
            optimizer=opt_name, init_learning_rate=0.1), [p])
        for g in grads:
            u, s = tx.update(jnp.asarray(g), s, w)
            w = optax.apply_updates(w, u)
            p.grad = torch.from_numpy(g)
            opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-7)


# --- host code -------------------------------------------------------------


def test_synthetic_images_equal_the_jax_lane_and_land_channels_last():
    mine = SyntheticImages(3, (8, 8, 3), 10, seed=5).batch()
    ref = JaxSyntheticImages(3, (8, 8, 3), 10, seed=5).batch()
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)
    x, y = to_device(mine, torch.device("cpu"))
    assert x.shape == (3, 3, 8, 8)
    assert x.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(x.permute(0, 2, 3, 1).numpy(), mine[0])
    assert y.dtype == torch.int64


def test_registry_and_model_specs():
    spec = get_model_spec("resnet50")
    assert spec.input_shape == (224, 224, 3) and spec.num_classes == 1000
    assert spec.flops_per_example == 8.2e9 and spec.fused_conv
    assert get_model_spec("resnet101").flops_per_example == 15.7e9
    assert get_model_spec("resnet152").flops_per_example == 23.1e9
    model, _ = create_model("resnet50", torch.bfloat16, device="cpu",
                            fused_conv=True, train=True)
    assert model.training and model.dtype == torch.bfloat16
    assert isinstance(model.blocks[4], resnet.FusedBottleneckBlock)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == 25557032
    assert not model.blocks[0].bn3.weight.detach().any()
    with pytest.raises(ValueError, match="float32"):
        create_model("llama_tiny", torch.float16, device="cpu")
    with pytest.raises(ValueError, match="resnets"):
        create_model("llama_tiny", device="cpu", train=True, fused_conv=True)


def test_peak_flops_table():
    assert hw.peak_flops("bfloat16", "cpu") is None
    with pytest.raises(ValueError):
        hw.peak_flops("float16", "cpu")


def test_peak_flops_for_named_cards(monkeypatch):
    for name, want in (("NVIDIA H100 80GB HBM3", (989e12, 67e12)),
                       ("NVIDIA H100 PCIe", (None, None)),
                       ("NVIDIA A100-SXM4-80GB", (None, None))):
        monkeypatch.setattr(hw, "device_name", lambda _d, n=name: n)
        assert (hw.peak_flops("bfloat16", "cuda"),
                hw.peak_flops("float32", "cuda")) == want, name


def test_benchmark_flags_defaults_and_rejections():
    d, j = flags.BenchmarkConfig(), jax_flags.BenchmarkConfig()
    for name in ("model", "batch_size", "num_warmup_batches",
                 "display_every", "optimizer", "init_learning_rate",
                 "momentum", "use_fp16", "fused_conv", "use_space_to_depth",
                 "seed", "num_classes", "variable_update",
                 "gradient_accumulation_steps", "overlap_grad_comm",
                 "fusion_threshold_bytes"):
        assert getattr(d, name) == getattr(j, name), name
    assert d.num_batches is j.num_batches is None     # unset until resolved
    assert d.resolve().num_batches == jax_flags.DEFAULT_NUM_BATCHES
    cfg = flags.parse_benchmark_flags(["--use_fp16=true", "--fused_conv",
                                       "TRUE", "--device=cpu"])
    assert cfg.use_fp16 and cfg.fused_conv and cfg.compute_dtype == \
        "bfloat16"
    assert flags.parse_benchmark_flags(
        ["--virtual_devices=8", "--device=cpu"]).virtual_devices == 8
    for bad, match in ((["--virtual_devices=8"], "CPU host's worker count"),
                       (["--virtual_devices=0", "--device=cpu"], ">= 1"),
                       (["--gradient_accumulation_steps=3"], "divisible"),
                       (["--variable_update=zero1", "--forward_only=true"],
                        "forward-only"),
                       (["--resume=elastic"], "needs --train_dir"),
                       (["--optimizer=lbfgs"], "momentum|sgd"),
                       (["--device=tpu"], "cuda|cpu")):
        with pytest.raises(ValueError, match=match):
            flags.parse_benchmark_flags(bad)
    with pytest.raises(SystemExit):
        flags.parse_benchmark_flags(["--max_in_flight=4"])


def test_launcher_positionals_and_world(monkeypatch, tmp_path):
    pos, rest = launcher.parse_positionals(["1", "1", "32", "sock",
                                            "--model=resnet50"])
    assert pos == ["1", "1", "32", "sock"] and rest == ["--model=resnet50"]
    with pytest.raises(SystemExit):
        launcher.parse_positionals(["1", "1", "32"])
    assert launcher.world_size(1, 1, "cpu") == 1
    assert launcher.world_size(1, 0, "cpu") == 1
    assert launcher.world_size(2, 4, "cuda") == 8
    # --virtual_devices=N: a CPU host of N cards, JAX's layout
    assert launcher.world_size(1, 0, "cpu", 4) == 4
    assert launcher.world_size(2, 2, "cpu", 4) == 4
    with pytest.raises(ValueError, match="exceeds --virtual_devices=4"):
        launcher.world_size(1, 5, "cpu", 4)
    # a world of two hosts needs a hostfile that lists both
    (tmp_path / "nodeips.txt").write_text("10.0.0.1\n")
    monkeypatch.setenv("TPU_HC_BENCH_HOSTFILE", str(tmp_path / "nodeips.txt"))
    with pytest.raises(ValueError, match="hostfile lists 1"):
        launcher.main(["2", "1", "4", "ib", "--device=cpu"])
    with pytest.raises(ValueError, match="fabric"):
        launcher.main(["1", "1", "4", "tcp", "--device=cpu"])


def test_launcher_and_driver_on_the_cpu():
    lines: list[str] = []
    rc = launcher.main(["1", "1", "1", "sock", "--device=cpu",
                        "--num_warmup_batches=1", "--num_batches=2",
                        "--display_every=1", "--num_classes=10"],
                       print_fn=lines.append)
    assert rc == 0
    assert sum("\timages/sec: " in ln for ln in lines) == 2
    assert any(ln.startswith("total images/sec: ") for ln in lines)
    # the result line is strict JSON: no MFU on the CPU is null, not NaN
    result = json.loads(lines[-1], parse_constant=pytest.fail)
    assert result["mfu"] is None and result["global_batch"] == 1
    cfg = flags.parse_benchmark_flags(
        ["--device=cpu", "--batch_size=1", "--num_warmup_batches=0",
         "--num_batches=1", "--num_classes=10", "--fused_conv=true"])
    res = driver.run_benchmark(cfg, print_fn=lambda _m: None)
    assert res.total_images_per_sec > 0 and res.p50_step_ms > 0
    assert res.images_per_sec_per_chip == res.total_images_per_sec
    assert res.global_batch == 1 and res.total_workers == 1
    assert np.isfinite(res.final_loss) and np.isnan(res.mfu)
    assert res.device_kind == "cpu" and res.p50_step_granularity == 1


def test_train_entry_points_without_cpu_request_raise_when_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model("resnet50")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.run_benchmark(flags.BenchmarkConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main(["1", "1", "2", "sock"])


def test_train_lane_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, tpu_hc_bench_torch.__main__, "
         "tpu_hc_bench_torch.launcher, tpu_hc_bench_torch.train.driver, "
         "tpu_hc_bench_torch.train.step, tpu_hc_bench_torch.models.resnet, "
         "tpu_hc_bench_torch.ops.fused_conv, tpu_hc_bench_torch.utils.hw, "
         "tpu_hc_bench_torch.data.synthetic, tpu_hc_bench_torch.convert; "
         "assert 'jax' not in sys.modules; "
         "assert 'tpu_hc_bench' not in sys.modules"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode == 0, proc.stderr
