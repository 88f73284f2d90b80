"""The port's real-data steps and flags against the JAX package, on the
CPU.

- **prep_inputs**: uint8 crops to normalized float32, bit for bit JAX's.
- **train step on real crops**: the narrow ResNet of
  ``test_torch_train.py`` (``[1,1,1,1]``, 8 filters, 10 classes) at
  32x32, one momentum-SGD step on uint8 crops the port's pipeline
  decoded from the committed fixture, against ``_loss_and_updates`` +
  ``make_optimizer``: the loss within ``LOSS_RTOL`` relative, every
  parameter and statistic within ``PARAM_TOL`` of its scale (that
  file's tolerances).
- **forward-only**: the loss equals JAX's training-mode loss (same
  tolerance); parameters, BatchNorm buffers, optimizer state and the
  step count bit-unchanged, on both BatchNorm routes.
- **eval**: ``eval_step``'s loss (1e-5 relative: float32 sums in
  another order) and top-1 count (exact) against JAX ``build_eval_step``
  on a one-device mesh, weights carried by ``convert.py``: the image arm
  and bert_tiny's text arm; and the same through a one-rank group, both
  fabrics' reductions.
- **optimizers**: adam, adamw and rmsprop, three steps on the same
  gradients against optax, relative to the parameters' scale: adam and
  adamw within 1e-5 (optax computes the bias correction ``1 - 0.999^t``
  in float32, where 0.999 rounds and the subtraction cancels: 1.3e-5
  relative at t = 1, ~6e-6 on the denominator's root; torch in
  float64), rmsprop within 2.4e-7, two float32 ulps at unit scale (the
  same operations in the same order, but a kernel may fuse ``nu * decay
  + alpha * g^2`` into one multiply-add).
- **flags**: the reference's whole line, translated with JAX's keys;
  ``--num_epochs`` gives JAX's ``num_batches``; JAX's refusals.
- **end to end**: ``run_benchmark`` on the committed fixture and a token
  corpus, the narrow ResNet standing in for resnet50 (``train/driver.py``'s
  code otherwise as it runs); the launcher with the reference's line on
  resnet50 at 224 (``slow``: a whole model at 224 px on the CPU).
"""

from __future__ import annotations

import dataclasses
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from test_torch_mlm import TINY, _tiny, _tiny_twin
from test_torch_train import (LOSS_RTOL, NARROW, PARAM_TOL, _close, _narrow,
                              _np_tree, _port_twin)
from tpu_hc_bench import flags as jax_flags
from tpu_hc_bench.data import imagenet as jax_imagenet
from tpu_hc_bench.train import step as jax_step
from tpu_hc_bench_torch import convert, flags, launcher
from tpu_hc_bench_torch.data import imagenet
from tpu_hc_bench_torch.data.feed import DeviceFeeder
from tpu_hc_bench_torch.data.synthetic import tokens_to_device
from tpu_hc_bench_torch.data.tokens import TokenDataset, write_token_file
from tpu_hc_bench_torch.models import get_model_spec, resnet
from tpu_hc_bench_torch.parallel import distributed
from tpu_hc_bench_torch.parallel.fabric import Fabric
from tpu_hc_bench_torch.train import driver, step as step_mod

from test_torch_data import FIXTURE
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

CPU = torch.device("cpu")
EVAL_LOSS_RTOL = 1e-5
OPT_TOL = {"adam": 1e-5, "adamw": 1e-5, "rmsprop": 2.4e-7}
WIDE_HEAD = dict(NARROW, num_classes=1000)
REFERENCE_LINE = [
    "--data_name=imagenet", "--data_format=NCHW", "--optimizer=momentum",
    "--forward_only=False", "--mkl=TRUE", "--variable_update=horovod",
    "--horovod_device=cpu", "--local_parameter_device=cpu",
    "--num_intra_threads=8", "--num_inter_threads=2", "--kmp_blocktime=1",
    "--kmp_affinity=granularity=fine,compact,1,0"]


def _crops(n: int = 4, size: int = 32, train: bool = True):
    """``n`` uint8 crops and labels from the committed fixture, by the
    port's pipeline (labels folded into the narrow net's 10 classes)."""
    it = iter(imagenet.ImageNetDataset(
        FIXTURE, n, image_size=size, train=train, seed=0,
        wire_dtype="uint8", decode_workers=1,
        split="train" if train else "validation"))
    images, labels = next(it)
    it.close()
    return images, (labels % 10).astype(np.int32)


def _to_port(batch):
    return next(iter(DeviceFeeder(iter([batch]), CPU)))


def _cfg(**kw) -> flags.BenchmarkConfig:
    kw.setdefault("init_learning_rate", 0.05)
    return flags.BenchmarkConfig(device="cpu", **kw).resolve()


def _jax_state(model, variables, jcfg=None):
    tx = jax_step.make_optimizer(jcfg or jax_flags.BenchmarkConfig(
        init_learning_rate=0.05))
    return jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        opt_state=tx.init(variables["params"]), apply_fn=model.apply, tx=tx)


def _snapshot(state) -> dict:
    snap = {f"model.{k}": v.clone()
            for k, v in state.model.state_dict().items()}
    for i, st in enumerate(state.optimizer.state.values()):
        for k, v in st.items():
            if torch.is_tensor(v):
                snap[f"opt.{i}.{k}"] = v.clone()
    return snap


def _assert_bit_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# --- prep_inputs and the real-data train step --------------------------------


def test_prep_inputs_is_jax_s_bitwise():
    images, _ = _crops(4, 48)
    want = np.asarray(jax_step.prep_inputs(jnp.asarray(images)))
    x = step_mod.prep_inputs(_to_port((images, np.zeros(4, np.int32)))[0])
    assert x.dtype == torch.float32
    assert x.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(x.permute(0, 2, 3, 1).numpy(), want)
    f = torch.ones(2, 3, 4, 4)
    assert step_mod.prep_inputs(f) is f


@pytest.mark.parametrize("fused", [False, True])
def test_real_data_train_step_matches_jax(fused):
    model, variables = _narrow(fused)
    batch = _crops()
    state = _jax_state(model, variables)

    def loss_fn(p):
        return jax_step._loss_and_updates(state, p, batch,
                                          jax.random.PRNGKey(0), False)

    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        state.params)
    updates, _ = state.tx.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)

    port = step_mod.make_train_state(_port_twin(variables, fused), _cfg())
    port, metrics = step_mod.train_step(port, _to_port(batch))
    assert abs(float(metrics["loss"]) - float(loss)) <= \
        LOSS_RTOL * abs(float(loss))
    want = convert.resnet_variables_from_flax(_np_tree(params),
                                              _np_tree(stats))
    for name, t in port.model.state_dict().items():
        _close(t, want[name], PARAM_TOL, name)


@pytest.mark.parametrize("fused", [False, True])
def test_forward_only_leaves_the_state_bit_unchanged(fused):
    model, variables = _narrow(fused)
    batch = _crops()
    state = _jax_state(model, variables)
    loss, _ = jax_step._loss_and_updates(state, state.params, batch,
                                         jax.random.PRNGKey(0), False)
    port = step_mod.make_train_state(_port_twin(variables, fused),
                                     _cfg(forward_only=True))
    dev_batch = _to_port(batch)
    before = _snapshot(port)
    port, metrics = step_mod.forward_step(port, dev_batch)
    assert abs(float(metrics["loss"]) - float(loss)) <= \
        LOSS_RTOL * abs(float(loss))
    _assert_bit_equal(_snapshot(port), before)
    assert port.step == 0 and not port.optimizer.state
    # with optimizer state: a train step, then forward-only steps
    port, _ = step_mod.train_step(port, dev_batch)
    before = _snapshot(port)
    assert any(k.startswith("opt.") for k in before)
    for _ in range(2):
        port, metrics = step_mod.forward_step(port, dev_batch)
    _assert_bit_equal(_snapshot(port), before)
    assert port.step == 1 and math.isfinite(float(metrics["loss"]))
    assert not any(m.frozen for m in port.model.modules()
                   if isinstance(m, resnet.BatchNorm))


# --- eval --------------------------------------------------------------------


def _jax_eval(model, variables, batch, is_text):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    fn = jax_step.build_eval_step(mesh, jax_flags.BenchmarkConfig(),
                                  types.SimpleNamespace(is_text=is_text))
    loss, correct = fn(_jax_state(model, variables), batch)
    return float(loss), float(correct)


def _image_eval_batch(model, variables):
    """Eval crops whose first half is labelled with the JAX model's own
    top-1 class, so the count is not 0."""
    images, labels = _crops(8, 32, train=False)
    logits = model.apply(variables, jax_step.prep_inputs(images),
                         train=False)
    labels[:4] = np.asarray(jnp.argmax(logits, -1))[:4]
    return images, labels


def _text_eval_batch(tmp_path, model, params):
    write_token_file(tmp_path / "validation.bin", np.random.default_rng(
        0).integers(1, TINY["vocab_size"], 4000), TINY["vocab_size"])
    tokens, targets, weights = next(iter(TokenDataset(
        tmp_path, 4, 32, split="validation", causal_lm=False, seed=1)))
    logits = model.apply({"params": params}, tokens, train=False)
    targets[:, ::2] = np.asarray(jnp.argmax(logits, -1))[:, ::2]
    return tokens, targets, weights


def test_eval_step_matches_jax_image_arm():
    model, variables = _narrow(False)
    batch = _image_eval_batch(model, variables)
    want_loss, want_correct = _jax_eval(model, variables, batch, False)
    port = step_mod.make_train_state(_port_twin(variables, False),
                                     _cfg(eval=True))
    port.model.eval()
    loss, correct = step_mod.eval_step(port, _to_port(batch))
    assert abs(float(loss) - want_loss) <= EVAL_LOSS_RTOL * abs(want_loss)
    assert float(correct) == want_correct >= 4


def test_eval_step_matches_jax_text_arm(tmp_path):
    model, params = _tiny("float32", "dense")
    batch = _text_eval_batch(tmp_path, model, params)
    want_loss, want_correct = _jax_eval(model, {"params": params}, batch,
                                        True)
    port = step_mod.make_train_state(
        _tiny_twin(params, "float32", "dense"),
        _cfg(model="bert_tiny", eval=True))
    port.model.eval()
    loss, correct = step_mod.eval_step(port, tokens_to_device(batch, CPU))
    assert abs(float(loss) - want_loss) <= EVAL_LOSS_RTOL * abs(want_loss)
    assert float(correct) == want_correct > 0


@pytest.mark.parametrize("fabric", [Fabric.ICI, Fabric.HOST])
def test_eval_and_forward_only_in_a_one_rank_group(fabric):
    """The ranks' sums and means at world 1 change nothing: the fast
    arm's NCCL-style all-reduce and the host arm's gloo round trip."""
    model, variables = _narrow(False)
    batch = _to_port(_image_eval_batch(model, variables))
    alone = step_mod.make_train_state(_port_twin(variables, False),
                                      _cfg(eval=True))
    alone.model.eval()
    want = step_mod.eval_step(alone, batch)
    want_fwd = step_mod.forward_step(alone, batch)[1]["loss"]
    distributed.init_single("gloo")
    try:
        grouped = step_mod.make_train_state(
            _port_twin(variables, False), _cfg(eval=True), fabric)
        grouped.model.eval()
        got = step_mod.eval_step(grouped, batch)
        got_fwd = step_mod.forward_step(grouped, batch)[1]["loss"]
        if grouped.dp.grads:
            grouped.dp.grads.close()
    finally:
        dist.destroy_process_group()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got_fwd, want_fwd)


# --- optimizers --------------------------------------------------------------


@pytest.mark.parametrize("name", ["adam", "adamw", "rmsprop"])
def test_optimizers_are_optax_s(name):
    rng = np.random.default_rng(0)
    w0 = [rng.standard_normal(s).astype(np.float32) for s in ((6,), (3, 4))]
    grads = [[rng.standard_normal(w.shape).astype(np.float32) for w in w0]
             for _ in range(3)]
    tx = jax_step.make_optimizer(jax_flags.BenchmarkConfig(
        optimizer=name, init_learning_rate=0.1))
    w = [jnp.asarray(a) for a in w0]
    s = tx.init(w)
    ps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in w0]
    opt = step_mod.make_optimizer(flags.BenchmarkConfig(
        optimizer=name, init_learning_rate=0.1), ps)
    for g in grads:
        u, s = tx.update([jnp.asarray(a) for a in g], s, w)
        w = optax.apply_updates(w, u)
        for p, a in zip(ps, g):
            p.grad = torch.from_numpy(a)
        opt.step()
        for p, ref in zip(ps, w):
            _close(p.detach(), np.asarray(ref), OPT_TOL[name], name)


def test_rmsprop_is_not_torch_s():
    """eps 1.0 inside the root: ``torch.optim.RMSprop``'s ``sqrt(nu) +
    eps`` takes another step."""
    p = torch.nn.Parameter(torch.ones(3))
    q = torch.nn.Parameter(torch.ones(3))
    mine = step_mod.OptaxRMSprop([p], lr=0.1, decay=0.9, eps=1.0)
    torch_rms = torch.optim.RMSprop([q], lr=0.1, alpha=0.9, eps=1.0)
    for t, opt in ((p, mine), (q, torch_rms)):
        t.grad = torch.full((3,), 2.0)
        opt.step()
    assert not torch.allclose(p, q)
    # 1 - 0.1 * 2 / sqrt(0.1 * 4 + 1)
    torch.testing.assert_close(p.detach(), torch.full(
        (3,), 1 - 0.2 / math.sqrt(1.4)), rtol=0, atol=1e-7)


# --- flags -------------------------------------------------------------------


def test_reference_flag_line_parses_with_jax_s_translations():
    cfg = flags.parse_benchmark_flags(["--data_dir=/data"] + REFERENCE_LINE)
    ref = jax_flags.BenchmarkConfig(
        data_dir="/data", data_name="imagenet", data_format="NCHW",
        optimizer="momentum", mkl=True, variable_update="horovod",
        horovod_device="cpu", local_parameter_device="cpu",
        num_intra_threads=8, device="cpu").resolve()
    # --device=cpu: JAX's translation to its accelerator; the port's
    # line leaves the flag out (here it asks for the CPU)
    assert set(cfg.translations) == set(ref.translations) - {"device"}
    assert (cfg.data_format, cfg.variable_update, cfg.mkl) == \
        (ref.data_format, ref.variable_update, ref.mkl)
    assert cfg.horovod_device == cfg.local_parameter_device == "fabric"
    assert cfg.num_batches == ref.num_batches == 100
    lines = cfg.summary_lines()
    assert sum(ln.startswith("translated: ") for ln in lines) == \
        len(cfg.translations)
    d, j = flags.BenchmarkConfig(), jax_flags.BenchmarkConfig()
    for name in ("num_epochs", "forward_only", "eval", "data_dir",
                 "data_name", "wire_dtype", "prefetch_depth",
                 "datasets_num_private_threads",
                 "datasets_repeat_cached_sample", "full_batch_identity",
                 "input_service", "num_intra_threads", "num_inter_threads",
                 "kmp_blocktime", "kmp_affinity"):
        assert getattr(d, name) == getattr(j, name), name


def test_num_epochs_gives_jax_s_num_batches():
    spec = get_model_spec("resnet50")
    examples = jax_imagenet.count_examples(FIXTURE, "train")
    for epochs, global_batch in ((1.0, 16), (2.5, 12), (0.1, 128)):
        cfg = _cfg(num_epochs=epochs, data_dir=str(FIXTURE))
        assert cfg.num_batches is None
        lines = []
        driver._resolve_epochs(cfg, spec, "train", global_batch,
                               lines.append)
        assert cfg.num_batches == math.ceil(epochs * examples
                                            / global_batch)
        assert cfg.num_epochs == 0.0 and "num_batches=" in lines[0]
    for split, model in ((None, "resnet50"), ("train", "bert_tiny")):
        with pytest.raises(ValueError, match="--num_epochs needs"):
            driver._resolve_epochs(_cfg(num_epochs=1.0),
                                   get_model_spec(model), split, 8, print)


REFUSALS = [
    dict(num_epochs=1.0, num_batches=10),
    dict(num_epochs=-1.0),
    dict(gradient_accumulation_steps=2, forward_only=True),
    dict(gradient_accumulation_steps=2, eval=True),
    dict(prefetch_depth=0),
    dict(input_service="sometimes"),
]


@pytest.mark.parametrize("i", range(len(REFUSALS)))
def test_jax_s_refusals_are_raised(i):
    kw = REFUSALS[i]
    with pytest.raises(ValueError):
        jax_flags.BenchmarkConfig(**kw).resolve()
    with pytest.raises(ValueError):
        flags.BenchmarkConfig(device="cpu", **kw).resolve()


@pytest.mark.parametrize("argv,match", [
    (["--resume=elastic"], "needs --train_dir"),
    (["--wire_dtype=bf16"], "float32|uint8"),
    (["--data_format=NCWH"], "NCHW|NHWC"),
    (["--horovod_device=tpu"], "cpu|gpu"),
    (["--datasets_repeat_cached_sample=true", "--eval=true"], "epoch"),
    (["--config=x.json"], "not ported"),
    (["--optimizer=lbfgs"], "rmsprop"),
])
def test_port_refusals(argv, match):
    with pytest.raises(ValueError, match=match):
        flags.parse_benchmark_flags(argv)


# --- end to end --------------------------------------------------------------


@pytest.fixture
def narrow_resnet50(monkeypatch):
    """``run_benchmark``'s resnet50 replaced by the narrow ResNet at 32x32
    (with ImageNet's 1000 classes, as the fixture's labels); the models
    it built, in order."""
    built = []

    def create(name, dtype, attention_impl, *, device, seed, rank, **kw):
        model = resnet.ResNet([1, 1, 1, 1], resnet.BottleneckBlock,
                              fused_conv=kw["fused_conv"], **WIDE_HEAD)
        gen = torch.Generator().manual_seed(seed)
        model.init_weights(gen)
        model = model.to(device, memory_format=torch.channels_last)
        built.append(model)
        return model.train(), dataclasses.replace(
            get_model_spec(name), input_shape=(32, 32, 3))

    monkeypatch.setattr(driver, "create_model", create)
    return built


def _run(argv: list[str]):
    lines = []
    cfg = flags.parse_benchmark_flags(["--device=cpu",
                                       f"--data_dir={FIXTURE}"] + argv)
    res = driver.run_benchmark(cfg, print_fn=lines.append)
    return res, lines, cfg


def test_train_on_the_fixture_end_to_end(narrow_resnet50):
    res, lines, _ = _run(REFERENCE_LINE + [
        "--batch_size=4", "--num_warmup_batches=1", "--num_batches=3",
        "--display_every=1"])
    assert res.total_images_per_sec > 0 and math.isfinite(res.final_loss)
    d = res.data
    assert (d["split"], d["reader"], d["decoder"], d["pil_fallbacks"]) == \
        ("train", "native", "libjpeg", 0)
    assert d["wire_dtype"] == "uint8" and d["input_wait_ms_per_step"] >= 0
    assert d["examples"] >= 16 and not d["repeat_cached_sample"]
    assert any(ln.startswith("decode pool: ") and "reader=native" in ln
               and "decoder=libjpeg" in ln for ln in lines)
    assert sum(ln.startswith("translated: ") for ln in lines) == 6
    assert json.loads(json.dumps(res.json_line()))["data"]["decoder"] == \
        "libjpeg"


def test_forward_only_and_cached_sample_end_to_end(narrow_resnet50):
    res, lines, _ = _run([
        "--batch_size=4", "--num_warmup_batches=1", "--num_batches=10",
        "--display_every=5", "--forward_only=true",
        "--datasets_repeat_cached_sample=true"])
    model = narrow_resnet50[0]
    fresh = resnet.ResNet([1, 1, 1, 1], resnet.BottleneckBlock, **WIDE_HEAD)
    fresh.init_weights(torch.Generator().manual_seed(0))
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k           # no update, no statistics
    assert res.forward_only and res.data["repeat_cached_sample"]
    # 8 batches kept, a few more decoded ahead (the feeder's lookahead
    # and the decode queue, 2 each) before the pool stopped
    assert driver.REPEAT_CACHED_BATCHES <= res.data["batches"] <= \
        driver.REPEAT_CACHED_BATCHES + 4
    assert any(ln.startswith("repeat_cached_sample: 8 real batches")
               for ln in lines)


def test_eval_and_num_epochs_end_to_end(narrow_resnet50):
    res, lines, cfg = _run(["--batch_size=4", "--num_warmup_batches=9",
                            "--num_epochs=2", "--display_every=2",
                            "--eval=true"])
    assert cfg.num_batches == 8                   # 2 x 16 examples / 4
    assert res.data["split"] == "validation"
    assert 0.0 <= res.eval_top_1 <= 1.0
    assert not narrow_resnet50[0].training
    assert lines.index(driver.RANDOM_INIT_EVAL_WARNING) >= 0
    assert [ln.split("\t")[0] for ln in lines if "\ttop_1: " in ln] == \
        ["2", "4", "6", "8"]
    assert any(ln.startswith("eval top_1 accuracy: ") for ln in lines)
    assert lines[-1].startswith("total images/sec: ")


def test_text_arm_end_to_end(tmp_path):
    write_token_file(tmp_path / "train.bin", np.random.default_rng(1)
                     .integers(1, 1024, 20000), 1024)
    for extra in ([], ["--eval=true"]):
        cfg = flags.parse_benchmark_flags([
            "--device=cpu", "--model=bert_tiny", f"--data_dir={tmp_path}",
            "--batch_size=2", "--num_warmup_batches=1", "--num_batches=2",
            "--attention_impl=flash", "--fused_xent=true", *extra])
        res = driver.run_benchmark(cfg, print_fn=lambda _m: None)
        assert math.isfinite(res.final_loss) and res.data["split"] == "train"
        assert res.data["reader"] == "memmap"
        assert (res.eval_top_1 is None) == (not extra)


def test_entry_points_with_data_dir_raise_without_a_gpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main(["1", "1", "2", "ib", f"--data_dir={FIXTURE}"]
                      + REFERENCE_LINE)


@pytest.mark.slow
def test_reference_line_on_resnet50_at_224():
    """The reference's command on the port (no --device=cpu there; here
    it asks for the CPU), resnet50 at full width on the fixture."""
    lines = []
    rc = launcher.main(["1", "1", "2", "ib", "--model=resnet50",
                        "--device=cpu", f"--data_dir={FIXTURE}",
                        "--num_warmup_batches=1", "--num_batches=2",
                        "--display_every=1"] + REFERENCE_LINE,
                       print_fn=lines.append)
    res = json.loads(lines[-1])
    assert rc == 0 and res["data"]["decoder"] == "libjpeg"
    assert res["total_workers"] == 1 and math.isfinite(res["final_loss"])

