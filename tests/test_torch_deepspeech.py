"""The port's speech member (deepspeech2, the CTC arm) against the JAX
package, on the CPU.

- **data**: ``SyntheticSpeech`` bit-equal to JAX's, and
  ``speech_to_device`` leaving the ``[B, T, F]`` features unpermuted.
- **trees**: deepspeech2 at full width in each ``--rnn_impl`` arm, from
  ``jax.eval_shape`` (no weights made), through
  ``convert.deepspeech2_variables_from_flax`` against the port's
  ``meta`` ``state_dict``: every leaf consumed, names, shapes and the
  parameter count equal (47.3M); the registry rows equal JAX's.
- **the model**: ``deepspeech2_tiny`` in each arm carried over from the
  same arm's Flax tree (``model.init`` perturbed by seeded noise): the
  training-mode logits, the updated BatchNorm statistics, the CTC loss
  and every gradient, and the eval-mode logits, float32 and bfloat16,
  the JAX side under ``jax.jit``; the three port arms on one
  ``state_dict`` agree with each other.
- **the loss**: ``ctc_loss_fn`` against ``optax.ctc_loss(...).mean()``
  and its gradient on ragged ``label_paddings`` with repeated labels.
- **the step**: two momentum-SGD steps (hoisted), and one step at
  ``--gradient_accumulation_steps=2``, against JAX's
  ``build_train_step`` on a one-device mesh; ``--forward_only`` leaves
  the state as it was.
- **the driver**: ``--eval`` refused with "CTC" in the message,
  ``--data_dir`` refused, ``--rnn_impl`` refused for a non-RNN member
  and an unknown arm refused; a launcher run prints ``examples/sec``
  in the per-step, total and per-chip lines.

Tolerances, relative to the reference's largest magnitude (at least
1): float32 logits, BatchNorm statistics, the loss and gradients 1e-4
(measured <= 6e-6 on the logits); bfloat16 logits and loss 2e-2,
gradients 5e-2, each raised to twice the reference's own bf16 spread
(JAX bf16 against JAX float32, per tensor) where that is larger, as
``test_torch_llama_train.py`` does for its logits: JAX's bf16 logits
sit 1.1-1.3e-2 from its float32 ones (the port's 1.5-1.8e-2 from JAX's
bf16), and its bf16 gradients of the conv frontend 7-16 % from its
float32 ones (BatchNorm's backward over the rounded recurrence; the
port's 4-17 % from JAX's bf16 and 4-8 % from JAX's float32); the CTC
loss alone 1e-5 (float32 sums over 20 frames in another order); the
parameters after two steps 1e-4.
"""

from __future__ import annotations

import functools
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_hc_bench import flags as jax_flags
from tpu_hc_bench.data.synthetic import SyntheticSpeech as JaxSyntheticSpeech
from tpu_hc_bench.models import deepspeech as jax_ds
from tpu_hc_bench.models import get_model_spec as jax_spec
from tpu_hc_bench.train import step as jax_step
from tpu_hc_bench_torch import convert, flags, launcher
from tpu_hc_bench_torch.data.synthetic import SyntheticSpeech, speech_to_device
from tpu_hc_bench_torch.models import create_model, deepspeech, get_model_spec
from tpu_hc_bench_torch.train import driver
from tpu_hc_bench_torch.train import step as step_mod
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
IMPLS = ("hoisted", "bidi", "flax")
FRAMES, FREQ = 64, 32                      # deepspeech2_tiny's input
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 5e-2)}  # net, grads
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# bfloat16: within this multiple of the reference's own bf16 spread (its
# distance from its float32 run) where that exceeds the tolerance
NOISE_FACTOR = 2.0
CTC_TOL = 1e-5
PARAM_TOL = 1e-4
CPU = torch.device("cpu")


def _close(got, want, tol: float, what: str) -> None:
    got = np.asarray(torch.as_tensor(got).detach().float())
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = max(float(np.abs(want).max()), 1.0)
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"


def _rel(got, want) -> float:
    """``got``'s largest distance from ``want`` over ``want``'s largest
    magnitude (at least 1)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed: int, b: int = 4):
    return SyntheticSpeech(b, FRAMES, FREQ, deepspeech.max_label_for(FRAMES),
                           seed=seed).batch()


@functools.lru_cache(maxsize=None)
def _variables(impl: str) -> dict:
    """``deepspeech2_tiny``'s Flax variables in ``impl``'s tree: the init
    moved by seeded noise (running variances kept positive)."""
    v = _np(jax_ds.deepspeech2_tiny(rnn_impl=impl).init(
        jax.random.PRNGKey(3), jnp.zeros((1, FRAMES, FREQ)), train=False))
    rng = np.random.default_rng(5)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: x + np.float32(0.1) * (
            np.abs(rng.standard_normal(x.shape)) if p[-1].key == "var"
            else rng.standard_normal(x.shape)).astype(np.float32), v)


def _port(impl: str, dname: str = "float32", train: bool = True):
    v = _variables(impl)
    port = deepspeech.deepspeech2_tiny(dtype=DTYPES[dname][1], rnn_impl=impl)
    port.load_state_dict(convert.deepspeech2_variables_from_flax(
        v["params"], v["batch_stats"]))                       # strict
    return port.train(train)


def _jax_ctc(logits, labels, paddings):
    zeros = jnp.zeros(logits.shape[:2], jnp.float32)
    return optax.ctc_loss(logits, zeros, labels, paddings).mean()


@functools.lru_cache(maxsize=None)
def _jax_fn(impl: str, dname: str):
    model = jax_ds.deepspeech2_tiny(rnn_impl=impl, dtype=DTYPES[dname][0])

    @jax.jit
    def run(variables, batch):
        feats, labels, paddings = batch

        def loss_fn(params):
            logits, upd = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                feats, train=True, mutable=["batch_stats"])
            return _jax_ctc(logits, labels, paddings), (
                logits, upd["batch_stats"])

        (loss, (logits, stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(variables["params"])
        return loss, logits, stats, grads, model.apply(variables, feats,
                                                       train=False)
    return run


# --- data --------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(global_batch=3, frames=64, freq=32, max_label=12, seed=4),
    dict(global_batch=2, frames=300, freq=161, max_label=50, vocab_size=29,
         seed=0)])
def test_synthetic_speech_is_the_jax_stream(kw):
    mine, ref = SyntheticSpeech(**kw).batch(), JaxSyntheticSpeech(**kw).batch()
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    feats, labels, paddings = speech_to_device(mine, CPU)
    assert feats.shape == mine[0].shape and torch.equal(
        feats, torch.from_numpy(mine[0]))
    assert labels.dtype == torch.int64 and paddings.dtype == torch.float32
    assert deepspeech.max_label_for(300) == jax_ds.max_label_for(300) == 50
    assert deepspeech.max_label_for(64) == jax_ds.max_label_for(64) == 12


# --- trees -------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_full_width_tree_converts(impl):
    shapes = jax.eval_shape(lambda x: jax_ds.deepspeech2(rnn_impl=impl).init(
        jax.random.PRNGKey(0), x, train=False),
        jax.ShapeDtypeStruct((1, 300, 161), jnp.float32))
    zero = np.zeros((), np.float32)
    views = jax.tree_util.tree_map(lambda s: np.broadcast_to(zero, s.shape),
                                   shapes)
    sd = convert.deepspeech2_variables_from_flax(views["params"],
                                                 views["batch_stats"])
    with torch.device("meta"):
        port = deepspeech.deepspeech2(rnn_impl=impl)
    assert {k: tuple(t.shape) for k, t in sd.items()} == {
        k: tuple(t.shape) for k, t in port.state_dict().items()}
    n = sum(p.numel() for p in port.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in
                    jax.tree_util.tree_leaves(shapes["params"]))
    assert 47.3e6 < n < 47.4e6
    assert port.grus[0].fwd.input_gates.weight.shape == (2400, 81 * 32)
    with pytest.raises(ValueError, match="leaves"):
        convert.deepspeech2_variables_from_flax(
            {**views["params"], "extra": {"kernel": zero}},
            views["batch_stats"])


def test_registry_rows_and_guards():
    for name in ("deepspeech2", "deepspeech2_tiny"):
        mine, ref = get_model_spec(name), jax_spec(name)
        assert (mine.input_shape, mine.flops_per_example, mine.ctc) == (
            ref.input_shape, ref.flops_per_example, True)
        assert not (mine.is_text or mine.integer_input)
    model, _ = create_model("deepspeech2_tiny", device="cpu",
                            rnn_impl="bidi", train=True)
    assert {g.rnn_impl for g in model.grus} == {"bidi"}
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(ValueError, match="only applies to RNN members"):
        create_model("resnet20_cifar", device="meta", rnn_impl="flax")
    with pytest.raises(ValueError, match="unknown rnn_impl"):
        create_model("deepspeech2_tiny", device="meta", rnn_impl="lstm")
    with pytest.raises(ValueError, match="hoisted\\|bidi\\|flax"):
        flags.parse_benchmark_flags(["--rnn_impl=lstm"])
    assert flags.parse_benchmark_flags(
        ["--model=deepspeech2", "--rnn_impl=flax"]).rnn_impl == "flax"


# --- the model ---------------------------------------------------------------


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_tiny_matches_jax(impl, dname):
    batch = _batch(11)
    v = _variables(impl)
    loss, logits, stats, grads, eval_logits = _jax_fn(impl, dname)(v, batch)
    assert math.isfinite(float(loss)) and float(loss) < 1e3
    net_tol, grad_tol = TOL[dname]
    want = convert.deepspeech2_variables_from_flax(_np(grads),
                                                   v["batch_stats"])
    grad_tols = dict.fromkeys(want, grad_tol)
    if dname == "bfloat16":
        # the reference's own bf16 rounding: its distance from its float32
        # run, per tensor
        f32 = _jax_fn(impl, "float32")(v, batch)
        net_tol = max(net_tol, NOISE_FACTOR * _rel(logits, f32[1]))
        exact = convert.deepspeech2_variables_from_flax(_np(f32[3]),
                                                        v["batch_stats"])
        grad_tols = {k: max(grad_tol, NOISE_FACTOR * _rel(want[k], exact[k]))
                     for k in want}
    port = _port(impl, dname)
    feats, labels, paddings = speech_to_device(batch, CPU)
    t_logits = port(feats)
    assert t_logits.dtype == torch.float32
    _close(t_logits, logits, net_tol, "logits")
    t_loss = step_mod.ctc_loss_fn(t_logits, labels, paddings)
    assert abs(float(t_loss.detach()) - float(loss)) <= \
        net_tol * abs(float(loss))
    t_loss.backward()
    for name, p in port.named_parameters():
        _close(p.grad, want[name], grad_tols[name], f"grad {name}")
    new = convert.deepspeech2_variables_from_flax(v["params"], _np(stats))
    for name, buf in port.named_buffers():
        _close(buf, new[name], net_tol, name)
    with torch.no_grad():
        _close(_port(impl, dname, train=False)(feats), eval_logits, net_tol,
               "eval logits")


def test_the_three_arms_share_one_state_dict():
    feats = speech_to_device(_batch(12), CPU)[0]
    sd = _port("hoisted").state_dict()
    outs = {}
    for impl in IMPLS:
        port = deepspeech.deepspeech2_tiny(rnn_impl=impl)
        port.load_state_dict(sd)
        with torch.no_grad():
            outs[impl] = port.eval()(feats)
    for impl in ("bidi", "flax"):
        _close(outs[impl], outs["hoisted"], 1e-5, impl)


# --- the loss ----------------------------------------------------------------


def test_ctc_loss_matches_optax_on_ragged_labels():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((5, 20, 7)).astype(np.float32)
    labels = rng.integers(1, 7, (5, 8)).astype(np.int32)
    labels[0, :4] = [3, 3, 2, 2]                  # repeats need blanks
    labels[1, :6] = [5, 5, 5, 1, 1, 4]
    lengths = np.array([4, 8, 1, 6, 3])
    paddings = (np.arange(8)[None] >= lengths[:, None]).astype(np.float32)
    loss, g = jax.value_and_grad(_jax_ctc)(logits, labels, paddings)
    t = torch.from_numpy(logits).requires_grad_()
    got = step_mod.ctc_loss_fn(t, torch.from_numpy(labels).long(),
                               torch.from_numpy(paddings))
    got.backward()
    assert abs(float(got.detach()) - float(loss)) <= \
        CTC_TOL * abs(float(loss))
    _close(t.grad, g, CTC_TOL, "dlogits")


# --- the step ----------------------------------------------------------------


def _jax_state(impl: str, optimizer: str = "momentum"):
    v = _variables(impl)
    tx = jax_step.make_optimizer(jax_flags.BenchmarkConfig(
        optimizer=optimizer))
    return jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
        apply_fn=jax_ds.deepspeech2_tiny(rnn_impl=impl).apply, tx=tx)


def _check_state(port_state, jstate) -> None:
    want = convert.deepspeech2_variables_from_flax(
        _np(jstate.params), _np(jstate.batch_stats))
    got = port_state.model.state_dict()
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], PARAM_TOL, name)


def test_two_sgd_steps_match_jax():
    batch = _batch(13)
    state = _jax_state("hoisted")

    @jax.jit
    def jax_step_fn(state):
        def loss_fn(p):
            return jax_step._loss_and_updates(
                state, p, batch, jax.random.PRNGKey(0), False, ctc=True)
        (loss, stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        updates, opt = state.tx.update(grads, state.opt_state, state.params)
        return state.replace(params=optax.apply_updates(state.params,
                                                        updates),
                             batch_stats=stats, opt_state=opt), loss

    cfg = flags.BenchmarkConfig(device="cpu",
                                model="deepspeech2_tiny").resolve()
    port_state = step_mod.make_train_state(_port("hoisted"), cfg)
    assert port_state.ctc
    t_batch = speech_to_device(batch, CPU)
    before = {k: t.clone() for k, t in port_state.model.state_dict().items()}
    _, fwd = step_mod.forward_step(port_state, t_batch)
    assert all(torch.equal(t, before[k])
               for k, t in port_state.model.state_dict().items())
    for i in range(2):
        state, loss = jax_step_fn(state)
        port_state, metrics = step_mod.train_step(port_state, t_batch)
        assert abs(float(metrics["loss"]) - float(loss)) <= \
            1e-4 * abs(float(loss)), i
        if i == 0:
            assert float(fwd["loss"]) == pytest.approx(float(loss), rel=1e-4)
    _check_state(port_state, state)


def test_accumulation_matches_jax_build_train_step():
    """``--gradient_accumulation_steps=2`` on batch 4 against JAX's step
    on a one-device mesh: the mean of the microbatches' CTC losses, their
    gradients and one decay of the running statistics toward the mean of
    theirs."""
    from jax.sharding import Mesh

    from tpu_hc_bench.parallel import fabric as jax_fabric
    from tpu_hc_bench.topology import DATA_AXIS

    batch = _batch(14)
    mesh = Mesh(np.array(jax.devices()[:1]), (DATA_AXIS,))
    jcfg = jax_flags.BenchmarkConfig(model="deepspeech2_tiny", batch_size=4,
                                     gradient_accumulation_steps=2)
    state = jax_step.replicate_state(_jax_state("hoisted"), mesh)
    step_fn = jax_step.build_train_step(mesh, jcfg,
                                        jax_spec("deepspeech2_tiny"),
                                        jax_fabric.resolve_fabric("ici"))
    state, metrics = step_fn(state, jax_step.shard_batch(batch, mesh),
                             jax.random.PRNGKey(0))
    cfg = flags.BenchmarkConfig(device="cpu", model="deepspeech2_tiny",
                                batch_size=4,
                                gradient_accumulation_steps=2).resolve()
    port_state = step_mod.make_train_state(_port("hoisted"), cfg)
    port_state, m = step_mod.train_step(port_state,
                                        speech_to_device(batch, CPU))
    loss = float(metrics["loss"])
    assert abs(float(m["loss"]) - loss) <= 1e-4 * abs(loss)
    _check_state(port_state, state)


# --- the driver --------------------------------------------------------------


def test_refusals_follow_jax(tmp_path):
    def run(*argv):
        cfg = flags.parse_benchmark_flags(
            ["--device=cpu", "--batch_size=2", "--num_warmup_batches=0",
             "--num_batches=1", *argv])
        return driver.run_benchmark(cfg, print_fn=lambda _m: None)

    with pytest.raises(ValueError, match="CTC"):
        run("--model=deepspeech2_tiny", "--eval=true")
    with pytest.raises(ValueError, match="--data_dir is not supported"):
        run("--model=deepspeech2_tiny", f"--data_dir={tmp_path}")
    with pytest.raises(ValueError, match="only applies to RNN members"):
        run("--model=trivial", "--rnn_impl=bidi")


def test_launcher_prints_examples_per_sec():
    lines: list[str] = []
    rc = launcher.main(["1", "1", "2", "sock", "--model=deepspeech2_tiny",
                        "--device=cpu", "--rnn_impl=bidi",
                        "--num_warmup_batches=1", "--num_batches=2",
                        "--display_every=1"], print_fn=lines.append)
    assert rc == 0
    assert sum("\texamples/sec: " in ln for ln in lines) == 2
    assert any(ln.startswith("total examples/sec: ") for ln in lines)
    assert any(ln.startswith("examples/sec/chip: ") for ln in lines)
    assert not any("images/sec" in ln for ln in lines)
    assert any("rnn_impl=bidi" in ln for ln in lines)


def test_new_modules_import_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, tpu_hc_bench_torch.models.deepspeech, "
         "tpu_hc_bench_torch.models.ncf, tpu_hc_bench_torch.convert, "
         "tpu_hc_bench_torch.train.driver, tpu_hc_bench_torch.serve.engine; "
         "assert 'jax' not in sys.modules; "
         "assert 'tpu_hc_bench' not in sys.modules"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
