"""Two card findings checked against the JAX package on the CPU.

- **deepspeech2's rising loss.**  On the card the full-width model's CTC
  loss rose over its first steps (lr 0.01, momentum 0.9, one fixed
  synthetic batch).  The port's step is JAX's: ``deepspeech2_tiny``
  over eight momentum steps on one seeded batch tracks JAX's loss
  within ``TINY_LOSS_TOL`` at every step, and both fall.  At full
  width JAX's own loss rises on that batch at those hyperparameters too
  (``--runslow``: eight steps of each package, float32, batch 8), so
  the rise is the hyperparameters', not the port's.
- **gpt2_moe's dropped pairs.**  At the card's seeded init 29.4 % of
  the (token, expert) pairs overflowed the einsum dispatch's capacity,
  where 2-8 % was predicted.  From JAX's own init at gpt2_moe's width
  and expert count (depth cut to two MoE layers, 8 sequences of 128
  tokens) JAX drops a fraction as large, and the port given those
  weights drops exactly the same pairs: the prediction was wrong, not
  the port.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_hc_bench import flags as jax_flags
from tpu_hc_bench.data import synthetic as jax_synthetic
from tpu_hc_bench.models import create_model as jax_create_model
from tpu_hc_bench.models import gpt as jax_gpt
from tpu_hc_bench.models import moe as jax_moe
from tpu_hc_bench.train import step as jax_step
from tpu_hc_bench_torch import convert, flags
from tpu_hc_bench_torch.data.synthetic import speech_to_device
from tpu_hc_bench_torch.models import create_model, gpt
from tpu_hc_bench_torch.train import step as step_mod

from test_torch_deepspeech import CPU, _batch, _jax_state, _port
from torch_threads import cpu_share  # noqa: F401

STEPS = 8
TINY_LOSS_TOL = 1e-5          # relative, at every step
# the prediction the card's 29.4 % missed
PREDICTED_DROP = (0.02, 0.08)


def _jax_step_fn(batch):
    @jax.jit
    def step(state):
        def loss_fn(p):
            return jax_step._loss_and_updates(
                state, p, batch, jax.random.PRNGKey(0), False, ctc=True)
        (loss, stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        updates, opt = state.tx.update(grads, state.opt_state, state.params)
        return state.replace(params=optax.apply_updates(state.params,
                                                        updates),
                             batch_stats=stats, opt_state=opt), loss

    return step


def test_deepspeech2_tiny_eight_momentum_steps_track_jax():
    jcfg = jax_flags.BenchmarkConfig()
    assert (jcfg.optimizer, jcfg.init_learning_rate, jcfg.momentum) == \
        ("momentum", 0.01, 0.9)
    batch = _batch(13)
    state, step = _jax_state("hoisted"), _jax_step_fn(batch)
    cfg = flags.BenchmarkConfig(device="cpu",
                                model="deepspeech2_tiny").resolve()
    port_state = step_mod.make_train_state(_port("hoisted"), cfg)
    t_batch = speech_to_device(batch, CPU)
    want, got = [], []
    for _ in range(STEPS):
        state, loss = step(state)
        port_state, metrics = step_mod.train_step(port_state, t_batch)
        want.append(float(loss))
        got.append(float(metrics["loss"]))
    for i, (a, b) in enumerate(zip(got, want)):
        assert abs(a - b) <= TINY_LOSS_TOL * abs(b), (i, a, b)
    assert want[-1] < want[0] and got[-1] < got[0]


@pytest.mark.slow
def test_deepspeech2_full_width_loss_rises_in_jax_too():
    b = 8
    model, spec = jax_create_model("deepspeech2")
    frames, freq = spec.input_shape
    batch = jax_synthetic.SyntheticSpeech(
        global_batch=b, frames=frames, freq=freq, max_label=50).batch()
    state = jax_step.make_train_state(
        model, jax_flags.BenchmarkConfig(model="deepspeech2", batch_size=b),
        batch)
    step = _jax_step_fn(batch)
    want = []
    for _ in range(STEPS):
        state, loss = step(state)
        want.append(float(loss))
    assert max(want[2:]) > want[0] and want[-1] > want[0]
    port, _ = create_model("deepspeech2", device="cpu", seed=0)
    cfg = flags.BenchmarkConfig(device="cpu", model="deepspeech2",
                                batch_size=b).resolve()
    port_state = step_mod.make_train_state(port, cfg)
    t_batch = speech_to_device(batch, CPU)
    got = [float(step_mod.train_step(port_state, t_batch)[1]["loss"])
           for _ in range(STEPS)]
    assert max(got[2:]) > got[0] and got[-1] > got[0]


def test_gpt2_moe_drop_fraction_equals_jax_at_its_init():
    layers, b, s = 2, 8, 128
    model = jax_gpt.GPTLM(num_layers=layers, num_experts=8, top_k=2)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                        train=False)["params"]
    tokens = np.random.default_rng(0).integers(
        0, model.vocab_size, (b, s)).astype(np.int32)
    _, col = model.apply({"params": params}, tokens, train=False,
                         capture_intermediates=True,
                         mutable=["intermediates", "losses"])
    capacity = max(4, math.ceil(1.25 * 2 * s / 8))
    want = []
    for i in range(layers):
        router = col["intermediates"][f"layer_{i}"]["moe"]["router"][
            "__call__"][0]
        dispatch, _, _ = jax_moe.top_k_routing(jax.nn.softmax(router, -1),
                                               2, capacity)
        want.append(1.0 - float(dispatch.sum()) / (b * s * 2))
    port = gpt.GPTLM(num_layers=layers, num_experts=8, top_k=2)
    port.load_state_dict(convert.gpt_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        port.eval()(torch.from_numpy(tokens))
    assert float(port.moe_dropped) == pytest.approx(sum(want) / layers,
                                                    abs=1e-6)
    assert min(want) > PREDICTED_DROP[1]
