"""The port's llama training arm against the JAX package, on the CPU.

- **the model**: ``llama_tiny`` (4 layers, hidden 128, 8 query and 2 KV
  heads: GQA repeats each KV head 4 times) carried over from Flax with
  perturbed weights: logits, the weighted next-token loss and every
  gradient, dense and flash (the flash kernels' plain version here, the
  JAX kernel in Pallas interpret mode) in float32 and flash in
  bfloat16.
- **the head**: in bfloat16 the untied head is a float32 product of the
  bf16-rounded operands (JAX's ``preferred_element_type=float32``).
- **the slice**: two momentum-SGD steps with ``--fused_xent`` against the
  JAX ``_loss_and_updates(..., fused_xent=True)`` and optax;
  ``--gradient_accumulation_steps=4 --accum_dtype=bf16`` under momentum
  and plain sgd against the JAX ``build_train_step``'s bf16 accumulator
  on a one-device mesh (llama has
  no dropout, so both steps see the same function); the registry rows
  and the launcher at llama_tiny on the CPU.

Tolerances are ``test_torch_lm.py``'s (float32 1e-4 for whole-network
values and gradients, bfloat16 2e-2 and 5e-2, relative to the
reference's largest magnitude); in bfloat16 the logits and loss are held
to the larger of 2e-2 and twice the JAX forward's own spread between its
eager and jitted runs, which at these weights is 1.8-2.3 % by itself.
The bf16 accumulator's step is held to one bf16 ulp of the largest
update (2^-7 of it): each side rounds its float32 microbatch gradients
to bf16, and a last-bit difference in float32 can round the other way.
Under plain sgd the port's update is also held bit for bit to optax's
``sgd`` applied op by op to the port's own bf16 gradients (the product
``bf16(-lr) * g`` rounded to bf16, then added in float32).  JAX's jitted
step on the CPU keeps that product in float32 (XLA's excess
precision), so no update form matches ``build_train_step`` bit for bit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_hc_bench import flags as jax_flags
from tpu_hc_bench.models import llama as jax_llama
from tpu_hc_bench.train import step as jax_step
from tpu_hc_bench_torch import convert, flags, launcher
from tpu_hc_bench_torch.data.synthetic import SyntheticTokens, tokens_to_device
from tpu_hc_bench_torch.models import create_model, get_model_spec, llama
from tpu_hc_bench_torch.train import step as step_mod

from test_torch_lm import DTYPES, TOL, _close, _close_tree, _np_tree, _perturb
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

VOCAB, SEQ = 1024, 64
# bfloat16 logits: within this multiple of the JAX reference's own
# eager-vs-jitted spread where that exceeds the 2e-2 tolerance (1.8-2.3 %
# at llama_tiny's perturbed weights)
NOISE_FACTOR = 2.0


@functools.lru_cache(maxsize=None)
def _tiny(dname: str, impl: str):
    model = jax_llama.llama_tiny(dtype=DTYPES[dname][0], attention_impl=impl)
    params = _perturb(model.init(jax.random.PRNGKey(2),
                                 jnp.zeros((1, 8), jnp.int32),
                                 train=False)["params"], 7)
    return model, params


def _port(params, dname, impl):
    port = llama.llama_tiny(dtype=DTYPES[dname][1], attention_impl=impl)
    port.load_state_dict(convert.llama_params_from_flax(params))  # strict
    return port.train()


def _jax_loss(model, params, batch):
    tokens, targets, weights = batch
    logits = model.apply({"params": params}, tokens, train=True)
    losses = optax.softmax_cross_entropy_with_integer_labels(logits, targets)
    return (losses * weights).sum() / jnp.maximum(weights.sum(), 1.0), logits


def _batch(seed: int, b: int = 2):
    return SyntheticTokens(b, SEQ, VOCAB, seed=seed, causal_lm=True).batch()


@pytest.mark.parametrize("dname,impl", [("float32", "dense"),
                                        ("float32", "flash"),
                                        ("bfloat16", "flash")])
def test_llama_tiny_matches_jax(dname, impl):
    model, params = _tiny(dname, impl)
    batch = _batch(8)
    (loss, logits), grads = jax.jit(jax.value_and_grad(
        functools.partial(_jax_loss, model), has_aux=True))(params, batch)
    port = _port(params, dname, impl)
    tokens, targets, weights = tokens_to_device(batch, torch.device("cpu"))
    t_logits = port(tokens)
    assert t_logits.dtype == torch.float32
    t_loss = step_mod.lm_loss_fn(t_logits, targets, weights)
    _, net_tol, grad_tol = TOL[dname]
    if dname == "bfloat16":
        # the reference's own spread: its eager forward against the
        # jitted one (XLA fuses, and so rounds, otherwise)
        eager = np.asarray(model.apply({"params": params}, batch[0],
                                       train=True))
        spread = float(np.abs(eager - np.asarray(logits)).max()) / max(
            float(np.abs(np.asarray(logits)).max()), 1.0)
        net_tol = max(net_tol, NOISE_FACTOR * spread)
    _close(t_logits, logits, net_tol, "logits")
    assert abs(float(t_loss.detach()) - float(loss)) <= \
        net_tol * abs(float(loss))
    t_loss.backward()
    _close_tree({k: p.grad for k, p in port.named_parameters()},
                convert.llama_params_from_flax(_np_tree(grads)), grad_tol,
                "grad")


def test_bf16_head_is_a_float32_product_of_rounded_operands():
    torch.manual_seed(0)
    m = llama.llama_tiny(dtype=torch.bfloat16)
    m.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, 128)
    got = m.head(x)
    h = m.final_norm(x)
    assert h.dtype == torch.bfloat16 and got.dtype == torch.float32
    want = h.float() @ m.lm_head.to(torch.bfloat16).float()
    assert torch.equal(got, want)


def test_two_train_steps_with_fused_xent_match_jax():
    model, params = _tiny("float32", "flash")
    batch = _batch(9)
    jcfg = jax_flags.BenchmarkConfig()
    tx = jax_step.make_optimizer(jcfg)
    state = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
        opt_state=tx.init(params), apply_fn=model.apply, tx=tx)

    @jax.jit
    def jax_step_fn(state):
        def loss_fn(p):
            return jax_step._loss_and_updates(
                state, p, batch, jax.random.PRNGKey(0), True, True)
        (loss, _), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        updates, opt = state.tx.update(grads, state.opt_state, state.params)
        return state.replace(params=optax.apply_updates(state.params,
                                                        updates),
                             opt_state=opt), loss

    cfg = flags.BenchmarkConfig(device="cpu", model="llama_tiny",
                                fused_xent=True).resolve()
    port_state = step_mod.make_train_state(_port(params, "float32", "flash"),
                                           cfg)
    t_batch = tokens_to_device(batch, torch.device("cpu"))
    for i in range(2):
        state, loss = jax_step_fn(state)
        port_state, metrics = step_mod.train_step(port_state, t_batch)
        assert abs(float(metrics["loss"]) - float(loss)) <= \
            1e-4 * abs(float(loss)), i
    _close_tree(port_state.model.state_dict(),
                convert.llama_params_from_flax(_np_tree(state.params)), 1e-4,
                "param")


@pytest.mark.parametrize("optimizer", ["momentum", "sgd"])
def test_bf16_accumulator_matches_jax_at_accum_4(optimizer, monkeypatch):
    """One step at ``--gradient_accumulation_steps=4 --accum_dtype=bf16``
    (batch 8: four microbatches of 2) against JAX's ``build_train_step``
    on a one-device mesh: the loss, and each parameter's update within
    one bf16 ulp of its largest element; the optimizer steps from bf16
    gradients (the mean rounded to bf16) and no float32 ``.grad`` is
    left, and the float32 accumulator's step differs.  Under plain sgd
    each update is bit-equal to optax's on the same bf16 gradients:
    ``bf16(-lr) * g`` rounded to bf16, added in float32."""
    seen = {}

    def spy(opt, params, grads):
        seen["before"] = [p.detach().clone() for p in params]
        seen["grads"] = [g.clone() for g in grads]
        return apply_bf16_grads(opt, params, grads)

    apply_bf16_grads = step_mod.apply_bf16_grads
    monkeypatch.setattr(step_mod, "apply_bf16_grads", spy)
    from jax.sharding import Mesh

    from tpu_hc_bench.models import ModelSpec
    from tpu_hc_bench.parallel import fabric as jax_fabric
    from tpu_hc_bench.topology import DATA_AXIS

    model, params = _tiny("float32", "dense")
    batch = _batch(10, b=8)
    mesh = Mesh(np.array(jax.devices()[:1]), (DATA_AXIS,))
    jcfg = jax_flags.BenchmarkConfig(
        model="llama_tiny", batch_size=8, gradient_accumulation_steps=4,
        accum_dtype="bf16", optimizer=optimizer)
    tx = jax_step.make_optimizer(jcfg)
    state = jax_step.replicate_state(jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
        opt_state=tx.init(params), apply_fn=model.apply, tx=tx), mesh)
    step_fn = jax_step.build_train_step(
        mesh, jcfg, ModelSpec("llama_tiny", None, (SEQ,), 1e6, is_text=True,
                              vocab_size=VOCAB, causal_lm=True),
        jax_fabric.resolve_fabric("ici"))
    state, metrics = step_fn(state, jax_step.shard_batch(batch, mesh),
                             jax.random.PRNGKey(0))
    before = convert.llama_params_from_flax(params)
    want = convert.llama_params_from_flax(_np_tree(state.params))
    t_batch = tokens_to_device(batch, torch.device("cpu"))
    steps = {}
    for dt in ("bf16", "f32"):
        cfg = flags.BenchmarkConfig(
            device="cpu", model="llama_tiny", batch_size=8,
            gradient_accumulation_steps=4, accum_dtype=dt,
            optimizer=optimizer).resolve()
        port_state = step_mod.make_train_state(
            _port(params, "float32", "dense"), cfg)
        port_state, m = step_mod.train_step(port_state, t_batch)
        steps[dt] = port_state
        if dt == "bf16":
            assert abs(float(m["loss"]) - float(metrics["loss"])) <= \
                1e-5 * abs(float(metrics["loss"]))
            assert all(p.grad is None
                       for p in port_state.model.parameters())
            assert all(g.dtype == torch.bfloat16 for g in seen["grads"])
    if optimizer == "sgd":
        tx = optax.sgd(jcfg.init_learning_rate)
        for p, p0, g in zip(steps["bf16"].model.parameters(),
                            seen["before"], seen["grads"]):
            jp = jnp.asarray(p0.numpy())
            u, _ = tx.update(jnp.asarray(g.float().numpy()).astype(
                jnp.bfloat16), tx.init(jp), jp)
            assert u.dtype == jnp.bfloat16
            np.testing.assert_array_equal(
                p.detach().numpy(), np.asarray(optax.apply_updates(jp, u)))
    got = steps["bf16"].model.state_dict()
    f32 = steps["f32"].model.state_dict()
    worst_f32 = 0.0
    for k in want:
        d_want = want[k] - before[k]
        scale = float(d_want.abs().max())
        err = float((got[k] - before[k] - d_want).abs().max())
        assert err <= 2.0 ** -7 * scale, (k, err, scale)
        worst_f32 = max(worst_f32, float(
            (f32[k] - before[k] - d_want).abs().max()) / scale)
    assert worst_f32 > 0.0      # the float32 arm steps otherwise


def test_llama_registry_rows_and_launcher_on_the_cpu():
    for name, flops, shape in (("llama_1b", 2 * 1.1e9 * 2048, (2048,)),
                               ("llama_tiny", 2 * 0.8e6 * 64, (64,))):
        spec = get_model_spec(name)
        assert spec.causal_lm and not spec.moe
        assert (spec.flops_per_example, spec.input_shape) == (flops, shape)
    with torch.device("meta"):
        big = llama.llama_1b()
    ref = jax_llama.llama_1b()
    assert (big.num_layers, big.hidden, big.heads, big.num_kv_heads,
            big.ffn, big.vocab_size) == (ref.num_layers, ref.hidden,
                                         ref.heads, ref.num_kv_heads,
                                         ref.ffn, ref.vocab_size)
    model, spec = create_model("llama_tiny", torch.bfloat16, "flash",
                               device="cpu", seed=1, train=True, seq_len=96,
                               gradient_checkpointing=True)
    assert model.remat and model.max_len == 128 and spec.input_shape == (96,)
    assert model.layers[0].attn.attention_impl == "flash"
    assert all(p.dtype == torch.float32 for p in model.parameters())
    lines: list[str] = []
    rc = launcher.main(["1", "1", "2", "sock", "--model=llama_tiny",
                        "--device=cpu", "--attention_impl=flash",
                        "--fused_xent=true", "--num_warmup_batches=1",
                        "--num_batches=2", "--display_every=1"],
                       print_fn=lines.append)
    assert rc == 0
    assert sum("\texamples/sec: " in ln for ln in lines) == 2
