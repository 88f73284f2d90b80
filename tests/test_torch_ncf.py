"""The port's recommendation member (ncf, NeuMF on integer ids) against
the JAX package, on the CPU.

- **data**: ``SyntheticIds`` bit-equal to JAX's; ``ids_to_device``
  gives int64 ``[B, 2]`` pairs (``nn.Embedding``'s index type).
- **trees**: ncf at full width from ``jax.eval_shape`` (no weights made)
  through ``convert.ncf_params_from_flax`` against the port's ``meta``
  ``state_dict``: names, shapes, the parameter count (31.8M, the four
  tables 31.7M of it); a leaf left over raises; the registry rows equal
  JAX's.
- **the model**: ``ncf_tiny`` carried over from Flax (``model.init``
  moved by seeded noise): logits, the loss and every gradient, float32
  and bfloat16, the JAX side under ``jax.jit``, on a batch with repeated
  users and items (their table gradients summed).
- **the step**: two momentum-SGD steps against JAX's
  ``_loss_and_updates`` and optax, and one at
  ``--gradient_accumulation_steps=2`` against JAX's ``build_train_step``
  on a one-device mesh; ``--eval``'s top-1 (binary accuracy) against
  JAX's ``build_eval_step``.
- **the driver**: ``--data_dir`` refused; a launcher run and an
  ``--eval`` run print ``examples/sec``.

Tolerances, relative to the reference's largest magnitude (at least
1): float32 1e-5 for logits, loss and gradients (measured ~1e-8);
bfloat16 2e-2 and 5e-2 (the gather is rounded on both sides; JAX sums
a repeated id's bf16 cotangents in bf16, the port in float32); the
parameters after the steps 1e-5.
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
from tpu_hc_bench.data.synthetic import SyntheticIds as JaxSyntheticIds
from tpu_hc_bench.models import get_model_spec as jax_spec
from tpu_hc_bench.models import ncf as jax_ncf
from tpu_hc_bench.train import step as jax_step
from tpu_hc_bench_torch import convert, flags, launcher
from tpu_hc_bench_torch.data.synthetic import SyntheticIds, ids_to_device
from tpu_hc_bench_torch.models import get_model_spec, ncf
from tpu_hc_bench_torch.train import driver
from tpu_hc_bench_torch.train import step as step_mod
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 5e-2)}   # net, grads
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
PARAM_TOL = 1e-5
CPU = torch.device("cpu")
BATCH = 64                      # 1000 users, 500 items: repeats are likely


def _close(got, want, tol: float, what: str) -> None:
    got = np.asarray(torch.as_tensor(got).detach().float())
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = max(float(np.abs(want).max()), 1.0)
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed: int, b: int = BATCH):
    ids, labels = SyntheticIds(b, 1000, 500, seed=seed).batch()
    ids[1] = ids[0]                       # a pair seen twice
    ids[2, 0] = ids[0, 0]                 # a user seen again
    return ids, labels


@functools.lru_cache(maxsize=None)
def _params() -> dict:
    v = _np(jax_ncf.ncf_tiny().init(jax.random.PRNGKey(3),
                                    jnp.zeros((1, 2), jnp.int32)))
    rng = np.random.default_rng(6)
    return jax.tree_util.tree_map(
        lambda x: x + 0.1 * rng.standard_normal(x.shape).astype(np.float32),
        v["params"])


def _port(dname: str = "float32"):
    port = ncf.ncf_tiny(dtype=DTYPES[dname][1])
    port.load_state_dict(convert.ncf_params_from_flax(_params()))  # strict
    return port.train()


def test_synthetic_ids_are_the_jax_stream():
    kw = dict(global_batch=33, num_users=138_493, num_items=26_744, seed=2)
    mine, ref = SyntheticIds(**kw).batch(), JaxSyntheticIds(**kw).batch()
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ids, labels = ids_to_device(mine, CPU)
    assert ids.shape == (33, 2) and ids.dtype == labels.dtype == torch.int64


def test_full_width_tree_and_registry():
    shapes = jax.eval_shape(
        lambda x: jax_ncf.ncf().init(jax.random.PRNGKey(0), x),
        jax.ShapeDtypeStruct((1, 2), jnp.int32))
    zero = np.zeros((), np.float32)
    views = jax.tree_util.tree_map(lambda s: np.broadcast_to(zero, s.shape),
                                   shapes["params"])
    sd = convert.ncf_params_from_flax(views)
    with torch.device("meta"):
        port = ncf.ncf()
    assert {k: tuple(t.shape) for k, t in sd.items()} == {
        k: tuple(t.shape) for k, t in port.state_dict().items()}
    n = sum(p.numel() for p in port.parameters())
    assert n == sum(int(np.prod(s.shape))
                    for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert (138_493 + 26_744) * (64 + 128) < n < 31.9e6
    with pytest.raises(ValueError, match="leaves"):
        convert.ncf_params_from_flax({**views, "x": {"kernel": zero}})
    for name in ("ncf", "ncf_tiny"):
        mine, ref = get_model_spec(name), jax_spec(name)
        assert (mine.input_shape, mine.flops_per_example,
                mine.integer_input) == (ref.input_shape,
                                        ref.flops_per_example, True)
        assert not (mine.is_text or mine.ctc)


@functools.lru_cache(maxsize=None)
def _jax_fn(dname: str):
    model = jax_ncf.ncf_tiny(dtype=DTYPES[dname][0])

    @jax.jit
    def run(params, batch):
        ids, labels = batch

        def loss_fn(p):
            logits = model.apply({"params": p}, ids)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, labels).mean(), logits
        (loss, logits), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        return loss, logits, grads
    return run


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_tiny_matches_jax(dname):
    batch = _batch(7)
    loss, logits, grads = _jax_fn(dname)(_params(), batch)
    net_tol, grad_tol = TOL[dname]
    port = _port(dname)
    ids, labels = ids_to_device(batch, CPU)
    t_logits = port(ids)
    assert t_logits.dtype == torch.float32
    _close(t_logits, logits, net_tol, "logits")
    t_loss = step_mod.loss_fn(t_logits, labels)
    assert abs(float(t_loss.detach()) - float(loss)) <= \
        net_tol * abs(float(loss))
    t_loss.backward()
    want = convert.ncf_params_from_flax(_np(grads))
    for name, p in port.named_parameters():
        _close(p.grad, want[name], grad_tol, f"grad {name}")


def _jax_state(params):
    tx = jax_step.make_optimizer(jax_flags.BenchmarkConfig())
    return jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
        opt_state=tx.init(params), apply_fn=jax_ncf.ncf_tiny().apply, tx=tx)


def _check_params(port_state, params) -> None:
    want = convert.ncf_params_from_flax(_np(params))
    got = port_state.model.state_dict()
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], PARAM_TOL, name)


def test_two_sgd_steps_and_eval_match_jax():
    batch = _batch(8)
    state = _jax_state(_params())

    @jax.jit
    def jax_step_fn(state):
        def loss_fn(p):
            return jax_step._loss_and_updates(
                state, p, batch, jax.random.PRNGKey(0), False)
        (loss, _), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        updates, opt = state.tx.update(grads, state.opt_state, state.params)
        return state.replace(params=optax.apply_updates(state.params,
                                                        updates),
                             opt_state=opt), loss

    cfg = flags.BenchmarkConfig(device="cpu", model="ncf_tiny").resolve()
    port_state = step_mod.make_train_state(_port(), cfg)
    assert not port_state.ctc
    t_batch = ids_to_device(batch, CPU)
    for i in range(2):
        state, loss = jax_step_fn(state)
        port_state, metrics = step_mod.train_step(port_state, t_batch)
        assert abs(float(metrics["loss"]) - float(loss)) <= \
            1e-5 * abs(float(loss)), i
    _check_params(port_state, state.params)
    # --eval: the top-1 count of the 2-way head, binary accuracy
    from jax.sharding import Mesh

    from tpu_hc_bench.topology import DATA_AXIS

    mesh = Mesh(np.array(jax.devices()[:1]), (DATA_AXIS,))
    eval_fn = jax_step.build_eval_step(mesh, jax_flags.BenchmarkConfig(
        model="ncf_tiny"), jax_spec("ncf_tiny"))
    j_loss, j_correct = eval_fn(jax_step.replicate_state(state, mesh),
                                jax_step.shard_batch(batch, mesh))
    port_state.model.eval()
    loss, correct = step_mod.eval_step(port_state, t_batch)
    assert float(correct) == float(j_correct)
    assert abs(float(loss) - float(j_loss)) <= 1e-5 * abs(float(j_loss))


def test_accumulation_matches_jax_build_train_step():
    from jax.sharding import Mesh

    from tpu_hc_bench.parallel import fabric as jax_fabric
    from tpu_hc_bench.topology import DATA_AXIS

    batch = _batch(9)
    mesh = Mesh(np.array(jax.devices()[:1]), (DATA_AXIS,))
    jcfg = jax_flags.BenchmarkConfig(model="ncf_tiny", batch_size=BATCH,
                                     gradient_accumulation_steps=2)
    state = jax_step.replicate_state(_jax_state(_params()), mesh)
    step_fn = jax_step.build_train_step(mesh, jcfg, jax_spec("ncf_tiny"),
                                        jax_fabric.resolve_fabric("ici"))
    state, metrics = step_fn(state, jax_step.shard_batch(batch, mesh),
                             jax.random.PRNGKey(0))
    cfg = flags.BenchmarkConfig(device="cpu", model="ncf_tiny",
                                batch_size=BATCH,
                                gradient_accumulation_steps=2).resolve()
    port_state = step_mod.make_train_state(_port(), cfg)
    port_state, m = step_mod.train_step(port_state, ids_to_device(batch, CPU))
    loss = float(metrics["loss"])
    assert abs(float(m["loss"]) - loss) <= 1e-5 * abs(loss)
    _check_params(port_state, state.params)


def test_driver_refuses_data_dir(tmp_path):
    cfg = flags.parse_benchmark_flags(["--model=ncf_tiny", "--device=cpu",
                                       f"--data_dir={tmp_path}"])
    with pytest.raises(ValueError, match="--data_dir is not supported for "
                       "ncf_tiny"):
        driver.run_benchmark(cfg, print_fn=lambda _m: None)


@pytest.mark.parametrize("extra", [[], ["--eval=true"],
                                   ["--forward_only=true"]])
def test_launcher_prints_examples_per_sec(extra):
    lines: list[str] = []
    rc = launcher.main(["1", "1", "16", "sock", "--model=ncf_tiny",
                        "--device=cpu", "--num_warmup_batches=1",
                        "--num_batches=2", "--display_every=1", *extra],
                       print_fn=lines.append)
    assert rc == 0
    assert any(ln.startswith("total examples/sec: ") for ln in lines)
    assert not any("images/sec" in ln for ln in lines)
    if not extra or extra[0].startswith("--forward_only"):
        assert sum("\texamples/sec: " in ln for ln in lines) == 2
        assert any(ln.startswith("examples/sec/chip: ") for ln in lines)
    else:
        assert any(ln.startswith("eval top_1 accuracy: ") for ln in lines)
