"""Helpers shared by the image zoo's parity tests (``test_torch_vit.py``
and ``test_torch_zoo_*.py``): Flax variables drawn from a numpy seed,
the converters, and the checks those files run.

- ``check_tree(name)``: the member's whole tree at full width, from
  ``jax.eval_shape`` of the Flax module's ``init`` at its canonical
  input (no weights made), converted from zero-strided views and held
  against the ``state_dict`` of the port model built on the ``meta``
  device: every leaf consumed, every name and shape equal, the
  parameter counts equal.
- ``check_forward(...)``: logits (and, in training mode, the updated
  BatchNorm statistics) of the port twin against ``model.apply``, the
  variables drawn from a numpy seed into the tree ``jax.eval_shape``
  gives (``flax_variables``) and the JAX forward under ``jax.jit``.
- ``two_steps(...)``: two momentum-SGD steps against the JAX step's
  ``_loss_and_updates`` and ``make_optimizer``.

Tolerances (float32): logits and losses within ``NET_TOL`` of their
largest magnitude (sums in another order through up to ~100 layers),
BatchNorm statistics within ``STATS_TOL`` of theirs, parameters after
two steps within ``PARAM_TOL``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from tpu_hc_bench import flags as jax_flags
from tpu_hc_bench.models import create_model as jax_create_model
from tpu_hc_bench.train import step as jax_step
from tpu_hc_bench_torch import convert, flags
from tpu_hc_bench_torch.models import get_model_spec
from tpu_hc_bench_torch.train import step as step_mod

NET_TOL = 1e-4
STATS_TOL = 1e-4
PARAM_TOL = 1e-4
LOSS_RTOL = 1e-4


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _draw(rng, path, shape) -> np.ndarray:
    """A leaf from ``rng`` by its name: lecun-scaled kernels (so every
    layer's output keeps unit scale), BatchNorm scales and running
    variances near 1 (variances positive), every other leaf (biases,
    means, class tokens, position tables) small and nonzero, so no leaf
    is left at an initialiser's 0 or 1."""
    name = path[-1].key
    noise = rng.standard_normal(shape).astype(np.float32)
    if name == "kernel":
        return noise / np.float32(np.sqrt(np.prod(shape[:-1])))
    if name == "scale":
        return 1 + 0.1 * noise
    if name == "var":
        return 1 + 0.1 * np.abs(noise)
    return 0.1 * noise


def images(shape, seed: int) -> np.ndarray:
    """NHWC float32 images from a numpy seed."""
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def nchw(a: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW torch in ``channels_last`` memory."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def close(got, want, tol: float, what: str) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = max(float(np.abs(want).max()), 1.0)
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"


def flax_variables(module, *inputs, seed: int = 0, **kw) -> dict:
    """The variables of ``module.init`` at ``inputs``: the tree's names
    and shapes from ``jax.eval_shape`` (no initialiser runs), the values
    drawn from a numpy seed (``_draw``)."""
    shapes = jax.eval_shape(
        lambda *a: module.init({"params": jax.random.PRNGKey(0),
                                "dropout": jax.random.PRNGKey(1)}, *a, **kw),
        *inputs)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: _draw(rng, path, s.shape), shapes)


def init_variables(module, *inputs, seed: int = 0, **kw) -> dict:
    """``module.init``'s own values (zero-initialised last BatchNorms
    keep a deep net's step well conditioned), each leaf moved by seeded
    noise so none stays at 0 or 1: the two-step tests' start."""
    v = np_tree(module.init({"params": jax.random.PRNGKey(seed),
                             "dropout": jax.random.PRNGKey(seed + 1)},
                            *inputs, **kw))
    rng = np.random.default_rng(seed + 2)

    def leaf(path, x):
        noise = rng.standard_normal(x.shape).astype(np.float32)
        name = path[-1].key
        if name == "var":
            return x + 0.1 * np.abs(noise)
        if name == "kernel":
            return x * (1 + 0.1 * noise)
        return x + 0.1 * noise

    return jax.tree_util.tree_map_with_path(leaf, v)


def jax_apply(module, variables, *inputs, train: bool | None):
    """``module.apply`` under ``jax.jit`` (one compile, where op-by-op
    dispatch compiles every op at every new shape): the output, and in
    training mode the updated ``batch_stats`` as numpy; ``train`` None
    for a module that takes no ``train`` (its mode fixed at
    construction)."""
    kw = {} if train is None else {"train": train}

    def run(v, *a):
        return module.apply(v, *a, rngs={"dropout": jax.random.PRNGKey(9)},
                            mutable=["batch_stats"], **kw)
    out, upd = jax.jit(run)(variables, *inputs)
    return np.asarray(out), np_tree(upd.get("batch_stats", {}))


def load(port: torch.nn.Module, family: str, variables: dict):
    """``port`` with ``variables`` converted and loaded strictly."""
    sd = convert.zoo_variables_from_flax(family, variables["params"],
                                         variables.get("batch_stats"))
    port.load_state_dict(sd, strict=True)
    return port


def check_tree(name: str) -> None:
    jm, js = jax_create_model(name, num_classes=1000)
    x = jax.ShapeDtypeStruct((1, *js.input_shape), jnp.float32)
    shapes = jax.eval_shape(
        lambda x: jm.init({"params": jax.random.PRNGKey(0),
                           "dropout": jax.random.PRNGKey(1)}, x,
                          train=False), x)
    zero = np.zeros((), np.float32)
    views = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(zero, s.shape), shapes)
    sd = convert.zoo_variables_from_flax(name, views["params"],
                                         views.get("batch_stats"))
    spec = get_model_spec(name)
    assert spec.input_shape == js.input_shape
    assert spec.flops_per_example == js.flops_per_example
    with torch.device("meta"):
        port = spec.create(num_classes=1000)
    want = {k: tuple(t.shape) for k, t in port.state_dict().items()}
    assert {k: tuple(t.shape) for k, t in sd.items()} == want, name
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert n_jax == sum(p.numel() for p in port.parameters()), name


def check_forward(module, port: torch.nn.Module, family: str, x: np.ndarray,
                  train: bool, seed: int = 0, dropout: bool = False,
                  tol: float = NET_TOL) -> None:
    """The port twin of ``module`` (variables from ``seed``) against
    ``module.apply`` on ``x``: logits (not in training mode where the
    model has ``dropout``, whose masks come from another generator), and
    in training mode the updated BatchNorm statistics."""
    variables = flax_variables(module, x, seed=seed, train=False)
    load(port, family, variables).train(train)
    with torch.no_grad():
        got = port(nchw(x))
    logits, stats = jax_apply(module, variables, x, train=train)
    if not (train and dropout):
        close(got, logits, tol, "logits")
    if train:
        check_stats(port, family, variables, stats)


def check_stats(port: torch.nn.Module, family: str, variables: dict,
                stats: dict) -> None:
    """Every running statistic of ``port`` against JAX's updated
    ``batch_stats``, and none left unchecked."""
    want = convert.zoo_variables_from_flax(family, variables["params"],
                                           stats)
    bufs = dict(port.named_buffers())
    assert len(bufs) == sum(1 for k in want if k.endswith(
        ("running_mean", "running_var")))
    for name, buf in bufs.items():
        close(buf, want[name], STATS_TOL, name)


def two_steps(module, port: torch.nn.Module, family: str, batch,
              lr: float = 0.05, dropout: bool = False) -> None:
    """Two momentum-SGD steps of ``port`` (its twin's variables) against
    the JAX step on the ``(images, labels)`` batch; with ``dropout``
    both sides run their dropout off (JAX at ``train=False`` with the
    running statistics: only dropout-free BN members use the train
    arm's statistics)."""
    images, labels = batch
    variables = init_variables(module, images, seed=4, train=False)
    load(port, family, variables)
    stats = variables.get("batch_stats", {})
    jcfg = jax_flags.BenchmarkConfig(optimizer="momentum",
                                     init_learning_rate=lr, momentum=0.9)
    tx = jax_step.make_optimizer(jcfg)
    apply_fn = module.apply
    if dropout:
        def apply_fn(v, x, train, rngs, mutable):
            return module.apply(v, x, train=False, rngs=rngs,
                                mutable=mutable)
    state = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=stats, opt_state=tx.init(variables["params"]),
        apply_fn=apply_fn, tx=tx)

    @jax.jit
    def jax_step_fn(state):
        def loss_fn(p):
            return jax_step._loss_and_updates(
                state, p, (images, labels), jax.random.PRNGKey(0), False)
        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        updates, opt = state.tx.update(grads, state.opt_state, state.params)
        return state.replace(params=optax.apply_updates(state.params,
                                                        updates),
                             batch_stats=new_stats, opt_state=opt), loss

    cfg = flags.BenchmarkConfig(optimizer="momentum", init_learning_rate=lr,
                                momentum=0.9, device="cpu").resolve()
    port_state = step_mod.make_train_state(port, cfg)
    if dropout:
        port_state.model.eval()
    t_batch = (nchw(images), torch.from_numpy(np.asarray(labels)).long())
    for i in range(2):
        state, loss = jax_step_fn(state)
        port_state, metrics = step_mod.train_step(port_state, t_batch)
        got = float(metrics["loss"])
        assert abs(got - float(loss)) <= LOSS_RTOL * abs(float(loss)), i
    assert port_state.step == 2
    want = convert.zoo_variables_from_flax(family, np_tree(state.params),
                                           np_tree(state.batch_stats))
    for name, t in port_state.model.state_dict().items():
        close(t, want[name], PARAM_TOL, name)
