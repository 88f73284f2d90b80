"""The port's MoE members against the JAX package, on the CPU.

- **routing**: ``topk_select`` and ``top_k_routing`` fed JAX's own router
  probabilities, so the discrete choices see the same numbers: masks,
  choices, gates, ``dispatch`` and ``combine`` equal element for
  element, at a capacity factor of 0.5 (tokens dropped) and 1.25; the
  aux term within 1e-6 (its means sum in another order).
- **the layer**: ``MoEFFN`` (hidden 64, FFN 96, 4 experts, top-2) with
  perturbed Flax weights through ``convert.moe_params_from_flax``:
  einsum, ragged, ragged in 16-row chunks and ragged with the FFN dim in
  40-wide slices (96 is no multiple: the last slice is short where JAX
  zero-pads), in float32 and bfloat16: the output, the aux term, and the
  gradients of ``sum(y * g) + 0.01 * aux`` for the input and every
  parameter.  Any token whose router margin (between consecutive sorted
  probabilities down to the (k+1)-th) is under 1e-5 is reported in the
  failure message: there a last-bit difference of the router's product
  may pick another expert.  Ragged equals einsum where the capacity
  drops nothing.
- **the model**: ``moe_tiny`` (4 layers, hidden 128, 4 experts) carried
  over from Flax: logits, the weighted loss plus ``AUX_LOSS_COEF`` times
  the summed aux terms (JAX's sown ``"losses"``), and every gradient,
  einsum with flash, ragged with dense, and einsum with flash in
  bfloat16, where a near tie may route a token elsewhere (see the
  test); then two momentum-SGD steps with ``--fused_xent`` against
  the JAX ``_loss_and_updates(..., fused_xent=True)`` and optax; the
  registry rows, the MoE flags and their guards.

Tolerances, relative to the reference's largest magnitude (or 1), are
``test_torch_lm.py``'s: float32 1e-5 for layer outputs and 1e-4 for
whole-network values and gradients, bfloat16 2e-2 and 5e-2.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_hc_bench import flags as jax_flags
from tpu_hc_bench.models import gpt as jax_gpt
from tpu_hc_bench.models import moe as jax_moe
from tpu_hc_bench.train import step as jax_step
from tpu_hc_bench_torch import convert, flags
from tpu_hc_bench_torch.data.synthetic import SyntheticTokens, tokens_to_device
from tpu_hc_bench_torch.models import create_model, get_model_spec, gpt, moe
from tpu_hc_bench_torch.train import step as step_mod

from test_torch_lm import DTYPES, TOL, _close, _close_tree, _np_tree, _perturb
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

H, FFN, E, K = 64, 96, 4, 2
MARGIN = 1e-5
VOCAB = 1024


def _probs(b: int, s: int, seed: int) -> np.ndarray:
    logits = np.random.default_rng(seed).standard_normal(
        (b, s, E)).astype(np.float32)
    return np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))


def _near_ties(probs: np.ndarray, k: int) -> list[tuple]:
    """Tokens whose consecutive sorted probabilities, down to the
    (k+1)-th, sit within ``MARGIN``: (index, smallest margin)."""
    srt = -np.sort(-probs.reshape(-1, probs.shape[-1]), axis=-1)
    gaps = (srt[:, :k] - srt[:, 1:k + 1]).min(-1)
    return [(int(i), float(gaps[i])) for i in np.flatnonzero(gaps < MARGIN)]


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_routing_matches_jax_elementwise(cf):
    b, s = 2, 32
    probs = _probs(b, s, 11)
    masks, gates, choices, aux = jax_moe.topk_select(jnp.asarray(probs), K)
    t_masks, t_gates, t_choices, t_aux = moe.topk_select(
        torch.from_numpy(probs), K)
    for j in range(K):
        np.testing.assert_array_equal(t_masks[j].numpy(), masks[j])
        np.testing.assert_array_equal(t_choices[j].numpy(), choices[j])
        np.testing.assert_array_equal(t_gates[j].numpy(), gates[j])
    assert abs(float(t_aux) - float(aux)) <= 1e-6 * abs(float(aux))
    cap = moe.capacity(cf, K, s, E)
    assert cap == max(4, math.ceil(cf * K * s / E))
    dispatch, combine, aux = jax_moe.top_k_routing(jnp.asarray(probs), K, cap)
    t_dispatch, t_combine, _ = moe.top_k_routing(torch.from_numpy(probs), K,
                                                 cap)
    np.testing.assert_array_equal(t_dispatch.numpy(), dispatch)
    np.testing.assert_array_equal(t_combine.numpy(), combine)
    if cf < 1:                          # the capacity dropped tokens
        assert float(t_dispatch.sum()) < b * s * K


def _flax_moe(impl: str, dname: str, **kw):
    jdt, tdt = DTYPES[dname]
    mod = jax_moe.MoEFFN(H, FFN, E, top_k=K, dtype=jdt, impl=impl, **kw)
    x = np.random.default_rng(3).standard_normal((2, 24, H)).astype(
        np.float32)
    params = _perturb(mod.init(jax.random.PRNGKey(4), x)["params"], 5)
    port = moe.MoEFFN(H, FFN, E, top_k=K, dtype=tdt, impl=impl,
                      ragged_chunk=kw.get("ragged_chunk", moe.RAGGED_CHUNK),
                      ragged_f_chunk=kw.get("ragged_f_chunk", 0))
    port.load_state_dict(convert.moe_params_from_flax(params))
    return mod, params, port, x


@pytest.mark.parametrize("impl,dname,kw", [
    ("einsum", "float32", {}), ("einsum", "bfloat16", {}),
    ("ragged", "float32", {}), ("ragged", "bfloat16", {}),
    ("ragged", "float32", {"ragged_chunk": 16}),
    ("ragged", "float32", {"ragged_f_chunk": 40}),
    ("ragged", "bfloat16", {"ragged_f_chunk": 40})])
def test_moe_ffn_matches_jax(impl, dname, kw):
    mod, params, port, x = _flax_moe(impl, dname, **kw)
    g = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def loss(p, x):
        y, col = mod.apply({"params": p}, x.astype(DTYPES[dname][0]),
                           mutable=["losses"])
        aux = jax.tree_util.tree_leaves(col["losses"])[0]
        return jnp.sum(y.astype(jnp.float32) * g) + 0.01 * aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, x)
    probs = np.asarray(jax.nn.softmax(
        jnp.asarray(x) @ params["router"]["kernel"], axis=-1))
    ties = _near_ties(probs, K)
    tx = torch.from_numpy(x).requires_grad_()
    ty, t_aux, dropped = port(tx.to(DTYPES[dname][1]))
    out_tol, _, grad_tol = TOL[dname]
    what = f"{impl} {dname} {kw} (router near-ties: {ties})"
    _close(ty, y, out_tol, f"output {what}")
    _close(t_aux, aux, 1e-6, f"aux {what}")
    if impl == "ragged":
        assert float(dropped) == 0.0
    ((ty.float() * torch.from_numpy(g)).sum() + 0.01 * t_aux).backward()
    _close(tx.grad, gx, grad_tol, f"dx {what}")
    _close_tree({k: p.grad for k, p in port.named_parameters()},
                convert.moe_params_from_flax(_np_tree(gp)), grad_tol,
                f"grad {what}")


def test_ragged_equals_einsum_without_drops():
    """At a capacity of the whole row nothing drops, and the two
    dispatches compute one function (float32, 1e-5)."""
    torch.manual_seed(0)
    s = 16
    cf = E / K                          # capacity == s
    ein = moe.MoEFFN(H, FFN, E, top_k=K, capacity_factor=cf)
    ein.init_weights(torch.Generator().manual_seed(1))
    rag = moe.MoEFFN(H, FFN, E, top_k=K, impl="ragged")
    rag.load_state_dict(ein.state_dict())
    x = torch.randn(3, s, H)
    y_e, aux_e, drop_e = ein(x)
    y_r, aux_r, drop_r = rag(x)
    assert moe.capacity(cf, K, s, E) == s and float(drop_e) == 0.0
    _close(y_r, y_e.detach().numpy(), 1e-5, "ragged vs einsum")
    assert float(aux_r.detach()) == float(aux_e.detach())
    assert float(drop_r) == 0.0
    # the same module, its impl overridden (the serving route)
    _close(ein(x, impl="ragged")[0], y_e.detach().numpy(), 1e-5, "override")


@functools.lru_cache(maxsize=None)
def _tiny(dname: str, impl: str, moe_impl: str):
    jdt, _ = DTYPES[dname]
    model = jax_gpt.moe_tiny(dtype=jdt, attention_impl=impl,
                             moe_impl=moe_impl)
    params = _perturb(model.init(jax.random.PRNGKey(2),
                                 jnp.zeros((1, 8), jnp.int32),
                                 train=False)["params"], 7)
    return model, params


def _port_tiny(params, dname, impl, moe_impl):
    port = gpt.moe_tiny(dtype=DTYPES[dname][1], attention_impl=impl,
                        moe_impl=moe_impl)
    port.load_state_dict(convert.gpt_params_from_flax(params))   # strict
    return port.eval()


def _jax_loss(model, params, batch, fused_xent=False):
    """The JAX text loss with the sown aux terms, as
    ``_loss_and_updates`` adds them."""
    tokens, targets, weights = batch
    logits, col = model.apply({"params": params}, tokens, train=False,
                              mutable=["losses"])
    if fused_xent:
        from tpu_hc_bench.ops import softmax_xent

        b, s, v = logits.shape
        losses = softmax_xent(logits.reshape(b * s, v),
                              targets.reshape(b * s)).reshape(b, s)
    else:
        losses = optax.softmax_cross_entropy_with_integer_labels(logits,
                                                                 targets)
    loss = (losses * weights).sum() / jnp.maximum(weights.sum(), 1.0)
    aux = sum(jnp.sum(t) for t in jax.tree_util.tree_leaves(col["losses"]))
    return loss + jax_moe.AUX_LOSS_COEF * aux, (logits, aux)


def _jax_routes(model, params, tokens):
    """The JAX forward's logits and each layer's top-k choices ``[B, S,
    k]``, from one op-by-op call (eager, as the port runs: a jitted call
    fuses, and so rounds and routes, otherwise in bfloat16)."""
    logits, col = model.apply({"params": params}, tokens, train=False,
                              capture_intermediates=True,
                              mutable=["intermediates", "losses"])
    inter = col["intermediates"]
    out = []
    for i in range(model.num_layers):
        router = inter[f"layer_{i}"]["moe"]["router"]["__call__"][0]
        _, _, choices, _ = jax_moe.topk_select(jax.nn.softmax(router, -1), K)
        out.append(np.stack([np.asarray(c) for c in choices], -1))
    return np.asarray(logits), out


def _port_routes(port, tokens, monkeypatch):
    """The port's logits and each layer's top-k choices."""
    seen = []
    route = moe.MoEFFN.route

    def recording(self, x):
        p = route(self, x)
        seen.append(torch.stack(moe.topk_select(p.detach(), K)[2],
                                -1).numpy())
        return p

    monkeypatch.setattr(moe.MoEFFN, "route", recording)
    with torch.no_grad():
        logits = port(tokens)
    monkeypatch.setattr(moe.MoEFFN, "route", route)
    return logits, seen


@pytest.mark.parametrize("dname,impl,moe_impl", [
    ("float32", "flash", "einsum"), ("float32", "dense", "ragged"),
    ("bfloat16", "flash", "einsum")])
def test_moe_tiny_matches_jax(dname, impl, moe_impl, monkeypatch):
    """Logits, the loss with its aux term, and every gradient.  Every
    layer's routing is compared too: in float32 it must agree for every
    token.  In bfloat16 the router reads an input rounded along another
    path, and a token at a near tie may take another expert, which moves
    its own logits and, through causal attention (and, under einsum,
    the expert queues), every later token of its row.  There the loss
    and aux term are held, and the logits of each row's tokens before
    its first routing difference; the differences are listed; the
    layer's gradients in bfloat16 are held in ``test_moe_ffn_matches_jax``."""
    model, params = _tiny(dname, impl, moe_impl)
    batch = SyntheticTokens(2, 64, VOCAB, seed=8, causal_lm=True).batch()
    (loss, (_, aux)), grads = jax.jit(jax.value_and_grad(
        functools.partial(_jax_loss, model), has_aux=True))(params, batch)
    port = _port_tiny(params, dname, impl, moe_impl)
    t_batch = tokens_to_device(batch, torch.device("cpu"))
    t_logits, routes = _port_routes(port, t_batch[0], monkeypatch)
    logits, jax_routes = _jax_routes(model, params, batch[0])
    diverged = np.zeros(t_batch[0].shape, bool)
    for got, want in zip(routes, jax_routes):
        diverged |= (got != want).any(-1)
    where = np.argwhere(diverged).tolist()
    _, net_tol, grad_tol = TOL[dname]
    if dname == "float32":
        assert not where, f"routing differs at (row, token) {where}"
    first = [int(np.argmax(r)) if r.any() else r.size for r in diverged]
    for row, n in enumerate(first):
        _close(t_logits[row, :n], logits[row, :n], net_tol,
               f"logits row {row} before token {n} (routing differs at "
               f"{where})")
    assert sum(first) >= t_batch[0].numel() // 4, where
    t_loss = step_mod.batch_loss(port, t_batch)
    _close(port.aux_loss, aux, net_tol, "aux")
    assert abs(float(t_loss.detach()) - float(loss)) <= \
        net_tol * abs(float(loss))
    if dname != "float32":
        return
    t_loss.backward()
    _close_tree({k: p.grad for k, p in port.named_parameters()},
                convert.gpt_params_from_flax(_np_tree(grads)), grad_tol,
                "grad")


def test_moe_tiny_two_train_steps_with_fused_xent_match_jax():
    """Two momentum-SGD steps of moe_tiny (float32, flash, einsum,
    ``--fused_xent``, dropout off): the losses with their aux terms and
    the parameters after them."""
    model, params = _tiny("float32", "flash", "einsum")
    batch = SyntheticTokens(2, 64, VOCAB, seed=9, causal_lm=True).batch()
    jcfg = jax_flags.BenchmarkConfig()
    tx = jax_step.make_optimizer(jcfg)
    state = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
        opt_state=tx.init(params),
        apply_fn=lambda v, x, train, rngs, mutable: model.apply(
            v, x, train=False, rngs=rngs, mutable=mutable),
        tx=tx)

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

    cfg = flags.BenchmarkConfig(device="cpu", model="moe_tiny",
                                fused_xent=True).resolve()
    port_state = step_mod.make_train_state(
        _port_tiny(params, "float32", "flash", "einsum"), cfg)
    port_state.model.eval()                    # dropout off, as JAX above
    assert port_state.fused_xent
    t_batch = tokens_to_device(batch, torch.device("cpu"))
    for i in range(2):
        state, loss = jax_step_fn(state)
        port_state, metrics = step_mod.train_step(port_state, t_batch)
        assert abs(float(metrics["loss"]) - float(loss)) <= \
            1e-4 * abs(float(loss)), i
    _close_tree(port_state.model.state_dict(),
                convert.gpt_params_from_flax(_np_tree(state.params)), 1e-4,
                "param")


def test_moe_registry_rows_flags_and_guards():
    for name, flops, shape, experts in (
            ("gpt2_moe", 2 * 180e6 * 1024, (1024,), 8),
            ("moe_tiny", 2 * 3e6 * 64, (64,), 4)):
        spec = get_model_spec(name)
        assert spec.moe and spec.causal_lm and spec.is_text
        assert (spec.flops_per_example, spec.input_shape) == (flops, shape)
        with torch.device("meta"):
            m = spec.create()
        assert (m.num_experts, m.top_k) == (experts, 2)
    with torch.device("meta"):
        big = gpt.gpt2_moe()
    ref = jax_gpt.gpt2_moe()
    assert (big.num_layers, big.hidden, big.num_experts, big.ffn) == (
        ref.num_layers, ref.hidden, ref.num_experts, ref.ffn)
    model, _ = create_model("moe_tiny", torch.bfloat16, "flash",
                            device="cpu", seed=1, train=True,
                            moe_impl="ragged", moe_f_chunk=64)
    blk = model.layers[0].moe
    assert (blk.impl, blk.ragged_f_chunk, blk.dtype) == ("ragged", 64,
                                                         torch.bfloat16)
    assert blk.wi.shape == (4, 128, 256) and blk.router.weight.shape == (4,
                                                                         128)
    for kw, match in ((dict(moe_impl="ragged"), "MoE members"),
                      (dict(moe_capacity_factor=0.5), "MoE members"),
                      (dict(moe_f_chunk=8), "MoE members")):
        with pytest.raises(ValueError, match=match):
            create_model("gpt2", device="cpu", seq_len=64, **kw)
    cfg = flags.parse_benchmark_flags(["--model=gpt2_moe", "--moe_impl=auto",
                                       "--moe_capacity_factor=2.0"])
    assert cfg.moe_impl == "einsum" and "moe_impl" in cfg.translations
    assert cfg.moe_capacity_factor == 2.0
    cfg = flags.parse_benchmark_flags(["--model=gpt2_moe", "--moe_impl=auto",
                                       "--seq_len=4096", "--moe_f_chunk=512"])
    assert (cfg.moe_impl, cfg.moe_f_chunk) == ("ragged", 512)
    assert jax_flags.BenchmarkConfig().moe_capacity_factor == \
        flags.BenchmarkConfig().moe_capacity_factor
    for bad, match in ((["--model=gpt2", "--moe_impl=auto"], "MoE members"),
                       (["--model=gpt2_moe", "--moe_impl=ragged",
                         "--moe_capacity_factor=2"], "einsum dispatch"),
                       (["--moe_impl=sparse"], "einsum|ragged|auto"),
                       (["--moe_f_chunk=-1"], ">= 0")):
        with pytest.raises(ValueError, match=match):
            flags.parse_benchmark_flags(bad)
