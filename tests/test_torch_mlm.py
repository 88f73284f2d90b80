"""The port's ``--fused_xent`` arm, BERT masked-LM training and the
max-pool VJP against the JAX package, on the CPU.

- **xent**: ``softmax_xent`` (the kernels' plain version on CPU
  tensors) against the JAX ``softmax_xent`` (Pallas interpret mode) at
  the JAX tests' four shapes: the losses at rtol/atol 1e-5 (float32
  logsumexps over up to 30522 terms in another order), the gradient of a
  weighted sum at rtol 1e-4 / atol 1e-5 (one exp of a logit less its
  lse, times the weight); bfloat16 logits at 1e-2 (the gradient is
  rounded to bf16, 2^-8 relative); logits scaled by 1e4 stay finite.
- **max_pool**: forward and gradient against the JAX ``max_pool`` at the
  JAX tests' five configurations on tie-free float32 input at 1e-6; a
  bfloat16 input with ties against the JAX kernel itself within one bf16
  ulp of the gradient; each fallback condition routes to the first max,
  as XLA's select-and-scatter does.
- **BERT**: ``TransformerLayer`` and a narrow ``BertMLM`` (bert_tiny's
  widths, two layers) through ``bert_params_from_flax``, dropout off:
  outputs, the weighted MLM loss and every gradient, with the tolerances
  of ``tests/test_torch_lm.py`` (float32 1e-5 outputs, 1e-4 logits,
  losses and gradients; bfloat16 2e-2 outputs and loss, 5e-2
  gradients, each relative to the reference's largest magnitude) but
  for BERT's bfloat16 logits, held to 5e-2: post-LN renormalises after
  every layer, and the MLM head adds a dense, a GELU and a LayerNorm in
  bf16 before the tied product, so the last-bit flips of two sums in
  another order grow to a few ulps (2^-8 each) of the head's input,
  which the 128-term product carries into every logit.
- **the loss arm**: ``batch_loss`` with ``fused_xent`` on and off against
  the JAX ``_loss_and_updates(..., fused_xent=True)``, for bert_tiny and
  a narrow GPT; two momentum-SGD steps of bert_tiny; the flags and the
  launcher on the CPU at bert_base's full width.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_hc_bench import flags as jax_flags
from tpu_hc_bench.models import bert as jax_bert
from tpu_hc_bench.models import gpt as jax_gpt
from tpu_hc_bench.ops.pool_bwd import _pool_bwd as jax_pool_bwd
from tpu_hc_bench.ops.pool_bwd import _pool_fwd as jax_pool_fwd
from tpu_hc_bench.ops.pool_bwd import max_pool as jax_max_pool
from tpu_hc_bench.ops.xent import softmax_xent as jax_softmax_xent
from tpu_hc_bench.train import step as jax_step
from tpu_hc_bench_torch import convert, flags, launcher
from tpu_hc_bench_torch.data.synthetic import (SyntheticTokens,
                                               tokens_to_device)
from tpu_hc_bench_torch.models import bert, create_model, get_model_spec, gpt
from tpu_hc_bench_torch.ops import pool_bwd
from tpu_hc_bench_torch.ops.flash_attention import flash_attention
from tpu_hc_bench_torch.ops.pool_bwd import (max_pool, max_pool_bwd,
                                             max_pool_bwd_plain)
from tpu_hc_bench_torch.ops.xent import (softmax_xent, softmax_xent_plain,
                                         softmax_xent_reference,
                                         xent_bwd_plain, xent_fwd_plain)
from tpu_hc_bench_torch.train import step as step_mod
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=1024, hidden=128, num_layers=2, heads=4, ffn=512,
            max_len=128)                 # bert_tiny's widths, two layers
GPT_NARROW = dict(vocab_size=1024, hidden=128, num_layers=2, heads=4,
                  ffn=512, max_len=128)
TOL = {  # dtype -> (module outputs, network logits and loss, gradients)
    "float32": (1e-5, 1e-4, 1e-4),
    "bfloat16": (2e-2, 2e-2, 5e-2),
}
BERT_BF16_LOGITS_TOL = 5e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
XENT_CASES = [(128, 512), (256, 1024), (100, 700), (8, 30522)]
POOL_CONFIGS = [                         # tests/test_pool_bwd.py CONFIGS
    ((2, 17, 17, 8), (3, 3), (2, 2), "SAME"),
    ((2, 16, 16, 8), (3, 3), (2, 2), "VALID"),
    ((2, 14, 14, 8), (3, 3), (1, 1), "SAME"),
    ((2, 16, 16, 8), (2, 2), (2, 2), "VALID"),
    ((1, 13, 15, 8), (3, 3), (2, 2), "SAME"),
]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(params, seed):
    """Seeded noise on every leaf, so the zero biases and unit LayerNorms
    of the Flax init carry information through the comparison."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: x + 0.1 * rng.standard_normal(x.shape).astype(np.float32),
        _np_tree(params))


def _close(got, want, tol, what):
    got = np.asarray(torch.as_tensor(got).detach().float())
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = max(float(np.abs(want).max()), 1.0)
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"


def _close_tree(got: dict, want: dict, tol, what):
    assert set(got) == set(want), (set(got) ^ set(want))
    for name in want:
        _close(got[name], want[name], tol, f"{what} {name}")


# --- softmax_xent -------------------------------------------------------------


def _xent_inputs(n, v, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    logits = (scale * rng.standard_normal((n, v))).astype(np.float32)
    labels = rng.integers(0, v, n).astype(np.int32)
    weights = rng.random(n).astype(np.float32)
    return logits, labels, weights


def _jax_xent_and_grad(logits, labels, weights):
    def f(x):
        return (jax_softmax_xent(x, jnp.asarray(labels)) * weights).sum()

    loss = jax_softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    return np.asarray(loss), np.asarray(jax.grad(f)(jnp.asarray(logits)))


def _port_xent_and_grad(logits, labels, weights, dtype=torch.float32):
    x = torch.from_numpy(logits).to(dtype).requires_grad_()
    loss = softmax_xent(x, torch.from_numpy(labels).long())
    (loss * torch.from_numpy(weights)).sum().backward()
    return loss.detach(), x.grad


@pytest.mark.parametrize("n,v", XENT_CASES)
def test_softmax_xent_matches_jax(n, v):
    logits, labels, weights = _xent_inputs(n, v, seed=n + v)
    want, want_grad = _jax_xent_and_grad(logits, labels, weights)
    got, grad = _port_xent_and_grad(logits, labels, weights)
    assert got.dtype == torch.float32 and grad.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=1e-4,
                               atol=1e-5)


def test_softmax_xent_bf16_logits_match_jax():
    logits, labels, weights = _xent_inputs(100, 700, seed=1)
    lb = jnp.asarray(logits).astype(jnp.bfloat16)

    def f(x):
        return (jax_softmax_xent(x, jnp.asarray(labels)) * weights).sum()

    want = np.asarray(jax_softmax_xent(lb, jnp.asarray(labels)))
    want_grad = np.asarray(jax.grad(f)(lb).astype(jnp.float32))
    got, grad = _port_xent_and_grad(
        np.array(lb.astype(jnp.float32)), labels, weights, torch.bfloat16)
    assert grad.dtype == torch.bfloat16
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(grad.float().numpy(), want_grad, rtol=1e-2,
                               atol=1e-2)


def test_softmax_xent_large_logits_stay_finite_and_match_jax():
    logits, labels, weights = _xent_inputs(128, 512, seed=2, scale=1e4)
    want, want_grad = _jax_xent_and_grad(logits, labels, weights)
    got, grad = _port_xent_and_grad(logits, labels, weights)
    assert torch.isfinite(got).all() and torch.isfinite(grad).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=1e-4,
                               atol=1e-5)


def test_softmax_xent_labels_outside_the_vocab_take_no_label_logit():
    """A label outside ``[0, V)`` contributes no label logit and no
    one-hot, as the JAX kernel's iota compare gives (beyond JAX's padded
    width: a label in its pad columns reads the -1e30 pad); int32 labels
    as JAX's."""
    logits, labels, weights = _xent_inputs(4, 700, seed=3)
    labels[1], labels[2] = -1, 2000
    want, want_grad = _jax_xent_and_grad(logits, labels, weights)
    x = torch.from_numpy(logits).requires_grad_()
    got = softmax_xent(x, torch.from_numpy(labels))
    (got * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=1e-4,
                               atol=1e-5)


def test_softmax_xent_plain_parts_agree_with_the_reference():
    """The blocked forward equals the straight-line reference; the
    backward writes ``(softmax - onehot) * g``, and exactly 0 where g is
    0 (the MLM batch's unmasked rows)."""
    logits, labels, _ = _xent_inputs(50, 1300, seed=4)
    x, lab = torch.from_numpy(logits), torch.from_numpy(labels).long()
    loss, lse = xent_fwd_plain(x, lab)
    torch.testing.assert_close(loss, softmax_xent_reference(x, lab),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, torch.logsumexp(x, -1), rtol=1e-6,
                               atol=1e-5)
    g = torch.rand(50)
    g[::3] = 0.0
    d = xent_bwd_plain(x, lab, lse, g)
    want = (torch.softmax(x, -1)
            - torch.nn.functional.one_hot(lab, 1300)) * g[:, None]
    torch.testing.assert_close(d, want, rtol=1e-5, atol=1e-6)
    assert (d[::3] == 0).all()
    assert torch.equal(softmax_xent_plain(x, lab), softmax_xent(x, lab))


def test_softmax_xent_validation_and_cpu_counts_no_launch():
    before = dict(softmax_xent.launches)
    x = torch.zeros((4, 8), requires_grad=True)
    softmax_xent(x, torch.zeros(4, dtype=torch.int64)).sum().backward()
    assert softmax_xent.launches == before
    assert sorted(before) == ["bwd", "fwd"]
    for bad_x, bad_l, match in (
            (torch.zeros((4,)), torch.zeros(4, dtype=torch.int64), "N, V"),
            (torch.zeros((4, 8), dtype=torch.float64),
             torch.zeros(4, dtype=torch.int64), "float32"),
            (torch.zeros((4, 8)), torch.zeros(3, dtype=torch.int64),
             "labels"),
            (torch.zeros((4, 8)), torch.zeros(4), "labels")):
        with pytest.raises(ValueError, match=match):
            softmax_xent(bad_x, bad_l)


# --- max_pool -----------------------------------------------------------------


def _nchw(a):
    """An NHWC numpy array as the port's [B, C, H, W] channels_last."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("shape,win,st,pad", POOL_CONFIGS)
def test_max_pool_matches_jax(shape, win, st, pad):
    """Tie-free float32 input: the forward and ``grad(sum(y^2))``."""
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    want = jax_max_pool(jnp.asarray(x), win, st, pad)
    want_grad = jax.grad(
        lambda v: (jax_max_pool(v, win, st, pad) ** 2).sum())(jnp.asarray(x))
    tx = _nchw(x).requires_grad_()
    y = max_pool(tx, win, st, pad)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(_nhwc(y), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_nhwc(tx.grad), np.asarray(want_grad),
                               rtol=1e-6, atol=1e-6)
    assert tx.grad.is_contiguous(memory_format=torch.channels_last)


def test_max_pool_bf16_ties_split_as_the_jax_kernel():
    """bf16 input where ~1 % of windows tie: every tied max takes the
    full cotangent, as the JAX kernel (interpret mode) gives, within one
    bf16 ulp of the gradient."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 16, 16, 8),
                                     jnp.bfloat16).astype(jnp.float32))
    dy = np.random.default_rng(5).standard_normal((2, 8, 8, 8)).astype(
        np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    y, res = jax_pool_fwd(xb, (3, 3), (2, 2), "SAME")
    (want,) = jax_pool_bwd((3, 3), (2, 2), "SAME", res,
                           jnp.asarray(dy).astype(jnp.bfloat16))
    tx = _nchw(x).to(torch.bfloat16).requires_grad_()
    ty = max_pool(tx, (3, 3), (2, 2), "SAME")
    np.testing.assert_array_equal(_nhwc(ty),
                                  np.asarray(y.astype(jnp.float32)))
    ty.backward(_nchw(dy).to(torch.bfloat16))
    got, want = _nhwc(tx.grad), np.asarray(want.astype(jnp.float32))
    assert tx.grad.dtype == torch.bfloat16
    ulp = 2.0 ** -7 * np.maximum(np.abs(want), 2.0 ** -126)
    assert (np.abs(got - want) <= ulp).all()
    # the input has ties, and they split (first-max routing would differ)
    first_max = torch.func.vjp(
        lambda v: torch.nn.functional.max_pool2d(
            torch.nn.functional.pad(v, (0, 1, 0, 1), value=float("-inf")),
            3, 2), tx.detach().float())[1](_nchw(dy))[0]
    assert not np.allclose(_nhwc(first_max), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("win,st", [((3, 3), (2, 2)), ((3, 3), (1, 1))])
def test_max_pool_ragged_channels_ties_match_jax(dtype, win, st):
    """C = 13, not a multiple of the CUDA kernel's 4- or 8-channel vector
    (its scalar case), and an input of six values, where most windows
    tie: the port's backward (the plain version on the CPU) against the
    JAX kernel (interpret mode), every tied max taking the full
    cotangent; float32 bit for bit (the same f32 sums in the same tap
    order), bf16 within one ulp of the gradient."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(13 + st[0])
    x = rng.integers(-3, 3, (2, 11, 9, 13)).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    y, res = jax_pool_fwd(xj, win, st, "SAME")
    dy = rng.standard_normal(y.shape).astype(np.float32)
    (want,) = jax_pool_bwd(win, st, "SAME", res, jnp.asarray(dy).astype(jdt))
    tx = _nchw(x).to(tdt).requires_grad_()
    ty = max_pool(tx, win, st, "SAME")
    np.testing.assert_array_equal(_nhwc(ty), np.asarray(y.astype(
        jnp.float32)))
    ty.backward(_nchw(dy).to(tdt))
    got, want = _nhwc(tx.grad), np.asarray(want.astype(jnp.float32))
    assert tx.grad.dtype == tdt
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
    else:
        ulp = 2.0 ** -7 * np.maximum(np.abs(want), 2.0 ** -126)
        assert (np.abs(got - want) <= ulp).all()
    # most windows tie, and a tied element takes the full cotangent
    assert (np.abs(want) > np.abs(dy).max()).any()


def test_max_pool_plain_matches_the_bwd_rule():
    """``max_pool_bwd`` on a CPU tensor is the plain version."""
    x = _nchw(np.random.default_rng(6).standard_normal(
        (2, 13, 15, 8)).astype(np.float32))
    y = pool_bwd._pool_fwd(x, (3, 3), (2, 2), "SAME")
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
    before = max_pool.launches
    assert torch.equal(max_pool_bwd(x, y, dy),
                       max_pool_bwd_plain(x, y, dy))
    assert max_pool.launches == before


def _tied(shape):
    """Constant windows: every element ties with its window's max."""
    return np.full(shape, 0.5, np.float32)


@pytest.mark.parametrize("case", ["stride_gt_window", "neg_inf"])
def test_max_pool_fallbacks_route_to_the_first_max(case):
    """A stride above the window, or an input holding -inf, takes torch's
    own backward: on tied windows the cotangent goes to the first max
    only, as XLA's select-and-scatter in the JAX op's fallback."""
    if case == "stride_gt_window":
        x, win, st, pad = _tied((1, 10, 10, 8)), (2, 2), (3, 3), "VALID"
    else:
        x, win, st, pad = _tied((1, 10, 10, 8)), (3, 3), (2, 2), "SAME"
        x[0, :3, :3, :] = -np.inf
    want = jax.grad(lambda v: jax_max_pool(v, win, st, pad).sum())(
        jnp.asarray(x))
    tx = _nchw(x).requires_grad_()
    max_pool(tx, win, st, pad).sum().backward()
    assert np.isfinite(_nhwc(tx.grad)).all()
    np.testing.assert_array_equal(_nhwc(tx.grad), np.asarray(want))
    # tie-splitting would give every tied element the cotangent
    assert (_nhwc(tx.grad) == 0).mean() > 0.5


def test_max_pool_integer_input_routes_to_the_first_max():
    """An integer input runs torch's backward on its float32 image and
    casts back, as the JAX rule (called directly: integer primals have no
    autograd)."""
    x = np.asarray(jax.random.randint(jax.random.PRNGKey(4), (1, 8, 8, 8),
                                      -3, 3, jnp.int32))
    y, res = jax_pool_fwd(jnp.asarray(x), (2, 2), (2, 2), "VALID")
    (want,) = jax_pool_bwd((2, 2), (2, 2), "VALID", res, jnp.ones_like(y))
    tx = _nchw(x)
    ty = max_pool(tx, (2, 2), (2, 2), "VALID")
    np.testing.assert_array_equal(_nhwc(ty), np.asarray(y))
    dx = max_pool_bwd(tx, ty, torch.ones_like(ty), (2, 2), (2, 2), "VALID")
    assert dx.dtype == torch.int32
    np.testing.assert_array_equal(_nhwc(dx), np.asarray(want))


def test_max_pool_validation():
    with pytest.raises(ValueError, match="SAME|VALID"):
        max_pool(torch.zeros((1, 2, 8, 8)), padding="FULL")
    with pytest.raises(ValueError, match="B, C, H, W"):
        max_pool(torch.zeros((2, 8, 8)))
    assert pool_bwd.pool_dims((112, 112), (3, 3), (2, 2), "SAME") == (
        56, 56, (0, 1, 0, 1))
    assert nn.max_pool(jnp.zeros((1, 112, 112, 1)), (3, 3), (2, 2),
                       "SAME").shape[1:3] == (56, 56)


# --- BERT modules through the converter ------------------------------------


@pytest.mark.parametrize("dname,impl", [("float32", "flash"),
                                        ("bfloat16", "flash"),
                                        ("float32", "dense")])
def test_transformer_layer_matches_jax(dname, impl):
    jdt, tdt = DTYPES[dname]
    hidden, heads, ffn, s = 128, 4, 512, 100
    x = np.random.default_rng(7).standard_normal(
        (2, s, hidden)).astype(np.float32)
    g = np.random.default_rng(8).standard_normal(
        (2, s, hidden)).astype(np.float32)
    mod = jax_bert.TransformerLayer(hidden, heads, ffn, dtype=jdt,
                                    attention_impl=impl)
    params = _perturb(mod.init(jax.random.PRNGKey(3), x,
                               train=False)["params"], 9)

    def loss(p, x):
        y = mod.apply({"params": p}, x, train=False)
        return jnp.sum(y.astype(jnp.float32) * g), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    port = bert.TransformerLayer(hidden, heads, ffn, tdt, impl).eval()
    port.load_state_dict(convert.bert_layer_params_from_flax(params))
    tx = torch.from_numpy(x).requires_grad_()
    ty = port(tx)
    assert ty.dtype == tdt
    out_tol, _, grad_tol = TOL[dname]
    _close(ty, y, out_tol, "layer output")
    (ty.float() * torch.from_numpy(g)).sum().backward()
    _close(tx.grad, gx, grad_tol, "dx")
    _close_tree({k: p.grad for k, p in port.named_parameters()},
                convert.bert_layer_params_from_flax(_np_tree(gp)), grad_tol,
                "grad")


@functools.lru_cache(maxsize=None)
def _tiny(dname: str, impl: str):
    """A narrow Flax BertMLM and its perturbed params."""
    model = jax_bert.BertMLM(dtype=DTYPES[dname][0], attention_impl=impl,
                             **TINY)
    params = _perturb(model.init(jax.random.PRNGKey(4),
                                 jnp.zeros((1, 8), jnp.int32),
                                 train=False)["params"], 10)
    return model, params


def _tiny_twin(params, dname, impl):
    port = bert.BertMLM(dtype=DTYPES[dname][1], attention_impl=impl, **TINY)
    port.load_state_dict(convert.bert_params_from_flax(params))  # strict
    return port.eval()


def _mlm_batch(seed, b=2, s=64):
    return SyntheticTokens(b, s, TINY["vocab_size"], seed=seed).batch()


def _jax_mlm_loss(model, params, batch, fused_xent=False):
    tokens, targets, weights = batch
    logits = model.apply({"params": params}, tokens, train=False)
    if fused_xent:
        b, s, v = logits.shape
        losses = jax_softmax_xent(logits.reshape(b * s, v),
                                  targets.reshape(b * s)).reshape(b, s)
    else:
        losses = optax.softmax_cross_entropy_with_integer_labels(logits,
                                                                 targets)
    return (losses * weights).sum() / jnp.maximum(weights.sum(), 1.0), logits


@pytest.mark.parametrize("dname,impl,fused", [("float32", "flash", True),
                                              ("bfloat16", "flash", True),
                                              ("float32", "dense", False)])
def test_bert_mlm_matches_jax(dname, impl, fused):
    """Logits, the weighted MLM loss and every gradient."""
    model, params = _tiny(dname, impl)
    batch = _mlm_batch(seed=11)
    (loss, logits), grads = jax.jit(jax.value_and_grad(functools.partial(
        _jax_mlm_loss, model, fused_xent=fused), has_aux=True))(params,
                                                                 batch)
    port = _tiny_twin(params, dname, impl)
    tokens, targets, weights = tokens_to_device(batch, torch.device("cpu"))
    t_logits = port(tokens)
    assert t_logits.dtype == torch.float32
    t_loss = step_mod.lm_loss_fn(t_logits, targets, weights, fused)
    _, net_tol, grad_tol = TOL[dname]
    _close(t_logits, logits, BERT_BF16_LOGITS_TOL if dname == "bfloat16"
           else net_tol, "logits")
    assert abs(float(t_loss.detach()) - float(loss)) <= \
        net_tol * abs(float(loss))
    t_loss.backward()
    _close_tree({k: p.grad for k, p in port.named_parameters()},
                convert.bert_params_from_flax(_np_tree(grads)), grad_tol,
                "grad")


# --- the loss arm and the step ------------------------------------------------


def _jax_state(model, params):
    tx = jax_step.make_optimizer(jax_flags.BenchmarkConfig())
    return jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
        opt_state=tx.init(params),
        apply_fn=lambda v, x, train, rngs, mutable: model.apply(
            v, x, train=False, rngs=rngs, mutable=mutable),
        tx=tx)


@pytest.mark.parametrize("family", ["bert_tiny", "gpt_narrow"])
def test_batch_loss_fused_and_plain_arms_match_jax_fused_xent(family):
    """``batch_loss`` with ``fused_xent`` on and off against the JAX
    ``_loss_and_updates(..., fused_xent=True)``: the loss and every
    gradient, float32, dropout off."""
    if family == "bert_tiny":
        model, params = _tiny("float32", "flash")
        batch = _mlm_batch(seed=12)
        port_of, conv = _tiny_twin, convert.bert_params_from_flax
    else:
        model = jax_gpt.GPTLM(dtype=jnp.float32, attention_impl="flash",
                              **GPT_NARROW)
        params = _perturb(model.init(jax.random.PRNGKey(5),
                                     jnp.zeros((1, 8), jnp.int32),
                                     train=False)["params"], 13)
        batch = SyntheticTokens(2, 64, GPT_NARROW["vocab_size"], seed=12,
                                causal_lm=True).batch()

        def port_of(p, dname, impl):
            port = gpt.GPTLM(dtype=torch.float32, attention_impl=impl,
                             **GPT_NARROW)
            port.load_state_dict(convert.gpt_params_from_flax(p))
            return port.eval()
        conv = convert.gpt_params_from_flax
    state = _jax_state(model, params)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_step._loss_and_updates(
            state, p, batch, jax.random.PRNGKey(0), True, fused_xent=True),
        has_aux=True))(params)
    t_batch = tokens_to_device(batch, torch.device("cpu"))
    for fused in (True, False):
        port = port_of(params, "float32", "flash")
        t_loss = step_mod.batch_loss(port, t_batch, fused_xent=fused)
        assert abs(float(t_loss.detach()) - float(loss)) <= \
            1e-4 * abs(float(loss)), fused
        t_loss.backward()
        _close_tree({k: p.grad for k, p in port.named_parameters()},
                    conv(_np_tree(grads)), 1e-4, f"grad fused={fused}")


def test_two_bert_train_steps_match_jax():
    """Two momentum-SGD steps (lr 0.01, momentum 0.9) of the narrow
    float32 BERT with flash attention and ``--fused_xent``, dropout off:
    the losses and the parameters after them."""
    model, params = _tiny("float32", "flash")
    batch = _mlm_batch(seed=14)
    state = _jax_state(model, params)

    @jax.jit
    def jax_step_fn(state):
        def loss_fn(p):
            return jax_step._loss_and_updates(
                state, p, batch, jax.random.PRNGKey(0), True,
                fused_xent=True)
        (loss, _), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        updates, opt = state.tx.update(grads, state.opt_state, state.params)
        return state.replace(params=optax.apply_updates(state.params,
                                                        updates),
                             opt_state=opt), loss

    cfg = flags.BenchmarkConfig(device="cpu", model="bert_tiny",
                                fused_xent=True).resolve()
    port_state = step_mod.make_train_state(
        _tiny_twin(params, "float32", "flash"), cfg)
    assert port_state.fused_xent
    port_state.model.eval()                    # dropout off, as JAX above
    t_batch = tokens_to_device(batch, torch.device("cpu"))
    for i in range(2):
        state, loss = jax_step_fn(state)
        port_state, metrics = step_mod.train_step(port_state, t_batch)
        assert abs(float(metrics["loss"]) - float(loss)) <= \
            1e-4 * abs(float(loss)), i
    _close_tree(port_state.model.state_dict(),
                convert.bert_params_from_flax(_np_tree(state.params)), 1e-4,
                "param")


# --- registry, flags, entry points ------------------------------------------


def test_bert_registry_rows_and_widths():
    for name, shape, flops, vocab in (
            ("bert_base", (128,), 2 * 110e6 * 128, 30522),
            ("bert_large", (128,), 2 * 335e6 * 128, 30522),
            ("bert_tiny", (64,), 2 * 4.5e6 * 64, 1024)):
        spec = get_model_spec(name)
        assert spec.is_text and not spec.causal_lm
        assert (spec.input_shape, spec.flops_per_example,
                spec.vocab_size) == (shape, flops, vocab)
    with torch.device("meta"):
        base = bert.bert_base_mlm()
        large = bert.bert_large_mlm(max_len=1024)
    ref = jax_bert.bert_base_mlm()
    assert (base.num_layers, base.hidden, base.heads, base.max_len) == (
        ref.num_layers, ref.hidden, ref.heads, ref.max_len)
    assert sum(p.numel() for p in base.parameters()) == 109_512_762
    assert (large.num_layers, large.hidden, large.max_len) == (24, 1024,
                                                              1024)
    model, spec = create_model("bert_tiny", torch.bfloat16, "flash",
                               device="cpu", seed=3, train=True)
    assert model.dropout_generator is not None and model.training
    assert model.tok_embed.weight.shape == (1024, 128)
    assert model.pos_embed.weight.shape == (128, 128)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert float(model.mlm_bias.detach().abs().sum()) == 0.0
    # sequence parallelism is ported: a seq axis is kept, and the flag
    # takes the sequence-sharded impl (tests/test_torch_sequence.py)
    assert bert.BertMLM(**TINY, seq_axis="seq").seq_axis == "seq"
    assert flags.parse_benchmark_flags(
        ["--model=bert_tiny", "--sequence_parallel=2"]).attention_impl \
        == "ring"
    with pytest.raises(ValueError, match="mask"):
        bert.TransformerLayer(128, 4, 512)(torch.zeros((1, 4, 128)),
                                           torch.ones((1, 4)))


def test_fused_xent_flag_parses_and_reaches_the_step():
    cfg = flags.parse_benchmark_flags(["--model=bert_base",
                                       "--fused_xent=true",
                                       "--attention_impl=flash"])
    assert cfg.fused_xent is True
    assert flags.BenchmarkConfig().fused_xent is \
        jax_flags.BenchmarkConfig().fused_xent is False
    assert any("fused_xent=True" in ln for ln in cfg.summary_lines())
    assert "fused_xent" not in flags.LATER_SLICE_TRAIN_FLAGS
    assert flags.parse_benchmark_flags(["--fused_xent=FALSE"]).fused_xent \
        is False


def test_bert_base_launcher_on_the_cpu():
    """``python -m tpu_hc_bench_torch 1 1 2 sock --model=bert_base
    --device=cpu --fused_xent=true ...``: full width at seq 128, the xent
    and flash kernels' plain versions and no kernel launch."""
    before = (dict(softmax_xent.launches), dict(flash_attention.launches))
    lines: list[str] = []
    rc = launcher.main(["1", "1", "2", "sock", "--model=bert_base",
                        "--device=cpu", "--fused_xent=true",
                        "--attention_impl=flash", "--num_warmup_batches=1",
                        "--num_batches=2", "--display_every=1"],
                       print_fn=lines.append)
    assert rc == 0
    assert sum("\texamples/sec: " in ln for ln in lines) == 2
    result = json.loads(lines[-1], parse_constant=pytest.fail)
    assert result["model"] == "bert_base" and result["global_batch"] == 2
    assert result["fused_xent"] is True
    assert result["attention_impl"] == "flash"
    assert np.isfinite(result["final_loss"]) and result["mfu"] is None
    assert (dict(softmax_xent.launches),
            dict(flash_attention.launches)) == before


def test_mlm_lane_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, tpu_hc_bench_torch.ops, "
         "tpu_hc_bench_torch.ops.xent, tpu_hc_bench_torch.ops.pool_bwd, "
         "tpu_hc_bench_torch.models.bert, tpu_hc_bench_torch.models, "
         "tpu_hc_bench_torch.train.step; "
         "assert 'jax' not in sys.modules; "
         "assert 'tpu_hc_bench' not in sys.modules"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode == 0, proc.stderr


# --- the CUDA kernels against their plain versions (card only) ----------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested above)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,v", [(300, 50257), (64, 700), (5, 3)])
def test_xent_kernels_match_plain_on_card(cuda_device, dtype, n, v):
    """Loss and lse within 1e-5 relative; dlogits within 1e-5 of its
    largest magnitude (f32) or one bf16 ulp; one launch of each."""
    logits, labels, weights = _xent_inputs(n, v, seed=n)
    outs = []
    for dev in ("cpu", cuda_device):
        x = torch.from_numpy(logits).to(device=dev,
                                        dtype=dtype).requires_grad_()
        before = dict(softmax_xent.launches)
        loss = softmax_xent(x, torch.from_numpy(labels).long().to(dev))
        (loss * torch.from_numpy(weights).to(dev)).sum().backward()
        outs.append((loss.detach().cpu(), x.grad.cpu().float()))
    torch.cuda.synchronize()
    assert {k: softmax_xent.launches[k] - before[k] for k in before} == {
        "fwd": 1, "bwd": 1}
    (want, want_d), (got, got_d) = outs
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    tol = (2.0 ** -8 if dtype == torch.bfloat16 else 1e-5) * float(
        want_d.abs().max())
    assert float((got_d - want_d).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,win,st,pad", POOL_CONFIGS)
def test_pool_kernel_matches_plain_on_card(cuda_device, dtype, shape, win,
                                           st, pad):
    x = _nchw(np.random.default_rng(15).standard_normal(shape).astype(
        np.float32)).to(dtype)
    y = pool_bwd._pool_fwd(x, win, st, pad)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(1),
                     dtype=torch.float32).to(dtype)
    want = max_pool_bwd_plain(x, y, dy, win, st, pad)
    before = max_pool.launches
    got = max_pool_bwd(*(t.to(cuda_device) for t in (x, y, dy)), win, st,
                       pad)
    torch.cuda.synchronize()
    assert max_pool.launches == before + 1
    assert torch.equal(got.cpu(), want)
