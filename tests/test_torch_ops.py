"""The port's kernel modules against the JAX package's Pallas kernels.

The JAX side runs as its own tests run it on the CPU (Pallas interpret
mode); the port's wrappers run their plain PyTorch versions, which is
what a wrapper does with a CPU tensor.  Inputs are made with numpy from
a seed and handed to both.  The CUDA kernels themselves run only on the
card: the ``cuda``-marked tests hold them against the plain versions
there (``chip_smoke.py`` does the same at the main paths' shapes).

Tolerances: 2e-5 absolute for attention and 1e-5 for the norms, the
bounds the JAX package's own kernel tests use for float32.  The fused
BN-relu-conv3x3 is held to 1e-5 of each output's largest magnitude
(sums over up to 9 x 128 terms in another order) and its gradients to
1e-4 of the largest (a transposed conv, then sums over the batch).
Flash attention's output is held to the attention bound above and its
gradients to 1e-4 of the largest (a recompute of P from the lse, then
sums over the key or query tiles); its bf16 forward to 1e-2 of the
largest, one bf16 rounding (2^-8) of the output with room for a P
rounded the other way.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_hc_bench.ops import fused_conv as jax_fused_conv
from tpu_hc_bench.ops.flash_attention import (
    flash_attention as jax_flash_attention)
from tpu_hc_bench.ops.fused_residual_ln import (
    fused_residual_norm as jax_fused_residual_norm)
from tpu_hc_bench.ops.paged_attention import (
    paged_decode_attention as jax_paged_decode_attention)
from tpu_hc_bench_torch.ops import _build
from tpu_hc_bench_torch.ops import fused_conv as torch_fused_conv
from tpu_hc_bench_torch.ops.flash_attention import (
    bwd_blocks, bwd_design, delta_rows, flash_attention,
    flash_attention_plain, flash_dkv_plain, flash_dq_plain, flash_fwd_plain,
    fwd_blocks, fwd_design, padded_head_dim)
from tpu_hc_bench_torch.ops.fused_conv import (
    conv_design, eligible, fused_bn_relu_conv, fused_bn_relu_conv_plain)
from tpu_hc_bench_torch.ops.fused_residual_ln import (
    NormLaunch, fused_residual_norm, fused_residual_norm_plain, norm_design,
    norm_launch)
from tpu_hc_bench_torch.ops.paged_attention import (
    BLOCKS_PER_SM, MIN_SPLIT_TOKENS, paged_decode_attention,
    paged_decode_attention_plain, paged_splits, split_ranges, split_slots)
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

ATTN_ATOL = 2e-5
NORM_ATOL = 1e-5
CONV_TOL = 1e-5
CONV_GRAD_TOL = 1e-4
FLASH_GRAD_TOL = 1e-4
FLASH_BF16_TOL = 1e-2
# a bf16 pool against the JAX op, relative to the output's largest
# magnitude: out is rounded to bf16 (2^-8 of it) on both sides, and p is
# rounded to bf16 against the running max of another block order
PAGED_BF16_TOL = 1e-2


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --- paged decode attention -------------------------------------------


@pytest.mark.parametrize("b,heads,kvh,d,pages,ps,w,ppb", [
    (3, 4, 4, 16, 10, 4, 3, 1),      # MHA, one page per block
    (2, 8, 2, 32, 12, 8, 4, 2),      # GQA group 4, two pages per block
    (1, 2, 2, 8, 6, 4, 5, 4),        # width not divisible by the block
])
def test_paged_attention_matches_jax(b, heads, kvh, d, pages, ps, w, ppb):
    rng = np.random.default_rng(b * 100 + ppb)
    q = rng.standard_normal((b, heads, d)).astype(np.float32)
    kp = rng.standard_normal((pages, ps, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((pages, ps, kvh, d)).astype(np.float32)
    tables = rng.integers(0, pages, (b, w)).astype(np.int32)
    lengths = rng.integers(1, w * ps + 1, (b,)).astype(np.int32)
    want, want_lse = jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lengths), pages_per_block=ppb,
        return_lse=True)
    got, lse = paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(tables), _t(lengths),
        pages_per_block=ppb, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATTN_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=ATTN_ATOL)


def test_paged_attention_int8_scales_match_jax():
    """int8 pool + per-(layer, page) scales, a layer index into a 5-D
    pool, two pages per block: the JAX int8 kernel case."""
    rng = np.random.default_rng(3)
    L, pages, ps, kvh, d, b, heads, w = 3, 8, 4, 2, 16, 2, 4, 3
    kf = rng.standard_normal((L, pages, ps, kvh, d)).astype(np.float32)
    vf = rng.standard_normal((L, pages, ps, kvh, d)).astype(np.float32)
    ks = np.maximum(np.abs(kf).reshape(L, pages, -1).max(-1) / 127,
                    1e-8).astype(np.float32)
    vs = np.maximum(np.abs(vf).reshape(L, pages, -1).max(-1) / 127,
                    1e-8).astype(np.float32)
    kq = np.round(kf / ks[..., None, None, None]).astype(np.int8)
    vq = np.round(vf / vs[..., None, None, None]).astype(np.int8)
    q = rng.standard_normal((b, heads, d)).astype(np.float32)
    tables = rng.integers(0, pages, (b, w)).astype(np.int32)
    lengths = rng.integers(1, w * ps + 1, (b,)).astype(np.int32)
    want = jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(tables), jnp.asarray(lengths), layer=1,
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
        pages_per_block=2)
    got = paged_decode_attention(
        _t(q), _t(kq), _t(vq), _t(tables), _t(lengths), layer=1,
        k_scales=_t(ks), v_scales=_t(vs), pages_per_block=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATTN_ATOL)


def test_paged_attention_lse_merges_fresh_token():
    """softmax over [cache, fresh] == the output mixed with the fresh
    value through sigmoid(s_new - lse): the identity the paged decode
    program's write-after-attend order rests on."""
    rng = np.random.default_rng(7)
    b, heads, d, pages, ps, w = 2, 4, 16, 8, 4, 3
    q = rng.standard_normal((b, heads, d)).astype(np.float32)
    kp = rng.standard_normal((pages, ps, heads, d)).astype(np.float32)
    vp = rng.standard_normal((pages, ps, heads, d)).astype(np.float32)
    tables = rng.integers(0, pages, (b, w)).astype(np.int32)
    lengths = rng.integers(1, w * ps, (b,)).astype(np.int32)
    kf = rng.standard_normal((b, heads, d)).astype(np.float32)
    vf = rng.standard_normal((b, heads, d)).astype(np.float32)

    out, lse = paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(tables), _t(lengths), return_lse=True)
    s_new = np.einsum("bhd,bhd->bh", q, kf) / d ** 0.5
    w_new = torch.sigmoid(_t(s_new) - lse).numpy()
    got = out.numpy() * (1 - w_new)[..., None] + vf * w_new[..., None]

    kc = kp[tables].reshape(b, w * ps, heads, d)
    vc = vp[tables].reshape(b, w * ps, heads, d)
    mask = np.arange(w * ps)[None, :] < lengths[:, None]
    s = np.einsum("bhd,bkhd->bhk", q, kc) / d ** 0.5
    s = np.where(mask[:, None, :], s, -1e30)
    s_full = np.concatenate([s, s_new[:, :, None]], axis=-1)
    p = np.exp(s_full - s_full.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    v_full = np.concatenate([vc, vf[:, None]], axis=1)
    want = np.einsum("bhk,bkhd->bhd", p, v_full)
    np.testing.assert_allclose(got, want, atol=ATTN_ATOL)


def test_paged_attention_padded_row_gives_zero_and_finite_lse():
    """A padded batch slot (length 0, table all trash page 0) gives out 0
    and a finite lse near -1e30, so sigmoid(s_new - lse) puts weight 1
    on the fresh token — and the JAX kernel agrees."""
    rng = np.random.default_rng(5)
    b, heads, kvh, d, pages, ps, w = 2, 8, 2, 16, 5, 4, 3
    q = rng.standard_normal((b, heads, d)).astype(np.float32)
    kp = rng.standard_normal((pages, ps, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((pages, ps, kvh, d)).astype(np.float32)
    tables = np.array([[1, 2, 3], [0, 0, 0]], np.int32)
    lengths = np.array([7, 0], np.int32)
    out, lse = paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(tables), _t(lengths), return_lse=True)
    assert (out[1] == 0).all()
    assert torch.isfinite(lse).all() and (lse[1] < -1e29).all()
    w_new = torch.sigmoid(torch.zeros(heads) - lse[1])
    assert (w_new == 1).all()
    want_out, want_lse = jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lengths), return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               atol=ATTN_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               rtol=1e-6)


def _split_case(kind, seed):
    """GQA group 4, 16-token pages, a 3-layer pool; rows of length 0, 1,
    a ragged one and a full table, so a row past a split's start leaves
    its later splits empty."""
    rng = np.random.default_rng(seed)
    L, pages, ps, kvh, d, b, heads, w = 3, 24, 4, 2, 16, 4, 8, 7
    kf = rng.standard_normal((L, pages, ps, kvh, d)).astype(np.float32)
    vf = rng.standard_normal((L, pages, ps, kvh, d)).astype(np.float32)
    q = rng.standard_normal((b, heads, d)).astype(np.float32)
    tables = rng.integers(1, pages, (b, w)).astype(np.int32)
    tables[0] = 0                                   # a padded row
    lengths = np.array([0, 1, 13, w * ps], np.int32)
    kw = {}
    if kind == "int8":
        ks = np.maximum(np.abs(kf).reshape(L, pages, -1).max(-1) / 127,
                        1e-8).astype(np.float32)
        vs = np.maximum(np.abs(vf).reshape(L, pages, -1).max(-1) / 127,
                        1e-8).astype(np.float32)
        kf = np.round(kf / ks[..., None, None, None]).astype(np.int8)
        vf = np.round(vf / vs[..., None, None, None]).astype(np.int8)
        kw = {"k_scales": ks, "v_scales": vs}
    return (q, kf, vf, tables, lengths), kw


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_paged_split_plain_matches_jax(kind, splits):
    """The split plain version (the kernels' split-and-merge: a partial
    softmax per range of table slots, merged in split order) against the
    JAX op in interpret mode, two pages per block, layer 2: out and lse
    within the attention bound; the padded row gives out 0 and lse below
    -1e29 on both sides."""
    (q, kf, vf, tables, lengths), kw = _split_case(kind, seed=splits)
    want, want_lse = jax_paged_decode_attention(
        *(jnp.asarray(a) for a in (q, kf, vf, tables, lengths)), layer=2,
        pages_per_block=2, return_lse=True,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got, lse = paged_decode_attention_plain(
        *(_t(a) for a in (q, kf, vf, tables, lengths)), layer=2,
        pages_per_block=2, return_lse=True, splits=splits,
        **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATTN_ATOL)
    np.testing.assert_allclose(lse[1:].numpy(), np.asarray(want_lse)[1:],
                               atol=ATTN_ATOL)
    assert (got[0] == 0).all() and (lse[0] < -1e29).all()
    assert (np.asarray(want_lse)[0] < -1e29).all()


@pytest.mark.parametrize("q_bf16", [True, False])
@pytest.mark.parametrize("splits", [None, 3])
def test_paged_bf16_pool_plain_matches_jax(q_bf16, splits):
    """A bf16 pool, p rounded to bf16 before P V as the JAX op rounds it,
    out in q's dtype: within PAGED_BF16_TOL of the output's largest
    magnitude; lse (f32 on both sides, from the same bf16 inputs) within
    the attention bound."""
    (q, kf, vf, tables, lengths), _ = _split_case("f32", seed=11)
    jq = jnp.asarray(q).astype(jnp.bfloat16 if q_bf16 else jnp.float32)
    jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (kf, vf))
    want, want_lse = jax_paged_decode_attention(
        jq, jk, jv, jnp.asarray(tables), jnp.asarray(lengths), layer=1,
        pages_per_block=2, return_lse=True)
    tq = _t(np.asarray(jq.astype(jnp.float32))).to(
        torch.bfloat16 if q_bf16 else torch.float32)
    tk, tv = (_t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
              for a in (jk, jv))
    got, lse = paged_decode_attention_plain(
        tq, tk, tv, _t(tables), _t(lengths), layer=1, pages_per_block=2,
        return_lse=True, splits=splits)
    assert got.dtype == tq.dtype
    want = np.asarray(want.astype(jnp.float32))
    _close_rel(got.float(), want, PAGED_BF16_TOL, "out")
    np.testing.assert_allclose(lse[1:].numpy(), np.asarray(want_lse)[1:],
                               atol=ATTN_ATOL)


@pytest.mark.parametrize("d", [20, 80, 96])
@pytest.mark.parametrize("pool", ["f32", "bf16"])
def test_paged_attention_off_list_head_dims_match_jax(d, pool):
    """Head dims off the kernels' template list (on the card 80 and 96 run
    the 128 case masked to d, 20 the 32 case, with scalar loads for a
    bf16 pool: 40 bytes a row): the CPU route against the JAX op in
    interpret mode, GQA group 2, two pages a block, layer 1 of a 2-layer
    pool, a row of length 0.  f32 within the attention bound; bf16 (q and
    pools, out in bf16) within PAGED_BF16_TOL of the largest magnitude;
    lse within the attention bound; the length-0 row gives out 0 and lse
    below -1e29 on both sides."""
    rng = np.random.default_rng(d)
    L, pages, ps, kvh, b, heads, w = 2, 12, 4, 2, 3, 4, 5
    q = rng.standard_normal((b, heads, d)).astype(np.float32)
    kf, vf = (rng.standard_normal((L, pages, ps, kvh, d)).astype(np.float32)
              for _ in range(2))
    tables = rng.integers(1, pages, (b, w)).astype(np.int32)
    tables[1] = 0                                   # the padded row
    lengths = np.array([w * ps, 0, 9], np.int32)
    jdt = jnp.bfloat16 if pool == "bf16" else jnp.float32
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, kf, vf))
    want, want_lse = jax_paged_decode_attention(
        jq, jk, jv, jnp.asarray(tables), jnp.asarray(lengths), layer=1,
        pages_per_block=2, return_lse=True)
    tdt = torch.bfloat16 if pool == "bf16" else torch.float32
    tq, tk, tv = (_t(np.asarray(a.astype(jnp.float32))).to(tdt)
                  for a in (jq, jk, jv))
    got, lse = paged_decode_attention(
        tq, tk, tv, _t(tables), _t(lengths), layer=1, pages_per_block=2,
        return_lse=True)
    assert got.dtype == tdt and got.shape == (b, heads, d)
    want = np.asarray(want.astype(jnp.float32))
    if pool == "bf16":
        _close_rel(got.float(), want, PAGED_BF16_TOL, "out")
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=ATTN_ATOL)
    np.testing.assert_allclose(lse[[0, 2]].numpy(),
                               np.asarray(want_lse)[[0, 2]], atol=ATTN_ATOL)
    assert (got[1] == 0).all() and (lse[1] < -1e29).all()
    assert (np.asarray(want_lse)[1] < -1e29).all()


def test_paged_bf16_plain_rounds_p_as_the_kernel():
    """The plain version rounds p to bf16 before P V for a bf16 pool (l
    sums the unrounded p), as the JAX op and the kernel do, and keeps it
    in f32 for an f32 pool: one page of three keys whose scores are
    about 0, -1 and -2 (p not bf16 values)."""
    d, ps = 8, 3
    q = torch.zeros((1, 1, d))
    q[0, 0, 0] = 1.0
    k = torch.zeros((1, ps, 1, d))
    k[0, :, 0, 0] = torch.tensor([0.0, -1.0, -2.0]) * d ** 0.5
    k = k.bfloat16().float()           # the same keys in both pools
    v = torch.zeros((1, ps, 1, d))
    v[0, :, 0, 0] = torch.tensor([1.0, 2.0, 4.0])
    tbl = torch.zeros((1, 1), dtype=torch.int32)
    ln = torch.tensor([ps], dtype=torch.int32)
    kb, vb = k.bfloat16(), v.bfloat16()
    s = (kb.float()[0, :, 0] @ q[0, 0]) / d ** 0.5
    p = torch.exp(s - s.max())
    want_rounded = (p.bfloat16().float() @ vb.float()[0, :, 0, 0]) / p.sum()
    want_exact = (p @ v[0, :, 0, 0]) / p.sum()
    rounded = paged_decode_attention_plain(q, kb, vb, tbl, ln)
    exact = paged_decode_attention_plain(q, k, v, tbl, ln)
    assert abs(float(rounded[0, 0, 0]) - float(want_rounded)) <= 1e-6
    assert abs(float(exact[0, 0, 0]) - float(want_exact)) <= 1e-6
    assert abs(float(want_rounded) - float(want_exact)) > 1e-5


@pytest.mark.parametrize("b,kvh,w,ps,ppb,sm", [
    (8, 8, 36, 16, 1, 132),       # llama_1b decode
    (8, 8, 36, 16, 2, 132),
    (8, 8, 256, 16, 1, 132),      # long context
    (1, 1, 1, 16, 1, 132),        # one slot
    (0, 8, 36, 16, 1, 132),       # no rows
    (64, 8, 36, 16, 4, 132),      # already above two blocks an SM
    (2, 2, 37, 4, 3, 8),          # w not a multiple of pages_per_block
    (1, 8, 5, 64, 1, 132),        # big pages: one split keeps 64 tokens
])
def test_paged_splits_rule(b, kvh, w, ps, ppb, sm):
    """``paged_splits`` gives at least one split, none empty, each a
    whole number of ``pages_per_block`` blocks (the last shorter), the
    ranges covering every table slot exactly once, at least
    MIN_SPLIT_TOKENS a split where the table holds that many, and about
    BLOCKS_PER_SM blocks an SM where the table is long enough."""
    splits = paged_splits(b, kvh, w, ps, ppb, sm)
    assert splits >= 1
    n, per = split_slots(w, ppb, splits)
    assert n == splits and per % min(ppb, w) == 0
    ranges = split_ranges(w, ppb, splits)
    assert len(ranges) == splits
    assert all(stop > start for start, stop in ranges)
    covered = [s for start, stop in ranges for s in range(start, stop)]
    assert covered == list(range(w))
    if w * ps >= MIN_SPLIT_TOKENS:
        assert per * ps >= MIN_SPLIT_TOKENS or splits == 1
    if b * kvh and w >= 64:
        # a long table is split far enough to fill the card (the cut to
        # no empty split gives back at most one split here)
        assert b * kvh * (splits + 1) >= BLOCKS_PER_SM * sm


def test_paged_split_count_is_normalized():
    """An explicit split count is cut to one that leaves no split empty
    (3 slots in 7 splits: 3), and both the plain version and the ranges
    use it."""
    assert split_slots(3, 1, 7) == (3, 1)
    assert split_slots(36, 1, 5) == (5, 8)
    assert split_slots(37, 3, 4) == (4, 12)
    assert split_ranges(37, 3, 4) == [(0, 12), (12, 24), (24, 36),
                                      (36, 37)]


def test_paged_attention_validation_matches_jax():
    def both(*shapes_dtypes):
        (qs, pool, pdt, tbl, ln) = shapes_dtypes
        jax_args = (jnp.zeros(qs), jnp.zeros(pool, pdt),
                    jnp.zeros(pool, pdt), jnp.zeros(tbl, jnp.int32),
                    jnp.zeros(ln, jnp.int32))
        tdt = torch.int8 if pdt == jnp.int8 else torch.float32
        torch_args = (torch.zeros(qs), torch.zeros(pool, dtype=tdt),
                      torch.zeros(pool, dtype=tdt),
                      torch.zeros(tbl, dtype=torch.int32),
                      torch.zeros(ln, dtype=torch.int32))
        return jax_args, torch_args

    for match, case in (
            ("kv_heads", ((1, 3, 8), (4, 4, 2, 8), jnp.float32, (1, 2),
                          (1,))),
            ("scales", ((1, 2, 8), (4, 4, 2, 8), jnp.int8, (1, 2),
                        (1,)))):
        jax_args, torch_args = both(*case)
        with pytest.raises(ValueError, match=match):
            jax_paged_decode_attention(*jax_args)
        with pytest.raises(ValueError, match=match):
            paged_decode_attention(*torch_args)


# --- fused residual + norm --------------------------------------------


@pytest.mark.parametrize("kind,shape", [
    ("rmsnorm", (4, 32)),
    ("rmsnorm", (3, 1, 128)),
    ("layernorm", (3, 5, 64)),
])
def test_fused_residual_norm_matches_jax(kind, shape):
    rng = np.random.default_rng(len(shape) + shape[-1])
    res = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    gamma = rng.standard_normal(shape[-1]).astype(np.float32)
    beta = (rng.standard_normal(shape[-1]).astype(np.float32)
            if kind == "layernorm" else None)
    want_y, want_o = jax_fused_residual_norm(
        jnp.asarray(res), jnp.asarray(x), jnp.asarray(gamma),
        None if beta is None else jnp.asarray(beta), kind=kind)
    y, o = fused_residual_norm(_t(res), _t(x), _t(gamma),
                               None if beta is None else _t(beta),
                               kind=kind)
    assert y.shape == o.shape == shape
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                               atol=NORM_ATOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o),
                               atol=NORM_ATOL)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("shape,dtype,gamma_dtype", [
    ((4, 64), "bfloat16", "bfloat16"),
    ((2, 3, 96), "bfloat16", "float32"),     # f32 scale, bf16 stream
    ((3, 130), "float32", "float32"),        # hidden not a multiple of 4
    ((3, 130), "bfloat16", "bfloat16"),      # nor of 8
])
def test_fused_residual_norm_bf16_and_ragged_match_jax(kind, shape, dtype,
                                                       gamma_dtype):
    """The plain route against the JAX op in bf16 and at a hidden size
    that is not a multiple of the kernel's 16-byte vector (its scalar
    case on the card): y = res + x rounded to res's dtype, bit-equal on
    both sides (one rounding of the exact sum); out in res's dtype from
    f32 statistics of the rounded y, f32 within NORM_ATOL, bf16 within
    one bf16 rounding (1e-2) of its largest magnitude."""
    rng = np.random.default_rng(shape[-1] + len(shape))
    res, x = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    gamma, beta = (rng.standard_normal(shape[-1]).astype(np.float32)
                   for _ in range(2))
    if kind == "rmsnorm":
        beta = None
    jdt, jg = getattr(jnp, dtype), getattr(jnp, gamma_dtype)
    tdt, tg = getattr(torch, dtype), getattr(torch, gamma_dtype)
    want_y, want_o = jax_fused_residual_norm(
        jnp.asarray(res).astype(jdt), jnp.asarray(x).astype(jdt),
        jnp.asarray(gamma).astype(jg),
        None if beta is None else jnp.asarray(beta).astype(jg), kind=kind)
    y, o = fused_residual_norm(
        _t(res).to(tdt), _t(x).to(tdt), _t(gamma).to(tg),
        None if beta is None else _t(beta).to(tg), kind=kind)
    assert y.dtype == o.dtype == tdt and y.shape == o.shape == shape
    np.testing.assert_array_equal(
        y.float().numpy(), np.asarray(want_y.astype(jnp.float32)))
    want_o = np.asarray(want_o.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(o.numpy(), want_o, atol=NORM_ATOL)
    else:
        _close_rel(o.float(), want_o, 1e-2, "out")


def test_norm_design_rule():
    """``norm_design``: the warp design at any count of rows wherever it
    takes the width, the cluster design for rows wider than 32 KB;
    ``norm_launch`` sizes each (llama_1b's 2048 f32: teams of 8 warps at
    2 vectors a thread; clusters of 8 CTAs of 64 threads at one
    vector)."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert norm_launch(2048, f32, "warp") == NormLaunch(
        "warp", 1, 256, 256, 2)
    assert norm_launch(2048, bf16, "warp") == NormLaunch(
        "warp", 1, 256, 256, 1)
    assert norm_launch(768, f32, "warp") == NormLaunch(
        "warp", 1, 256, 128, 2)
    assert norm_launch(130, f32, "warp") == NormLaunch("warp", 1, 256, 32, 2)
    assert norm_launch(8192, f32, "warp") == NormLaunch(
        "warp", 1, 512, 512, 4)
    assert norm_launch(2048, f32, "cluster") == NormLaunch(
        "cluster", 8, 64, 64, 1)
    assert norm_launch(2048, bf16, "cluster") == NormLaunch(
        "cluster", 4, 64, 64, 1)
    assert norm_launch(768, f32, "cluster") == NormLaunch(
        "cluster", 2, 96, 96, 1)
    # a slice of at least 64 vectors a CTA: none below 128 vectors
    assert norm_launch(130, f32, "cluster") is None
    assert norm_launch(768, bf16, "cluster") is None
    # the warp design stops at 16 warps of 4 vectors (32 KB a row); the
    # cluster design at 8 CTAs of 512 threads of 4 vectors (65536 f32)
    assert norm_launch(8196, f32, "warp") is None
    assert norm_launch(65536, f32, "cluster") == NormLaunch(
        "cluster", 8, 512, 512, 4)
    assert norm_launch(65540, f32, "cluster") is None
    for rows in (1, 8, 9, 512, 4096):
        assert norm_design(rows, 2048, f32) == "warp"
        assert norm_design(rows, 2048, bf16) == "warp"
        assert norm_design(rows, 130, f32) == "warp"
        assert norm_design(rows, 8192, f32) == "warp"
        assert norm_design(rows, 16384, bf16) == "warp"
        assert norm_design(rows, 8196, f32) == "cluster"
        assert norm_design(rows, 16392, bf16) == "cluster"
    with pytest.raises(ValueError, match="wider"):
        norm_design(8, 65540, f32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        norm_design(8, 2048, torch.float16)
    with pytest.raises(ValueError, match="cluster|warp"):
        norm_launch(2048, f32, "block")


def test_fused_residual_norm_validation_matches_jax():
    r = np.zeros((2, 8), np.float32)
    g = np.ones(8, np.float32)
    for kw, match in (({"kind": "layernorm"}, "beta"),
                      ({"kind": "batchnorm"}, "kind")):
        with pytest.raises(ValueError, match=match):
            jax_fused_residual_norm(jnp.asarray(r), jnp.asarray(r),
                                    jnp.asarray(g), **kw)
        with pytest.raises(ValueError, match=match):
            fused_residual_norm(_t(r), _t(r), _t(g), **kw)


# --- fused BN-relu-conv3x3 ---------------------------------------------


def _close_rel(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    scale = max(float(np.abs(want).max()), 1.0)
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"


def _conv_inputs(n, h, cin, cout, seed):
    rng = np.random.default_rng(seed)
    y1 = rng.standard_normal((n, h, h, cin)).astype(np.float32)
    a = (0.5 + 0.5 * np.abs(rng.standard_normal(cin))).astype(np.float32)
    b = (0.1 * rng.standard_normal(cin)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, cin, cout))).astype(np.float32)
    return y1, a, b, w


@pytest.mark.parametrize("n,h,cin,cout", [(2, 8, 16, 32), (2, 14, 128, 128)])
def test_fused_bn_relu_conv_matches_jax(n, h, cin, cout):
    """Forward (y2, s1, s2) and all four gradients, the stats cotangents
    included: the Pallas kernel (interpret mode) and its custom_vjp
    against the port's wrapper on CPU tensors."""
    y1, a, b, w = _conv_inputs(n, h, cin, cout, seed=h + cin)
    rng = np.random.default_rng(1)
    g_y = rng.standard_normal((n, h, h, cout)).astype(np.float32)
    g_s1 = rng.standard_normal(cout).astype(np.float32)
    g_s2 = (0.01 * rng.standard_normal(cout)).astype(np.float32)

    def jax_loss(*args):
        y2, s1, s2 = jax_fused_conv.fused_bn_relu_conv(*args)
        return (jnp.sum(y2 * g_y) + jnp.sum(s1 * g_s1)
                + jnp.sum(s2 * g_s2)), (y2, s1, s2)

    (_, want), want_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(v) for v in (y1, a, b, w)))
    args = [_t(v).requires_grad_() for v in (y1, a, b, w)]
    got = fused_bn_relu_conv(*args)
    for g, wnt, name in zip(got, want, ("y2", "s1", "s2")):
        _close_rel(g.detach(), wnt, CONV_TOL, name)
    (torch.sum(got[0] * _t(g_y)) + torch.sum(got[1] * _t(g_s1))
     + torch.sum(got[2] * _t(g_s2))).backward()
    for t, wnt, name in zip(args, want_grads, ("dy1", "da", "db", "dw")):
        _close_rel(t.grad, wnt, CONV_GRAD_TOL, name)


def test_fused_bn_relu_conv_plain_rounds_like_the_kernel():
    """bf16: xn rounded to bf16, the conv summed in f32, stats from the
    f32 sum, y2 its rounding (the JAX kernel's rule)."""
    y1, a, b, w = _conv_inputs(1, 6, 32, 64, seed=2)
    yb = _t(y1).to(torch.bfloat16)
    wb = _t(w).to(torch.bfloat16)
    y2, s1, s2 = fused_bn_relu_conv_plain(yb, _t(a), _t(b), wb)
    assert y2.dtype == torch.bfloat16 and s1.dtype == torch.float32
    xn = torch.relu(yb.float() * _t(a) + _t(b)).to(torch.bfloat16).float()
    acc = torch.nn.functional.conv2d(
        xn.permute(0, 3, 1, 2), wb.float().permute(3, 2, 0, 1), padding=1)
    acc = acc.permute(0, 2, 3, 1)
    assert torch.equal(y2, acc.to(torch.bfloat16))
    _close_rel(s1, acc.sum((0, 1, 2)), CONV_TOL, "s1")
    _close_rel(s2, (acc * acc).sum((0, 1, 2)), CONV_TOL, "s2")


def test_fused_conv_eligible_matches_jax():
    for h in (7, 13, 14, 28, 56):
        for cin in (64, 127, 128, 256, 512):
            for kernel in ((3, 3), (1, 1), (3, 1)):
                for strides in (1, 2, (1, 1), (2, 2)):
                    for shape in ((8, h, h, cin), (8, h, h + 1, cin),
                                  (h, h, cin)):
                        assert (eligible(shape, kernel, strides, cin)
                                == jax_fused_conv.eligible(
                                    shape, kernel, strides, cin)), \
                            (shape, kernel, strides, cin)
    assert eligible((128, 28, 28, 128), (3, 3), 1, 128)
    assert eligible((128, 14, 14, 256), (3, 3), 1, 256)
    assert not eligible((128, 56, 56, 64), (3, 3), 1, 64)
    assert not eligible((128, 7, 7, 512), (3, 3), 1, 512)


def test_fused_conv_design_rule():
    """The wrapper's shape rule: bf16 with Cin % 64 == 0 and W <= 62 runs
    the wgmma kernel (128 output channels a block where Cout allows,
    else 64), other bf16 shapes the WMMA kernel, float32 the FMA kernel;
    a shape no kernel takes raises before any launch.  The wgmma kernel's
    partial stats come one row per 128 positions of its padded order."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert conv_design(bf16, 28, 128, 128) == "wgmma_n128"
    assert conv_design(bf16, 14, 256, 256) == "wgmma_n128"
    assert conv_design(bf16, 56, 64, 64) == "wgmma_n64"
    assert conv_design(bf16, 7, 512, 512) == "wgmma_n128"
    assert conv_design(bf16, 7, 64, 192) == "wgmma_n64"
    assert conv_design(bf16, 62, 64, 128) == "wgmma_n128"
    assert conv_design(bf16, 63, 64, 128) == "wmma"
    assert conv_design(bf16, 112, 128, 128) == "wmma"
    assert conv_design(bf16, 28, 96, 128) == "wmma"
    assert conv_design(f32, 28, 128, 128) == "fma"
    for dtype, cin, cout in ((bf16, 48, 64), (bf16, 64, 96),
                             (f32, 16, 64), (torch.float16, 64, 64)):
        with pytest.raises(ValueError):
            conv_design(dtype, 14, cin, cout)
    rows = torch_fused_conv._part_rows
    assert rows("wgmma_n128", 128, 28, 28) == -(-128 * 29 * 29 // 128)
    assert rows("wgmma_n64", 3, 7, 7) == 2            # 3 * 8 * 8 = 192
    assert rows("wmma", 3, 7, 7) == 2                 # 147 pixels
    assert rows("fma", 2, 8, 8) == 1


def test_fused_bn_relu_conv_validation():
    y1, a, b, w = (_t(v) for v in _conv_inputs(1, 4, 8, 8, seed=0))
    with pytest.raises(ValueError, match="3,3"):
        fused_bn_relu_conv(y1, a, b, w[:1])
    with pytest.raises(ValueError, match="a, b"):
        fused_bn_relu_conv(y1, a[:4], b, w)
    with pytest.raises(ValueError, match="share"):
        fused_bn_relu_conv(y1, a, b, w.double())
    with pytest.raises(ValueError, match="float32"):
        fused_bn_relu_conv(y1, a.double(), b, w)


# --- flash attention ---------------------------------------------------


def _flash_inputs(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, h, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("b,sq,sk,h,d,causal", [
    (2, 64, 64, 2, 16, False),
    (2, 64, 64, 2, 16, True),
    (1, 37, 37, 2, 8, True),         # unaligned: a ragged last tile
    (2, 100, 100, 1, 16, True),
    (1, 37, 100, 2, 8, False),       # more keys than queries
])
def test_flash_attention_matches_jax(b, sq, sk, h, d, causal):
    """``o`` and the gradients of q, k, v under the cotangent of
    ``sum(o * cos(o))``: the Pallas kernels (interpret mode, 16-row
    blocks) against the plain version with the same blocks, and the
    wrapper's own 64-row tiles against the same JAX result."""
    q, k, v = _flash_inputs(b, sq, sk, h, d, seed=sq + sk + causal)

    def jax_loss(q, k, v):
        o = jax_flash_attention(q, k, v, causal=causal, block_q=16,
                                block_k=16)
        return jnp.sum(o * jnp.cos(o)), o

    (_, want), want_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    for fn in (functools.partial(flash_attention_plain, block_q=16,
                                 block_k=16), flash_attention):
        args = [_t(a).requires_grad_() for a in (q, k, v)]
        o = fn(*args, causal=causal)
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(want),
                                   atol=ATTN_ATOL)
        (o * torch.cos(o)).sum().backward()
        for t, wnt, name in zip(args, want_grads, ("dq", "dk", "dv")):
            _close_rel(t.grad, wnt, FLASH_GRAD_TOL, name)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_bf16_forward_matches_jax(causal):
    """bf16 in and out, both sides' P rounded to bf16 before P V: within
    one bf16 rounding (2^-8) of the output's largest magnitude."""
    q, k, v = _flash_inputs(2, 100, 100, 2, 16, seed=21 + causal)
    want = jax_flash_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        causal=causal, block_q=16, block_k=16)
    got = flash_attention_plain(
        *(_t(a).to(torch.bfloat16) for a in (q, k, v)), causal=causal,
        block_q=16, block_k=16)
    assert got.dtype == torch.bfloat16
    _close_rel(got.float(), np.asarray(want, np.float32), FLASH_BF16_TOL,
               "o")


def test_flash_plain_parts_are_the_backward():
    """The three plain passes the kernels mirror: ``flash_fwd_plain``'s
    lse is the row logsumexp, and ``flash_dq_plain`` /
    ``flash_dkv_plain`` give the autograd gradients."""
    q, k, v = (_t(a) for a in _flash_inputs(2, 50, 50, 2, 8, seed=31))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    o, lse = flash_fwd_plain(q, k, v, causal=True, block_q=16, block_k=16)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 8 ** 0.5
    s = s.masked_fill(~torch.ones(50, 50, dtype=torch.bool).tril(), -1e30)
    _close_rel(lse, torch.logsumexp(s, -1), ATTN_ATOL, "lse")
    delta = delta_rows(o, do)
    dq = flash_dq_plain(q, k, v, do, lse, delta, causal=True)
    dk, dv = flash_dkv_plain(q, k, v, do, lse, delta, causal=True)
    args = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.autograd.backward(flash_attention(*args, causal=True), do)
    for got, t, name in zip((dq, dk, dv), args, ("dq", "dk", "dv")):
        _close_rel(got, t.grad, FLASH_GRAD_TOL, name)


@pytest.mark.parametrize("b,sq,sk,h,d,causal,dtype", [
    (1, 200, 200, 2, 64, True, torch.float32),
    (1, 200, 200, 2, 64, False, torch.bfloat16),
    (1, 150, 300, 2, 128, False, torch.float32),    # ragged sq and sk
    (1, 256, 256, 1, 128, True, torch.bfloat16),
])
def test_flash_plain_at_the_wgmma_tiles_matches_jax(b, sq, sk, h, d, causal,
                                                    dtype):
    """The plain forward at the bf16 kernel's tiles (128 queries against
    128 keys at head dim 64, 64 keys at 128) against the Pallas forward
    (interpret mode) at the same blocks: float32 within the attention
    bound, bf16 within one bf16 rounding of the output's largest
    magnitude."""
    block_q, block_k = fwd_blocks(torch.bfloat16, d)
    q, k, v = _flash_inputs(b, sq, sk, h, d, seed=sq + sk + d + causal)
    want = jax_flash_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                else jnp.float32) for a in (q, k, v)),
        causal=causal, block_q=block_q, block_k=block_k)
    got = flash_attention_plain(
        *(_t(a).to(dtype) for a in (q, k, v)), causal=causal,
        block_q=block_q, block_k=block_k)
    assert got.dtype == dtype
    want = np.asarray(want, np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, atol=ATTN_ATOL)
    else:
        _close_rel(got.float(), want, FLASH_BF16_TOL, "o")


def test_flash_fwd_design_rule():
    """bf16 runs the wgmma forward at 128-query tiles (128 keys at head
    dim 64, 64 at 128), float32 the FMA forward at 64-row tiles; a head
    dim takes the tiles of the one it is padded to (192: the FMA kernel
    at 256, 32-row tiles; 320: the same kernel over two 256-wide chunks);
    another dtype, or a head dim below 1, raises."""
    assert fwd_design(torch.bfloat16) == "wgmma"
    assert fwd_design(torch.float32) == "fma"
    assert fwd_blocks(torch.bfloat16, 64) == (128, 128)
    assert fwd_blocks(torch.bfloat16, 128) == (128, 64)
    assert fwd_blocks(torch.float32, 64) == (64, 64)
    assert fwd_blocks(torch.float32, 128) == (64, 64)
    assert fwd_blocks(torch.bfloat16, 32) == (128, 128)
    assert fwd_blocks(torch.bfloat16, 96) == (128, 64)
    assert fwd_blocks(torch.bfloat16, 192) == (32, 32)
    assert fwd_blocks(torch.bfloat16, 320) == (32, 32)
    with pytest.raises(ValueError, match="float16"):
        fwd_design(torch.float16)
    with pytest.raises(ValueError, match="head_dim"):
        fwd_blocks(torch.bfloat16, 0)


def test_flash_bwd_design_rule():
    """bf16 runs the wgmma dQ kernel (128 query rows over 64-key tiles)
    and dK/dV kernel (128 keys over 64-query tiles) at head dims up to
    128, float32 the FMA kernels at 64-row tiles; head dim 192 runs the
    FMA kernels at 256 (32-row tiles), and head dim 320 the same kernels
    over two 256-wide chunks; another dtype, or a head dim below 1,
    raises."""
    assert bwd_design(torch.bfloat16) == "wgmma"
    assert bwd_design(torch.float32) == "fma"
    for d in (16, 32, 64, 96, 128):
        assert bwd_blocks(torch.bfloat16, d) == {"dq": (128, 64),
                                                 "dkv": (64, 128)}
        assert bwd_blocks(torch.float32, d) == {"dq": (64, 64),
                                                "dkv": (64, 64)}
    assert bwd_blocks(torch.bfloat16, 192) == {"dq": (32, 32),
                                               "dkv": (32, 32)}
    assert bwd_blocks(torch.float32, 320) == {"dq": (32, 32),
                                              "dkv": (32, 32)}
    with pytest.raises(ValueError, match="float16"):
        bwd_design(torch.float16)
    with pytest.raises(ValueError, match="head_dim"):
        bwd_blocks(torch.bfloat16, 0)


@pytest.mark.parametrize("d,want", [(1, 64), (16, 64), (32, 64), (64, 64),
                                    (65, 128), (96, 128), (128, 128),
                                    (129, 256), (192, 256), (256, 256),
                                    (257, 512), (320, 512), (512, 512),
                                    (513, 768), (1000, 1024)])
def test_flash_padded_head_dim_rule(d, want):
    """Up to 256 the next template case; above it the next multiple of
    256, the FMA kernels' chunk."""
    assert padded_head_dim(d) == want


@pytest.mark.parametrize("d", [0, 257, 320, 512])
def test_flash_head_dim_above_128_raises(d):
    """Of these only a head dim below 1 still raises: above 256 the rule
    pads to a multiple of 256 (512 for each of 257, 320 and 512), which
    both dtypes run on the FMA kernels at 32-row tiles, two 256-wide
    chunks of the head dim (``test_torch_kernels_card.py`` holds the card
    to it); both routes pad alike."""
    if d < 1:
        with pytest.raises(ValueError, match="head_dim"):
            padded_head_dim(d)
        with pytest.raises(ValueError, match="head_dim"):
            fwd_blocks(torch.bfloat16, d)
        with pytest.raises(ValueError, match="head_dim"):
            bwd_blocks(torch.float32, d)
        return
    assert padded_head_dim(d) == 512
    for dtype in (torch.float32, torch.bfloat16):
        assert fwd_design(dtype, d) == bwd_design(dtype, d) == "fma"
        assert fwd_blocks(dtype, d) == (32, 32)
        assert bwd_blocks(dtype, d) == {"dq": (32, 32), "dkv": (32, 32)}


@pytest.mark.parametrize("d", [129, 160, 192, 256])
def test_flash_head_dims_129_to_256_take_the_d256_kernels(d):
    """Head dims 129..256 pad to 256, where both dtypes run the FMA
    kernels (``fwd_design``/``bwd_design`` given the head dim) at 32-row
    tiles; without a head dim the designs keep their rule for 64 and
    128."""
    assert padded_head_dim(d) == 256
    for dtype in (torch.float32, torch.bfloat16):
        assert fwd_design(dtype, d) == "fma"
        assert bwd_design(dtype, d) == "fma"
        assert fwd_blocks(dtype, d) == (32, 32)
        assert bwd_blocks(dtype, d) == {"dq": (32, 32), "dkv": (32, 32)}
    assert fwd_design(torch.bfloat16) == "wgmma"
    assert fwd_design(torch.bfloat16, 128) == "wgmma"
    assert bwd_design(torch.bfloat16, 64) == "wgmma"


@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_plain_at_the_d256_tiles_matches_jax(d, dtype):
    """``flash_attention_plain`` at the head-dim-256 kernels' 32-row tiles
    (``fwd_blocks``; d 192 zero-padded to 256, as the card runs it)
    against the Pallas kernels (interpret mode) at 32-row blocks and the
    unpadded width: o and the gradients of q, k, v under one cotangent
    (``jax.vjp``), causal, ragged over the tiles; float32 within the
    attention bound (o) and 1e-4 of the largest gradient, bf16 within
    one bf16 rounding (1e-2) of the largest magnitude."""
    b, s, h = 1, 45, 2
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    q, k, v = _flash_inputs(b, s, s, h, d, seed=d)
    do = np.random.default_rng(d + 1).standard_normal(
        (b, s, h, d)).astype(np.float32)
    bq, bk = fwd_blocks(dtype, d)
    assert bwd_blocks(dtype, d)["dq"] == (bq, bk) == (32, 32)
    want, vjp = jax.vjp(functools.partial(
        jax_flash_attention, causal=True, block_q=bq, block_k=bk),
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(do).astype(jdt))
    args = [_t(a).to(dtype).requires_grad_() for a in (q, k, v)]
    o = flash_attention_plain(*args, causal=True, block_q=bq, block_k=bk)
    o.backward(_t(do).to(dtype))
    assert o.dtype == dtype and o.shape == (b, s, h, d)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(o.detach().numpy(), want, atol=ATTN_ATOL)
        tol = FLASH_GRAD_TOL
    else:
        _close_rel(o.detach().float(), want, FLASH_BF16_TOL, "o")
        tol = FLASH_BF16_TOL
    for t, wnt, name in zip(args, want_grads, ("dq", "dk", "dv")):
        assert t.grad.dtype == dtype
        _close_rel(t.grad.float(), np.asarray(wnt.astype(jnp.float32)), tol,
                   name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_plain_at_head_dim_320_matches_jax(dtype):
    """``flash_attention_plain`` at head dim 320, zero-padded to 512 as
    the card runs it (the FMA kernels over two 256-wide chunks, 32-row
    tiles), against the Pallas kernels (interpret mode) at the unpadded
    width and the same tiles: o and the gradients of q, k, v under one
    cotangent (``jax.vjp``), causal, ragged over the tiles; float32 o
    within the attention bound and the gradients within 1e-4 of the
    largest, bf16 within one bf16 rounding (1e-2) of the largest."""
    b, s, h, d = 1, 40, 2, 320
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    q, k, v = _flash_inputs(b, s, s, h, d, seed=d)
    do = np.random.default_rng(d + 1).standard_normal(
        (b, s, h, d)).astype(np.float32)
    bq, bk = fwd_blocks(dtype, d)
    assert padded_head_dim(d) == 512 and (bq, bk) == (32, 32)
    want, vjp = jax.vjp(functools.partial(
        jax_flash_attention, causal=True, block_q=bq, block_k=bk),
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(do).astype(jdt))
    args = [_t(a).to(dtype).requires_grad_() for a in (q, k, v)]
    o = flash_attention_plain(*args, causal=True, block_q=bq, block_k=bk)
    o.backward(_t(do).to(dtype))
    assert o.dtype == dtype and o.shape == (b, s, h, d)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(o.detach().numpy(), want, atol=ATTN_ATOL)
        tol = FLASH_GRAD_TOL
    else:
        _close_rel(o.detach().float(), want, FLASH_BF16_TOL, "o")
        tol = FLASH_BF16_TOL
    for t, wnt, name in zip(args, want_grads, ("dq", "dk", "dv")):
        assert t.grad.shape == t.shape
        _close_rel(t.grad.float(), np.asarray(wnt.astype(jnp.float32)), tol,
                   name)


@pytest.mark.parametrize("d", [129, 192, 320])
def test_flash_cpu_route_takes_head_dim_above_128(d):
    """As the JAX package does: ``o`` and the gradients of q, k, v under
    the cotangent of ``sum(o * cos(o))`` against the Pallas kernels
    (interpret mode) at the same width, within the tolerances above."""
    b, sq, sk, h = 1, 20, 30, 1
    q, k, v = _flash_inputs(b, sq, sk, h, d, seed=d)

    def jax_loss(q, k, v):
        o = jax_flash_attention(q, k, v, causal=True, block_q=16,
                                block_k=16)
        return jnp.sum(o * jnp.cos(o)), o

    (_, want), want_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    args = [_t(a).requires_grad_() for a in (q, k, v)]
    o = flash_attention(*args, causal=True)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want),
                               atol=ATTN_ATOL)
    (o * torch.cos(o)).sum().backward()
    for t, wnt, name in zip(args, want_grads, ("dq", "dk", "dv")):
        _close_rel(t.grad, wnt, FLASH_GRAD_TOL, name)


@pytest.mark.parametrize("d", [16, 32, 48, 96])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_padded_head_dim_matches_jax(d, causal):
    """The padded route (q, k, v zero-padded to 64 or 128 columns, the
    scale 1/sqrt(d) of the original width, o sliced back) against the
    Pallas kernels (interpret mode) at the unpadded width: o within the
    attention bound, and the gradients of q, k, v under the cotangent of
    ``sum(o * cos(o))`` within 1e-4 of the largest (as above)."""
    b, sq, sk, h = 1, 70, 90, 2
    q, k, v = _flash_inputs(b, sq, sk, h, d, seed=d + causal)

    def jax_loss(q, k, v):
        o = jax_flash_attention(q, k, v, causal=causal, block_q=32,
                                block_k=32)
        return jnp.sum(o * jnp.cos(o)), o

    (_, want), want_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    args = [_t(a).requires_grad_() for a in (q, k, v)]
    o = flash_attention(*args, causal=causal)
    assert o.shape == (b, sq, h, d)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want),
                               atol=ATTN_ATOL)
    (o * torch.cos(o)).sum().backward()
    for t, wnt, name in zip(args, want_grads, ("dq", "dk", "dv")):
        assert t.grad.shape == t.shape
        _close_rel(t.grad, wnt, FLASH_GRAD_TOL, name)


@pytest.mark.parametrize("b,sq,sk,h,d,causal,dtype", [
    (1, 256, 256, 2, 64, True, torch.float32),
    (1, 256, 256, 2, 64, True, torch.bfloat16),
    (1, 200, 330, 2, 64, False, torch.bfloat16),    # ragged sq and sk
    (1, 150, 300, 1, 128, False, torch.float32),
    (1, 200, 200, 1, 128, True, torch.bfloat16),     # ragged, causal
])
def test_flash_plain_bwd_at_the_kernel_tiles_matches_jax(b, sq, sk, h, d,
                                                        causal, dtype):
    """``flash_dq_plain`` and ``flash_dkv_plain`` at the bf16 kernels'
    tiles (``bwd_blocks``: dQ 128 queries over 64-key tiles, dK/dV 128
    keys over 64-query tiles) against the gradients of the Pallas
    kernels (interpret mode) at the same blocks, under one cotangent:
    float32 within 1e-4 of the largest gradient (a recompute of P from
    the lse, then sums over the tiles in another order), bf16 within one
    bf16 rounding of it (1e-2: dS and P rounded to bf16 before their
    products, where a last-bit difference can round the other way)."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    q, k, v = _flash_inputs(b, sq, sk, h, d, seed=sq + sk + d + causal)
    do = np.random.default_rng(d + causal).standard_normal(
        (b, sq, h, d)).astype(np.float32)
    blocks = bwd_blocks(torch.bfloat16, d)
    want = {}
    for name, (bq, bk) in blocks.items():
        _, vjp = jax.vjp(functools.partial(
            jax_flash_attention, causal=causal, block_q=bq, block_k=bk),
            *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
        want[name] = vjp(jnp.asarray(do).astype(jdt))
    tq, tk, tv, tdo = (_t(a).to(dtype) for a in (q, k, v, do))
    o, lse = flash_fwd_plain(tq, tk, tv, causal)
    delta = delta_rows(o, tdo)
    args = (tq, tk, tv, tdo, lse, delta, causal)
    dq = flash_dq_plain(*args, block_q=blocks["dq"][0],
                        block_k=blocks["dq"][1])
    dk, dv = flash_dkv_plain(*args, block_q=blocks["dkv"][0],
                             block_k=blocks["dkv"][1])
    tol = FLASH_BF16_TOL if dtype == torch.bfloat16 else FLASH_GRAD_TOL
    for got, wnt, name in ((dq, want["dq"][0], "dq"),
                           (dk, want["dkv"][1], "dk"),
                           (dv, want["dkv"][2], "dv")):
        assert got.dtype == dtype
        _close_rel(got.float(), np.asarray(wnt, np.float32), tol, name)


def test_flash_attention_validation():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="share"):
        flash_attention(q, q.double(), q.double())
    with pytest.raises(ValueError, match="batch, heads and head_dim"):
        flash_attention(q, torch.zeros((1, 8, 3, 16)),
                        torch.zeros((1, 8, 3, 16)))
    with pytest.raises(ValueError, match="expected"):
        flash_attention(q[0], q[0], q[0])


# --- wrapper contract ---------------------------------------------------


def test_cpu_calls_run_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(0)
    before = (paged_decode_attention.launches,
              fused_residual_norm.launches)
    res = _t(rng.standard_normal((2, 16)).astype(np.float32))
    g = torch.ones(16)
    y, o = fused_residual_norm(res, res, g, kind="rmsnorm")
    y2, o2 = fused_residual_norm_plain(res, res, g, kind="rmsnorm")
    assert torch.equal(y, y2) and torch.equal(o, o2)
    q = torch.zeros((1, 2, 8))
    pool = torch.zeros((3, 4, 1, 8))
    tbl = torch.zeros((1, 2), dtype=torch.int32)
    ln = torch.ones((1,), dtype=torch.int32)
    assert torch.equal(paged_decode_attention(q, pool, pool, tbl, ln),
                       paged_decode_attention_plain(q, pool, pool, tbl, ln))
    assert (paged_decode_attention.launches,
            fused_residual_norm.launches) == before


def test_cpu_fused_conv_runs_the_plain_version_and_counts_no_launch():
    before = fused_bn_relu_conv.launches
    y1, a, b, w = (_t(v) for v in _conv_inputs(2, 5, 8, 16, seed=4))
    got = fused_bn_relu_conv(y1, a, b, w)
    want = fused_bn_relu_conv_plain(y1, a, b, w)
    assert all(torch.equal(g, wt) for g, wt in zip(got, want))
    assert fused_bn_relu_conv.launches == before


def test_cpu_flash_attention_runs_the_plain_version_and_counts_no_launch():
    before = dict(flash_attention.launches)
    q, k, v = (_t(a).requires_grad_()
               for a in _flash_inputs(1, 70, 70, 2, 16, seed=5))
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_plain(q, k, v, causal=True)
    assert torch.equal(got, want)
    got.sum().backward()
    assert flash_attention.launches == before
    assert sorted(before) == ["dkv", "dq", "fwd"]


def test_kernel_build_hash_covers_every_source():
    names = sorted(p.name for p in _build._sources())
    assert names == ["flash_attention.cu", "flash_bwd_sm90.cu",
                     "flash_fwd_sm90.cu", "fused_conv.cu",
                     "fused_conv_sm90.cu",
                     "fused_residual_norm.cu", "paged_attention.cu",
                     "paged_attention_masked.cu", "pool_bwd.cu",
                     "sm90_selftest.cu", "xent.cu"]
    # the shared headers are hashed too: a change to one rebuilds
    assert sorted(p.name for p in _build._CSRC.glob("*.cuh")) == [
        "paged_attention.cuh", "sm90.cuh"]
    h = _build.source_hash()
    assert h == _build.source_hash() and len(h) == 64
    assert _build.pad_up(13, 8) == 16 and _build.pad_up(16, 8) == 16


# --- the CUDA kernels against their plain versions (card only) ----------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested above)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("quantized,ppb", [(False, 1), (False, 2),
                                           (True, 1), (True, 2)])
def test_paged_kernel_matches_plain_on_card(cuda_device, quantized, ppb):
    rng = np.random.default_rng(11)
    L, pages, ps, kvh, d, b, heads, w = 2, 20, 16, 8, 64, 4, 32, 6
    kf = rng.standard_normal((L, pages, ps, kvh, d)).astype(np.float32)
    vf = rng.standard_normal((L, pages, ps, kvh, d)).astype(np.float32)
    q = rng.standard_normal((b, heads, d)).astype(np.float32)
    tables = rng.integers(1, pages, (b, w)).astype(np.int32)
    lengths = np.array([0, 1, 50, w * ps], np.int32)
    kw = {}
    if quantized:
        kf = np.clip(np.round(kf * 40), -127, 127).astype(np.int8)
        vf = np.clip(np.round(vf * 40), -127, 127).astype(np.int8)
        kw = {"k_scales": torch.full((L, pages), 1 / 40.0),
              "v_scales": torch.full((L, pages), 1 / 40.0)}
    args = [_t(a) for a in (q, kf, vf, tables, lengths)]
    want, want_lse = paged_decode_attention_plain(
        *args, pages_per_block=ppb, layer=1, return_lse=True, **kw)
    got, lse = paged_decode_attention(
        *[a.to(cuda_device) for a in args], pages_per_block=ppb, layer=1,
        return_lse=True, **{k: v.to(cuda_device) for k, v in kw.items()})
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.numpy(),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_fused_norm_kernel_matches_plain_on_card(cuda_device, kind):
    rng = np.random.default_rng(12)
    res, x = (_t(rng.standard_normal((64, 2048)).astype(np.float32))
              for _ in range(2))
    g = _t(rng.standard_normal(2048).astype(np.float32))
    bta = (_t(rng.standard_normal(2048).astype(np.float32))
           if kind == "layernorm" else None)
    want_y, want_o = fused_residual_norm_plain(res, x, g, bta, kind=kind)
    dev = cuda_device
    y, o = fused_residual_norm(res.to(dev), x.to(dev), g.to(dev),
                               None if bta is None else bta.to(dev),
                               kind=kind)
    torch.cuda.synchronize()
    np.testing.assert_allclose(y.cpu().numpy(), want_y.numpy(), atol=0)
    np.testing.assert_allclose(o.cpu().numpy(), want_o.numpy(), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,cin,cout", [(2, 14, 128, 128),
                                          (3, 7, 64, 192)])
def test_fused_conv_kernel_matches_plain_on_card(cuda_device, dtype, n, h,
                                                 cin, cout):
    """Forward outputs at the working dtype (bf16 y2 within 1e-2 of its
    largest magnitude, one bf16 ulp there; f32 within 1e-4) and stats
    within 1e-4 relative; a ragged last tile (3*7*7 = 147 pixels)."""
    y1, a, b, w = _conv_inputs(n, h, cin, cout, seed=7)
    args = [_t(y1).to(dtype), _t(a), _t(b), _t(w).to(dtype)]
    want = fused_bn_relu_conv_plain(*args)
    before = fused_bn_relu_conv.launches
    got = fused_bn_relu_conv(*[t.to(cuda_device) for t in args])
    torch.cuda.synchronize()
    assert fused_bn_relu_conv.launches == before + 1
    y_tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for g, wt, tol, name in zip(got, want, (y_tol, 1e-4, 1e-4),
                                ("y2", "s1", "s2")):
        _close_rel(g.cpu().float(), wt.float(), tol, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,d,causal", [(2, 256, 4, 64, True),
                                            (2, 100, 3, 128, False),
                                            (1, 130, 2, 64, True),
                                            (2, 190, 4, 32, True),
                                            (1, 333, 2, 128, True)])
def test_flash_kernels_match_plain_on_card(cuda_device, dtype, b, s, h, d,
                                           causal):
    """The forward, dQ and dK/dV kernels through the autograd wrapper,
    q, k, v as views of one fused projection (head dim 32 through the
    padded route; ragged last tiles at s 100, 130, 190 and 333): o and
    the three gradients
    within 1e-4 (f32: sums in another order) or 1e-2 (bf16: outputs
    rounded to 2^-8, P and dS rounded before their products) of the
    largest magnitude, one launch of each kernel."""
    rng = np.random.default_rng(13)
    qkv = _t(rng.standard_normal((b, s, 3, h, d)).astype(np.float32))
    do = _t(rng.standard_normal((b, s, h, d)).astype(np.float32)).to(dtype)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    outs = []
    for dev in ("cpu", cuda_device):
        x = qkv.to(device=dev, dtype=dtype).requires_grad_()
        before = dict(flash_attention.launches)
        o = flash_attention(*x.unbind(2), causal=causal)
        o.backward(do.to(dev))
        outs.append((o.detach().cpu().float(), x.grad.cpu().float()))
    torch.cuda.synchronize()
    assert {k: flash_attention.launches[k] - before[k]
            for k in before} == {"fwd": 1, "dq": 1, "dkv": 1}
    for got, want, name in zip(outs[1], outs[0], ("o", "dqkv")):
        _close_rel(got, want, tol, name)
