"""The port's kernel modules against the JAX package's Pallas kernels.

The JAX side runs as its own tests run it on the CPU (Pallas interpret
mode); the port's wrappers run their plain PyTorch versions, which is
what a wrapper does with a CPU tensor.  Inputs are made with numpy from
a seed and handed to both.  The CUDA kernels themselves run only on the
card: the ``cuda``-marked tests hold them against the plain versions
there (``chip_smoke.py`` does the same at the serving lane's shapes).

Tolerances: 2e-5 absolute for attention and 1e-5 for the norms, the
bounds the JAX package's own kernel tests use for float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_hc_bench.ops.fused_residual_ln import (
    fused_residual_norm as jax_fused_residual_norm)
from tpu_hc_bench.ops.paged_attention import (
    paged_decode_attention as jax_paged_decode_attention)
from tpu_hc_bench_torch.ops import _build
from tpu_hc_bench_torch.ops.fused_residual_ln import (
    fused_residual_norm, fused_residual_norm_plain)
from tpu_hc_bench_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_attention_plain)

ATTN_ATOL = 2e-5
NORM_ATOL = 1e-5


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


def test_kernel_build_hash_covers_every_source():
    names = sorted(p.name for p in _build._sources())
    assert names == ["fused_residual_norm.cu", "paged_attention.cu"]
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
