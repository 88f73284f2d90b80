"""The split paged decode attention, the fused residual+norm, the
max-pool backward and the head-dim-256 (and above) flash kernels against
their plain versions, on the card.

This file imports no JAX, so it runs on a machine with the card and no
JAX stack (there: ``python -m pytest --noconftest -q
tests/test_torch_kernels_card.py``); here every test skips for want of a
GPU, and the plain versions are held against the JAX package in
``test_torch_ops.py`` and ``test_torch_mlm.py``.

- paged decode attention (``csrc/paged_attention.cu``, a split kernel
  and a merge kernel a call) against ``paged_decode_attention_plain``
  at the rule's split count (``paged_splits``), for f32, bf16 (q bf16 or
  f32) and int8 pools, at table widths that make the rule choose 1, 2, 3
  and 7 splits, over rows of length 0, 1 (later splits empty), a ragged
  one and a full table: f32 and int8 within 1e-4 absolute (sums in
  another order), bf16 within 1e-2 of the output's largest magnitude (out
  rounded to bf16, p rounded to bf16 against another running max); lse
  within 1e-4; one launch counted a call; and p rounded to bf16 before
  P V, where one warp's chunk holds the whole row (so its running max is
  the split's): within 1e-6 of the plain version, which the unrounded
  result misses; head dims off the template list (20, 80, 96, 200: the
  next listed case masked to d, scalar loads where a row is not a whole
  number of 16-byte vectors) in every pool type, at the same bounds;
- the fused residual+norm (``csrc/fused_residual_norm.cu``) in both
  designs (``"cluster"``, ``"warp"``), f32 and bf16, rmsnorm and
  layernorm, at 1 to 4096 rows of hidden 768, 2048, 2050 (the scalar
  case) and 4096: y bit-equal to the plain version (one rounding of the
  exact sum), out within 1e-4 (f32: statistics summed in another order)
  or 1e-2 of its largest magnitude (bf16: one rounding of out);
- the max-pool backward (``csrc/pool_bwd.cu``) at a ragged channel
  count (C = 13: the scalar case), at a tie-heavy bf16 input, at the
  generic window case and at a channel count above the block's 64
  vectors: the same bits as the plain version (the same f32 sums in the
  same order);
- the FMA flash kernels at head dim 256 (``csrc/flash_attention.cu``,
  32-row tiles) in f32 and bf16 against the plain versions at those
  tiles: o and the gradients within 1e-4 (f32) or 1e-2 (bf16) of their
  largest magnitudes (with one key, dQ and dK within 1e-5 (f32) or 1e-3
  (bf16) of zero on both sides); at head dim 320 (padded to 512: two
  256-wide chunks) the same; and ``flash_attention`` at head dim 192
  through autograd, padded to 256;
- ``data.feed.DeviceFeeder``, the real-data runs' pinned copies on a
  copy stream: 40 batches through a ring of 3 slots, with a slow step
  after each, arrive bit-equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpu_hc_bench_torch.data.feed import DeviceFeeder
from tpu_hc_bench_torch.ops import flash_attention as fa
from tpu_hc_bench_torch.ops import pool_bwd
from tpu_hc_bench_torch.ops.fused_residual_ln import (
    fused_residual_norm, fused_residual_norm_plain, norm_launch)
from tpu_hc_bench_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_attention_plain, paged_splits)

PAGED_ATOL = 1e-4
PAGED_BF16_TOL = 1e-2
LSE_ATOL = 1e-4
F32_TOL = 1e-4
BF16_TOL = 1e-2
# with one key dQ and dK are zero; what is left is the f32 rounding of
# dP - D (256 products of O(1) terms, ~1e-6 in f32), scaled and rounded
# to the dtype (bf16 keeps what its P and dS rounding leave)
ONE_KEY_FLOOR = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
# the rounding case: f32 sums of three products in another order
ROUNDING_ATOL = 1e-6
# the fused residual+norm's out: f32 statistics over the row in another
# order (f32); one rounding of out to bf16, 2^-8 of the largest (bf16)
NORM_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested in "
                    "test_torch_ops.py and test_torch_mlm.py)")
    return torch.device("cuda")


def _rel(got, want):
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def _paged_inputs(pool, q_dtype, d, w, seed):
    rng = np.random.default_rng(seed)
    L, pages, ps, kvh, b, heads = 2, 40, 16, 8, 5, 32
    kf = rng.standard_normal((L, pages, ps, kvh, d)).astype(np.float32)
    vf = rng.standard_normal((L, pages, ps, kvh, d)).astype(np.float32)
    q = torch.from_numpy(rng.standard_normal((b, heads, d)).astype(
        np.float32)).to(q_dtype)
    tables = torch.from_numpy(rng.integers(1, pages, (b, w)).astype(
        np.int32))
    n = w * ps
    lengths = torch.tensor([0, 1, n // 2 + 5, n, 2 * n // 3],
                           dtype=torch.int32)
    kw = {}
    if pool == "int8":
        kp = torch.from_numpy(np.clip(np.round(kf * 40), -127, 127).astype(
            np.int8))
        vp = torch.from_numpy(np.clip(np.round(vf * 40), -127, 127).astype(
            np.int8))
        kw = {"k_scales": torch.from_numpy(rng.uniform(
                  0.01, 0.04, (L, pages)).astype(np.float32)),
              "v_scales": torch.from_numpy(rng.uniform(
                  0.01, 0.04, (L, pages)).astype(np.float32))}
    else:
        dt = torch.float32 if pool == "f32" else torch.bfloat16
        kp, vp = torch.from_numpy(kf).to(dt), torch.from_numpy(vf).to(dt)
    return (q, kp, vp, tables, lengths), kw


def _rule_splits(device, q, kp, tables, ppb):
    sm = torch.cuda.get_device_properties(device).multi_processor_count
    return paged_splits(q.shape[0], kp.shape[-2], tables.shape[1],
                        kp.shape[-3], ppb, sm)


@pytest.mark.cuda
@pytest.mark.parametrize("pool,q_dtype", [
    ("f32", torch.float32), ("bf16", torch.bfloat16),
    ("bf16", torch.float32), ("int8", torch.float32)])
# (table slots, the rule's split count): 40 blocks of 128 threads want
# several splits a row, and a split keeps at least 64 tokens (4 pages)
@pytest.mark.parametrize("w,splits", [(4, 1), (9, 2), (12, 3), (28, 7)])
@pytest.mark.parametrize("ppb", [1, 2])
def test_split_paged_kernel_matches_plain(cuda_device, pool, q_dtype, w,
                                          splits, ppb):
    args, kw = _paged_inputs(pool, q_dtype, 64, w, seed=w + ppb)
    q, kp, vp, tables, lengths = args
    assert _rule_splits(cuda_device, q, kp, tables, ppb) == splits
    want, want_lse = paged_decode_attention_plain(
        *args, pages_per_block=ppb, layer=1, return_lse=True,
        splits=splits, **kw)
    before = paged_decode_attention.launches
    got, lse = paged_decode_attention(
        *[a.to(cuda_device) for a in args], pages_per_block=ppb, layer=1,
        return_lse=True, **{k: v.to(cuda_device) for k, v in kw.items()})
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    assert got.dtype == q_dtype and lse.dtype == torch.float32
    got, lse = got.cpu(), lse.cpu()
    assert (got[0] == 0).all() and (lse[0] < -1e29).all()
    assert torch.isfinite(lse).all()
    if pool == "bf16":
        assert _rel(got, want) <= PAGED_BF16_TOL
    else:
        assert float((got - want).abs().max()) <= PAGED_ATOL
    assert float((lse[1:] - want_lse[1:]).abs().max()) <= LSE_ATOL


@pytest.mark.cuda
def test_split_paged_kernel_rounds_p_to_bf16(cuda_device):
    """A bf16 pool and an f32 q (out f32): one row of three keys whose
    scores are about 0, -1 and -2, so p is no bf16 value.  One split and
    one warp chunk hold the row, so the kernel rounds p against the same
    max as the plain version: within ROUNDING_ATOL of it, while the
    unrounded result (the same keys in an f32 pool) lies further off."""
    d, ps = 16, 4
    q = torch.zeros((1, 1, d))
    q[0, 0, 0] = 1.0
    k = torch.zeros((1, ps, 1, d))
    k[0, :3, 0, 0] = torch.tensor([0.0, -1.0, -2.0]) * d ** 0.5
    v = torch.zeros((1, ps, 1, d))
    v[0, :3, 0, 0] = torch.tensor([1.0, 2.0, 4.0])
    kb, vb = k.bfloat16(), v.bfloat16()      # k and v are bf16 values
    tbl = torch.zeros((1, 1), dtype=torch.int32)
    ln = torch.tensor([3], dtype=torch.int32)
    assert _rule_splits(cuda_device, q, kb, tbl, 1) == 1
    want = paged_decode_attention_plain(q, kb, vb, tbl, ln)
    exact = paged_decode_attention_plain(q, k, v, tbl, ln)
    assert float((want - exact).abs().max()) > 10 * ROUNDING_ATOL
    dev = [t.to(cuda_device) for t in (q, kb, vb, tbl, ln)]
    got = paged_decode_attention(*dev).cpu()
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= ROUNDING_ATOL
    assert float((got - exact).abs().max()) > ROUNDING_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("d,heads,kvh", [(128, 16, 4), (64, 8, 8),
                                         (64, 32, 2), (16, 8, 2),
                                         (32, 12, 4), (256, 8, 1)])
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
def test_split_paged_kernel_head_dims_and_groups(cuda_device, d, heads,
                                                 kvh, pool):
    """Every head-dim case (16: llama_tiny's, 32, 64, 128, 256), group 1
    (MHA), 3 (a tile of 4 with a row masked), 4, 8 (int8: two tiles of
    4) and 16 (two tiles of 8), in each pool type, at the rule's 3 splits
    of 8 slots (rows of 3, 2 and 1 live splits)."""
    rng = np.random.default_rng(d + heads)
    L, pages, ps, b, w = 1, 30, 8, 3, 24
    q = torch.from_numpy(rng.standard_normal((b, heads, d)).astype(
        np.float32))
    kf, vf = (rng.standard_normal((L, pages, ps, kvh, d)).astype(np.float32)
              for _ in range(2))
    kw = {}
    if pool == "int8":
        kp, vp = (torch.from_numpy(np.clip(np.round(a * 40), -127,
                                           127).astype(np.int8))
                  for a in (kf, vf))
        kw = {"k_scales": torch.full((L, pages), 1 / 40.0),
              "v_scales": torch.full((L, pages), 1 / 40.0)}
    else:
        dt = torch.float32 if pool == "f32" else torch.bfloat16
        kp, vp = torch.from_numpy(kf).to(dt), torch.from_numpy(vf).to(dt)
    tables = torch.from_numpy(rng.integers(0, pages, (b, w)).astype(
        np.int32))
    lengths = torch.tensor([150, 3, 80], dtype=torch.int32)
    args = (q, kp, vp, tables, lengths)
    assert _rule_splits(cuda_device, q, kp, tables, 1) == 3
    want, want_lse = paged_decode_attention_plain(*args, return_lse=True,
                                                  splits=3, **kw)
    got, lse = paged_decode_attention(
        *[a.to(cuda_device) for a in args], return_lse=True,
        **{k: v.to(cuda_device) for k, v in kw.items()})
    torch.cuda.synchronize()
    if pool == "bf16":
        assert _rel(got.cpu(), want) <= PAGED_BF16_TOL
    else:
        assert float((got.cpu() - want).abs().max()) <= PAGED_ATOL
    assert float((lse.cpu() - want_lse).abs().max()) <= LSE_ATOL


@pytest.mark.cuda
def test_split_paged_kernel_raises_outside_its_cases(cuda_device):
    """Head dim 96, which raised before the masked case, now runs (the 128
    case masked to 96) within the bounds above; an int8 pool with a bf16
    q and a head dim above 256 still raise."""
    args, _ = _paged_inputs("f32", torch.float32, 96, 9, seed=96)
    want, want_lse = paged_decode_attention_plain(
        *args, layer=1, return_lse=True,
        splits=_rule_splits(cuda_device, args[0], args[1], args[3], 1))
    got, lse = paged_decode_attention(*[a.to(cuda_device) for a in args],
                                      layer=1, return_lse=True)
    torch.cuda.synchronize()
    assert float((got.cpu() - want).abs().max()) <= PAGED_ATOL
    assert float((lse.cpu()[1:] - want_lse[1:]).abs().max()) <= LSE_ATOL
    tbl = torch.zeros((1, 2), dtype=torch.int32, device=cuda_device)
    ln = torch.ones((1,), dtype=torch.int32, device=cuda_device)
    q = torch.zeros((1, 4, 320), device=cuda_device)
    pool = torch.zeros((1, 3, 4, 2, 320), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim 1..256"):
        paged_decode_attention(q, pool, pool, tbl, ln)
    q8 = torch.zeros((1, 4, 64), dtype=torch.bfloat16, device=cuda_device)
    pool8 = torch.zeros((1, 3, 4, 2, 64), dtype=torch.int8,
                        device=cuda_device)
    sc = torch.ones((1, 3), device=cuda_device)
    with pytest.raises(ValueError, match="float32 q"):
        paged_decode_attention(q8, pool8, pool8, tbl, ln, k_scales=sc,
                               v_scales=sc)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [20, 80, 96, 200])
@pytest.mark.parametrize("pool,q_dtype", [
    ("f32", torch.float32), ("bf16", torch.bfloat16), ("int8", torch.float32)])
def test_split_paged_kernel_off_list_head_dims(cuda_device, d, pool,
                                               q_dtype):
    """Head dims off the template list run the next listed case masked
    to d, reading the pools in place at a row stride of d: 16-byte loads
    where d values are a whole number of 16-byte vectors, scalar ones
    where not (bf16 at 20 and 200 is 40 and 400 bytes: 400 is whole; int8
    at 20 and 200; f32 never).  Against the split plain version at the
    rule's split count, with rows of length 0, 1, ragged and full: the
    bounds above, one launch counted."""
    args, kw = _paged_inputs(pool, q_dtype, d, 9, seed=d)
    q, kp, vp, tables, lengths = args
    splits = _rule_splits(cuda_device, q, kp, tables, 1)
    want, want_lse = paged_decode_attention_plain(
        *args, layer=1, return_lse=True, splits=splits, **kw)
    before = paged_decode_attention.launches
    got, lse = paged_decode_attention(
        *[a.to(cuda_device) for a in args], layer=1, return_lse=True,
        **{k: v.to(cuda_device) for k, v in kw.items()})
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    assert got.dtype == q_dtype and got.shape == q.shape
    got, lse = got.cpu(), lse.cpu()
    assert (got[0] == 0).all() and (lse[0] < -1e29).all()
    if pool == "bf16":
        assert _rel(got, want) <= PAGED_BF16_TOL
    else:
        assert float((got - want).abs().max()) <= PAGED_ATOL
    assert float((lse[1:] - want_lse[1:]).abs().max()) <= LSE_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["cluster", "warp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_fused_norm_designs_match_plain(cuda_device, design, dtype, kind):
    """Each design at 1, 8, 9, 64, 512 and 4096 rows of hidden 768, 2048,
    2050 (not a multiple of the 16-byte vector: the scalar case) and 4096,
    gamma and beta in res's dtype, against the plain version on the same
    inputs: y bit-equal, out within NORM_TOL of its largest magnitude, one
    launch counted, the design recorded.  Where a design does not take a
    width (``norm_launch`` None: the cluster design below 128 vectors a
    row), the forced call raises before any launch."""
    g = torch.Generator().manual_seed(len(kind) + dtype.itemsize)
    for hidden in (768, 2048, 2050, 4096):
        gamma = torch.randn((hidden,), generator=g).to(dtype)
        beta = (torch.randn((hidden,), generator=g).to(dtype)
                if kind == "layernorm" else None)
        for rows in (1, 8, 9, 64, 512, 4096):
            res, x = (torch.randn((rows, hidden), generator=g).to(dtype)
                      for _ in range(2))
            dev = [None if t is None else t.to(cuda_device)
                   for t in (res, x, gamma, beta)]
            if norm_launch(hidden, dtype, design) is None:
                with pytest.raises(ValueError, match="does not take"):
                    fused_residual_norm(*dev, kind=kind, design=design)
                continue
            want_y, want_o = fused_residual_norm_plain(res, x, gamma, beta,
                                                       kind=kind)
            before = fused_residual_norm.launches
            y, o = fused_residual_norm(*dev, kind=kind, design=design)
            torch.cuda.synchronize()
            assert fused_residual_norm.launches == before + 1
            assert fused_residual_norm.design == design
            assert y.dtype == o.dtype == dtype
            assert torch.equal(y.cpu(), want_y), (hidden, rows)
            assert _rel(o.cpu(), want_o) <= NORM_TOL[dtype], (hidden, rows)


def _pool_case(shape, dtype, tied, seed):
    g = torch.Generator().manual_seed(seed)
    if tied:
        x = torch.randint(-3, 3, shape, generator=g).float()
    else:
        x = torch.randn(shape, generator=g)
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,win,st,pad,dtype,tied", [
    ((2, 13, 17, 15), (3, 3), (2, 2), "SAME", torch.float32, False),
    ((2, 13, 17, 15), (3, 3), (2, 2), "SAME", torch.bfloat16, False),
    ((2, 13, 16, 16), (3, 3), (1, 1), "SAME", torch.bfloat16, True),
    ((4, 64, 28, 28), (3, 3), (2, 2), "SAME", torch.bfloat16, True),
    ((2, 24, 16, 16), (2, 2), (2, 2), "VALID", torch.float32, False),
    ((2, 8, 19, 19), (3, 3), (2, 2), "VALID", torch.bfloat16, False),
    ((1, 600, 9, 9), (3, 3), (1, 1), "SAME", torch.bfloat16, False),
])
def test_pool_kernel_cases_match_plain(cuda_device, shape, win, st, pad,
                                       dtype, tied):
    """Ragged channels (13, 15), ties, the generic case (2x2/2), VALID's
    uncovered last rows and 600 channels (75 vectors, above a block's
    64): the bits of the plain version."""
    x = _pool_case(shape, dtype, tied, seed=sum(shape))
    y = pool_bwd._pool_fwd(x, win, st, pad)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
    dy = dy.to(dtype).contiguous(memory_format=torch.channels_last)
    want = pool_bwd.max_pool_bwd_plain(x, y, dy, win, st, pad)
    before = pool_bwd.max_pool.launches
    got = pool_bwd.max_pool_bwd(*(t.to(cuda_device) for t in (x, y, dy)),
                                win, st, pad)
    torch.cuda.synchronize()
    assert pool_bwd.max_pool.launches == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got.cpu(), want)


def _qkv(b, s, h, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((b, s, 3, h, d), generator=g).to(dtype)
    do = torch.randn((b, s, h, d), generator=g).to(dtype)
    return qkv, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,causal", [(2, 100, 2, True),
                                          (1, 70, 3, False),
                                          (1, 1, 1, True)])
def test_flash_d256_kernels_match_plain_at_their_tiles(cuda_device, dtype, b,
                                                       s, h, causal):
    """The three FMA kernels at head dim 256 (32-row tiles, ragged last
    tiles at s 100 and 70) against the plain versions at those tiles,
    fed the plain forward's lse and D."""
    qkv, do = _qkv(b, s, h, 256, dtype, seed=s + h)
    q, k, v = qkv.unbind(2)
    bq, bk = fa.fwd_blocks(dtype, 256)
    blocks = fa.bwd_blocks(dtype, 256)
    assert (bq, bk) == (32, 32) and fa.fwd_design(dtype, 256) == "fma"
    want_o, want_lse = fa.flash_fwd_plain(q, k, v, causal, block_q=bq,
                                          block_k=bk)
    delta = fa.delta_rows(want_o, do)
    args = (q, k, v, do, want_lse, delta, causal)
    want_dq = fa.flash_dq_plain(*args, block_q=blocks["dq"][0],
                                block_k=blocks["dq"][1])
    want_dk, want_dv = fa.flash_dkv_plain(*args, block_q=blocks["dkv"][0],
                                          block_k=blocks["dkv"][1])
    dev_args = [t.to(cuda_device) for t in args[:6]]
    o, lse = fa.flash_fwd(*dev_args[:3], causal)
    dq = fa.flash_dq(*dev_args, causal)
    dk, dv = fa.flash_dkv(*dev_args, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.designs == dict.fromkeys(fa.KERNELS, "fma")
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    for got, want, name in ((o, want_o, "o"), (dq, want_dq, "dq"),
                            (dk, want_dk, "dk"), (dv, want_dv, "dv")):
        assert got.dtype == dtype
        if s == 1 and name in ("dq", "dk"):
            # one key: dQ and dK are zero but for the f32 rounding of
            # dP - D on both sides
            assert float(got.float().abs().max()) <= ONE_KEY_FLOOR[dtype]
            assert float(want.float().abs().max()) <= ONE_KEY_FLOOR[dtype]
        else:
            assert _rel(got.cpu(), want) <= tol, name
    assert float((lse.cpu() - want_lse).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_d320_kernels_match_plain_at_their_tiles(cuda_device, dtype):
    """The three FMA kernels at head dim 320 as ``flash_attention`` hands
    it over, zero-padded to 512 (two 256-wide chunks of the head dim, two
    column blocks of each output), ``[2, 256, 4, 320]`` causal, against
    the plain versions at the kernels' 32-row tiles on the same padded
    inputs, fed the plain forward's lse and D: the bounds above, and the
    padded columns of every output zero."""
    b, s, h, d = 2, 256, 4, 320
    dp = fa.padded_head_dim(d)
    assert dp == 512 and fa.fwd_blocks(dtype, d) == (32, 32)
    qkv, do = _qkv(b, s, h, d, dtype, seed=d)
    pad = torch.nn.functional.pad
    q, k, v = pad(qkv, (0, dp - d)).unbind(2)
    do = pad(do, (0, dp - d))
    scale = d ** -0.5
    want_o, want_lse = fa.flash_fwd_plain(q, k, v, True, scale, 32, 32)
    delta = fa.delta_rows(want_o, do)
    args = (q, k, v, do, want_lse, delta, True, scale)
    want_dq = fa.flash_dq_plain(*args, block_q=32, block_k=32)
    want_dk, want_dv = fa.flash_dkv_plain(*args, block_q=32, block_k=32)
    dev_args = [t.to(cuda_device) for t in args[:6]]
    o, lse = fa.flash_fwd(*dev_args[:3], True, scale)
    dq = fa.flash_dq(*dev_args, True, scale)
    dk, dv = fa.flash_dkv(*dev_args, True, scale)
    torch.cuda.synchronize()
    assert fa.flash_attention.designs == dict.fromkeys(fa.KERNELS, "fma")
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    for got, want, name in ((o, want_o, "o"), (dq, want_dq, "dq"),
                            (dk, want_dk, "dk"), (dv, want_dv, "dv")):
        assert got.dtype == dtype and got.shape == want.shape
        assert _rel(got.cpu(), want) <= tol, name
        assert not got[..., d:].any(), name
    assert float((lse.cpu() - want_lse).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_head_dim_192_on_card(cuda_device, dtype):
    """``flash_attention`` at head dim 192 through autograd: padded to
    256, one launch of each kernel, and within the tolerance of the CPU
    route (the plain version at 64-row tiles)."""
    qkv, do = _qkv(2, 90, 2, 192, dtype, seed=9)
    outs = []
    for dev in ("cpu", cuda_device):
        x = qkv.to(dev).detach().clone().requires_grad_()
        before = dict(fa.flash_attention.launches)
        o = fa.flash_attention(*x.unbind(2), causal=False)
        o.backward(do.to(dev))
        outs.append((o.detach().cpu(), x.grad.cpu()))
    torch.cuda.synchronize()
    assert {k: fa.flash_attention.launches[k] - before[k]
            for k in before} == {"fwd": 1, "dq": 1, "dkv": 1}
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    for got, want in zip(outs[1], outs[0]):
        assert got.shape == want.shape
        assert _rel(got, want) <= tol


@pytest.mark.cuda
def test_feeder_on_the_card(cuda_device):
    """Pinned copies on the copy stream: every batch arrives intact,
    each held on the card while the ring's three slots are refilled many
    times over behind a slow step."""
    rng = np.random.default_rng(0)
    host = [(rng.integers(0, 256, (64, 32, 32, 3), np.uint8),
             rng.integers(0, 1000, (64,), np.int32)) for _ in range(40)]
    got = []
    for x, y in DeviceFeeder(iter(host), cuda_device, depth=2):
        torch.cuda._sleep(100_000)            # a slow step
        got.append((x.clone(), y.clone()))
    for (gx, gy), (hx, hy) in zip(got, host):
        assert gx.dtype == torch.uint8 and gy.dtype == torch.int64
        np.testing.assert_array_equal(gx.permute(0, 2, 3, 1).cpu().numpy(),
                                      hx)
        np.testing.assert_array_equal(gy.cpu().numpy(), hy)
    assert len(got) == len(host)
