"""The port's Hopper (wgmma) kernels against their plain versions, on the
card.

This file imports no JAX, so it runs on a machine with the card and no
JAX stack (there: ``python -m pytest --noconftest -q
tests/test_torch_sm90.py``); here every test skips for want of a GPU,
and the plain versions are held against the JAX package in
``test_torch_ops.py``.

- the lone warpgroup product of ``csrc/sm90_selftest.cu`` against
  ``torch.matmul``: every descriptor mode the kernels use (K-major and
  MN-major B, A from shared memory or registers) at N and K 64 and 128,
  within 1e-5 of the largest magnitude (bf16 products are exact in f32;
  only the order of the f32 sums differs), far below what a layout
  mismatch gives;
- the bf16 flash forward (``csrc/flash_fwd_sm90.cu``) at odd shapes
  against ``flash_fwd_plain`` at the kernel's tiles: o within 1e-2 of its
  largest magnitude (bf16 outputs rounded to 2^-8, P rounded to bf16
  before P V) and lse within 1e-2 absolute; the f32 design at 1e-4;
- the bf16 flash backward (``csrc/flash_bwd_sm90.cu``, dQ and dK/dV) at
  the same shapes against ``flash_dq_plain`` and ``flash_dkv_plain`` at
  the kernels' tiles (``bwd_blocks``), fed the plain forward's lse and
  D: each gradient within 1e-2 of its largest magnitude (dS and P
  rounded to bf16 before their products); with one key, dQ and dK are
  zero, and both sides within 1e-3 of it (the f32 rounding of dP - D);
  the f32 design at 1e-4;
- all three kernels at b * h above 65535, a few heads of it against the
  plain version on those heads alone; the padded route of
  ``flash_attention`` at head dims 32 and 96 (the kernels' bits at the
  padded width, sliced back, and the CPU route within 1e-2); a head dim
  above 256 (320, padded to 512) through autograd against the CPU route;
- the bf16 fused conv (``csrc/fused_conv_sm90.cu``) at Cout 64, 128, 192
  and 512, a ragged last tile, H != W, a 1 x 1 image and the widest
  window it takes (W 62), and the other designs at the shapes the rule
  sends them (Cin % 64 != 0, W > 62, float32): y2 within 1e-2 (f32:
  1e-4) and the stats within 1e-4 of their largest magnitudes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpu_hc_bench_torch.ops import _build
from tpu_hc_bench_torch.ops import flash_attention as fa
from tpu_hc_bench_torch.ops.fused_conv import (
    conv_design, fused_bn_relu_conv, fused_bn_relu_conv_plain)

TILE_TOL = 1e-5
BF16_TOL = 1e-2
F32_TOL = 1e-4
STATS_TOL = 1e-4
# with one key dQ and dK are zero; what is left is the f32 rounding of
# dP - D (64 products of O(1) terms, ~1e-5), scaled and rounded to bf16
ONE_KEY_FLOOR = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested in "
                    "test_torch_ops.py)")
    return torch.device("cuda")


def _rel(got, want):
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("k", [64, 128])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_lone_wgmma_tile_matches_matmul(cuda_device, n, k, mode):
    """C [64, n] = A [64, k] B: mode 0 takes B as Bt [n, k] (K-major),
    modes 1 (A in shared memory) and 2 (A in registers) as [k, n]
    (MN-major, the transpose bit)."""
    g = torch.Generator().manual_seed(n + k + mode)
    a = torch.randn((64, k), generator=g).to(torch.bfloat16)
    b = torch.randn((k, n), generator=g).to(torch.bfloat16)
    want = a.float() @ b.float()
    b_in = b.t().contiguous() if mode == 0 else b
    a_d, b_d = a.to(cuda_device), b_in.to(cuda_device)
    c = torch.empty((64, n), dtype=torch.float32, device=cuda_device)
    err = _build.load_library().thb_sm90_wgmma_tile(
        a_d.data_ptr(), b_d.data_ptr(), c.data_ptr(), n, k, mode,
        _build.stream_ptr(cuda_device))
    _build.check(err, "wgmma tile")
    torch.cuda.synchronize()
    assert _rel(c.cpu(), want) <= TILE_TOL


def _qkv(b, sq, sk, h, d, fused, dtype, seed):
    rng = np.random.default_rng(seed)
    if fused:
        x = torch.from_numpy(
            rng.standard_normal((b, sq, 3, h, d)).astype(np.float32))
        return x.to(dtype).unbind(2)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, h, d)).astype(np.float32)
            for _ in range(2))
    return tuple(torch.from_numpy(t).to(dtype) for t in (q, k, v))


FLASH_SHAPES = [
    (2, 256, 256, 3, 64, True, True),       # fused-QKV views
    (1, 1000, 1000, 2, 128, False, True),   # ragged last tiles, d 128
    (2, 300, 1000, 2, 64, False, False),    # sq != sk, sk 1000
    (1, 700, 700, 2, 128, True, False),     # causal at d 128
    (2, 77, 200, 1, 64, True, False),       # causal, sq < sk
    (4, 128, 128, 12, 64, False, True),     # BERT's tile, one per head
    (3, 1, 1, 2, 64, True, False),          # one query, one key
    (1, 200, 33, 2, 128, True, False),      # causal, sq > sk
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,d,causal,fused", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_fwd_matches_plain_at_its_tiles(cuda_device, b, sq, sk, h, d,
                                              causal, fused, dtype):
    q, k, v = _qkv(b, sq, sk, h, d, fused, dtype, seed=sq + sk + d)
    bq, bk = fa.fwd_blocks(dtype, d)
    want_o, want_lse = fa.flash_fwd_plain(q, k, v, causal, block_q=bq,
                                          block_k=bk)
    before = fa.flash_attention.launches["fwd"]
    o, lse = fa.flash_fwd(*(t.to(cuda_device) for t in (q, k, v)), causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches["fwd"] == before + 1
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    assert o.dtype == dtype and o.is_contiguous()
    assert _rel(o.cpu(), want_o) <= tol
    assert float((lse.cpu() - want_lse).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,d,causal,fused", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_matches_plain_at_its_tiles(cuda_device, b, sq, sk, h, d,
                                              causal, fused, dtype):
    q, k, v = _qkv(b, sq, sk, h, d, fused, dtype, seed=sq + sk + d + 1)
    do = torch.from_numpy(np.random.default_rng(sq + d).standard_normal(
        (b, sq, h, d)).astype(np.float32)).to(dtype)
    o, lse = fa.flash_fwd_plain(q, k, v, causal)
    delta = fa.delta_rows(o, do)
    args = (q, k, v, do, lse, delta, causal)
    blocks = fa.bwd_blocks(dtype, d)
    want_dq = fa.flash_dq_plain(*args, block_q=blocks["dq"][0],
                                block_k=blocks["dq"][1])
    want_dk, want_dv = fa.flash_dkv_plain(*args, block_q=blocks["dkv"][0],
                                          block_k=blocks["dkv"][1])
    before = dict(fa.flash_attention.launches)
    dev = [t.to(cuda_device) for t in args[:6]]
    dq = fa.flash_dq(*dev, causal)
    dk, dv = fa.flash_dkv(*dev, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches["dq"] == before["dq"] + 1
    assert fa.flash_attention.launches["dkv"] == before["dkv"] + 1
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    for got, want, name in ((dq, want_dq, "dq"), (dk, want_dk, "dk"),
                            (dv, want_dv, "dv")):
        assert got.dtype == dtype and got.is_contiguous()
        got = got.cpu().float()
        if sk == 1 and name != "dv":
            # one key: P is 1 and dP - D is 0, so dQ and dK are zero and
            # both sides hold only the f32 rounding of dP - D
            assert float(got.abs().max()) <= ONE_KEY_FLOOR
            assert float(want.float().abs().max()) <= ONE_KEY_FLOOR
        else:
            assert _rel(got, want) <= tol, name


@pytest.mark.cuda
def test_flash_kernels_take_batch_heads_above_65535(cuda_device):
    """b * h = 65540 (b 16385, h 4) at a ragged 40-token sequence, bf16,
    causal, through the autograd wrapper: the first and last batch rows
    of o and the three gradients against the plain version run on those
    rows alone, within 1e-2 of their largest magnitudes."""
    b, s, h, d = 16385, 40, 4, 64
    g = torch.Generator(device=cuda_device).manual_seed(5)
    qkv = torch.randn((b, s, 3, h, d), generator=g,
                      device=cuda_device).to(torch.bfloat16)
    do = torch.randn((b, s, h, d), generator=g,
                     device=cuda_device).to(torch.bfloat16)
    x = qkv.requires_grad_()
    o = fa.flash_attention(*x.unbind(2), causal=True)
    o.backward(do)
    torch.cuda.synchronize()
    rows = [0, b - 1]
    xc = qkv.detach()[rows].cpu().requires_grad_()
    oc = fa.flash_attention(*xc.unbind(2), causal=True)
    oc.backward(do[rows].cpu())
    assert _rel(o.detach()[rows].cpu(), oc.detach()) <= BF16_TOL
    assert _rel(x.grad[rows].cpu(), xc.grad) <= BF16_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("d,causal", [(32, True), (96, False)])
def test_flash_padded_route_on_card(cuda_device, d, causal):
    """``flash_attention`` at a head dim the kernels do not take, bf16,
    through autograd: o and the gradients have the caller's width and
    carry the same bits as the three kernels called on inputs zero-padded
    to ``padded_head_dim(d)`` with the scale of d, sliced back (so the
    wrapper padded and sliced); and they agree with the CPU route within
    1e-2 of their largest magnitudes, as above."""
    b, s, h = 8, 130, 4                        # a ragged last tile
    dp = fa.padded_head_dim(d)
    g = torch.Generator(device=cuda_device).manual_seed(d)
    qkv = torch.randn((b, s, 3, h, d), generator=g,
                      device=cuda_device).to(torch.bfloat16)
    do = torch.randn((b, s, h, d), generator=g,
                     device=cuda_device).to(torch.bfloat16)
    before = dict(fa.flash_attention.launches)
    x = qkv.clone().requires_grad_()
    o = fa.flash_attention(*x.unbind(2), causal=causal)
    o.backward(do)
    torch.cuda.synchronize()
    assert {k: fa.flash_attention.launches[k] - before[k]
            for k in before} == {"fwd": 1, "dq": 1, "dkv": 1}
    assert o.shape == (b, s, h, d) and x.grad.shape == qkv.shape

    pad = torch.nn.functional.pad
    q, k, v = pad(qkv, (0, dp - d)).unbind(2)
    dop = pad(do, (0, dp - d))
    scale = 1.0 / d ** 0.5
    po, lse = fa.flash_fwd(q, k, v, causal, scale)
    args = (q, k, v, dop, lse, fa.delta_rows(po, dop), causal, scale)
    pdq = fa.flash_dq(*args)
    pdk, pdv = fa.flash_dkv(*args)
    want = torch.stack([t[..., :d] for t in (pdq, pdk, pdv)], 2)
    assert torch.equal(o.detach(), po[..., :d])
    assert torch.equal(x.grad, want)

    xc = qkv.cpu().requires_grad_()
    oc = fa.flash_attention(*xc.unbind(2), causal=causal)
    oc.backward(do.cpu())
    assert _rel(o.detach().cpu(), oc.detach()) <= BF16_TOL
    assert _rel(x.grad.cpu(), xc.grad) <= BF16_TOL


@pytest.mark.cuda
def test_flash_head_dim_above_128_raises_on_card(cuda_device):
    """Head dims 129..256 run padded to 256, and since the FMA kernels
    loop over 256-wide chunks a head dim above 256 no longer raises: 320
    runs padded to 512 through autograd, one launch of each kernel, o and
    the gradients at the caller's width within 1e-2 of the CPU route's
    largest magnitudes (bf16, as above)."""
    b, s, h, d = 1, 70, 2, 320
    g = torch.Generator(device=cuda_device).manual_seed(d)
    qkv = torch.randn((b, s, 3, h, d), generator=g,
                      device=cuda_device).to(torch.bfloat16)
    do = torch.randn((b, s, h, d), generator=g,
                     device=cuda_device).to(torch.bfloat16)
    before = dict(fa.flash_attention.launches)
    x = qkv.clone().requires_grad_()
    o = fa.flash_attention(*x.unbind(2), causal=True)
    o.backward(do)
    torch.cuda.synchronize()
    assert {k: fa.flash_attention.launches[k] - before[k]
            for k in before} == {"fwd": 1, "dq": 1, "dkv": 1}
    assert o.shape == (b, s, h, d) and x.grad.shape == qkv.shape
    xc = qkv.cpu().requires_grad_()
    oc = fa.flash_attention(*xc.unbind(2), causal=True)
    oc.backward(do.cpu())
    assert _rel(o.detach().cpu(), oc.detach()) <= BF16_TOL
    assert _rel(x.grad.cpu(), xc.grad) <= BF16_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,dtype,design", [
    (2, 14, 14, 128, 128, torch.bfloat16, "wgmma_n128"),
    (3, 7, 7, 64, 192, torch.bfloat16, "wgmma_n64"),   # 147 pixels: ragged
    (4, 56, 56, 64, 64, torch.bfloat16, "wgmma_n64"),
    (4, 7, 7, 512, 512, torch.bfloat16, "wgmma_n128"),
    (2, 5, 9, 128, 64, torch.bfloat16, "wgmma_n64"),   # H != W
    (3, 1, 1, 64, 128, torch.bfloat16, "wgmma_n128"),  # all halo
    (1, 3, 62, 64, 128, torch.bfloat16, "wgmma_n128"),  # the widest window
    (2, 9, 9, 96, 64, torch.bfloat16, "wmma"),         # Cin % 64 != 0
    (1, 64, 64, 64, 64, torch.bfloat16, "wmma"),       # W > 62
    (2, 9, 9, 64, 128, torch.float32, "fma"),
])
def test_fused_conv_designs_match_plain(cuda_device, n, h, w, cin, cout,
                                        dtype, design):
    rng = np.random.default_rng(cin + cout + h + w)
    y1 = torch.from_numpy(
        rng.standard_normal((n, h, w, cin)).astype(np.float32)).to(dtype)
    a = torch.from_numpy((0.5 + np.abs(rng.standard_normal(cin)))
                         .astype(np.float32))
    b = torch.from_numpy((0.2 * rng.standard_normal(cin)).astype(np.float32))
    wt = torch.from_numpy((rng.standard_normal((3, 3, cin, cout))
                           * (2.0 / (9 * cin)) ** 0.5).astype(np.float32))
    wt = wt.to(dtype)
    assert conv_design(dtype, w, cin, cout) == design
    want = fused_bn_relu_conv_plain(y1, a, b, wt)
    before = fused_bn_relu_conv.launches
    got = fused_bn_relu_conv(*(t.to(cuda_device) for t in (y1, a, b, wt)))
    torch.cuda.synchronize()
    assert fused_bn_relu_conv.launches == before + 1
    y_tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    assert _rel(got[0].cpu(), want[0]) <= y_tol
    assert _rel(got[1].cpu(), want[1]) <= STATS_TOL
    assert _rel(got[2].cpu(), want[2]) <= STATS_TOL
