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


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,d,causal,fused", [
    (2, 256, 256, 3, 64, True, True),       # fused-QKV views
    (1, 1000, 1000, 2, 128, False, True),   # ragged last tiles, d 128
    (2, 300, 1000, 2, 64, False, False),    # sq != sk, sk 1000
    (1, 700, 700, 2, 128, True, False),     # causal at d 128
    (2, 77, 200, 1, 64, True, False),       # causal, sq < sk
    (4, 128, 128, 12, 64, False, True),     # BERT's tile, one per head
    (3, 1, 1, 2, 64, True, False),          # one query, one key
    (1, 200, 33, 2, 128, True, False),      # causal, sq > sk
])
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
