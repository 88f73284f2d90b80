"""The port's ``--quant`` arms against the JAX package, on the CPU.

- **int8_w**: ``quantize_weights`` leaves against JAX's for the llama
  and GPT minis: the int8 tensors equal and the scales bit-equal (both
  sides quantize in float32 with the same ``max(amax/127, 1e-8)`` floor
  and round half to even); JAX's ``[in, ..., out]`` kernels are laid out
  as the port's ``[out, in]``.  Then the programs' logits against JAX's
  ``int8_w`` programs over the fixed feed (atol 1e-4, as the float32
  programs: the same int8 values and scales, only the sums' order
  differs), the greedy argmax equal.
- **int8_kv**: ``_write_quantized_chunks`` and ``_append_quantized``
  bit-equal to JAX's (pages and scales), on a pool whose appended pages
  hold another request's stale values past the offset; then the paged
  program's logits against JAX's ``int8_kv`` paged program (atol 1e-4,
  met with 2.3e-7 on this feed: no K/V value computed in another
  summation order rounds to a neighbouring int8 step here), the argmax
  equal.
- **no fallback**: ``int8_kv`` under the gather arm raises JAX's
  message from the decode program and from the flags.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_hc_bench import flags as jax_flags
from tpu_hc_bench.serve import decode as jax_decode
from tpu_hc_bench_torch import flags
from tpu_hc_bench_torch.serve import decode as decode_mod

from test_torch_serve import _mini_pair
from test_torch_serve_gpt import (PROGRAM_ATOL, gpt_mini_pair, jax_feed,
                                  port_feed)
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

def _jax_leaves(family, params):
    """JAX's quantized leaves by the port's state_dict names, laid out
    ``[out, in]``."""
    q = jax_decode.quantize_weights(family, params)
    out = {}
    for l in range(family.num_layers):
        for path, caxes in family.quant_paths(l):
            leaf = q
            for k in path:
                leaf = leaf[k]
            qa = np.asarray(leaf["q"])
            sa = np.asarray(leaf["scale"])
            # contract axes lead: [in..., out...] -> [out, in]
            n_in = int(np.prod([qa.shape[a] for a in caxes]))
            out[path] = (qa.reshape(n_in, -1).T, sa.reshape(-1))
    return out


_LLAMA_NAMES = {"wq": "attn.wq", "wk": "attn.wk", "wv": "attn.wv",
                "wo": "attn.wo", "gate": "gate", "up": "up",
                "down": "down"}
_GPT_NAMES = {"qkv": "attn.qkv", "out": "attn.out", "fc": "fc",
              "proj": "proj"}


def _port_name(path) -> str:
    l = int(path[0].split("_")[1])
    names = {**_LLAMA_NAMES, **_GPT_NAMES}
    key = next(k for k in reversed(path[:-1]) if k in names)
    return f"layers.{l}.{names[key]}.weight"


@pytest.mark.parametrize("family_name", ["llama", "gpt"])
def test_quantize_weights_leaves_equal_jax(family_name):
    model, params, port = (_mini_pair() if family_name == "llama"
                           else gpt_mini_pair())
    want = _jax_leaves(jax_decode.build_family(model, quant="int8_w"),
                       params)
    fam = decode_mod.build_family(port, quant="int8_w")
    got = decode_mod.quantize_weights(fam)
    assert got.keys() == fam.qweights.keys()
    assert sorted(_port_name(p) for p in want) == sorted(got)
    for path, (q, scale) in want.items():
        leaf = got[_port_name(path)]
        assert leaf["q"].dtype == torch.int8
        np.testing.assert_array_equal(leaf["q"].numpy(), q)
        assert leaf["scale"].numpy().tobytes() == \
            scale.astype(np.float32).tobytes()
    # the int8 projections read a quarter of their float32 bytes, plus
    # one float32 scale an output channel
    full = decode_mod.build_family(port).weight_bytes()
    qbytes = sum(p["q"].numel() for p in got.values())
    assert fam.weight_bytes() == full - 3 * qbytes + 4 * sum(
        p["scale"].numel() for p in got.values())


@pytest.mark.parametrize("family_name,attention", [
    ("llama", "paged"), ("llama", "gather"), ("gpt", "paged")])
def test_int8_w_programs_match_jax(family_name, attention):
    model, params, port = (_mini_pair() if family_name == "llama"
                           else gpt_mini_pair())
    want, want_first = jax_feed(model, params, attention, quant="int8_w")
    got, first = port_feed(port, attention, quant="int8_w")
    assert first == want_first
    np.testing.assert_allclose(got, want, atol=PROGRAM_ATOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def _stale_pool(rng, layers=2, pages=6, ps=4, kvh=2, d=8):
    """An int8 pool whose pages hold a previous occupant's values."""
    q = rng.integers(-127, 128, (layers, pages, ps, kvh, d)).astype(np.int8)
    sc = rng.uniform(0.01, 0.5, (layers, pages)).astype(np.float32)
    return q, sc


def test_write_quantized_chunks_bit_equal_to_jax():
    rng = np.random.default_rng(21)
    q, sc = _stale_pool(rng)
    new = rng.standard_normal((2, 8, 2, 8)).astype(np.float32)
    new[:, 6:] = 0.0                    # pads zeroed, as prefill does
    table = np.array([3, 5, 1], np.int32)
    jq, js = jax_decode._write_quantized_chunks(
        jnp.asarray(q), jnp.asarray(sc), jnp.asarray(new),
        jnp.asarray(table), 6, 4, 3)
    tq, ts = torch.from_numpy(q.copy()), torch.from_numpy(sc.copy())
    decode_mod._write_quantized_chunks(tq, ts, torch.from_numpy(new),
                                       torch.from_numpy(table), 6, 4, 3)
    written = [3, 5]                    # the two chunks of a 6-token prompt
    np.testing.assert_array_equal(tq.numpy()[:, written],
                                  np.asarray(jq)[:, written])
    assert ts.numpy()[:, written].tobytes() == \
        np.asarray(js)[:, written].tobytes()
    untouched = [1, 2, 4]
    np.testing.assert_array_equal(tq.numpy()[:, untouched], q[:, untouched])


def test_append_quantized_bit_equal_to_jax_on_stale_pages():
    """Rows past each offset hold stale values; both sides zero them
    before the amax, so the fresh token sets its page's scale."""
    rng = np.random.default_rng(22)
    q, sc = _stale_pool(rng)
    page_idx = np.array([2, 4, 0], np.int32)       # two rows + a pad row
    offset = np.array([0, 3, 0], np.int32)
    new = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    jq, js = jax_decode._append_quantized(
        jnp.asarray(q), jnp.asarray(sc), jnp.asarray(page_idx),
        jnp.asarray(offset), jnp.asarray(new))
    tq, ts = torch.from_numpy(q.copy()), torch.from_numpy(sc.copy())
    decode_mod._append_quantized(tq, ts, torch.from_numpy(page_idx).long(),
                                 torch.from_numpy(offset).long(),
                                 torch.from_numpy(new))
    rows = [2, 4]
    np.testing.assert_array_equal(tq.numpy()[:, rows],
                                  np.asarray(jq)[:, rows])
    assert ts.numpy()[:, rows].tobytes() == \
        np.asarray(js)[:, rows].tobytes()
    # page 2 takes its first token at offset 0: the stale rows are gone
    # and the fresh token alone sets the scale
    assert (tq.numpy()[:, 2, 1:] == 0).all()
    np.testing.assert_array_equal(
        ts.numpy()[:, 2], np.abs(new[:, 0]).max(axis=(1, 2)) / 127.0)
    stale = np.abs(q[:, 2, 1:].astype(np.float32)).max(axis=(1, 2, 3))
    assert (ts.numpy()[:, 2] < stale * sc[:, 2]).all()


def test_int8_kv_paged_program_matches_jax():
    model, params, port = _mini_pair()
    want, want_first = jax_feed(model, params, "paged", quant="int8_kv")
    got, first = port_feed(port, "paged", quant="int8_kv")
    assert first == want_first
    np.testing.assert_allclose(got, want, atol=PROGRAM_ATOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    f32, _ = port_feed(port, "paged")
    assert np.abs(got - f32).max() > 0      # the pool really is int8


def test_int8_kv_state_and_page_copy():
    _, _, port = _mini_pair()
    fam = decode_mod.build_family(port)
    kv = decode_mod.init_kv_state(fam, 5, 4, quant="int8_kv", device="cpu")
    assert [x.dtype for x in kv] == [torch.int8, torch.int8,
                                     torch.float32, torch.float32]
    assert kv[2].shape == (2, 5) and (kv[2] == 1).all()
    assert kv[2].data_ptr() != kv[3].data_ptr()
    kv[0][:, 2] = 7
    kv[2][:, 2] = 0.25
    decode_mod.build_page_copy_fn()(kv, 2, 4)
    assert (kv[0][:, 4] == 7).all() and (kv[2][:, 4] == 0.25).all()
    assert (kv[1][:, 4] == 0).all() and (kv[3][:, 4] == 1).all()


def test_int8_kv_under_gather_raises_as_jax_does():
    _, _, port = _mini_pair()
    fam = decode_mod.build_family(port)
    with pytest.raises(ValueError, match="gather reference has no "
                       "scale-fused read path"):
        decode_mod.build_decode_fn(fam, 4, 4, attention="gather",
                                   quant="int8_kv")
    msg = "set --decode_attention=paged"
    with pytest.raises(ValueError, match=msg):
        flags.ServeConfig(model="llama_tiny", quant="int8_kv").resolve()
    with pytest.raises(ValueError, match=msg):
        jax_flags.BenchmarkConfig(model="llama_tiny", workload="serve",
                                  quant="int8_kv").resolve()
