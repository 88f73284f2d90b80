"""The port's GPT serving family against the JAX package, on the CPU.

- **programs**: a Flax ``GPTLM`` mini (2 layers, hidden 64, 4 heads,
  vocab 128; every weight perturbed so biases and LayerNorm shifts carry
  information), carried to the port by ``convert.gpt_params_from_flax``:
  the port's prefill + decode programs (both attention arms) against
  JAX's ``build_prefill_fn``/``build_decode_fn`` over the fixed-feed
  protocol of ``test_torch_serve.py`` (atol 1e-4 on the logits, the
  first token and the greedy argmax equal).  The paged arm fuses the
  LayerNorm-with-bias residual pairs (``fused_residual_norm``'s plain
  version here).
- **engine**: a ``ServeEngine`` over the mini in virtual time whose
  tokens equal the mini's own full-context greedy forward.
- **gate**: MLM members refused with JAX's message, a classify member
  refused the decode lane's knobs (the classify mode itself:
  ``test_torch_serve_classify.py``), gpt2's position table sized to the
  context.
- **the kernels' contract**: every operand the paged programs hand the
  two kernel wrappers is contiguous and of a dtype the CUDA kernels
  take (they refuse others on the card; their plain versions here take
  anything).
- **MoE**: a Flax ``GPTLM`` mini with 4 top-2 experts a layer (the
  ``moe_tiny`` shape, narrowed as the GPT mini), its experts perturbed
  too: the port's programs (both attention arms, and ``int8_w``, whose
  router and experts stay float32) against JAX's over the fixed feed
  (atol 1e-4, tokens equal); both dispatch ragged, whatever the model's
  ``moe_impl``; the engine's tokens equal the mini's own full-context
  greedy forward under the ragged dispatch; and ``serve --model=moe_tiny``
  on the CPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_hc_bench.models import gpt as jax_gpt
from tpu_hc_bench.serve import decode as jax_decode
from tpu_hc_bench_torch import convert, flags
from tpu_hc_bench_torch.models import gpt
from tpu_hc_bench_torch.serve import decode as decode_mod
from tpu_hc_bench_torch.serve import engine as engine_mod

from test_torch_serve import _fixed_feed, _greedy, _TokenTap
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

GPT_MINI = dict(vocab_size=128, hidden=64, num_layers=2, heads=4, ffn=128,
                max_len=32)
PROGRAM_ATOL = 1e-4
VCOSTS = {"prefill": 0.004, "decode": 0.003, "page_copy": 0.001}


@functools.lru_cache(maxsize=None)
def gpt_mini_pair():
    """A Flax GPT mini with perturbed params, and the port's twin."""
    model = jax_gpt.GPTLM(**GPT_MINI)
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32),
                        train=False)["params"]
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.standard_normal(
            x.shape).astype(np.float32), params)
    port = gpt.GPTLM(**GPT_MINI)
    port.load_state_dict(convert.gpt_params_from_flax(params))
    return model, params, port.eval()


def jax_feed(model, params, attention: str, quant: str = "off"):
    """JAX's programs over the fixed feed (pool of 9 pages of 4)."""
    family = jax_decode.build_family(model, quant=quant)
    exec_params = (jax_decode.quantize_weights(family, params)
                   if quant == "int8_w" else params)
    kv = jax_decode.init_kv_state(family, 1 + 2 * 4, 4, jnp.float32,
                                  quant=quant)
    pre = jax.jit(jax_decode.build_prefill_fn(family, 4, 4, quant=quant))
    dec = jax.jit(jax_decode.build_decode_fn(family, 4, 4,
                                             attention=attention,
                                             quant=quant))

    def prefill(kv, toks, n, table):
        tok, _, kv = pre(exec_params, kv, toks, np.int32(n), table)
        return int(np.asarray(tok)[0]), kv

    def decode(kv, toks, tables, lengths, active):
        _, logits, kv = dec(exec_params, kv, toks, tables, lengths, active)
        return np.asarray(logits), kv

    return _fixed_feed(prefill, decode, kv)


def port_feed(port, attention: str, quant: str = "off"):
    """The port's programs over the same feed."""
    family = decode_mod.build_family(port, quant=quant)
    kv = decode_mod.init_kv_state(family, 1 + 2 * 4, 4, quant=quant,
                                  device="cpu")
    pre = decode_mod.build_prefill_fn(family, 4, 4, quant=quant)
    dec = decode_mod.build_decode_fn(family, 4, 4, attention=attention,
                                     quant=quant)
    t = torch.from_numpy

    def prefill(kv, toks, n, table):
        tok, _, kv = pre(kv, t(toks), n, t(table))
        return int(tok[0]), kv

    def decode(kv, toks, tables, lengths, active):
        _, logits, kv = dec(kv, t(toks), t(tables), t(lengths), t(active))
        return logits.numpy(), kv

    return _fixed_feed(prefill, decode, kv)


MOE_MINI = dict(GPT_MINI, num_experts=4)


@functools.lru_cache(maxsize=None)
def moe_mini_pair():
    """A Flax MoE GPT mini with perturbed params, and the port's twin
    (einsum: serving dispatches ragged all the same)."""
    model = jax_gpt.GPTLM(**MOE_MINI)
    params = model.init(jax.random.PRNGKey(4), jnp.zeros((1, 8), jnp.int32),
                        train=False)["params"]
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.standard_normal(
            x.shape).astype(np.float32), params)
    port = gpt.GPTLM(**MOE_MINI)
    port.load_state_dict(convert.gpt_params_from_flax(params))
    return model, params, port.eval()


@pytest.mark.parametrize("attention,quant", [
    ("paged", "off"), ("gather", "off"), ("paged", "int8_w")])
def test_moe_programs_match_jax_fixed_feed(attention, quant):
    model, params, port = moe_mini_pair()
    want, want_first = jax_feed(model, params, attention, quant=quant)
    got, first = port_feed(port, attention, quant=quant)
    assert first == want_first
    np.testing.assert_allclose(got, want, atol=PROGRAM_ATOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_moe_family_keeps_experts_float32_under_int8_w():
    _, _, port = moe_mini_pair()
    fam = decode_mod.build_family(port, quant="int8_w")
    assert fam.quant_paths(1) == ["layers.1.attn.qkv.weight",
                                  "layers.1.attn.out.weight"]
    assert not any("moe" in k for k in fam.qweights)
    assert fam.weight_bytes() < sum(p.nbytes for p in port.parameters())


def test_moe_engine_tokens_match_ragged_greedy():
    """The engine (paged) decodes the greedy tokens of the mini's full
    forward under the ragged dispatch (no capacity drops)."""
    model, params, _ = moe_mini_pair()
    port = gpt.GPTLM(**MOE_MINI, moe_impl="ragged")
    port.load_state_dict(convert.gpt_params_from_flax(params))
    port.eval()
    eng = engine_mod.ServeEngine(_gpt_cfg(model="moe_tiny",
                                          decode_attention="paged"),
                                 print_fn=lambda _m: None, model=port)
    rng = np.random.default_rng(9)
    reqs = [engine_mod.Request(
        rid=i, arrival_s=0.01 * i,
        prompt=rng.integers(1, 128, 3 + 2 * i).astype(np.int32),
        output_len=2 + i % 4) for i in range(5)]
    tap = _TokenTap()
    summary = eng.run(reqs, writer=tap, clock=engine_mod.VirtualClock(VCOSTS))
    assert summary["completed"] == 5
    for r in reqs:
        assert tap.tokens[r.rid] == _greedy(port, r.prompt, r.output_len)


def test_moe_tiny_serve_cli_on_the_cpu():
    from tpu_hc_bench_torch.serve import cli

    lines: list[str] = []
    rc = cli.main(["--model=moe_tiny", "--device=cpu",
                   "--decode_attention=paged", "--num_requests=4",
                   "--max_prompt_len=12", "--max_output_len=4",
                   "--max_in_flight=2", "--kv_page_size=4"],
                  print_fn=lines.append)
    assert rc == 0 and any("tokens" in ln for ln in lines)


@pytest.mark.parametrize("attention", ["paged", "gather"])
def test_gpt_programs_match_jax_fixed_feed(attention):
    model, params, port = gpt_mini_pair()
    want, want_first = jax_feed(model, params, attention)
    got, first = port_feed(port, attention)
    assert first == want_first
    assert got.shape == (2, 2, GPT_MINI["vocab_size"])
    np.testing.assert_allclose(got, want, atol=PROGRAM_ATOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_gpt_family_shape():
    _, _, port = gpt_mini_pair()
    fam = decode_mod.build_family(port)
    assert (fam.kv_heads, fam.heads, fam.head_dim, fam.norm_kind) == \
        (4, 4, 16, "layernorm")
    g, b = fam.attn_norm_params(1)
    assert g is port.layers[1].ln1.weight and b is port.layers[1].ln1.bias
    assert fam.quant_paths(0) == [
        "layers.0.attn.qkv.weight", "layers.0.attn.out.weight",
        "layers.0.fc.weight", "layers.0.proj.weight"]


def _gpt_cfg(**kw):
    base = dict(model="gpt2", device="cpu", arrival_rate=50.0,
                num_requests=5, max_prompt_len=12, max_output_len=5,
                max_in_flight=2, kv_page_size=4, seed=0)
    return flags.ServeConfig(**{**base, **kw}).resolve()


@pytest.mark.parametrize("attention", ["paged", "gather"])
def test_gpt_engine_tokens_match_full_context_greedy(attention):
    """The engine over the mini (passed in: gpt2's registry row at full
    width is the card's) decodes the mini's own greedy tokens."""
    _, _, port = gpt_mini_pair()
    cfg = _gpt_cfg(decode_attention=attention)
    eng = engine_mod.ServeEngine(cfg, print_fn=lambda _m: None, model=port)
    rng = np.random.default_rng(8)
    reqs = [engine_mod.Request(
        rid=i, arrival_s=0.01 * i,
        prompt=rng.integers(1, 128, 3 + 2 * i).astype(np.int32),
        output_len=2 + i % 4) for i in range(5)]
    tap = _TokenTap()
    summary = eng.run(reqs, writer=tap, clock=engine_mod.VirtualClock(VCOSTS))
    assert summary["completed"] == 5
    for r in reqs:
        assert tap.tokens[r.rid] == _greedy(port, r.prompt, r.output_len)


def test_engine_gate_refuses_mlm_and_classify_members():
    with pytest.raises(ValueError, match="MLM members have no "
                       "autoregressive serving story"):
        engine_mod.ServeEngine(_gpt_cfg(model="bert_tiny"),
                               print_fn=lambda _m: None)
    with pytest.raises(ValueError, match="single-forward classify"):
        engine_mod.ServeEngine(_gpt_cfg(model="resnet50",
                                        decode_attention="paged"),
                               print_fn=lambda _m: None)


def test_gpt2_position_table_covers_the_serving_context():
    """The engine builds a text model with ``seq_len = max_ctx``;
    gpt2's table holds ``max(1024, max_ctx)`` rows."""
    with torch.device("meta"):
        assert gpt.gpt2(max_len=1536).wpe.weight.shape[0] == 1536
        assert gpt.gpt2(max_len=576).wpe.weight.shape[0] == 1024


@pytest.mark.parametrize("family_name,quant", [
    ("gpt", "off"), ("gpt", "int8_w"), ("llama", "int8_kv")])
def test_paged_operands_meet_the_kernels_contract(monkeypatch, family_name,
                                                  quant):
    from test_torch_serve import _mini_pair

    port = gpt_mini_pair()[2] if family_name == "gpt" else _mini_pair()[2]
    seen = {"paged": 0, "norm": 0}

    def paged(q, k_pages, v_pages, tables, lengths, **kw):
        ops = [q, k_pages, v_pages, tables, lengths]
        ops += [kw[k] for k in ("k_scales", "v_scales") if kw.get(k)
                is not None]
        assert all(t.is_contiguous() for t in ops)
        assert q.dtype == torch.float32 and tables.dtype == torch.int32
        assert lengths.dtype == torch.int32
        assert k_pages.dtype == (torch.int8 if quant == "int8_kv"
                                 else torch.float32)
        seen["paged"] += 1
        return orig_paged(q, k_pages, v_pages, tables, lengths, **kw)

    def norm(res, x, gamma, beta=None, **kw):
        assert res.is_contiguous() and x.is_contiguous()
        assert res.dtype == x.dtype == torch.float32
        assert (beta is not None) == (family_name == "gpt")
        seen["norm"] += 1
        return orig_norm(res, x, gamma, beta, **kw)

    orig_paged = decode_mod.paged_decode_attention
    orig_norm = decode_mod.fused_residual_norm
    monkeypatch.setattr(decode_mod, "paged_decode_attention", paged)
    monkeypatch.setattr(decode_mod, "fused_residual_norm", norm)
    port_feed(port, "paged", quant=quant)
    layers = port.num_layers
    assert seen == {"paged": 2 * layers, "norm": 2 * (2 * layers - 1)}
