"""``--gradient_checkpointing`` and ``--scan_layers`` of the port, on the CPU.

- **remat and scan against the plain step**: a narrow GPT-2 (2 layers,
  hidden 64, dropout on), a narrow MoE decoder (2 layers, 4 experts,
  dropout on), ``llama_tiny`` and ``bert_tiny`` (dropout on; no scan
  there, as in JAX) in training mode: the loss, every gradient and the
  dropout generator's state after the backward, bit for bit, against
  the plain model from the same seed.  The recompute draws the
  forward's masks (the checkpoint's own RNG handling does not reach an
  explicit generator) and the stream goes on where the forward left it;
  a scanned model holds the unrolled one's weights for the same seed,
  and its stacked gradients unstack to the unrolled ones.
- **JAX's scanned trees**: Flax ``GPTLM`` (dense and MoE) and
  ``LlamaLM`` built with ``scan_layers=True`` (one ``layers`` subtree of
  stacked leaves) convert to the port's scanned model, whose logits match
  JAX's (float32, 1e-4 of the largest), and to the unrolled layout, whose
  logits equal the scanned model's bit for bit.
- **checkpoints**: a scanned state saves, restores and fingerprints; a
  restore across the two layouts is refused by the saved parameter
  names, with a topology sidecar or without one.
- **flags and guards**: the two flags parse and reach the model; scan is
  refused for bert and the resnets, remat for the resnets, serving for a
  scanned model.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_hc_bench.models import gpt as jax_gpt
from tpu_hc_bench.models import llama as jax_llama
from tpu_hc_bench_torch import convert, flags
from tpu_hc_bench_torch.data.synthetic import SyntheticTokens, tokens_to_device
from tpu_hc_bench_torch.models import (bert, create_model, gpt, layer_stack,
                                       llama)
from tpu_hc_bench_torch.serve import decode as decode_mod
from tpu_hc_bench_torch.train import step as step_mod
from tpu_hc_bench_torch.utils import checkpoint as ckpt

from test_torch_lm import _close, _perturb
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

NARROW = dict(vocab_size=256, hidden=64, num_layers=2, heads=4, ffn=128,
              max_len=64)
SEQ = 32


def _build(family: str, remat: bool, scan: bool):
    """The family's narrow model, weights from seed 3, its dropout
    generator from seed 4, in training mode."""
    kw = dict(remat=remat)
    if scan:
        kw["scan_layers"] = True
    if family == "gpt":
        m, vocab = gpt.GPTLM(**NARROW, **kw), 256
    elif family == "moe":
        m, vocab = gpt.GPTLM(**NARROW, num_experts=4, **kw), 256
    elif family == "llama":
        m, vocab = llama.llama_tiny(**kw), 1024
    else:
        m, vocab = bert.bert_tiny_mlm(**kw), 1024
    m.init_weights(torch.Generator().manual_seed(3))
    m.dropout_generator = torch.Generator().manual_seed(4)
    return m.train(), vocab


def _grads(model) -> dict:
    g = {k: p.grad for k, p in model.named_parameters()}
    if getattr(model, "scan_layers", False):
        names = [n for n, _ in model.layers.named_parameters()]
        g = layer_stack.unstack_state_dict(g, names)
    return g


@pytest.mark.parametrize("family,mode", [
    ("gpt", "remat"), ("gpt", "scan"), ("gpt", "scan_remat"),
    ("moe", "remat"), ("moe", "scan"), ("moe", "scan_remat"),
    ("llama", "remat"), ("llama", "scan"), ("llama", "scan_remat"),
    ("bert", "remat")])
def test_remat_and_scan_are_bit_equal_to_the_plain_step(family, mode):
    plain, vocab = _build(family, False, False)
    other, _ = _build(family, "remat" in mode, "scan" in mode)
    batch = tokens_to_device(SyntheticTokens(
        2, SEQ, vocab, seed=5, causal_lm=family != "bert").batch(),
        torch.device("cpu"))
    losses = []
    for m in (plain, other):
        loss = step_mod.batch_loss(m, batch)
        loss.backward()
        losses.append(loss.detach())
    assert torch.equal(losses[0], losses[1])
    want, got = _grads(plain), _grads(other)
    assert set(want) == set(got)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(plain.dropout_generator.get_state(),
                       other.dropout_generator.get_state())
    if family == "moe":
        assert torch.equal(plain.aux_loss.detach(), other.aux_loss.detach())


def _flax(family: str, scan: bool):
    if family == "llama":
        return jax_llama.llama_tiny(scan_layers=scan)
    return jax_gpt.GPTLM(**NARROW, scan_layers=scan,
                         num_experts=4 if family == "moe" else 0)


@pytest.mark.parametrize("family", ["gpt", "moe", "llama"])
def test_jax_scanned_trees_convert_to_both_layouts(family):
    model = _flax(family, True)
    params = _perturb(model.init(jax.random.PRNGKey(1),
                                 jnp.zeros((1, 8), jnp.int32),
                                 train=False)["params"], 2)
    assert "layers" in params and not any(k.startswith("layer_")
                                          for k in params)
    tokens = SyntheticTokens(2, SEQ, 256, seed=6, causal_lm=True).batch()[0]
    want = model.apply({"params": params}, tokens, train=False,
                       mutable=["losses"])[0]
    conv = (convert.llama_params_from_flax if family == "llama"
            else convert.gpt_params_from_flax)
    scanned, _ = _build(family, False, True)
    scanned.load_state_dict(conv(params))                       # strict
    unrolled, _ = _build(family, False, False)
    unrolled.load_state_dict(layer_stack.unstack_state_dict(    # strict
        conv(params), [n for n, _ in scanned.layers.named_parameters()]))
    t = torch.from_numpy(np.asarray(tokens))
    with torch.no_grad():
        got = scanned.eval()(t)
        _close(got, want, 1e-4, f"{family} scanned logits")
        assert torch.equal(unrolled.eval()(t), got)


def test_checkpoints_keep_the_stacked_layout_and_refuse_to_cross(tmp_path):
    cfg = flags.BenchmarkConfig(device="cpu", model="moe_tiny",
                                scan_layers=True).resolve()
    model, _ = create_model("moe_tiny", device="cpu", seed=1, train=True,
                            scan_layers=True)
    state = step_mod.make_train_state(model, cfg)
    batch = tokens_to_device(SyntheticTokens(2, 16, 1024, seed=2,
                                             causal_lm=True).batch(),
                             torch.device("cpu"))
    step_mod.train_step(state, batch)
    live = ckpt.topology_record(1, cfg)
    ckpt.save(state, tmp_path / "a", topology=live)
    again = step_mod.make_train_state(create_model(
        "moe_tiny", device="cpu", seed=9, train=True, scan_layers=True)[0],
        cfg)
    ckpt.restore(again, tmp_path / "a", expect_topology=live)
    assert ckpt.fingerprint(again.model.state_dict()) == \
        ckpt.fingerprint(state.model.state_dict())
    assert again.model.layers.moe.wi.shape == (4, 4, 128, 256)
    ucfg = flags.BenchmarkConfig(device="cpu", model="moe_tiny").resolve()
    unrolled = step_mod.make_train_state(create_model(
        "moe_tiny", device="cpu", seed=1, train=True)[0], ucfg)
    with pytest.raises(ckpt.TopologyMismatchError, match="not "
                       "interchangeable"):
        ckpt.restore(unrolled, tmp_path / "a",
                     expect_topology=ckpt.topology_record(1, ucfg))
    ckpt.save(unrolled, tmp_path / "b")                 # no sidecar
    with pytest.raises(ckpt.TopologyMismatchError, match="stacked"):
        ckpt.restore(again, tmp_path / "b")


def test_flags_reach_the_model_and_guards_hold():
    cfg = flags.parse_benchmark_flags(["--model=llama_1b",
                                       "--gradient_checkpointing=true",
                                       "--scan_layers=true"])
    assert cfg.gradient_checkpointing and cfg.scan_layers
    assert any("gradient_checkpointing=True scan_layers=True" in ln
               for ln in cfg.summary_lines())
    for name in ("gradient_checkpointing", "scan_layers", "moe_impl",
                 "moe_capacity_factor", "moe_f_chunk", "accum_dtype"):
        assert name not in flags.LATER_SLICE_TRAIN_FLAGS
    with torch.device("meta"):
        model = gpt.gpt2(remat=True, scan_layers=True)
    assert model.remat and model.scan_layers
    assert model.layers.attn.qkv.weight.shape == (12, 3 * 768, 768)
    model, _ = create_model("llama_tiny", device="cpu",
                            gradient_checkpointing=True, scan_layers=True)
    assert model.remat and model.layers.gate.weight.shape == (4, 256, 128)
    for name, kw, match in (
            ("bert_tiny", dict(scan_layers=True), "decoder families"),
            ("resnet50", dict(scan_layers=True), "decoder families"),
            ("resnet50", dict(gradient_checkpointing=True),
             "transformer members")):
        with pytest.raises(ValueError, match=match):
            create_model(name, device="cpu", **kw)
    with pytest.raises(ValueError, match="not servable"):
        decode_mod.build_family(create_model("llama_tiny", device="cpu",
                                             scan_layers=True)[0])
    for bad, match in ((["--accum_dtype=bf16"], "without"),
                       (["--accum_dtype=fp8", "--batch_size=4",
                         "--gradient_accumulation_steps=2"], "f32 or bf16")):
        with pytest.raises(ValueError, match=match):
            flags.parse_benchmark_flags(bad)
