"""The port's GPT-2 training path against the JAX package, on the CPU.

- **data**: ``SyntheticTokens``, both arms, equal bit for bit.
- **attention**: ``local_attention`` dense against flash (the flash
  kernels' plain version on CPU tensors), with GQA repetition, and
  against the JAX dense reference.
- **modules**: ``MultiHeadAttention``, ``DecoderLayer`` and a narrow
  ``GPTLM`` (2 layers, hidden 128, 4 heads, vocab 1024, max_len 128)
  carrying the Flax weights through the converters, in float32 and
  bfloat16, dropout off: outputs, the loss and the gradients of every
  parameter against ``jax.grad`` of the JAX loss at ``train=False``.
  The JAX flash kernel runs in Pallas interpret mode.
- **the slice**: two momentum-SGD steps of the narrow model against the
  JAX ``_loss_and_updates`` + ``make_optimizer``; the dropout rate; the
  flags; the launcher on the CPU at gpt2's full width.

Tolerances, each relative to the reference's largest magnitude (or 1):
float32 1e-5 for module outputs and 1e-4 for whole-network logits,
losses, gradients and parameters after two steps (sums in another order
through two layers and a backward).  bfloat16 2e-2 for outputs, logits
and the loss, 5e-2 for gradients: every product rounds its result to
bf16 (2^-8 relative), so one sum in another order can flip the last bit
of an activation, which the next layers carry on; the port's tied head
also rounds its float32 logit cotangent to bf16 before its two products,
where JAX keeps it in float32.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_hc_bench import flags as jax_flags
from tpu_hc_bench.data.synthetic import SyntheticTokens as JaxSyntheticTokens
from tpu_hc_bench.models import bert as jax_bert
from tpu_hc_bench.models import gpt as jax_gpt
from tpu_hc_bench.parallel import sequence as jax_seq
from tpu_hc_bench.train import step as jax_step
from tpu_hc_bench_torch import convert, flags, launcher, models
from tpu_hc_bench_torch.data.synthetic import (SyntheticTokens,
                                               tokens_to_device)
from tpu_hc_bench_torch.models import bert, create_model, get_model_spec, gpt
from tpu_hc_bench_torch.ops.flash_attention import flash_attention
from tpu_hc_bench_torch.parallel.sequence import local_attention
from tpu_hc_bench_torch.train import driver, step as step_mod
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
NARROW = dict(vocab_size=1024, hidden=128, num_layers=2, heads=4, ffn=512,
              max_len=128)
TOL = {  # dtype -> (module outputs, network logits and loss, gradients)
    "float32": (1e-5, 1e-4, 1e-4),
    "bfloat16": (2e-2, 2e-2, 5e-2),
}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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


# --- data --------------------------------------------------------------------


@pytest.mark.parametrize("causal_lm", [True, False])
def test_synthetic_tokens_equal_the_jax_lane(causal_lm):
    kw = dict(global_batch=3, seq_len=17, vocab_size=101, seed=4,
              causal_lm=causal_lm)
    mine, ref = SyntheticTokens(**kw).batch(), JaxSyntheticTokens(**kw).batch()
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ids, targets, weights = mine
    if causal_lm:
        assert ids.min() >= 1 and ids.max() < 101
        np.testing.assert_array_equal(targets[:, :-1], ids[:, 1:])
        assert (weights[:, -1] == 0).all() and (weights[:, :-1] == 1).all()
    else:
        assert ((ids == 0) == (weights == 1)).all()
    t_ids, t_targets, t_weights = tokens_to_device(mine, torch.device("cpu"))
    assert t_ids.dtype == t_targets.dtype == torch.int64
    assert t_weights.dtype == torch.float32
    np.testing.assert_array_equal(t_ids.numpy(), ids)


# --- attention dispatch -----------------------------------------------------


@pytest.mark.parametrize("causal,kv_repeat", [(True, 1), (False, 1),
                                              (True, 2)])
def test_local_attention_dense_matches_flash_and_jax(causal, kv_repeat):
    rng = np.random.default_rng(kv_repeat + 2 * causal)
    b, s, h, d = 2, 70, 4, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, h // kv_repeat, d)).astype(np.float32)
            for _ in range(2))
    want = jax_seq.local_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), impl="dense",
                                   causal=causal, kv_repeat=kv_repeat)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    dense = local_attention(tq, tk, tv, "dense", causal, kv_repeat=kv_repeat)
    flash = local_attention(tq, tk, tv, "flash", causal, kv_repeat=kv_repeat)
    _close(dense, want, TOL["float32"][0], "dense vs JAX")
    _close(flash, dense, TOL["float32"][0], "flash vs dense")


def test_bert_tiny_flash_matches_jax():
    """``bert_tiny`` at its own widths (4 layers, hidden 128, 4 heads of
    head dim 32, which the flash route zero-pads to the kernels' 64) with
    ``--attention_impl=flash``, float32, dropout off: the weighted MLM
    loss and the gradients' global norm against the JAX model (its flash
    kernel in Pallas interpret mode) at ``train=False``, within 1e-4
    relative (sums in another order through four layers and a
    backward)."""
    model = jax_bert.bert_tiny_mlm(dtype=jnp.float32, attention_impl="flash")
    params = _perturb(model.init(jax.random.PRNGKey(6),
                                 jnp.zeros((1, 8), jnp.int32),
                                 train=False)["params"], 16)
    batch = SyntheticTokens(2, 64, 1024, seed=16).batch()

    def jax_loss(p):
        tokens, targets, weights = batch
        logits = model.apply({"params": p}, tokens, train=False)
        losses = optax.softmax_cross_entropy_with_integer_labels(logits,
                                                                 targets)
        return (losses * weights).sum() / jnp.maximum(weights.sum(), 1.0)

    loss, grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    want_norm = float(np.sqrt(sum(
        float(np.sum(np.square(np.asarray(g, np.float64))))
        for g in jax.tree_util.tree_leaves(grads))))
    port = bert.bert_tiny_mlm(torch.float32, "flash")
    port.load_state_dict(convert.bert_params_from_flax(_np_tree(params)))
    port.eval()
    tokens, targets, weights = tokens_to_device(batch, torch.device("cpu"))
    t_loss = step_mod.lm_loss_fn(port(tokens), targets, weights)
    t_loss.backward()
    norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                for p in port.parameters())))
    assert abs(float(t_loss.detach()) - float(loss)) <= \
        1e-4 * abs(float(loss))
    assert abs(norm - want_norm) <= 1e-4 * want_norm, (norm, want_norm)


def test_local_attention_rejects_sequence_parallel_impls():
    """Without a seq group the sequence-sharded impls raise (JAX's
    "requires axis_name"); with one they run
    (``tests/test_torch_sequence.py``)."""
    q = torch.zeros((1, 8, 2, 8))
    for impl in ("ring", "ulysses", "ulysses_flash"):
        with pytest.raises(ValueError, match="requires a seq group"):
            local_attention(q, q, q, impl)
    with pytest.raises(ValueError, match="unknown"):
        local_attention(q, q, q, "paged")


# --- modules through the converters ----------------------------------------


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_multi_head_attention_matches_jax(dname):
    jdt, tdt = DTYPES[dname]
    hidden, heads, s = 128, 4, 100
    x = np.random.default_rng(1).standard_normal(
        (2, s, hidden)).astype(np.float32)
    g = np.random.default_rng(2).standard_normal(
        (2, s, hidden)).astype(np.float32)
    mod = jax_bert.MultiHeadAttention(hidden, heads, dtype=jdt,
                                      attention_impl="flash", causal=True)
    params = _perturb(mod.init(jax.random.PRNGKey(0), x)["params"], 3)

    def loss(p, x):
        y = mod.apply({"params": p}, x)
        return jnp.sum(y.astype(jnp.float32) * g), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    port = bert.MultiHeadAttention(hidden, heads, tdt, "flash", causal=True)
    port.load_state_dict(convert.attention_params_from_flax(params))
    tx = torch.from_numpy(x).requires_grad_()
    ty = port(tx)
    assert ty.dtype == tdt
    out_tol, _, grad_tol = TOL[dname]
    _close(ty, y, out_tol, "attention output")
    (ty.float() * torch.from_numpy(g)).sum().backward()
    _close(tx.grad, gx, grad_tol, "dx")
    _close_tree({k: p.grad for k, p in port.named_parameters()},
                convert.attention_params_from_flax(_np_tree(gp)), grad_tol,
                "grad")


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_decoder_layer_matches_jax(dname):
    jdt, tdt = DTYPES[dname]
    hidden, heads, ffn, s = 128, 4, 512, 100
    x = np.random.default_rng(4).standard_normal(
        (2, s, hidden)).astype(np.float32)
    g = np.random.default_rng(5).standard_normal(
        (2, s, hidden)).astype(np.float32)
    mod = jax_gpt.DecoderLayer(hidden, heads, ffn, dtype=jdt,
                               attention_impl="flash")
    params = _perturb(mod.init(jax.random.PRNGKey(1), x,
                               train=False)["params"], 6)

    def loss(p, x):
        y = mod.apply({"params": p}, x, train=False)
        return jnp.sum(y.astype(jnp.float32) * g), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    port = gpt.DecoderLayer(hidden, heads, ffn, tdt, "flash").eval()
    port.load_state_dict(convert.decoder_layer_params_from_flax(params))
    tx = torch.from_numpy(x).requires_grad_()
    ty = port(tx)
    out_tol, _, grad_tol = TOL[dname]
    _close(ty, y, out_tol, "layer output")
    (ty.float() * torch.from_numpy(g)).sum().backward()
    _close(tx.grad, gx, grad_tol, "dx")
    _close_tree({k: p.grad for k, p in port.named_parameters()},
                convert.decoder_layer_params_from_flax(_np_tree(gp)),
                grad_tol, "grad")


@functools.lru_cache(maxsize=None)
def _narrow(dname: str, impl: str):
    """A narrow Flax GPTLM, its perturbed params, and the port's twin
    carrying the converted weights."""
    jdt, tdt = DTYPES[dname]
    model = jax_gpt.GPTLM(dtype=jdt, attention_impl=impl, **NARROW)
    params = _perturb(model.init(jax.random.PRNGKey(2),
                                 jnp.zeros((1, 8), jnp.int32),
                                 train=False)["params"], 7)
    return model, params


def _port_twin(params, dname, impl):
    port = gpt.GPTLM(dtype=DTYPES[dname][1], attention_impl=impl, **NARROW)
    port.load_state_dict(convert.gpt_params_from_flax(params))   # strict
    return port.eval()


def _jax_lm_loss(model, params, batch):
    tokens, targets, weights = batch
    logits = model.apply({"params": params}, tokens, train=False)
    losses = optax.softmax_cross_entropy_with_integer_labels(logits, targets)
    return (losses * weights).sum() / jnp.maximum(weights.sum(), 1.0), logits


@pytest.mark.parametrize("dname,impl", [("float32", "flash"),
                                        ("bfloat16", "flash"),
                                        ("float32", "dense")])
def test_gptlm_matches_jax(dname, impl):
    """Logits, the weighted next-token loss and every gradient."""
    model, params = _narrow(dname, impl)
    batch = SyntheticTokens(2, 100, NARROW["vocab_size"], seed=8,
                            causal_lm=True).batch()
    (loss, logits), grads = jax.jit(jax.value_and_grad(
        functools.partial(_jax_lm_loss, model), has_aux=True))(params, batch)
    port = _port_twin(params, dname, impl)
    tokens, targets, weights = tokens_to_device(batch, torch.device("cpu"))
    t_logits = port(tokens)
    assert t_logits.dtype == torch.float32
    t_loss = step_mod.lm_loss_fn(t_logits, targets, weights)
    _, net_tol, grad_tol = TOL[dname]
    _close(t_logits, logits, net_tol, "logits")
    assert abs(float(t_loss.detach()) - float(loss)) <= net_tol * abs(float(loss))
    t_loss.backward()
    _close_tree({k: p.grad for k, p in port.named_parameters()},
                convert.gpt_params_from_flax(_np_tree(grads)), grad_tol,
                "grad")


def test_two_train_steps_match_jax():
    """Two momentum-SGD steps (lr 0.01, momentum 0.9, the JAX defaults)
    of the narrow float32 model with flash attention, dropout off: the
    losses and the parameters after them."""
    model, params = _narrow("float32", "flash")
    batch = SyntheticTokens(2, 100, NARROW["vocab_size"], seed=9,
                            causal_lm=True).batch()
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
                state, p, batch, jax.random.PRNGKey(0), True)
        (loss, _), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        updates, opt = state.tx.update(grads, state.opt_state, state.params)
        return state.replace(params=optax.apply_updates(state.params,
                                                        updates),
                             opt_state=opt), loss

    cfg = flags.BenchmarkConfig(device="cpu").resolve()
    assert (cfg.optimizer, cfg.init_learning_rate, cfg.momentum) == (
        jcfg.optimizer, jcfg.init_learning_rate, jcfg.momentum)
    port_state = step_mod.make_train_state(
        _port_twin(params, "float32", "flash"), cfg)
    port_state.model.eval()                    # dropout off, as JAX above
    t_batch = tokens_to_device(batch, torch.device("cpu"))
    for i in range(2):
        state, loss = jax_step_fn(state)
        port_state, metrics = step_mod.train_step(port_state, t_batch)
        got = float(metrics["loss"])
        assert abs(got - float(loss)) <= 1e-4 * abs(float(loss)), i
    assert port_state.step == 2
    _close_tree(port_state.model.state_dict(),
                convert.gpt_params_from_flax(_np_tree(state.params)), 1e-4,
                "param")


def test_tied_head_is_a_float32_product_of_rounded_operands():
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((2, 5, 64)).astype(np.float32))
    table = torch.from_numpy(rng.standard_normal((50, 64)).astype(
        np.float32))
    out = gpt.tied_logits(x, table, torch.bfloat16)
    assert out.dtype == torch.float32 and out.shape == (2, 5, 50)
    want = x.bfloat16().float() @ table.bfloat16().float().T
    assert torch.equal(out, want)
    assert not torch.equal(out, out.bfloat16().float())   # not rounded


# --- dropout ------------------------------------------------------------------


def test_dropout_keeps_nine_tenths_scaled_and_only_in_training():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(1 << 20)
    y = gpt.dropout(x, 0.1, gen, training=True)
    kept = y != 0
    # 2^20 Bernoulli(0.9) draws: the kept share has std 3e-4; 6 sigma
    assert abs(float(kept.float().mean()) - 0.9) < 2e-3
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert torch.equal(gpt.dropout(x, 0.1, gen, training=False), x)


def test_gptlm_dropout_draws_from_its_seeded_generator():
    model = gpt.GPTLM(**NARROW)
    model.init_weights(torch.Generator().manual_seed(0))
    tokens = torch.arange(16)[None]

    def run(seed, train):
        model.dropout_generator = torch.Generator().manual_seed(seed)
        return model.train(train)(tokens).detach()

    a, b, c = run(1, True), run(1, True), run(2, True)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(run(1, False), run(2, False))
    assert not torch.equal(a, run(1, False))


# --- registry, flags, entry points ------------------------------------------


def test_gpt2_registry_rows_and_seq_len_override(monkeypatch):
    spec = get_model_spec("gpt2")
    assert spec.is_text and spec.causal_lm
    assert spec.input_shape == (1024,) and spec.vocab_size == 50257
    assert spec.flops_per_example == 2 * 124e6 * 1024
    assert get_model_spec("gpt2_medium").flops_per_example == \
        2 * 355e6 * 1024
    with torch.device("meta"):
        full = gpt.gpt2()
    assert sum(p.numel() for p in full.parameters()) == 124439808
    assert (full.num_layers, full.hidden, full.heads) == (12, 768, 12)

    # create_model's text arm at a narrow width (the factory swapped):
    # the spec rescaled to --seq_len, the position table grown, f32
    # parameters, the dropout stream seeded apart from the weights
    def narrow(dtype, attention_impl, max_len):
        return gpt.GPTLM(dtype=dtype, attention_impl=attention_impl,
                         **{**NARROW, "max_len": max(128, max_len or 0)})

    monkeypatch.setattr(gpt, "gpt2", narrow)
    model, spec2 = create_model("gpt2", torch.bfloat16, "flash",
                                device="cpu", seed=5, train=True,
                                seq_len=256)
    assert model.dropout_generator.initial_seed() == \
        5 + models.DROPOUT_SEED_OFFSET
    assert spec2.input_shape == (256,)
    assert spec2.flops_per_example == spec.flops_per_example / 4
    assert model.wpe.weight.shape == (256, 128) and model.training
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.dtype == torch.bfloat16
    assert model.layers[0].attn.attention_impl == "flash"
    with pytest.raises(ValueError, match="resnets"):
        create_model("gpt2", device="cpu", fused_conv=True)
    with pytest.raises(ValueError, match="text models"):
        create_model("resnet50", device="cpu", seq_len=128)


def test_lm_flags_pass_and_later_slices_raise():
    cfg = flags.parse_benchmark_flags(["--model=gpt2", "--attention_impl",
                                       "flash", "--seq_len=128"])
    assert (cfg.attention_impl, cfg.seq_len) == ("flash", 128)
    assert any("attention_impl=flash seq_len=128" in ln
               for ln in cfg.summary_lines())
    assert flags.BenchmarkConfig().attention_impl == \
        jax_flags.BenchmarkConfig().attention_impl
    # the sequence-sharded impls are ported (the degenerate seq axis at
    # --sequence_parallel=1; tests/test_torch_sp_train.py)
    for impl in ("ring", "ulysses_flash"):
        cfg = flags.parse_benchmark_flags([f"--attention_impl={impl}"])
        assert cfg.attention_impl == impl and cfg.sp_active
        assert "degenerate seq axis" in cfg.translations["sequence_parallel"]
    for bad, match in ((["--attention_impl=paged"], "dense|flash"),
                       (["--wire_dtype=bf16"], "float32|uint8"),
                       (["--virtual_devices=2"], "not ported"),
                       (["--seq_len=0"], "seq_len")):
        with pytest.raises(ValueError, match=match):
            flags.parse_benchmark_flags(bad)
    with pytest.raises(ValueError, match="not ported"):
        flags.parse_benchmark_flags(["--config=x.json"])
    assert flags.parse_benchmark_flags(
        ["--model_parallel=2", "--sequence_parallel=2"]).model_parallel == 2
    assert flags.parse_benchmark_flags(
        ["--sequence_parallel=2"]).attention_impl == "ring"


def test_gpt2_launcher_on_the_cpu():
    """``python -m tpu_hc_bench_torch 1 1 2 sock --model=gpt2 --device=cpu
    --attention_impl=flash --seq_len=128 ...``: full width, short
    sequences, the flash path's plain version and no kernel launch."""
    before = dict(flash_attention.launches)
    lines: list[str] = []
    rc = launcher.main(["1", "1", "2", "sock", "--model=gpt2", "--device=cpu",
                        "--attention_impl=flash", "--seq_len=128",
                        "--num_warmup_batches=1", "--num_batches=2",
                        "--display_every=1"], print_fn=lines.append)
    assert rc == 0
    assert sum("\texamples/sec: " in ln for ln in lines) == 2
    assert any(ln.startswith("total examples/sec: ") for ln in lines)
    result = json.loads(lines[-1], parse_constant=pytest.fail)
    assert result["model"] == "gpt2" and result["global_batch"] == 2
    assert np.isfinite(result["final_loss"]) and result["mfu"] is None
    assert flash_attention.launches == before


def test_lm_entry_points_without_cpu_request_raise_when_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model("gpt2", attention_impl="flash")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.run_benchmark(flags.BenchmarkConfig(model="gpt2",
                                                   attention_impl="flash"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main(["1", "1", "2", "sock", "--model=gpt2",
                       "--attention_impl=flash"])


def test_lm_lane_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, tpu_hc_bench_torch.models.gpt, "
         "tpu_hc_bench_torch.models.bert, "
         "tpu_hc_bench_torch.ops.flash_attention, "
         "tpu_hc_bench_torch.parallel.sequence, "
         "tpu_hc_bench_torch.data.synthetic, tpu_hc_bench_torch.convert, "
         "tpu_hc_bench_torch.train.driver; "
         "assert 'jax' not in sys.modules; "
         "assert 'tpu_hc_bench' not in sys.modules"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode == 0, proc.stderr
