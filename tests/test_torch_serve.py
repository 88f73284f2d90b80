"""The port's serving lane against the JAX package, on the CPU.

- **weights**: ``convert.llama_params_from_flax`` carries a Flax
  ``LlamaLM`` param tree to the port, whose full-context forward then
  matches ``LlamaLM.apply`` (2-layer mini, atol 1e-5).
- **programs**: the port's prefill + decode programs (both attention
  arms) against the JAX ``build_prefill_fn`` + ``build_decode_fn`` over
  the fixed-feed protocol of the JAX decode-kernel tests (atol 1e-4,
  greedy argmax equal).
- **engine**: a port ``ServeEngine`` closed loop in virtual time whose
  tokens equal the port's own full-context greedy forward per request.
- **host code**: arrival and prompt traces equal the JAX lane's for the
  same seed; flags, entry points and the no-JAX import rule.
"""

from __future__ import annotations

import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_hc_bench import flags as jax_flags
from tpu_hc_bench.models import llama as jax_llama
from tpu_hc_bench.serve import arrivals as jax_arrivals
from tpu_hc_bench.serve import decode as jax_decode
from tpu_hc_bench.data.tokens import PromptSampler as JaxPromptSampler
from tpu_hc_bench_torch import convert, flags
from tpu_hc_bench_torch.data.tokens import PromptSampler
from tpu_hc_bench_torch.models import create_model
from tpu_hc_bench_torch.models.llama import LlamaLM
from tpu_hc_bench_torch.serve import arrivals, cli
from tpu_hc_bench_torch.serve import decode as decode_mod
from tpu_hc_bench_torch.serve import engine as engine_mod
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
VCOSTS = {"prefill": 0.004, "decode": 0.003}
MINI = dict(vocab_size=64, hidden=32, num_layers=2, heads=4,
            num_kv_heads=2, ffn=64)
PROGRAM_ATOL = 1e-4


@functools.lru_cache(maxsize=None)
def _mini_pair():
    """A Flax llama mini with its params, and the port's twin carrying
    the converted weights."""
    model = jax_llama.LlamaLM(max_len=32, **MINI)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                        train=False)["params"]
    np_params = jax.tree_util.tree_map(np.asarray, params)
    port = LlamaLM(**MINI)
    port.load_state_dict(convert.llama_params_from_flax(np_params))
    return model, params, port.eval()


def test_converted_weights_reproduce_the_jax_forward():
    model, params, port = _mini_pair()
    rng = np.random.default_rng(4)
    toks = rng.integers(0, MINI["vocab_size"], (2, 11)).astype(np.int32)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(toks),
                                  train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(toks)).numpy()
    assert got.shape == want.shape == (2, 11, MINI["vocab_size"])
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_convert_layout_rules():
    _, params, port = _mini_pair()
    sd = port.state_dict()
    p0 = params["layer_0"]
    h, n, d = np.asarray(p0["attn"]["wq"]["kernel"]).shape
    assert sd["layers.0.attn.wq.weight"].shape == (n * d, h)
    assert sd["layers.0.attn.wo.weight"].shape == (h, n * d)
    np.testing.assert_array_equal(sd["lm_head"].numpy(),
                                  np.asarray(params["lm_head"]))
    np.testing.assert_array_equal(sd["layers.1.down.weight"].numpy(),
                                  np.asarray(params["layer_1"]["down"]
                                             ["kernel"]).T)


def _fixed_feed(prefill, decode, kv, steps: int = 2):
    """Prefill two prompts, then ``steps`` decode steps on a fixed token
    feed (the protocol of the JAX decode-kernel tests): stacked per-step
    logits ``[steps, b, vocab]`` and the prefill tokens.  ``prefill`` and
    ``decode`` take numpy arguments."""
    page_size, w, b = 4, 4, 2
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 64, n).astype(np.int32) for n in (5, 3)]
    tables = np.arange(1, 1 + b * w, dtype=np.int32).reshape(b, w)
    lengths = np.zeros((b,), np.int32)
    first = []
    for i, prompt in enumerate(prompts):
        toks = np.zeros((1, 8), np.int32)
        toks[0, :len(prompt)] = prompt
        tok, kv = prefill(kv, toks, len(prompt), tables[i])
        lengths[i] = len(prompt)
        first.append(tok)
    feed = rng.integers(1, 64, (steps, b)).astype(np.int32)
    out = []
    for t in range(steps):
        logits, kv = decode(kv, feed[t], tables, lengths.copy(),
                            np.ones((b,), bool))
        out.append(logits)
        lengths += 1
    return np.stack(out), first


@functools.lru_cache(maxsize=None)
def _jax_program_logits(attention: str):
    model, params, _ = _mini_pair()
    family = jax_decode.build_family(model)
    kv = jax_decode.init_kv_state(family, 1 + 2 * 4, 4, jnp.float32)
    pre = jax.jit(jax_decode.build_prefill_fn(family, 4, 4))
    dec = jax.jit(jax_decode.build_decode_fn(family, 4, 4,
                                             attention=attention))

    def prefill(kv, toks, n, table):
        tok, _, kv = pre(params, kv, toks, np.int32(n), table)
        return int(np.asarray(tok)[0]), kv

    def decode(kv, toks, tables, lengths, active):
        _, logits, kv = dec(params, kv, toks, tables, lengths, active)
        return np.asarray(logits), kv

    return _fixed_feed(prefill, decode, kv)


def _port_program_logits(attention: str):
    _, _, port = _mini_pair()
    family = decode_mod.build_family(port)
    kv = decode_mod.init_kv_state(family, 1 + 2 * 4, 4, device="cpu")
    pre = decode_mod.build_prefill_fn(family, 4, 4)
    dec = decode_mod.build_decode_fn(family, 4, 4, attention=attention)
    t = torch.from_numpy

    def prefill(kv, toks, n, table):
        tok, _, kv = pre(kv, t(toks), n, t(table))
        return int(tok[0]), kv

    def decode(kv, toks, tables, lengths, active):
        _, logits, kv = dec(kv, t(toks), t(tables), t(lengths), t(active))
        return logits.numpy(), kv

    return _fixed_feed(prefill, decode, kv)


@pytest.mark.parametrize("attention", ["paged", "gather"])
def test_programs_match_jax_fixed_feed(attention):
    want, want_first = _jax_program_logits(attention)
    got, first = _port_program_logits(attention)
    assert first == want_first
    np.testing.assert_allclose(got, want, atol=PROGRAM_ATOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_paged_program_matches_gather_program():
    """The port's own arms agree (the on-card parity reference)."""
    got, _ = _port_program_logits("paged")
    ref, _ = _port_program_logits("gather")
    np.testing.assert_allclose(got, ref, atol=PROGRAM_ATOL)


def test_quant_arms_are_not_ported_yet():
    """Both int8 arms are ported now; what stays refused is JAX's one
    refused combination: ``int8_kv`` under the gather arm, whose read
    path has no scales (no quiet fallback to ``paged`` or ``off``)."""
    _, _, port = _mini_pair()
    for quant in ("int8_w", "int8_kv"):
        assert decode_mod.build_family(port, quant=quant).num_layers == 2
        assert flags.ServeConfig(quant=quant,
                                 decode_attention="paged").resolve()
    family = decode_mod.build_family(port, quant="int8_kv")
    with pytest.raises(ValueError, match="gather reference has no "
                       "scale-fused read path"):
        decode_mod.build_decode_fn(family, 4, 4, attention="gather",
                                   quant="int8_kv")
    with pytest.raises(ValueError, match="set --decode_attention=paged"):
        flags.ServeConfig(quant="int8_kv").resolve()
    with pytest.raises(ValueError, match="int8_w\\|int8_kv"):
        flags.ServeConfig(quant="int4").resolve()


# --- engine ---------------------------------------------------------------


def _cfg(**kw):
    base = dict(model="llama_tiny", device="cpu", arrival_rate=50.0,
                num_requests=5, max_prompt_len=12, max_output_len=5,
                max_in_flight=2, kv_page_size=4, seed=0)
    return flags.ServeConfig(**{**base, **kw}).resolve()


class _TokenTap:
    def __init__(self):
        self.tokens = {}

    def event(self, kind, **kw):
        if kind == "request":
            self.tokens[kw["id"]] = kw["generated"]


@functools.lru_cache(maxsize=None)
def _engine_run(attention: str, batching: str):
    cfg = _cfg(decode_attention=attention)
    eng = engine_mod.ServeEngine(cfg, print_fn=lambda _m: None)
    reqs = arrivals.build_requests(cfg, eng.spec.vocab_size)
    tap = _TokenTap()
    summary = eng.run(reqs, batching=batching, writer=tap,
                      clock=engine_mod.VirtualClock(VCOSTS))
    return eng, reqs, summary, tap.tokens


def _greedy(model, prompt, n: int) -> list[int]:
    seq = [int(t) for t in prompt]
    out = []
    with torch.no_grad():
        for _ in range(n):
            logits = model(torch.tensor([seq]))
            nxt = int(logits[0, -1].argmax())
            out.append(nxt)
            seq.append(nxt)
    return out


@pytest.mark.parametrize("attention,batching", [
    ("paged", "continuous"), ("gather", "continuous"), ("paged", "static")])
def test_engine_tokens_match_full_context_greedy(attention, batching):
    eng, reqs, summary, tokens = _engine_run(attention, batching)
    assert summary["completed"] == summary["requests"] == len(reqs)
    assert summary["decode_attention"] == attention
    assert summary["decode_steps"] > 0
    assert set(tokens) == {r.rid for r in reqs}
    for r in reqs:
        assert tokens[r.rid] == _greedy(eng.model, r.prompt, r.output_len), \
            f"request {r.rid}"


def test_engine_summary_keys_and_ladders():
    eng, reqs, summary, _ = _engine_run("paged", "continuous")
    for key in ("requests", "completed", "wall_s", "tokens", "tokens_per_s",
                "buckets", "max_in_flight", "kv_page_size", "kv_pages",
                "decode_attention"):
        assert key in summary
    for field in ("ttft", "e2e", "queue"):
        for q in (50, 95, 99):
            assert f"p{q}_{field}_ms" in summary
    assert summary["tokens"] == sum(r.output_len for r in reqs)
    assert eng.prefill_buckets == (8, 16) and eng.batch_buckets == (1, 2)
    assert eng.table_width == 5 and eng.num_pages == 11
    big = _cfg(max_prompt_len=512, max_output_len=64, max_in_flight=8,
               kv_page_size=16)
    assert flags.parse_serve_buckets(big.serve_buckets,
                                     big.max_in_flight) == (1, 2, 4, 8)
    assert engine_mod.ceil_pow2(5) == 8 and engine_mod.pick_bucket(
        (1, 2, 4, 8), 3) == 4


def test_engine_with_converted_weights_runs_the_jax_mini():
    """An engine over a model passed in (weights carried from JAX)."""
    _, _, port = _mini_pair()
    cfg = _cfg(num_requests=2, max_prompt_len=6, max_output_len=3)
    eng = engine_mod.ServeEngine(cfg, print_fn=lambda _m: None, model=port)
    reqs = [arrivals.Request(rid=i, arrival_s=0.0,
                             prompt=np.arange(1, 5 + i, dtype=np.int32),
                             output_len=3) for i in range(2)]
    tap = _TokenTap()
    eng.run(reqs, writer=tap, clock=engine_mod.VirtualClock(VCOSTS))
    for r in reqs:
        assert tap.tokens[r.rid] == _greedy(port, r.prompt, 3)


def test_page_allocator_reserves_trash_page():
    a = engine_mod.PageAllocator(4)
    got = a.alloc(3)
    assert sorted(got) == [1, 2, 3] and a.alloc(1) is None
    assert a.refcount(got[0]) == 1
    a.free(got[:1])
    assert a.free_pages == 1 and a.refcount(got[0]) == 0
    with pytest.raises(RuntimeError):
        a.free(got[:1])
    with pytest.raises(ValueError):
        engine_mod.PageAllocator(1)


# --- host code: traces, flags, entry points -------------------------------


@pytest.mark.parametrize("process", ["poisson", "bursty", "diurnal"])
def test_arrival_and_prompt_traces_equal_the_jax_lane(process):
    np.testing.assert_array_equal(
        arrivals.arrival_times(process, 12.0, 20, seed=3),
        jax_arrivals.arrival_times(process, 12.0, 20, seed=3))
    np.testing.assert_array_equal(
        arrivals.sample_lengths(20, 64, seed=4),
        jax_arrivals.sample_lengths(20, 64, seed=4))
    ours, theirs = PromptSampler(1024, seed=5), JaxPromptSampler(1024,
                                                                seed=5)
    for rid in range(6):
        np.testing.assert_array_equal(ours.sample(rid, 9),
                                      theirs.sample(rid, 9))


def test_request_trace_equals_the_jax_lane():
    cfg = _cfg(num_requests=7)
    jcfg = jax_flags.BenchmarkConfig(
        model="llama_tiny", workload="serve", arrival_rate=50.0,
        num_requests=7, max_prompt_len=12, max_output_len=5, seed=0)
    ours = arrivals.build_requests(cfg, 1024)
    theirs = jax_arrivals.build_requests(jcfg, 1024)
    for a, b in zip(ours, theirs, strict=True):
        assert (a.rid, a.arrival_s, a.output_len) == (b.rid, b.arrival_s,
                                                      b.output_len)
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_serve_buckets_parse_like_the_jax_lane():
    for spec, cap in (("auto", 8), ("auto", 6), ("1,4,8", 8), (" 2, 2", 4)):
        assert flags.parse_serve_buckets(spec, cap) == \
            jax_flags.parse_serve_buckets(spec, cap)
    for bad in ("x", "0,1"):
        with pytest.raises(ValueError, match="serve_buckets"):
            flags.parse_serve_buckets(bad, 4)


def test_flags_defaults_and_rejections():
    d, j = flags.ServeConfig(), jax_flags.BenchmarkConfig()
    for name in ("arrival", "arrival_rate", "num_requests", "serve_buckets",
                 "max_in_flight", "kv_page_size", "kv_pages",
                 "max_prompt_len", "max_output_len", "batching",
                 "decode_attention", "quant", "decode_block_pages"):
        assert getattr(d, name) == getattr(j, name), name
    cfg = flags.parse_flags(["--model=llama_tiny", "--device=cpu",
                             "--decode_attention=paged",
                             "--decode_block_pages=2"])
    assert cfg.decode_block_pages == 2 and cfg.device == "cpu"
    with pytest.raises(ValueError, match="kv_reserve=lazy"):
        flags.parse_flags(["--prefix_cache=on"])
    # --config=auto keys the registry by the card: with none and no
    # --device=cpu, it raises instead of keying the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flags.parse_flags(["--config=auto"])
    with pytest.raises(ValueError, match="decode_block_pages"):
        flags.parse_flags(["--decode_block_pages=2"])
    with pytest.raises(SystemExit):
        flags.parse_flags(["--batch_size=4"])


def test_entry_points_without_cpu_request_raise_when_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model("llama_tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine_mod.ServeEngine(flags.ServeConfig(model="llama_tiny"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--model=llama_tiny"], print_fn=lambda _m: None)


def test_cli_serves_on_the_cpu_when_asked():
    lines = []
    rc = cli.main(["--model=llama_tiny", "--device=cpu",
                   "--decode_attention=paged", "--num_requests=3",
                   "--max_prompt_len=8", "--max_output_len=3",
                   "--max_in_flight=2", "--kv_page_size=4",
                   "--arrival_rate=100"], print_fn=lines.append)
    assert rc == 0
    assert any("3/3 requests" in ln for ln in lines)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, tpu_hc_bench_torch, tpu_hc_bench_torch.serve.cli, "
         "tpu_hc_bench_torch.serve.engine, tpu_hc_bench_torch.convert, "
         "tpu_hc_bench_torch.serve.decode, tpu_hc_bench_torch.serve.faults, "
         "tpu_hc_bench_torch.serve.prefix_cache, "
         "tpu_hc_bench_torch.serve.slo, "
         "tpu_hc_bench_torch.obs, tpu_hc_bench_torch.obs.__main__, "
         "tpu_hc_bench_torch.obs.fleet, tpu_hc_bench_torch.obs.kv, "
         "tpu_hc_bench_torch.obs.memory, tpu_hc_bench_torch.obs.metrics, "
         "tpu_hc_bench_torch.obs.requests, tpu_hc_bench_torch.obs.signals, "
         "tpu_hc_bench_torch.obs.sketch, tpu_hc_bench_torch.obs.timeline, "
         "tpu_hc_bench_torch.ops._build, "
         "tpu_hc_bench_torch.resilience.preempt, "
         "tpu_hc_bench_torch.resilience.retry, "
         "tpu_hc_bench_torch.resilience.watchdog, "
         "tpu_hc_bench_torch.data.tokens; "
         "assert 'jax' not in sys.modules; "
         "assert 'tpu_hc_bench' not in sys.modules"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode == 0, proc.stderr
    banned = re.compile(r"^\s*(import jax|from jax|import tpu_hc_bench\b"
                        r"(?!_torch)|from tpu_hc_bench[. ](?!_torch))",
                        re.M)
    files = list((REPO / "tpu_hc_bench_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        assert not banned.search(path.read_text()), path
