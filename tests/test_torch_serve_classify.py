"""The serving lane's classify mode against the JAX package's, on the CPU.

The image and speech members serve single-forward requests: no KV
pool, one classify program a batch bucket, each request answered by one
forward.  Two members, each served by a JAX ``ServeEngine`` and a port
``ServeEngine`` on the same geometry (``--num_classes=10``,
``--max_in_flight=2``: buckets 1 and 2, ``--kv_pages=2``, which a
classify member must accept), the port's model carried over from the
JAX engine's own variables: ``vit_tiny`` (an NHWC image, permuted to the
port's NCHW) and ``deepspeech2_tiny`` (a ``[T, F]`` spectrogram, not
permuted; classified frame by frame, ``[B, T']``).

- **inputs**: ``_classify_input`` bit-equal to JAX's for every request.
- **programs**: at each bucket the port's classify logits against JAX's
  eval-mode forward under ``jax.jit`` within 1e-4 of their largest
  magnitude (float32; measured <= 8e-7), and the port's argmax equal to
  the answer of JAX's warmed classify program wherever the top two
  logits stand more than that tolerance apart.
- **the scheduler**: one Poisson trace in virtual time (a classify step
  costs 10 ms on both clocks): the same ``completed`` and
  ``classify_steps``, no decode or prefill step, every request's
  timings (ttft, e2e and the breakdown, where ttft is e2e and the
  resident window is the decode lane's) equal to JAX's.
- **refusals**: the decode lane's knobs at construction,
  ``--kv_preempt`` and a fault plan at run time, with JAX's messages;
  ncf by both engines (its embeddings take integer ids).
- **CLI**: ``serve --model=deepspeech2_tiny`` prints its classify steps.
"""

from __future__ import annotations

import re

import jax
import numpy as np
import pytest
import torch

from tpu_hc_bench import flags as jax_flags
from tpu_hc_bench.obs import metrics as jax_metrics
from tpu_hc_bench.serve import arrivals as jax_arrivals
from tpu_hc_bench.serve import engine as jax_engine
from tpu_hc_bench.serve import faults as jax_faults
from tpu_hc_bench_torch import convert, flags
from tpu_hc_bench_torch.models import create_model
from tpu_hc_bench_torch.serve import arrivals, cli
from tpu_hc_bench_torch.serve import engine as engine_mod
from tpu_hc_bench_torch.serve import faults as faults_mod
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

GEOMETRY = dict(num_classes=10, arrival_rate=50.0, num_requests=8,
                max_in_flight=2, kv_pages=2, seed=0)
VCOSTS = {"classify": 0.01}
LOGITS_TOL = 1e-4
MEMBERS = ("vit_tiny", "deepspeech2_tiny")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _state_dict(name: str, variables: dict) -> dict:
    v = _np(variables)
    if name.startswith("deepspeech2"):
        return convert.deepspeech2_variables_from_flax(v["params"],
                                                       v["batch_stats"])
    return convert.zoo_variables_from_flax(name, v["params"],
                                           v.get("batch_stats"))


@pytest.fixture(scope="module", params=MEMBERS)
def pair(request):
    """``(port engine, JAX engine)`` of one member, the port's model
    holding the JAX engine's variables."""
    name = request.param
    jcfg = jax_flags.BenchmarkConfig(workload="serve", model=name,
                                     **GEOMETRY).resolve()
    jax_eng = jax_engine.ServeEngine(jcfg, print_fn=lambda _m: None)
    model, _ = create_model(name, device="cpu", num_classes=10)
    model.load_state_dict(_state_dict(name, jax_eng.variables))
    cfg = flags.ServeConfig(model=name, device="cpu", **GEOMETRY).resolve()
    port = engine_mod.ServeEngine(cfg, print_fn=lambda _m: None, model=model)
    return port, jax_eng


def _requests(port, jax_eng):
    reqs = arrivals.build_requests(port.cfg, None)
    jreqs = jax_arrivals.build_requests(jax_eng.cfg, None)
    assert [(r.rid, r.arrival_s, r.prompt, r.output_len) for r in reqs] == \
        [(r.rid, r.arrival_s, r.prompt, r.output_len) for r in jreqs]
    return reqs, jreqs


def test_classify_input_is_jax_draw(pair):
    port, jax_eng = pair
    assert not port.decode_mode and not jax_eng.decode_mode
    reqs, jreqs = _requests(port, jax_eng)
    for r, jr in zip(reqs, jreqs):
        a, b = port._classify_input(r), jax_eng._classify_input(jr)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
        assert a.shape == tuple(port.spec.input_shape)


def test_classify_program_matches_jax(pair):
    port, jax_eng = pair
    reqs, jreqs = _requests(port, jax_eng)
    forward = jax.jit(lambda v, x: jax_eng.model.apply(v, x, train=False))
    assert port.batch_buckets == jax_eng.batch_buckets == (1, 2)
    for b in port.batch_buckets:
        x = np.stack([jax_eng._classify_input(jr) for jr in jreqs[:b]])
        want = np.asarray(forward(jax_eng.variables, x))
        answer = np.asarray(jax_eng.compiled[("classify", b)](
            jax_eng.variables, x))
        got_arg, got = port.classify_fn(torch.from_numpy(x))
        got, got_arg = got.numpy(), got_arg.numpy()
        assert got.shape == want.shape and got_arg.shape == answer.shape
        scale = max(float(np.abs(want).max()), 1.0)
        assert float(np.abs(got - want).max()) <= LOGITS_TOL * scale
        top2 = np.sort(want, -1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > LOGITS_TOL * scale
        assert clear.mean() > 0.5
        assert np.array_equal(got_arg[clear], answer[clear])
    if port.spec.ctc:
        assert answer.shape == (2, 16)            # [B, T'], frame by frame


class _Tap:
    def __init__(self):
        self.records = []

    def event(self, kind, **fields):
        self.records.append({"kind": kind, **fields})


def test_engine_matches_jax_in_virtual_time(pair):
    port, jax_eng = pair
    reqs, jreqs = _requests(port, jax_eng)
    tap = _Tap()
    got = port.run(reqs, writer=tap, clock=engine_mod.VirtualClock(VCOSTS))
    jtap = _Tap()
    jw = jax_metrics.MetricsWriter(None)
    jw.event = jtap.event
    want = jax_eng.run(jreqs, writer=jw,
                       clock=jax_engine.VirtualClock(VCOSTS))
    assert got["completed"] == want["completed"] == len(reqs)
    assert got["classify_steps"] == want["classify_steps"] > 0
    assert got["decode_steps"] == got["prefill_steps"] == 0
    assert got["tokens"] == want["tokens"] == len(reqs)
    assert got["kv_pages"] == want["kv_pages"] == 2
    assert got["kv_pool_bytes"] is None and got["decode_attention"] is None
    assert got["p99_ttft_ms"] == got["p99_e2e_ms"]
    for key in ("p50_e2e_ms", "p99_e2e_ms", "p99_ttft_ms", "p99_queue_ms"):
        assert got[key] == pytest.approx(want[key], abs=1e-3), key
    mine = {r["id"]: r for r in tap.records if r["kind"] == "request"}
    ref = {r["id"]: r for r in jtap.records if r["kind"] == "request"}
    assert set(mine) == set(ref) == {r.rid for r in reqs}
    for rid, rec in mine.items():
        assert "generated" not in rec and "pages_reserved" not in rec
        assert rec["ttft_ms"] == rec["e2e_ms"]
        assert rec["prefill_ms"] == 0.0
        for key, val in rec.items():
            if key != "kind":
                assert val == ref[rid][key], (rid, key)


@pytest.mark.parametrize("knob", [
    dict(decode_attention="paged"), dict(quant="int8_w"),
    dict(decode_attention="paged", decode_block_pages=2),
    dict(kv_reserve="lazy"), dict(kv_reserve="lazy", prefix_cache="on")])
def test_decode_knobs_refused_as_jax(knob):
    def message(make):
        with pytest.raises(ValueError) as err:
            make()
        return re.sub(r"\s+", " ", str(err.value))

    got = message(lambda: engine_mod.ServeEngine(flags.ServeConfig(
        model="deepspeech2_tiny", device="cpu", **knob).resolve(),
        print_fn=lambda _m: None))
    want = message(lambda: jax_engine.ServeEngine(jax_flags.BenchmarkConfig(
        workload="serve", model="deepspeech2_tiny", **knob).resolve(),
        print_fn=lambda _m: None))
    assert got == want


def test_run_refusals_follow_jax(pair):
    port, jax_eng = pair
    reqs, jreqs = _requests(port, jax_eng)
    for run, req, parse in ((port.run, reqs, faults_mod.parse_serve_plan),
                            (jax_eng.run, jreqs,
                             jax_faults.parse_serve_plan)):
        with pytest.raises(ValueError, match="--serve_faults/--kv_preempt"):
            run(req, kv_preempt="on")
        with pytest.raises(ValueError, match="--serve_faults/--kv_preempt"):
            run(req, faults=parse("nan_logits@1"))
        with pytest.raises(ValueError, match="no KV pool"):
            run(req, kv_reserve="lazy")


def test_ncf_is_refused_by_both_engines():
    with pytest.raises(ValueError, match="Input type must be an integer"):
        engine_mod.ServeEngine(flags.ServeConfig(
            model="ncf_tiny", device="cpu").resolve(),
            print_fn=lambda _m: None)
    with pytest.raises(ValueError, match="Input type must be an integer"):
        jax_engine.ServeEngine(jax_flags.BenchmarkConfig(
            workload="serve", model="ncf_tiny").resolve(),
            print_fn=lambda _m: None)


def test_cli_serves_classify_requests():
    lines: list[str] = []
    rc = cli.main(["--model=deepspeech2_tiny", "--device=cpu",
                   "--num_requests=4", "--max_in_flight=2",
                   "--arrival_rate=100"], print_fn=lines.append)
    assert rc == 0
    assert any("4/4 requests" in ln for ln in lines)
    steps = [ln for ln in lines if "/ classify " in ln]
    assert steps and not steps[0].endswith("/ classify 0")
    assert not any("decode arm:" in ln for ln in lines)
