"""The port's degradation, faults, drain/resume and watchdog against the
JAX serving lane, on the CPU.

- **grammar**: ``parse_serve_plan`` accepts and refuses the same specs
  as JAX's, with the same message (both lanes' vocabularies).
- **dispositions**: the same traces under ``shed=admit|deadline``,
  ``kv_preempt=on``, pool squeezes and a NaN-poison plan, in virtual
  time with the same step costs, through the port's ``llama_tiny``
  engine and JAX's: every request's terminal disposition (served, shed
  by cause, quarantined), the preempted ids in order, and the
  ``degrade`` counts equal.  Dispositions depend on the clock and the
  plan, not on the weights, so the two engines' different seeded
  weights do not enter.
- **requeue**: preempted requests decode the tokens of the port's own
  fault-free run, and each record's components sum to its e2e.
- **drain/resume**: a drain journals every unfinished request and the
  resumed run serves each exactly once; the journal file is read by
  both packages; a real SIGTERM through the CLI exits 75 and
  ``--serve_resume`` exits 0.
- **watchdog**: the hook fires on a wedged iteration, quiet otherwise.
- **corpus prompts and flags**: ``PromptSampler(data_dir=...)`` equals
  JAX's; every ported serving flag's default equals JAX's, and its
  refusals carry JAX's message.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpu_hc_bench import flags as jax_flags
from tpu_hc_bench.data import tokens as jax_tokens
from tpu_hc_bench.obs import metrics as jax_metrics
from tpu_hc_bench.serve import arrivals as jax_arrivals
from tpu_hc_bench.serve import engine as jax_engine
from tpu_hc_bench.serve import faults as jax_faults
from tpu_hc_bench.serve import slo as jax_slo
from tpu_hc_bench_torch import flags
from tpu_hc_bench_torch.data import tokens
from tpu_hc_bench_torch.resilience import watchdog
from tpu_hc_bench_torch.serve import arrivals, slo
from tpu_hc_bench_torch.serve import engine as engine_mod
from tpu_hc_bench_torch.serve import faults as faults_mod
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
VCOSTS = {"prefill": 0.004, "decode": 0.003, "page_copy": 0.001}
GEOMETRY = dict(model="llama_tiny", arrival_rate=50.0, num_requests=8,
                max_prompt_len=8, max_output_len=4, max_in_flight=2,
                kv_page_size=4, seed=0)


@pytest.fixture(scope="module")
def engines():
    """The port's engine and JAX's, on the same geometry."""
    cfg = flags.ServeConfig(device="cpu", **GEOMETRY).resolve()
    port = engine_mod.ServeEngine(cfg, print_fn=lambda _m: None)
    jcfg = jax_flags.BenchmarkConfig(workload="serve", **GEOMETRY).resolve()
    jax_eng = jax_engine.ServeEngine(jcfg, print_fn=lambda _m: None)
    return port, jax_eng, arrivals.build_requests(cfg, 1024)


class _Tap:
    def __init__(self):
        self.records = []

    def event(self, kind, **fields):
        self.records.append({"kind": kind, **fields})

    def of(self, *kinds):
        return [r for r in self.records if r["kind"] in kinds]


def _jax_tap():
    tap = _Tap()
    w = jax_metrics.MetricsWriter(None)
    w.event = tap.event
    return w, tap


def _burst(reqs):
    return [dataclasses.replace(r, arrival_s=0.0) for r in reqs]


def _dispositions(tap):
    return {r["id"]: (r["kind"], r.get("cause"), r.get("preempts", 0))
            for r in tap.of("request", "shed", "quarantine")}


def _both(engines, reqs, plan=None, **policy):
    port, jax_eng, _ = engines
    tap = _Tap()
    got = port.run(reqs, writer=tap, clock=engine_mod.VirtualClock(VCOSTS),
                   faults=faults_mod.parse_serve_plan(plan), **policy)
    jw, jtap = _jax_tap()
    want = jax_eng.run(reqs, writer=jw,
                       clock=jax_engine.VirtualClock(VCOSTS),
                       faults=jax_faults.parse_serve_plan(plan), **policy)
    return got, tap, want, jtap


# --- the fault grammar ---------------------------------------------------


@pytest.mark.parametrize("spec", [
    "hang@2:0.5,nan_logits@3,sigterm@0.1,pool_squeeze@0:2,"
    "pool_squeeze@0.2:1", "", None, " nan_logits@0 , ",
    "hang@2", "nan_logits@3:1", "sigterm@-1", "pool_squeeze@0:0",
    "nan_loss@2", "what@ever:x", "noat", "hang@:1", "hang@1:"])
def test_parse_serve_plan_equals_jax(spec):
    def parse(mod):
        try:
            p = mod.parse_serve_plan(spec)
        except ValueError as e:
            return "error", str(e)
        return "plan", None if p is None else (
            p.hang, p.nan_logits, p.sigterm, p.pool_squeeze)

    got, want = parse(faults_mod), parse(jax_faults)
    assert got == want
    if got[0] == "error":
        assert "--inject_fault" in got[1] and "--serve_faults" in got[1]


def test_serve_plan_hooks_are_one_shot():
    plan = faults_mod.parse_serve_plan(
        "hang@2:0.5,nan_logits@3,sigterm@0.1,pool_squeeze@0.2:2")
    assert plan.hang_before_decode(1) == 0.0
    assert plan.hang_before_decode(2) == 0.5
    assert plan.hang_before_decode(2) == 0.0
    assert plan.poison_rids([1, 3, 5]) == [3]
    assert plan.poison_rids([1, 3, 5]) == []
    assert not plan.sigterm_due(0.05)
    assert plan.sigterm_due(0.2) and not plan.sigterm_due(0.2)
    assert plan.squeezed_pages(0.1) == 0
    assert plan.squeezed_pages(9.9) == 2


# --- dispositions against JAX's engine ------------------------------------


SCENARIOS = {
    "nan_guarded": (False, "nan_logits@3", dict(kv_preempt="on")),
    "nan_unarmed": (False, "nan_logits@3",
                    dict(shed="off", kv_preempt="off")),
    "squeeze_preempt": (True, "pool_squeeze@0:3", dict(kv_preempt="on")),
    "terminal_squeeze_shed": (True, "pool_squeeze@0:13",
                              dict(shed="deadline", deadline_ms=100.0)),
    "shed_admit": (True, None, dict(shed="admit", deadline_ms=15.0)),
    "shed_predicted": (True, None, dict(shed="deadline", deadline_ms=40.0)),
    "shed_deadline_preempt_nan": (
        True, "nan_logits@5,pool_squeeze@0.002:4",
        dict(shed="deadline", deadline_ms=30.0, kv_preempt="on")),
    "lazy_preempt": (True, "pool_squeeze@0:3",
                     dict(kv_reserve="lazy", kv_preempt="on")),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_dispositions_equal_jax(engines, name):
    burst, plan, policy = SCENARIOS[name]
    reqs = _burst(engines[2]) if burst else engines[2]
    got, tap, want, jtap = _both(engines, reqs, plan, **policy)
    assert got["degrade"] == want["degrade"]
    assert got["completed"] == want["completed"]
    assert got["shed_frac"] == want["shed_frac"]
    assert _dispositions(tap) == _dispositions(jtap)
    assert [r["rid"] for r in tap.of("preempt")] == \
        [r["rid"] for r in jtap.of("preempt")]
    assert len(_dispositions(tap)) == len(reqs)


def test_scenarios_reach_every_disposition(engines):
    """The table above forces each path at least once."""
    seen = {"shed": set(), "preempts": 0, "quarantined": 0}
    for name, (burst, plan, policy) in SCENARIOS.items():
        reqs = _burst(engines[2]) if burst else engines[2]
        s = engines[0].run(reqs, clock=engine_mod.VirtualClock(VCOSTS),
                           faults=faults_mod.parse_serve_plan(plan),
                           **policy)
        seen["shed"] |= set(s["degrade"]["shed"])
        seen["preempts"] += s["degrade"]["preempts"]
        seen["quarantined"] += s["degrade"]["quarantined"]
    assert seen["shed"] >= {"deadline_expired", "deadline_predicted"}
    assert seen["preempts"] > 0 and seen["quarantined"] > 0


def test_terminal_squeeze_without_shedding_stalls_loudly(engines):
    with pytest.raises(RuntimeError, match="stall"):
        engines[0].run(_burst(engines[2]),
                       clock=engine_mod.VirtualClock(VCOSTS),
                       faults=faults_mod.parse_serve_plan(
                           "pool_squeeze@0:13"), shed="off")


def test_requeue_conserves_tokens_and_components(engines):
    port, _, reqs = engines
    burst = _burst(reqs)
    base = _Tap()
    port.run(burst, writer=base, clock=engine_mod.VirtualClock(VCOSTS))
    want = {r["id"]: r["generated"] for r in base.of("request")}
    tap = _Tap()
    summary = port.run(burst, writer=tap,
                       clock=engine_mod.VirtualClock(VCOSTS),
                       faults=faults_mod.parse_serve_plan("pool_squeeze@0:3"),
                       kv_preempt="on")
    assert summary["completed"] == len(burst)
    assert summary["degrade"]["preempts"] >= 1
    recs = tap.of("request")
    assert [r for r in recs if r.get("preempts")]
    for rec in recs:
        assert rec["generated"] == want[rec["id"]]
        parts = sum(rec[key] for key in (
            "queue_ms", "prefill_ms", "decode_active_ms",
            "decode_stall_ms", "retire_ms"))
        assert abs(parts - rec["e2e_ms"]) < 1e-6
    assert sum(r["output_len"] for r in recs) == \
        sum(r.output_len for r in burst)


def test_slo_lines_render_degradation_and_burn_rate(engines):
    port, _, reqs = engines
    summary = port.run(_burst(reqs), clock=engine_mod.VirtualClock(VCOSTS),
                       shed="deadline", deadline_ms=30.0)
    text = "\n".join(slo.slo_lines(summary))
    assert "degrade: shed" in text and "deadline_" in text
    done = [{"e2e_ms": 10.0 * i, "arrival_s": 0.01 * i} for i in range(8)]
    assert slo.fold_burn_rate(done, 35.0) == \
        jax_slo.fold_burn_rate(done, 35.0)


# --- drain, journal, resume ----------------------------------------------


class FakeHandler:
    def __init__(self, after: int):
        self.after = after
        self.polls = 0

    def requested(self) -> bool:
        self.polls += 1
        return self.polls > self.after


def test_drain_journals_then_resume_serves_exactly_once(engines, tmp_path):
    port, _, reqs = engines
    journal = str(tmp_path / "j" / "serve_journal.json")
    first = _Tap()
    summary = port.run(reqs, writer=first,
                       clock=engine_mod.VirtualClock(VCOSTS),
                       drain_handler=FakeHandler(after=2),
                       journal_path=journal)
    drained = summary["drained"]
    assert drained == {"journal": journal, "reason": "sigterm",
                       "unfinished": drained["unfinished"]}
    assert drained["unfinished"] >= 1
    assert summary["completed"] + drained["unfinished"] == len(reqs)
    replay = faults_mod.journal_requests(faults_mod.read_journal(journal))
    second = _Tap()
    resumed = port.run(replay, writer=second,
                       clock=engine_mod.VirtualClock(VCOSTS))
    assert resumed["completed"] == len(replay)
    a = {r["id"] for r in first.of("request")}
    b = {r["id"] for r in second.of("request")}
    assert a.isdisjoint(b) and a | b == {r.rid for r in reqs}


def test_journal_file_is_read_by_both_packages(engines, tmp_path):
    reqs = engines[2]
    rows = [faults_mod.journal_entry(reqs[0]),
            faults_mod.journal_entry(reqs[3], produced=2, prefix=[5, 6],
                                     preempts=1)]
    ours = faults_mod.write_journal(str(tmp_path / "ours.json"), rows,
                                    model="llama_tiny", seed=0)
    theirs = jax_faults.write_journal(
        str(tmp_path / "theirs.json"),
        [jax_faults.journal_entry(reqs[0]),
         jax_faults.journal_entry(reqs[3], produced=2, prefix=[5, 6],
                                  preempts=1)],
        model="llama_tiny", seed=0)
    assert Path(ours).read_text() == Path(theirs).read_text()
    for path in (ours, theirs):
        got = faults_mod.journal_requests(faults_mod.read_journal(path))
        want = jax_faults.journal_requests(jax_faults.read_journal(path))
        for a, b in zip(got, want, strict=True):
            assert (a.rid, a.arrival_s, a.output_len) == \
                (b.rid, b.arrival_s, b.output_len)
            np.testing.assert_array_equal(a.prompt, b.prompt)
    bad = tmp_path / "bad.json"
    bad.write_text('{"kind": "manifest"}\n')
    with pytest.raises(ValueError, match="serve drain journal"):
        faults_mod.read_journal(str(bad))


def test_cli_sigterm_drains_and_resume_serves_the_rest(tmp_path):
    """A real SIGTERM (``sigterm@`` delivers one to the process) through
    the CLI: exit 75 and a journal; the resume exits 0 having served
    exactly the journaled requests."""
    journal = tmp_path / "serve_journal.json"
    base = [sys.executable, "-m", "tpu_hc_bench_torch", "serve",
            "--model=llama_tiny", "--device=cpu", "--arrival_rate=50",
            "--num_requests=8", "--max_prompt_len=8", "--max_output_len=4",
            "--max_in_flight=2", "--kv_page_size=4"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

    def served(out: str) -> tuple[int, int]:
        m = re.search(r"serve: (\d+)/(\d+) requests", out)
        return int(m.group(1)), int(m.group(2))

    first = subprocess.run(
        base + [f"--serve_journal={journal}", "--serve_faults=sigterm@0.05"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert first.returncode == 75, first.stdout + first.stderr
    assert "serve drain" in first.stdout
    payload = json.loads(journal.read_text())
    unfinished = payload["unfinished"]
    done1, total = served(first.stdout)
    assert total == 8 and unfinished >= 1 and done1 + unfinished == 8
    second = subprocess.run(base + [f"--serve_resume={journal}"], cwd=REPO,
                            env=env, capture_output=True, text=True,
                            timeout=300)
    assert second.returncode == 0, second.stdout + second.stderr
    assert served(second.stdout) == (unfinished, unfinished)


# --- watchdog --------------------------------------------------------------


def test_watchdog_hook_fires_on_wedged_iteration(engines):
    port, _, reqs = engines
    fired: list = []
    summary = port.run(reqs, faults=faults_mod.parse_serve_plan("hang@2:0.8"),
                       step_timeout_s="0.3", on_watchdog=fired.append)
    assert fired and fired[0] >= 0.3
    assert summary["completed"] == len(reqs)


def test_watchdog_quiet_on_healthy_run(engines):
    port, _, reqs = engines
    fired: list = []
    summary = port.run(reqs, step_timeout_s="30", on_watchdog=fired.append)
    assert not fired and summary["completed"] == len(reqs)


@pytest.mark.parametrize("spec", [None, "", "off", "0", "2.5", "auto",
                                  "-1", "soon"])
def test_resolve_timeout_equals_jax(spec):
    from tpu_hc_bench.resilience import watchdog as jax_watchdog

    def call(fn):
        try:
            return fn(spec, warmup_step_s=0.5), None
        except ValueError as e:
            return None, str(e)

    assert call(watchdog.resolve_timeout) == \
        call(jax_watchdog.resolve_timeout)


# --- corpus prompts and flags ----------------------------------------------


def test_corpus_prompts_equal_jax(tmp_path):
    rng = np.random.default_rng(9)
    stream = rng.integers(1, 300, 4000)
    stream[rng.integers(0, 4000, 60)] = 0           # end-of-document ids
    tokens.write_token_file(tmp_path / "train.bin", stream, vocab_size=300)
    ours = tokens.PromptSampler(300, data_dir=tmp_path, seed=4)
    theirs = jax_tokens.PromptSampler(300, data_dir=str(tmp_path), seed=4)
    lengths = []
    for rid in range(24):
        got = ours.sample(rid, 64)
        np.testing.assert_array_equal(got, theirs.sample(rid, 64))
        lengths.append(len(got))
    assert min(lengths) < 64                # cut at a document's end
    cfg = flags.ServeConfig(model="llama_tiny", data_dir=str(tmp_path),
                            num_requests=5, max_prompt_len=32).resolve()
    jcfg = jax_flags.BenchmarkConfig(
        model="llama_tiny", workload="serve", data_dir=str(tmp_path),
        num_requests=5, max_prompt_len=32)
    for a, b in zip(arrivals.build_requests(cfg, 300),
                    jax_arrivals.build_requests(jcfg, 300), strict=True):
        np.testing.assert_array_equal(a.prompt, b.prompt)


PORTED = ("quant", "slo_e2e_ms", "deadline_ms", "shed", "kv_preempt",
          "serve_faults", "serve_journal", "serve_resume",
          "serve_step_timeout_s", "kv_reserve", "prefix_cache",
          "kv_growth_headroom", "data_dir", "metrics_dir",
          "compile_cache", "hbm_budget", "flight_recorder")


def test_ported_flag_defaults_equal_jax():
    d, j = flags.ServeConfig(), jax_flags.BenchmarkConfig()
    for name in PORTED:
        assert getattr(d, name) == getattr(j, name), name
        assert name not in flags.LATER_SLICE_FLAGS
    cfg = flags.parse_flags(["--model=llama_tiny", "--kv_reserve=lazy",
                             "--prefix_cache=on", "--shed=deadline",
                             "--deadline_ms=50", "--kv_preempt=on",
                             "--serve_faults=nan_logits@1",
                             "--serve_step_timeout_s=auto",
                             "--kv_growth_headroom=2"])
    assert (cfg.prefix_cache, cfg.deadline_ms, cfg.kv_growth_headroom,
            cfg.serve_step_timeout_s) == ("on", 50.0, 2, "auto")
    with pytest.raises(ValueError, match="not ported"):
        flags.parse_flags(["--config=x"])


@pytest.mark.parametrize("kw", [
    dict(shed="deadline"), dict(shed="yes", deadline_ms=50.0),
    dict(kv_preempt="maybe"), dict(deadline_ms=-1.0),
    dict(slo_e2e_ms=-1.0), dict(serve_faults="hang@2"),
    dict(serve_step_timeout_s="soon"), dict(kv_reserve="x"),
    dict(prefix_cache="on"), dict(kv_growth_headroom=-1),
    dict(quant="int4"), dict(quant="int8_kv", decode_attention="gather"),
    dict(shed="admit", slo_e2e_ms=80.0)])
def test_flag_refusals_equal_jax(kw):
    def resolve(make):
        try:
            make(model="llama_tiny", **kw).resolve()
        except ValueError as e:
            return str(e)
        return None

    assert resolve(flags.ServeConfig) == resolve(
        lambda **k: jax_flags.BenchmarkConfig(workload="serve", **k))
