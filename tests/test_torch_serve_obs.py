"""The port's serving observability against the JAX serving lane, on the
CPU.

Two engines on one geometry (``llama_tiny``, 24 Poisson requests, two
in flight): JAX's ``ServeEngine`` and the port's, the port's model
holding the JAX engine's own weights (``convert.llama_params_from_flax``),
so greedy tokens agree as well as the schedule.  Each run goes through
its own package's real ``MetricsWriter`` and ``FleetWriter`` into a
``tmp_path``, in virtual time (``VirtualClock`` costs for every step
kind, so no wall time enters a record).

- **stream parity**, in four arms: continuous, static, ``kv_reserve=
  lazy`` with ``prefix_cache=on`` (prompts sharing a prefix: hits and
  copy-on-write), and a degraded arm (lazy, ``shed=deadline``,
  ``kv_preempt=on``, a NaN-poisoned request and a pool squeeze: every
  disposition and a fired signal).  Every record of ``metrics.jsonl``
  is equal field for field (``request``, ``serve``, ``kv_pool``,
  ``latency_sketch``, ``shed``, ``preempt``, ``quarantine``,
  ``injected_fault``) except the wall fields of ``serve_clock`` and the
  lane-specific ``serve_compile``; ``signals.jsonl`` is equal; the
  flight recorder's span and instant names come in the same order; the
  heartbeats are equal but for their wall clocks; ``serve_summary``'s
  shared keys are equal (the keys each lane has alone are listed in
  ``PORT_ONLY`` and ``JAX_ONLY``).
- **cross-reading**: JAX's ``summarize_run`` renders the port's run dir
  with the port's serve lines, JAX's ``evaluate_run`` gives the port's
  signal lines, and each package's ``merge_chrome_trace`` reads the
  other's spans.
- **CLI**: ``--metrics_dir``, ``--flight_recorder``, ``--hbm_budget``
  on the CPU (the budget unchecked: no allocator peak), the summarize
  command, the streams closed after an exception inside ``run`` and on
  a Ctrl-C outside it (130), the drain journal and timeline dump in
  the metrics dir, the watchdog's forensics.
- **classify**: the classify mode's records against JAX's on
  ``vit_tiny``.
- **flags**: the four flags with JAX's defaults and refusals;
  ``--compile_cache`` drives the kernel build directory.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from tpu_hc_bench import flags as jax_flags
from tpu_hc_bench.obs import fleet as jax_fleet
from tpu_hc_bench.obs import metrics as jax_metrics
from tpu_hc_bench.obs import signals as jax_signals
from tpu_hc_bench.obs import timeline as jax_timeline
from tpu_hc_bench.serve import engine as jax_engine
from tpu_hc_bench.serve import faults as jax_faults
from tpu_hc_bench_torch import convert, flags
from tpu_hc_bench_torch.models import create_model
from tpu_hc_bench_torch.obs import __main__ as obs_cli
from tpu_hc_bench_torch.obs import fleet, metrics, signals, timeline
from tpu_hc_bench_torch.ops import _build
from tpu_hc_bench_torch.serve import arrivals, cli, slo
from tpu_hc_bench_torch.serve import engine as engine_mod
from tpu_hc_bench_torch.serve import faults as faults_mod
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

GEOMETRY = dict(model="llama_tiny", arrival_rate=50.0, num_requests=24,
                max_prompt_len=8, max_output_len=4, max_in_flight=2,
                kv_page_size=4, seed=0)
VCOSTS = {"prefill": 0.004, "decode": 0.003, "page_copy": 0.001}
SHARED_PREFIX = 4                          # prompt tokens the lazy arm shares
ARMS = {
    "continuous": (None, dict(batching="continuous")),
    "static": (None, dict(batching="static")),
    "lazy_prefix": (None, dict(kv_reserve="lazy", prefix_cache="on")),
    "degraded": ("nan_logits@3,pool_squeeze@0.08:4",
                 dict(kv_reserve="lazy", shed="deadline", deadline_ms=120.0,
                      kv_preempt="on")),
}
# serve_summary keys one lane has and the other has not
PORT_ONLY = ("device", "weight_bytes", "decode_peak_bytes")
JAX_ONLY = ("aot_decode_temp_bytes", "post_warmup_compiles")
MANIFEST = {"model": "llama_tiny", "workload": "serve"}
# record fields read off the wall clock, whatever the engine clock
WALL_FIELDS = ("t_unix", "t_mono")


@pytest.fixture(scope="module")
def engines():
    """JAX's engine and the port's over the JAX engine's weights."""
    jcfg = jax_flags.BenchmarkConfig(workload="serve", **GEOMETRY).resolve()
    jax_eng = jax_engine.ServeEngine(jcfg, print_fn=lambda _m: None)
    cfg = flags.ServeConfig(device="cpu", **GEOMETRY).resolve()
    model, _ = create_model("llama_tiny", device="cpu",
                            seq_len=cfg.max_prompt_len + cfg.max_output_len)
    model.load_state_dict(convert.llama_params_from_flax(
        jax.tree_util.tree_map(np.asarray, jax_eng.params)))
    port = engine_mod.ServeEngine(cfg, print_fn=lambda _m: None,
                                  model=model)
    return port, jax_eng, arrivals.build_requests(cfg, 1024)


def _trace(reqs, arm: str):
    if arm != "lazy_prefix":
        return reqs
    common = reqs[0].prompt[:SHARED_PREFIX]
    return [dataclasses.replace(r, prompt=np.concatenate(
        [common, r.prompt[SHARED_PREFIX:]]).astype(np.int32))
        if r.prompt_len > SHARED_PREFIX else r for r in reqs]


def _serve_both(engines, tmp_path, arm: str) -> dict:
    """One arm through both engines, each into its own run dir."""
    port, jax_eng, reqs = engines
    plan, policy = ARMS[arm]
    reqs = _trace(reqs, arm)
    out = {}
    for lane, eng, writer_cls, fleet_cls, plans, clock in (
            ("port", port, lambda d: metrics.MetricsWriter(d, MANIFEST),
             fleet.FleetWriter, faults_mod, engine_mod.VirtualClock),
            ("jax", jax_eng,
             lambda d: jax_metrics.MetricsWriter(d, MANIFEST, primary=True),
             jax_fleet.FleetWriter, jax_faults, jax_engine.VirtualClock)):
        run_dir = str(tmp_path / arm / lane)
        writer = writer_cls(run_dir)
        beats = fleet_cls(run_dir, process_index=0)
        # JAX's recorder flushes every span its ring holds into the run
        # dir, those of earlier runs in this process too (the port's
        # starts at the attach): give it a fresh ring for the run
        fresh = pytest.MonkeyPatch()
        fresh.setattr(jax_timeline, "_RECORDER", jax_timeline.SpanRecorder())
        try:
            summary = eng.run(reqs, writer=writer, fleet=beats,
                              clock=clock(VCOSTS),
                              faults=plans.parse_serve_plan(plan), **policy)
        finally:
            writer.close()
            beats.close()
            fresh.undo()
        out[lane] = (run_dir, summary)
    return out


def _span_names(run_dir: str) -> list[str]:
    return [s["name"] for s in timeline.read_spans(run_dir)[0]]


def _signals(run_dir: str) -> str | None:
    path = signals.signals_path(run_dir)
    return open(path).read() if os.path.exists(path) else None


@pytest.fixture(scope="module")
def runs(engines, tmp_path_factory):
    base = tmp_path_factory.mktemp("arms")
    return {arm: _serve_both(engines, base, arm) for arm in ARMS}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_stream_parity_with_jax(runs, arm):
    (pdir, got), (jdir, want) = runs[arm]["port"], runs[arm]["jax"]
    mine = metrics.read_jsonl(os.path.join(pdir, metrics.METRICS_NAME))
    ref = metrics.read_jsonl(os.path.join(jdir, metrics.METRICS_NAME))
    assert [r["kind"] for r in mine] == [r["kind"] for r in ref]
    for a, b in zip(mine, ref):
        if a["kind"] == "serve_compile":
            continue
        if a["kind"] == "serve_clock":
            a, b = ({k: v for k, v in r.items() if k not in WALL_FIELDS}
                    for r in (a, b))
        if a["kind"] == "serve_summary":
            for k in PORT_ONLY:
                a.pop(k)
            for k in JAX_ONLY:
                b.pop(k)
        assert a == b, a["kind"]
    assert set(got) - set(want) == set(PORT_ONLY)
    assert set(want) - set(got) == set(JAX_ONLY)
    assert {k: v for k, v in got.items() if k not in PORT_ONLY} == \
        {k: v for k, v in want.items() if k not in JAX_ONLY}
    assert _signals(pdir) == _signals(jdir)
    assert _span_names(pdir) == _span_names(jdir)
    beats = [[{k: v for k, v in r.items() if k not in WALL_FIELDS}
              for r in fleet.read_heartbeats(d)[0]] for d in (pdir, jdir)]
    assert beats[0] == beats[1] and beats[0]
    kinds = {r["kind"] for r in mine}
    assert {"request", "serve", "kv_pool", "latency_sketch"} <= kinds \
        or arm == "degraded"


def test_arms_reach_every_record_kind_and_signal(runs):
    kinds, fired, hits = set(), {}, 0
    for arm in ARMS:
        pdir, summary = runs[arm]["port"]
        kinds |= {r["kind"] for r in metrics.read_jsonl(
            os.path.join(pdir, metrics.METRICS_NAME))}
        for k, n in summary["signals_fired"].items():
            fired[k] = fired.get(k, 0) + n
        hits += (summary["kv_pool"] or {}).get("prefix_hits", 0)
    assert {"request", "serve", "kv_pool", "latency_sketch", "shed",
            "preempt", "quarantine", "injected_fault", "serve_clock",
            "serve_summary", "serve_compile"} <= kinds
    deg = runs["degraded"]["port"][1]["degrade"]
    assert set(deg["shed"]) == {"deadline_expired", "deadline_predicted"}
    assert deg["preempts"] and deg["quarantined"]
    assert fired.get("KV_PRESSURE") and hits > 0
    names = set().union(*(_span_names(runs[arm]["port"][0])
                          for arm in ARMS))
    assert {"prefill", "decode", "admit", "retire", "shed", "preempt",
            "requeue", "quarantine", "pool_starved",
            "batch_full"} <= names <= timeline.KNOWN_SPANS | {"page_copy"}


def test_sketch_percentiles_equal_jax_and_the_stream(runs):
    pdir, summary = runs["continuous"]["port"]
    _, records = metrics.read_run(pdir)
    reqs = [r for r in records if r["kind"] == "request"]
    assert {k: summary[k] for k in slo.fold_requests(reqs)} == \
        slo.fold_requests(reqs)
    assert summary["p99_merged_ms"] == summary["p99_e2e_ms"]
    assert summary["latency_source"] == "sketch"


def test_jax_reads_the_port_run_dirs(runs):
    for arm in ("continuous", "degraded"):
        pdir, _ = runs[arm]["port"]
        _, records = metrics.read_run(pdir)
        serve_lines = slo.slo_lines(slo.fold_serve_records(records))
        ours = metrics.summarize_run(pdir)
        theirs = jax_metrics.summarize_run(pdir)
        for ln in serve_lines:
            assert ln in ours and ln in theirs, ln
        for prefix in ("  p99 e2e", "  kv_pool_util", "  queue_wait cause"):
            assert [ln for ln in ours if ln.startswith(prefix)] == \
                [ln for ln in theirs if ln.startswith(prefix)]
        assert signals.evaluate_run(pdir)["lines"] == \
            jax_signals.evaluate_run(pdir)["lines"]
        jdir, _ = runs[arm]["jax"]
        for run_dir in (pdir, jdir):
            a = timeline.merge_chrome_trace(run_dir)
            b = jax_timeline.merge_chrome_trace(run_dir)
            assert [e["name"] for e in a["traceEvents"]] == \
                [e["name"] for e in b["traceEvents"]]
            assert a["metadata"]["request_lanes"] == \
                b["metadata"]["request_lanes"] > 0


def test_obs_cli_on_the_port_run(runs, capsys):
    pdir, _ = runs["degraded"]["port"]
    assert obs_cli.main(["summarize", pdir]) == 0
    out = capsys.readouterr().out
    assert "serve: 13/24 requests" in out and "resilience:" in out
    assert obs_cli.main(["signals", pdir]) == 1      # KV_PRESSURE fired
    assert "fire KV_PRESSURE" in capsys.readouterr().out
    trace = os.path.join(pdir, "t.json")
    assert obs_cli.main(["timeline", pdir, "-o", trace]) == 0
    with open(trace) as f:
        assert json.load(f)["traceEvents"]
    assert obs_cli.main(["summarize", os.path.join(pdir, "nothing")]) == 2


# --- the CLI and the failure paths ----------------------------------------


def _argv(run_dir, *extra):
    return ["--model=llama_tiny", "--device=cpu", "--decode_attention=paged",
            "--num_requests=20", "--max_prompt_len=8", "--max_output_len=3",
            "--max_in_flight=2", "--kv_page_size=4", "--arrival_rate=100",
            f"--metrics_dir={run_dir}", *extra]


def test_cli_writes_the_run_dir_on_the_cpu(tmp_path):
    run_dir = str(tmp_path / "run")
    lines: list[str] = []
    rc = cli.main(_argv(run_dir, "--flight_recorder=on", "--hbm_budget=1GB",
                        "--slo_e2e_ms=5"), print_fn=lines.append)
    assert rc == 0
    assert any(ln.startswith("WARNING: --hbm_budget: no memory report")
               and "budget unchecked" in ln for ln in lines)
    assert f"summarize: python -m tpu_hc_bench_torch.obs summarize " \
           f"{run_dir}" in lines
    assert any(ln.startswith("metrics: ") for ln in lines)
    for name in ("manifest.json", "metrics.jsonl", "metrics.0.jsonl",
                 "spans.0.jsonl", "signals.jsonl"):
        path = os.path.join(run_dir, name)
        with open(path) as f:
            body = f.read()
        if name.endswith(".json"):
            json.loads(body)
        else:
            assert all(json.loads(ln) for ln in body.splitlines())
    problems: list[str] = []
    man, records = metrics.read_run(run_dir, problems=problems)
    assert not problems
    assert man["workload"] == "serve" and man["world"] == 1
    assert man["config"]["hbm_budget"] == "1GB" and man["git_sha"]
    summary = [r for r in records if r["kind"] == "serve_summary"][-1]
    compile_rec = [r for r in records if r["kind"] == "serve_compile"][-1]
    assert compile_rec["kernel_library"] is None     # the CPU: no library
    assert compile_rec["hbm_budget"] == {"budget_bytes": 2**30,
                                         "measured": None}
    assert summary["completed"] == 20 and summary["signals_fired_total"]
    # the run's own spans only: one a decode step
    assert _span_names(run_dir).count("decode") == summary["decode_steps"]
    assert any("hbm budget: unchecked" in ln
               for ln in metrics.summarize_run(run_dir))
    off = str(tmp_path / "off")
    assert cli.main(_argv(off, "--flight_recorder=off"),
                    print_fn=lambda _m: None) == 0
    assert not os.path.exists(os.path.join(off, "spans.0.jsonl"))


def test_streams_closed_after_an_exception_inside_run(tmp_path,
                                                      monkeypatch):
    cfg = flags.parse_flags(_argv(str(tmp_path / "run")))
    engine, reqs = cli.build_engine_and_requests(cfg, lambda _m: None)
    calls = {"n": 0}
    decode = engine.decode_fn

    def failing(*args):
        calls["n"] += 1
        if calls["n"] == 5:
            raise RuntimeError("device fell over")
        return decode(*args)

    monkeypatch.setattr(engine, "decode_fn", failing)
    writer = cli.serve_writer(cfg, cfg.metrics_dir)
    with pytest.raises(RuntimeError, match="fell over"):
        cli.run_serve(engine, reqs, writer)
    assert not writer.enabled                # closed on the way out
    problems: list[str] = []
    _, records = metrics.read_run(cfg.metrics_dir, problems=problems)
    assert not problems and records[0]["kind"] == "serve_clock"
    assert any(r["kind"] == "request" for r in records)
    assert _span_names(cfg.metrics_dir).count("decode") == 4
    assert fleet.read_heartbeats(cfg.metrics_dir) == {0: []}


def test_ctrl_c_outside_run_exits_130_with_streams_closed(tmp_path,
                                                          monkeypatch):
    seen = {}

    def interrupted(self, requests, **kw):
        seen["writer"] = kw["writer"]
        kw["writer"].event("serve_clock", t_unix=0.0)
        raise KeyboardInterrupt

    monkeypatch.setattr(engine_mod.ServeEngine, "run", interrupted)
    lines: list[str] = []
    run_dir = str(tmp_path / "run")
    assert cli.main(_argv(run_dir), print_fn=lines.append) == 130
    assert "interrupted — metrics stream closed" in lines
    assert not seen["writer"].enabled
    assert metrics.read_jsonl(os.path.join(run_dir, "metrics.jsonl")) == \
        [{"kind": "serve_clock", "t_unix": 0.0}]


class _DrainAfter:
    def __init__(self, polls: int):
        self.polls = polls

    def requested(self) -> bool:
        self.polls -= 1
        return self.polls < 0


def test_drain_journals_into_the_metrics_dir(engines, tmp_path):
    port, _, reqs = engines
    run_dir = str(tmp_path / "run")
    writer = metrics.MetricsWriter(run_dir)
    summary = port.run(reqs, writer=writer,
                       clock=engine_mod.VirtualClock(VCOSTS),
                       drain_handler=_DrainAfter(6))
    writer.close()
    journal = os.path.join(run_dir, faults_mod.JOURNAL_NAME)
    assert summary["drained"]["journal"] == journal
    assert os.path.isfile(journal)
    with open(os.path.join(run_dir, timeline.TIMELINE_DUMP_NAME)) as f:
        dump = json.load(f)
    assert dump["reason"] == "serve_drain"
    assert dump["ranks"]["0"][-1]["name"] == "drain"
    records = metrics.read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    (drain,) = [r for r in records if r.get("scope") == "drain"]
    assert drain["journal"] == journal
    replay = faults_mod.journal_requests(faults_mod.read_journal(journal))
    assert len(replay) == summary["drained"]["unfinished"]


def test_watchdog_leaves_forensics_in_the_metrics_dir(engines, tmp_path):
    port, _, reqs = engines
    run_dir = str(tmp_path / "run")
    writer = metrics.MetricsWriter(run_dir)
    fired: list = []
    port.run(reqs[:6], writer=writer,
             faults=faults_mod.parse_serve_plan("hang@2:0.8"),
             step_timeout_s="0.3", on_watchdog=fired.append)
    assert fired and not writer.enabled      # the watchdog closed it
    records = metrics.read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    assert any(r["kind"] == "watchdog_dump" for r in records)
    for name in (timeline.TIMELINE_DUMP_NAME, "memory_dump.json"):
        with open(os.path.join(run_dir, name)) as f:
            assert json.load(f)["reason"] == "serve_watchdog"


# --- classify --------------------------------------------------------------


def test_classify_records_equal_jax(tmp_path, monkeypatch):
    from test_torch_serve_classify import _state_dict

    # a fresh JAX ring, as in _serve_both
    monkeypatch.setattr(jax_timeline, "_RECORDER",
                        jax_timeline.SpanRecorder())

    geometry = dict(num_classes=10, arrival_rate=50.0, num_requests=40,
                    max_in_flight=2, seed=0)
    jcfg = jax_flags.BenchmarkConfig(workload="serve", model="vit_tiny",
                                     **geometry).resolve()
    jax_eng = jax_engine.ServeEngine(jcfg, print_fn=lambda _m: None)
    model, _ = create_model("vit_tiny", device="cpu", num_classes=10)
    model.load_state_dict(_state_dict("vit_tiny", jax_eng.variables))
    cfg = flags.ServeConfig(model="vit_tiny", device="cpu",
                            **geometry).resolve()
    port = engine_mod.ServeEngine(cfg, print_fn=lambda _m: None,
                                  model=model)
    reqs = arrivals.build_requests(cfg, None)
    streams = []
    for run_dir, eng, writer_cls, clock in (
            (str(tmp_path / "p"), port, metrics.MetricsWriter,
             engine_mod.VirtualClock({"classify": 0.01})),
            (str(tmp_path / "j"), jax_eng,
             lambda d: jax_metrics.MetricsWriter(d, primary=True),
             jax_engine.VirtualClock({"classify": 0.01}))):
        writer = writer_cls(run_dir)
        eng.run(reqs, writer=writer, clock=clock)
        writer.close()
        streams.append([r for r in metrics.read_jsonl(
            os.path.join(run_dir, "metrics.jsonl"))
            if r["kind"] in ("request", "serve", "latency_sketch")])
    assert streams[0] == streams[1]
    kinds = {r["kind"] for r in streams[0]}
    assert kinds == {"request", "serve", "latency_sketch"}
    assert "generated" not in streams[0][0]
    assert _span_names(str(tmp_path / "p")) == \
        _span_names(str(tmp_path / "j"))
    assert "classify" in _span_names(str(tmp_path / "p"))


# --- flags and the kernel build directory ---------------------------------


def test_obs_flags_take_jax_defaults_and_refusals():
    d, j = flags.ServeConfig(), jax_flags.BenchmarkConfig()
    for name in ("metrics_dir", "flight_recorder", "hbm_budget",
                 "compile_cache"):
        assert getattr(d, name) == getattr(j, name), name
    cfg = flags.parse_flags(["--metrics_dir=/tmp/run", "--flight_recorder=off",
                             "--hbm_budget=auto", "--compile_cache=off"])
    assert (cfg.metrics_dir, cfg.flight_recorder, cfg.hbm_budget,
            cfg.compile_cache) == ("/tmp/run", "off", "auto", "off")
    assert any("flight_recorder=off hbm_budget=auto" in ln
               for ln in cfg.summary_lines())
    for bad, kw in (("flight_recorder", dict(flight_recorder="maybe")),
                    ("hbm_budget", dict(hbm_budget="12 bananas"))):
        with pytest.raises(ValueError) as mine:
            flags.ServeConfig(**kw).resolve()
        with pytest.raises(ValueError) as ref:
            jax_flags.BenchmarkConfig(workload="serve", **kw).resolve()
        assert str(mine.value) == str(ref.value), bad
    with pytest.raises(SystemExit):
        flags.parse_flags(["--flight_recorder=maybe"])
    with pytest.raises(ValueError, match="not ported"):
        flags.parse_flags(["--config=auto"])


def test_compile_cache_points_the_kernel_build(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_STATE", dict(_build._STATE,
                                               record=None, builds=0))
    assert _build.library_record() is None
    got = _build.configure(str(tmp_path / "kernels"))
    assert got == (tmp_path / "kernels").resolve()
    assert _build._STATE["reuse"]
    assert _build.configure("off") == _build.BUILD_DIR
    assert not _build._STATE["reuse"]
    built = []

    def fake_build(lib, stamp):
        built.append(lib)
        lib.write_text("lib")
        stamp.write_text("h")
        return 1.5, ""

    lib = tmp_path / "k" / "lib.so"
    lib.parent.mkdir()
    assert _build.build_stamped(lib, "h", fake_build) == (1.5, "")
    assert _build.build_stamped(lib, "h", fake_build) == (0.0, "")
    assert _build.build_stamped(lib, "h", fake_build,
                                reuse=False) == (1.5, "")
    assert len(built) == 2
    _build._STATE["record"] = {"build_dir": str(lib.parent), "built": True,
                               "seconds": 1.5}
    assert _build.library_record()["built"]
    with pytest.raises(RuntimeError, match="already loaded"):
        _build.configure(str(tmp_path / "elsewhere"))
