"""The port's obs CLI additions — ``diff``, ``watch``, ``regress`` — and
the offline ``DATA_STARVED`` signal, against the JAX package's, on the
CPU.

Every input is built here in ``tmp_path`` from a numpy seed: training
and serving run directories (manifest, ``metrics.jsonl``, heartbeats,
``signals.jsonl``) written by the port's writers, and BENCH-style
records for the regression gate.  Both packages read the same files;
their lines must agree once the package names are normalised:

- ``diff_runs`` (config drift, summary deltas, ledger phases, trace
  buckets, memory, the serving rows with attribution and KV deltas)
  and the trace-bucket table;
- ``watch.render`` on a finished training run (heartbeats, signals,
  goodput, MFU) and a serving run, then the CLI's exit codes: 0 once a
  summary is present, 1 at ``--timeout``;
- ``regress_check``/``run_regress``: pass, a regression, no matching
  history, an unusable fresh record (exit 0/1/0/2), the wrapper shapes;
- ``evaluate_records``: ``DATA_STARVED`` on a starved stream (10 s
  wall, 6 s ``data_wait``), not under the threshold, not without ledger
  records; ``obs signals`` exits 1 on the starved run.
"""

from __future__ import annotations

import io
import json

import numpy as np
import pytest

from test_torch_obs import _stream
from tpu_hc_bench.obs import fleet as jax_fleet
from tpu_hc_bench.obs import metrics as jax_metrics
from tpu_hc_bench.obs import regress as jax_regress
from tpu_hc_bench.obs import signals as jax_signals
from tpu_hc_bench.obs import trace as jax_trace
from tpu_hc_bench.obs import watch as jax_watch
from tpu_hc_bench.obs.__main__ import main as jax_obs_main
from tpu_hc_bench_torch.obs import fleet, metrics, regress, signals, trace
from tpu_hc_bench_torch.obs import watch
from tpu_hc_bench_torch.obs.__main__ import main as obs_main
from torch_threads import cpu_share, jax_private_cache  # noqa: F401


def _norm(lines: list[str]) -> list[str]:
    return [ln.replace("tpu_hc_bench_torch", "tpu_hc_bench")
            for ln in lines]


def _train_records(seed: int, *, data_wait: float = 0.4,
                   wall: float = 10.0, done: bool = True) -> list[dict]:
    """A training stream as ``train/driver.py`` writes it: ledger phases, a
    window, memory samples, trace buckets and the summary."""
    rng = np.random.default_rng(seed)
    rate = float(rng.uniform(900.0, 1100.0))
    step_ms = round(128e3 / rate, 3)
    recs = [{"kind": "phase", "phase": "init", "t": 50.0, "step": None},
            {"kind": "phase", "phase": "compile", "t": 51.0 + seed,
             "step": None},
            {"kind": "phase", "phase": "step", "t": 52.5 + seed, "step": 0},
            {"kind": "phase_acc", "phase": "data_wait",
             "seconds": data_wait, "step": 10},
            {"kind": "window", "step": 10, "rate": rate,
             "step_ms": step_ms, "loss": float(rng.uniform(6.0, 7.0))},
            {"kind": "memory", "phase": "compile", "step": 0,
             "bytes_in_use": int(rng.integers(1 << 30, 2 << 30)),
             "peak_bytes": int(rng.integers(4 << 30, 6 << 30)),
             "bytes_limit": 80 << 30, "source": "torch.cuda"},
            {"kind": "memory", "phase": "step", "step": 10,
             "bytes_in_use": int(rng.integers(2 << 30, 3 << 30)),
             "peak_bytes": int(rng.integers(5 << 30, 9 << 30)),
             "bytes_limit": 80 << 30, "source": "torch.cuda"},
            {"kind": "trace_buckets", "buckets": {
                "compute": float(rng.uniform(5e4, 6e4)),
                "collective": float(rng.uniform(0.0, 1e4)),
                "copy": float(rng.uniform(1e3, 2e3)),
                **({"idle": 10.0} if seed else {})}}]
    if not done:
        return recs
    recs += [{"kind": "phase", "phase": "end", "t": 50.0 + wall,
              "step": 10},
             {"kind": "summary", "model": "resnet50", "total_workers": 1,
              "global_batch": 128, "total_images_per_sec": rate,
              "images_per_sec_per_chip": rate, "mean_step_ms": step_ms,
              "p50_step_ms": step_ms - 0.5,
              "mfu": float(rng.uniform(0.01, 0.02)),
              "final_loss": float(rng.uniform(6.0, 7.0)),
              "goodput": float(rng.uniform(0.6, 0.8)),
              "mfu_source": "measured" if seed else "analytic"}]
    return recs


def _write_run(path, records: list[dict], config: dict,
               beats: bool = False, signal_events: list | None = None,
               **manifest) -> str:
    run = str(path)
    w = metrics.MetricsWriter(run, {"model": config.get("model"),
                                    "config": config, "process_count": 1,
                                    "device_count": 1, **manifest})
    for r in records:
        w.event(**r)
    w.close()
    if beats:
        for rank, (step, ewma) in enumerate(((10, 120.5), (9, 131.0))):
            f = fleet.FleetWriter(run, process_index=rank)
            f.heartbeat(step=step, step_ewma_ms=ewma, phase="step",
                        mem_peak_bytes=(5 + rank) << 30)
            f.close()
    if signal_events:
        signals.append_events(signals.signals_path(run), signal_events)
    return run


def _cfg(**kw) -> dict:
    base = {"model": "resnet50", "batch_size": 128, "num_batches": 10,
            "use_fp16": True, "metrics_dir": "/runs/x", "config": "manual"}
    base.update(kw)
    return base


# --- diff --------------------------------------------------------------------


@pytest.mark.parametrize("seeds", [(0, 1), (1, 2)])
def test_diff_runs_training_equals_jax(tmp_path, seeds):
    a = _write_run(tmp_path / "a", _train_records(seeds[0]),
                   _cfg(), git_sha="aaa", device_kind="NVIDIA H100")
    b = _write_run(tmp_path / "b", _train_records(seeds[1], data_wait=1.5),
                   _cfg(batch_size=256, metrics_dir="/runs/y",
                        config="auto", train_dir="/ckpt"),
                   git_sha="bbb", device_kind="NVIDIA H100")
    got = metrics.diff_runs(a, b)
    want = jax_metrics.diff_runs(a, b)
    assert _norm(got) == want
    text = "\n".join(got)
    assert "config: batch_size: 128 -> 256" in text
    assert "config: metrics_dir" not in text        # a path: presence only
    assert "config: train_dir: None -> '/ckpt'" in text
    assert "env: git_sha: aaa -> bbb" in text
    assert "ledger phases (wall s):" in text and "data_wait frac" in text
    assert "trace buckets (device us):" in text and "peak HBM MiB" in text


def test_diff_runs_serving_equals_jax(tmp_path):
    sa, sb = _stream(0), _stream(1)
    sb = [dict(r, e2e_ms=r["e2e_ms"] * 1.3) if r["kind"] == "request"
          else r for r in sb]
    cfg = _cfg(model="llama_tiny")
    a = _write_run(tmp_path / "a", sa, cfg)
    b = _write_run(tmp_path / "b", sb, dict(cfg, max_in_flight=8))
    got = metrics.diff_runs(a, b)
    assert _norm(got) == jax_metrics.diff_runs(a, b)
    text = "\n".join(got)
    assert "serve metrics:" in text and "tail attribution" in text
    assert "kv pool (written/reserved page-seconds):" in text


def test_diff_helpers_equal_jax():
    rng = np.random.default_rng(4)
    for _ in range(4):
        a = {k: float(rng.uniform(0, 1e4)) for k in ("compute", "copy")
             if rng.uniform() < 0.8}
        b = {k: float(rng.uniform(0, 1e4)) for k in ("compute", "idle")}
        assert trace.diff_buckets(a, b, "x", "y") == \
            jax_trace.diff_buckets(a, b, "x", "y")
    for rec in ({"kv_peak_pages": 7}, {"kv_peak_pages": 0}, {}):
        assert fleet.heartbeat_kv_peak(rec) == \
            jax_fleet.heartbeat_kv_peak(rec)
    for name in signals.KNOWN_SIGNALS:
        assert signals.advice_for(name) == jax_signals.advice_for(name)
    with pytest.raises(ValueError, match="unknown signal"):
        signals.advice_for("OVERLOAD")
    events = signals.evaluate_records(_train_records(0, data_wait=6.0))
    assert signals.fired_count(events, "DATA_STARVED") == \
        jax_signals.fired_count(events, "DATA_STARVED") == 1
    assert metrics.manifest_subset({"git_sha": "s", "x": 1}) == {
        k: ("s" if k == "git_sha" else None)
        for k in metrics.MANIFEST_IDENTITY_KEYS}


def test_cli_diff_exit_codes(tmp_path, capsys):
    a = _write_run(tmp_path / "a", _train_records(0), _cfg())
    b = _write_run(tmp_path / "b", _train_records(1), _cfg())
    assert obs_main(["diff", a, b]) == 0
    assert "total ex/s" in capsys.readouterr().out
    assert obs_main(["diff", a, str(tmp_path / "nothing")]) == 2
    (tmp_path / "b" / "manifest.json").unlink()
    assert obs_main(["diff", a, b]) == jax_obs_main(["diff", a, b]) == 1


# --- watch -------------------------------------------------------------------


def test_watch_render_equals_jax(tmp_path):
    fired = signals.evaluate_records(_train_records(0, data_wait=6.0))
    run = _write_run(tmp_path / "t", _train_records(0), _cfg(),
                     beats=True, signal_events=fired)
    man, recs = metrics.read_run(run)
    got = watch.render(run, man, recs)
    assert _norm(got) == jax_watch.render(run, man, recs)
    text = "\n".join(got)
    assert "step 10/10" in text and "DONE: total" in text
    assert "rank0: ALIVE" in text and "signals: DATA_STARVED@t=" in text
    serve = _write_run(tmp_path / "s", _stream(3), _cfg(model="llama_tiny"))
    man, recs = metrics.read_run(serve)
    assert _norm(watch.render(serve, man, recs)) == \
        jax_watch.render(serve, man, recs)
    # a run in flight: the heartbeat line stands in for the window
    live = _write_run(tmp_path / "l", _train_records(1, done=False)[:3],
                      _cfg(), beats=True)
    man, recs = metrics.read_run(live)
    got = watch.render(live, man, recs)
    assert _norm(got) == jax_watch.render(live, man, recs)
    assert any("(heartbeat)" in ln for ln in got)


def test_cli_watch_exit_codes(tmp_path):
    done = _write_run(tmp_path / "d", _train_records(0), _cfg())
    out = io.StringIO()
    assert obs_main(["watch", done, "--interval", "0.05"], out=out) == 0
    assert "DONE: total" in out.getvalue()
    live = _write_run(tmp_path / "l", _train_records(0, done=False),
                      _cfg())
    out = io.StringIO()
    assert obs_main(["watch", live, "--interval", "0.05",
                     "--timeout", "0.2"], out=out) == 1
    assert "watch: timeout waiting for run to complete" in out.getvalue()
    out = io.StringIO()
    assert obs_main(["watch", live, "--no-follow"], out=out) == 0
    assert obs_main(["watch", str(tmp_path / "none")]) == 2


# --- regress -----------------------------------------------------------------


def _bench(rng, value: float, **extra) -> dict:
    rec = {"metric": "gpt2_train_examples_per_sec", "unit": "examples/sec",
           "value": value,
           "extra": {"global_batch": 128, "chips": 1, "dtype": "bfloat16",
                     "variable_update": "psum",
                     "goodput": float(rng.uniform(0.80, 0.82)),
                     "peak_hbm_bytes": int(rng.integers(17 << 30,
                                                        (17 << 30) + 2**24)),
                     **extra},
           "manifest": {"device_kind": "NVIDIA H100 80GB HBM3",
                        "process_count": 1}}
    return rec


def _history(tmp_path, n: int = 6) -> list[str]:
    rng = np.random.default_rng(5)
    paths = []
    for i in range(n):
        p = tmp_path / f"BENCH_r{i:02d}.json"
        rec = _bench(rng, float(rng.uniform(185.0, 188.0)))
        # the harness's wrapper for half of them
        p.write_text(json.dumps({"parsed": rec} if i % 2 else rec))
        paths.append(str(p))
    # a TPU record: another fingerprint, never gated against
    tpu = _bench(rng, 900.0)
    tpu["manifest"]["device_kind"] = "TPU v5 lite"
    (tmp_path / "BENCH_tpu.json").write_text(json.dumps(tpu))
    return paths + [str(tmp_path / "BENCH_tpu.json")]


@pytest.mark.parametrize("value,want_rc", [(186.4, 0), (150.0, 1)])
def test_regress_equals_jax(tmp_path, value, want_rc):
    hist = _history(tmp_path)
    fresh = _bench(np.random.default_rng(9), value)
    history = [rec for _, rec in regress.load_history(hist)]
    assert history == [rec for _, rec in jax_regress.load_history(hist)]
    got = regress.regress_check(fresh, history)
    assert got == jax_regress.regress_check(fresh, history)
    assert got["history_n"] == 6              # the TPU record left out
    for kw in ({}, {"mad_k": 2.0, "rel_floor": 0.01}):
        out, ref = io.StringIO(), io.StringIO()
        assert regress.run_regress(fresh, hist, out=out, **kw) == \
            jax_regress.run_regress(fresh, hist, out=ref, **kw) == want_rc
        assert out.getvalue() == ref.getvalue()
    path = tmp_path / "fresh.json"
    path.write_text(json.dumps(fresh))
    out = io.StringIO()
    assert obs_main(["regress", str(path), "--history", *hist],
                    out=out) == want_rc
    assert ("FAIL" in out.getvalue()) == bool(want_rc)


def test_regress_no_history_and_unusable(tmp_path):
    hist = _history(tmp_path)
    other = _bench(np.random.default_rng(2), 10.0)
    other["extra"]["global_batch"] = 4
    out = io.StringIO()
    assert regress.run_regress(other, hist, out=out) == 0
    assert "no history for fingerprint" in out.getvalue()
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert obs_main(["regress", str(bad), "--history", *hist]) == 2
    assert jax_obs_main(["regress", str(bad), "--history", *hist]) == 2
    tail = tmp_path / "tail.json"
    tail.write_text(json.dumps({"tail": "log line\n" + json.dumps(other)}))
    assert regress.load_bench_record(str(tail)) == \
        jax_regress.load_bench_record(str(tail)) == other


# --- DATA_STARVED ----------------------------------------------------------


@pytest.mark.parametrize("data_wait,fires", [(6.0, True), (0.5, False)])
def test_data_starved_equals_jax(tmp_path, data_wait, fires):
    recs = _train_records(0, data_wait=data_wait)
    run = _write_run(tmp_path / "r", recs, _cfg())
    for window_s in (None, 2.0):
        got = signals.evaluate_records(recs, run_dir=run, window_s=window_s)
        want = jax_signals.evaluate_records(recs, run_dir=run,
                                            window_s=window_s)
        assert got == want
        assert [(e["signal"], e["state"], e["measure"], e["cause"])
                for e in got] == [(e["signal"], e["state"], e["measure"],
                                   e["cause"]) for e in want]
    starved = [(e["signal"], e["state"]) for e in got]
    assert starved == ([("DATA_STARVED", "fire")] if fires else [])
    if fires:
        assert got[0]["cause"] == {"data_wait_s": 6.0, "wall_s": 10.0}
        assert got[0]["measure"] == pytest.approx(0.6)
    out = io.StringIO()
    assert obs_main(["signals", run], out=out) == (1 if fires else 0)
    assert ("DATA_STARVED" in out.getvalue()) == fires


def test_data_starved_needs_the_ledger(tmp_path):
    recs = [r for r in _train_records(0, data_wait=6.0)
            if r["kind"] not in ("phase", "phase_acc")]
    run = _write_run(tmp_path / "r", recs, _cfg(), beats=True)
    got = signals.evaluate_records(recs, run_dir=run)
    assert got == jax_signals.evaluate_records(recs, run_dir=run)
    assert signals.fired_count(got, "DATA_STARVED") == 0
