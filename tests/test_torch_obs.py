"""The port's ``obs`` modules against the JAX package's, on the CPU.

The port keeps its own copies of JAX's pure record processing
(``obs/sketch.py``, ``requests.py``, ``kv.py``, ``signals.py``,
``timeline.py``, ``fleet.py``, ``serve/slo.py``) and writes JAX's
on-disk formats.  Each fold here runs on the same seeded records
through both packages and must agree exactly (``==`` on floats: the
folds are the same arithmetic in the same order):

- **sketch**: quantiles, merges, collapse, records and histograms;
- **percentiles**: ``fold_requests`` bit for bit, on 37 gamma-distributed
  records (seed 0: where the exact ``np.percentile`` the port used to
  fold differs from JAX's sketch by up to 3 %), an empty list and more;
- **requests, kv**: components, attribution, bucket utilization, the
  wait-cause and ledger folds, their lines and timeline events;
- **slo**: the stream folds, window sketches, burn and serve lines;
- **signals**: the hysteresis engine's events and lines on seeded
  measure sequences, and the offline evaluator on a record stream;
- **budget**: ``--hbm_budget``'s parser over a table of specs;
- **writers**: ``MetricsWriter``, ``FleetWriter`` and the span recorder
  leave files the JAX readers parse the same way as the port's.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from tpu_hc_bench.obs import fleet as jax_fleet
from tpu_hc_bench.obs import kv as jax_kv
from tpu_hc_bench.obs import memory as jax_memory
from tpu_hc_bench.obs import metrics as jax_metrics
from tpu_hc_bench.obs import requests as jax_requests
from tpu_hc_bench.obs import signals as jax_signals
from tpu_hc_bench.obs import sketch as jax_sketch
from tpu_hc_bench.obs import timeline as jax_timeline
from tpu_hc_bench.resilience import retry as jax_retry
from tpu_hc_bench.serve import slo as jax_slo
from tpu_hc_bench_torch.obs import fleet, kv, memory, metrics, requests
from tpu_hc_bench_torch.obs import signals, sketch, timeline
from tpu_hc_bench_torch.resilience import retry
from tpu_hc_bench_torch.serve import slo
from torch_threads import cpu_share, jax_private_cache  # noqa: F401


def _records(n: int, seed: int, *, causes: bool = True,
             footprints: bool = True) -> list[dict]:
    """``n`` request records as the engines write them, from a numpy
    seed: gamma latencies, conserved components, cause splits and KV
    footprints."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        arrival = round(float(rng.uniform(0.0, 2.0)), 6)
        queue, prefill = rng.gamma(2.0, 20.0), rng.gamma(2.0, 5.0)
        active, retire = rng.gamma(2.0, 30.0), rng.uniform(0.0, 0.5)
        t_admit = arrival + queue / 1e3
        t_first = t_admit + prefill / 1e3
        t_last = t_first + (active + rng.gamma(1.0, 10.0)) / 1e3
        t_done = t_last + retire / 1e3
        rec = {"kind": "request", "id": i, "status": "ok",
               "arrival_s": arrival,
               "ttft_ms": round(1e3 * (t_first - arrival), 3),
               "e2e_ms": round(1e3 * (t_done - arrival), 3),
               "prompt_len": int(rng.integers(1, 64)),
               "output_len": int(rng.integers(1, 32))}
        rec.update(requests.components_ms(arrival, t_admit, t_first,
                                          t_last, t_done, active / 1e3))
        if causes:
            split = rng.uniform(0.0, 1.0)
            rec["queue_pool_starved_ms"] = round(rec["queue_ms"] * split, 3)
            rec["queue_batch_full_ms"] = round(
                rec["queue_ms"] * (1 - split), 3)
        if footprints:
            res = int(rng.integers(2, 9))
            fin = int(rng.integers(1, res + 1))
            rec.update(pages_reserved=res, pages_peak_used=fin,
                       pages_final=fin, pages_grown=int(rng.integers(0, 2)),
                       prefix_pages_shared=int(rng.integers(0, 2)))
        out.append(rec)
    return out


# --- sketch ----------------------------------------------------------------


@pytest.mark.parametrize("n,seed,scale", [
    (1, 0, 1.0), (37, 0, 100.0), (500, 1, 0.01), (2000, 2, 1e4)])
def test_sketch_quantiles_and_records_equal_jax(n, seed, scale):
    vals = np.random.default_rng(seed).gamma(2.0, scale, n)
    vals[: n // 10] = 0.0                       # the exact zero bucket
    mine, ref = sketch.sketch_of(vals), jax_sketch.sketch_of(vals)
    for q in (0, 1, 25, 50, 90, 95, 99, 99.9, 100):
        assert mine.quantile(q) == ref.quantile(q)
    assert mine.to_record() == ref.to_record()
    assert mine.mean() == ref.mean()


def test_sketch_merge_collapse_and_histograms_equal_jax():
    rng = np.random.default_rng(3)
    parts = [rng.lognormal(0.0, 3.0, 300) for _ in range(3)]
    for mod in (sketch, jax_sketch):
        assert mod.merge_records([]) is None
    got = sketch.merge_records(
        [sketch.sketch_of(p).to_record() for p in parts] + ["junk"])
    want = jax_sketch.merge_records(
        [jax_sketch.sketch_of(p).to_record() for p in parts])
    assert got.to_record() == want.to_record()
    whole = sketch.sketch_of(np.concatenate(parts))
    assert (got.buckets, got.count, got.vmin, got.vmax) == \
        (whole.buckets, whole.count, whole.vmin, whole.vmax)
    small = sketch.QuantileSketch(max_buckets=8)
    ref = jax_sketch.QuantileSketch(max_buckets=8)
    for v in parts[0]:
        small.add(v)
        ref.add(v)
    assert len(small.buckets) == 8 and small.to_record() == ref.to_record()
    counts = rng.integers(0, 5, 40)
    assert sketch.QuantileSketch.from_counts(counts).to_record() == \
        jax_sketch.QuantileSketch.from_counts(counts).to_record()
    with pytest.raises(ValueError, match="different alpha"):
        sketch.QuantileSketch(0.01).merge(sketch.QuantileSketch(0.02))


# --- percentiles: the repaired fold ----------------------------------------


@pytest.mark.parametrize("n,seed", [(0, 0), (1, 0), (2, 5), (37, 0),
                                    (100, 1), (1000, 2)])
def test_fold_requests_equals_jax_bit_for_bit(n, seed):
    recs = _records(n, seed)
    got = slo.fold_requests(recs)
    assert got == jax_slo.fold_requests(recs)
    assert sorted(got) == sorted(f"p{q}_{f}" for q in (50, 95, 99)
                                 for f in slo.LATENCY_FIELDS)
    if n == 37:
        # the fold the port used before: exact percentiles, off JAX's
        exact = {f"p{q}_{f}": round(float(np.percentile(
            [r[f] for r in recs], q)), 3)
            for q in (50, 95, 99) for f in slo.LATENCY_FIELDS}
        assert any(exact[k] != got[k] for k in got)


def test_fold_requests_gamma_37_matches_jax_where_exact_differs():
    """The case of the repair: 37 records of gamma latencies (seed 0)."""
    rng = np.random.default_rng(0)
    recs = [{"ttft_ms": float(a), "e2e_ms": float(b), "queue_ms": float(c)}
            for a, b, c in rng.gamma(2.0, 40.0, (37, 3))]
    got = slo.fold_requests(recs)
    assert got == jax_slo.fold_requests(recs)
    e2e = [r["e2e_ms"] for r in recs]
    assert got["p99_e2e_ms"] != round(float(np.percentile(e2e, 99)), 3)
    assert slo.fold_requests([]) == jax_slo.fold_requests([]) == {
        f"p{q}_{f}": 0.0 for f in slo.LATENCY_FIELDS for q in (50, 95, 99)}


# --- requests and kv folds -------------------------------------------------


def test_components_ms_equal_jax():
    rng = np.random.default_rng(4)
    for _ in range(200):
        a, b, c, d, e = np.sort(rng.uniform(0.0, 3.0, 5))
        active = rng.uniform(0.0, d - c + 1e-3)
        args = (a, b, c, d, e, active)
        got = requests.components_ms(*args)
        assert got == jax_requests.components_ms(*args)
        assert abs(sum(got.values()) - round(1e3 * (e - a), 3)) < 1e-6


@pytest.mark.parametrize("n,seed", [(1, 1), (10, 2), (37, 0), (300, 3)])
def test_attribution_and_bucket_util_equal_jax(n, seed):
    recs = _records(n, seed)
    got = requests.fold_attribution(recs)
    assert got == jax_requests.fold_attribution(recs)
    assert requests.flatten_attribution(got) == \
        jax_requests.flatten_attribution(got)
    assert requests.attribution_lines(got, p99_e2e_ms=123.4) == \
        jax_requests.attribution_lines(got, p99_e2e_ms=123.4)
    bare = [{k: v for k, v in r.items() if k in ("e2e_ms", "queue_ms")}
            for r in recs]
    assert requests.attribution_lines(requests.fold_attribution(bare)) == \
        jax_requests.attribution_lines(jax_requests.fold_attribution(bare))
    util = {f"decode@{b}": {"steps": b * 3, "rows": b * 9,
                            "active_rows": b * 7, "wall_s": 0.5 * b}
            for b in (1, 2, 4)}
    util["prefill@16"] = {"steps": 4, "rows": 64, "active_rows": 40,
                          "wall_s": 0.1, "occupancy": 0.625}
    assert requests.bucket_util_lines(util) == \
        jax_requests.bucket_util_lines(util)
    clock = [{"kind": "serve_clock", "t_unix": 1.7e9}]
    assert requests.request_trace_events(clock + recs) == \
        jax_requests.request_trace_events(clock + recs)
    assert requests.request_trace_events(recs) == []
    assert requests.fold_attribution([]) is None


@pytest.mark.parametrize("n,seed", [(1, 5), (37, 0), (200, 6)])
def test_kv_folds_and_lines_equal_jax(n, seed):
    recs = _records(n, seed)
    for r in recs[:3]:
        assert kv.wait_cause_of(r) == jax_kv.wait_cause_of(r)
        assert kv.footprint_of(r) == jax_kv.footprint_of(r)
    assert kv.fold_wait_causes(recs) == jax_kv.fold_wait_causes(recs)
    ledger = dict(reserved_page_s=12.5, written_page_s=7.25,
                  pages_peak=31, pages_recycled=9, pages_grown=4,
                  cow_copies=2, prefix_hits=3, prefix_lookups=8,
                  prefix_pages_shared=5, request_records=recs)
    got = kv.fold_ledger(**ledger)
    assert got == jax_kv.fold_ledger(**ledger)
    assert kv.flatten_kv(got) == jax_kv.flatten_kv(got)
    pools = [{"kind": "kv_pool", "t": 0.1 * i, "pages_reserved": 10 + i,
              "pages_written": 5 + i, "free_pages": 20 - i,
              "pages_peak": 15, "pages_recycled": i,
              "reserved_page_s": 1.0 * i, "written_page_s": 0.5 * i,
              "pages_grown": i, "pages_cow": 1, "prefix_hits": i,
              "prefix_lookups": 2 * i, "prefix_pages_shared": i}
             for i in range(4)]
    stream = [{"kind": "serve_clock", "t_unix": 1.7e9}] + recs + pools
    assert kv.fold_kv(stream) == jax_kv.fold_kv(stream)
    fold = {"kv_pool": kv.fold_kv(stream), "kv_pages": 33,
            "kv_page_size": 16, "kv_layers": 16, "kv_pool_bytes": 2**27,
            "kv_scale_bytes": 4096}
    assert kv.kv_lines(fold) == jax_kv.kv_lines(fold)
    assert kv.kv_counter_events(stream) == jax_kv.kv_counter_events(stream)
    assert kv.fold_kv([]) is None and jax_kv.fold_kv([]) is None


# --- slo: stream folds and lines -------------------------------------------


def _stream(seed: int) -> list[dict]:
    """A serve stream: requests, periodic serve/kv_pool records, window
    sketches and the summary, as the engines write them."""
    recs = _records(48, seed)
    stream: list[dict] = [{"kind": "serve_clock", "t_unix": 1.7e9,
                           "t_mono": 5.0, "batching": "continuous"}]
    win = []
    for i, r in enumerate(recs):
        stream.append(r)
        win.append(r)
        if i % 16 == 15:
            stream.append({"kind": "serve", "t": 0.1 * i, "queue_depth": i,
                           "in_flight": 4, "free_pages": 12, "tokens": 9 * i,
                           "bucket_occ": {"decode@4": 0.75},
                           "decode_steps": i, "prefill_steps": i,
                           "classify_steps": 0})
            stream.append({"kind": "kv_pool", "t": 0.1 * i,
                           "pages_reserved": 20, "pages_written": 11,
                           "free_pages": 12, "pages_peak": 24,
                           "pages_recycled": i, "reserved_page_s": 0.2 * i,
                           "written_page_s": 0.1 * i})
            stream.append({"kind": "latency_sketch", "t": 0.1 * i,
                           "window": i // 16, "fields": {
                               f: sketch.sketch_of(
                                   [w[f] for w in win]).to_record()
                               for f in slo.LATENCY_FIELDS}})
            win = []
    summary = {"kind": "serve_summary", "workload": "serve",
               "model": "llama_tiny", "batching": "continuous",
               "arrival": "poisson", "arrival_rate": 8.0, "requests": 50,
               "completed": 48, "wall_s": 6.5, "tokens": 512,
               "tokens_per_s": 78.8, "goodput": 0.61,
               "queue_depth_max": 9, "queue_depth_mean": 3.2,
               "buckets": [1, 2, 4], "max_in_flight": 4, "kv_page_size": 16,
               "kv_pages": 25, "kv_layers": 4, "kv_pool_bytes": 2**20,
               "kv_scale_bytes": 0, "decode_attention": "paged",
               "quant": "off", "decode_block_pages": 1,
               "slo": {"slo_e2e_ms": 150.0},
               "degrade": {"shed": {"deadline_expired": 1,
                                    "deadline_predicted": 1},
                           "shed_frac": 0.04, "preempts": 2,
                           "requeues": 2, "quarantined": 1},
               "bucket_util": {"decode@4": {"steps": 30, "rows": 120,
                                            "active_rows": 90,
                                            "wall_s": 0.3}}}
    stream.append(summary)
    stream.append({"kind": "serve_compile", "buckets": 6, "warm": True})
    return stream


@pytest.mark.parametrize("seed", [0, 1])
def test_slo_folds_and_lines_equal_jax(seed):
    stream = _stream(seed)
    got = slo.fold_serve_records(stream)
    want = jax_slo.fold_serve_records(stream)
    want.pop("post_warmup_compiles")    # JAX's compile key (None here)
    assert got == want
    assert slo.fold_window_sketches(stream) == \
        jax_slo.fold_window_sketches(stream)
    assert slo.slo_lines(got) == jax_slo.slo_lines(got)
    assert slo.burn_lines(got["slo"]) == jax_slo.burn_lines(got["slo"])
    assert slo.watch_lines(stream) == jax_slo.watch_lines(stream)
    assert slo.fold_serve_records([{"kind": "window"}]) is None
    recs = [r for r in stream if r["kind"] == "request"]
    for w in (None, 0.25):
        assert slo.fold_burn_rate(recs, 90.0, w) == \
            jax_slo.fold_burn_rate(recs, 90.0, w)


# --- signals ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_signal_engine_events_equal_jax(seed):
    rng = np.random.default_rng(seed)
    mine, ref = signals.SignalEngine(), jax_signals.SignalEngine()
    for i in range(60):
        measures = {name: (None if rng.uniform() < 0.15
                           else float(rng.uniform(0.0, 3.0 if name ==
                                                  "STRAGGLER" else 1.0)))
                    for name in signals.KNOWN_SIGNALS}
        causes = {name: {"window": i} for name in signals.KNOWN_SIGNALS}
        assert mine.observe(0.1 * i, measures, causes) == \
            ref.observe(0.1 * i, measures, causes)
    assert mine.events == ref.events and mine.fired == ref.fired
    assert mine.events
    assert signals.signal_lines(mine.events) == \
        jax_signals.signal_lines(ref.events)
    assert signals.fired_counts(mine.events) == \
        jax_signals.fired_counts(ref.events)
    assert signals.active_of(mine.events) == \
        jax_signals.active_of(ref.events)
    assert signals.signal_lines([]) == jax_signals.signal_lines([])
    with pytest.raises(ValueError, match="unknown signal"):
        signals.spec_of("OVERLOAD")


def test_offline_signal_evaluation_equals_jax(tmp_path):
    stream = _stream(2)
    slow = [dict(r, e2e_ms=r["e2e_ms"] * 4) for r in stream
            if r["kind"] == "request"]
    records = stream + slow
    assert signals.evaluate_records(records) == \
        jax_signals.evaluate_records(records)
    fired = signals.evaluate_records(records)
    assert any(ev["signal"] == "SUSTAINED_OVERLOAD" for ev in fired)
    run = tmp_path / "run"
    w = metrics.MetricsWriter(str(run), {"model": "llama_tiny"})
    for r in records:
        w.event(**r)
    w.close()
    signals.append_events(signals.signals_path(str(run)), fired[:1])
    got, want = signals.evaluate_run(str(run)), \
        jax_signals.evaluate_run(str(run))
    assert got["lines"] == want["lines"] and got["fired"] == want["fired"]
    assert signals.read_signals(str(run)) == fired[:1]


# --- --hbm_budget ------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    None, "", "off", "none", "0", "auto", "AUTO", "16GB", "16gib", "900MB",
    "1.5 GB", "17179869184", "2tb", "512kb", "7b", "abc", "-1GB", "0.0",
    "GB", "1e3mb"])
def test_hbm_budget_parser_equals_jax(spec):
    def parse(mod):
        try:
            return "ok", mod.parse_hbm_budget(spec)
        except ValueError as e:
            return "error", str(e)

    assert parse(memory) == parse(jax_memory)


def test_budget_lines_without_a_report_warn_and_resolve_off_card():
    import torch

    cpu = torch.device("cpu")
    assert memory.resolve_hbm_budget_bytes(None, cpu) == (None, None)
    assert memory.resolve_hbm_budget_bytes(2**30, cpu) == (2**30, None)
    budget, note = memory.resolve_hbm_budget_bytes("auto", cpu)
    assert budget is None and "budget check skipped" in note
    assert memory.budget_lines(None, None, note) == [f"WARNING: {note}"]
    (line,) = memory.budget_lines(None, 2**30)
    assert line.startswith("WARNING: --hbm_budget: no memory report") and \
        "budget unchecked" in line
    (ok,) = memory.budget_lines({"total_bytes": 2**29}, 2**30)
    assert ok.startswith("hbm budget: measured peak 0.50 GiB") and \
        "(50%)" in ok
    (over,) = memory.budget_lines({"total_bytes": 2**31}, 2**30)
    assert "EXCEEDS" in over
    assert memory.device_memory_sample(cpu)["bytes_limit"] is None
    assert memory.ladder_report(cpu, [("decode", lambda: None)]) is None


# --- writers and readers ---------------------------------------------------


def test_metrics_writer_and_readers_round_trip(tmp_path):
    run = tmp_path / "run"
    w = metrics.MetricsWriter(str(run), {"model": "llama_tiny"})
    assert w.enabled and w.out_dir == str(run)
    w.event("request", id=1, e2e_ms=3.5)
    w.update_manifest({"kernel_library": "loaded"})
    w.event("serve_summary", completed=1)
    assert w.last_record == {"kind": "serve_summary", "completed": 1}
    w.close()
    w.close()
    with open(run / metrics.METRICS_NAME, "a") as f:
        f.write('{"kind": "req')              # a torn last line
    for mod in (metrics, jax_metrics):
        problems: list[str] = []
        man, recs = mod.read_run(str(run), problems=problems)
        assert man == {"model": "llama_tiny", "kernel_library": "loaded"}
        assert [r["kind"] for r in recs] == ["request", "serve_summary"]
        assert len(problems) == 1 and "corrupt" in problems[0]
        assert mod.read_jsonl(str(run / metrics.METRICS_NAME)) == recs
    assert metrics.resolve_run(str(run)) == jax_metrics.resolve_run(str(run))
    with pytest.raises(FileNotFoundError):
        metrics.resolve_run(str(tmp_path / "nothing"))
    off = metrics.MetricsWriter(None)
    off.event("request", id=2)
    assert not off.enabled and off.out_dir is None
    assert not metrics.MetricsWriter(str(tmp_path / "x"),
                                     primary=False).enabled


def test_retry_io_equals_jax():
    for mod in (retry, jax_retry):
        calls, notes = [], []

        class Tap:
            def event(self, kind, **fields):
                notes.append(kind)

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "done"

        assert mod.retry_io(flaky, "w", attempts=3, base_delay_s=0.0,
                            obs_writer=Tap()) == "done"
        assert len(calls) == 3 and notes == ["io_retry", "io_retry"]
        with pytest.raises(OSError):
            mod.retry_io(lambda: (_ for _ in ()).throw(OSError("x")), "w",
                         attempts=2, base_delay_s=0.0)
        with pytest.raises(ValueError):
            mod.retry_io(flaky, "w", attempts=0)


def test_fleet_heartbeats_read_by_both_packages(tmp_path):
    run = str(tmp_path)
    for life in range(2):
        f = fleet.FleetWriter(run, process_index=0)
        assert f.enabled and f.incarnation == life
        f.heartbeat(step=16 * (life + 1), step_ewma_ms=3.5,
                    kv_peak_pages=7, phase="serve")
        f.close()
    g = fleet.FleetWriter(run, process_index=1)
    g.heartbeat(step=4, step_ewma_ms=9.0)
    g.close()
    assert not fleet.FleetWriter(None, process_index=0).enabled
    beats = fleet.read_heartbeats(run)
    assert beats == jax_fleet.read_heartbeats(run)
    assert fleet.latest_heartbeats(run) == jax_fleet.latest_heartbeats(run)
    assert [r["incarnation"] for r in beats[0]] == [0, 1]
    assert beats[0][-1]["kv_peak_pages"] == 7
    now = beats[0][-1]["t_unix"]
    for dt in (0.0, 20.0, 100.0):
        for inc in (None, 1, 2):
            assert fleet.classify_liveness(beats[0], now + dt,
                                           expect_incarnation=inc) == \
                jax_fleet.classify_liveness(beats[0], now + dt,
                                            expect_incarnation=inc)
    assert fleet.straggler_lines(run, []) == \
        jax_fleet.straggler_lines(run, [])
    assert fleet.compute_skew([4, 32], [9.0, 3.5]) == \
        jax_fleet.compute_skew([4, 32], [9.0, 3.5])


def test_span_recorder_ring_flush_and_dump(tmp_path):
    rec = timeline.SpanRecorder(capacity=4)
    rec.attach(str(tmp_path))
    for i in range(6):
        rec.record("decode", float(i), float(i) + 0.5, step=i)
    assert rec.flush() == 4 and rec.dropped == 2
    rec.instant("admit", rid=3)
    with rec.span("prefill"):
        pass
    rec.detach()
    spans = timeline.read_spans(str(tmp_path))[0]
    assert spans == jax_timeline.read_spans(str(tmp_path))[0]
    assert [s["name"] for s in spans] == ["decode"] * 4 + ["admit",
                                                          "prefill"]
    assert spans[4]["rid"] == 3 and spans[0]["step"] == 2
    assert timeline.KNOWN_SPANS == jax_timeline.KNOWN_SPANS
    timeline.configure(enabled=True, run_dir=None)
    timeline.instant("drain", queued=1)
    path = timeline.dump_timeline(str(tmp_path), "serve_drain", step=9)
    with open(path) as f:
        dump = json.load(f)
    assert dump["reason"] == "serve_drain" and dump["step"] == 9
    assert dump["ranks"]["0"][-1]["name"] == "drain"
    assert timeline.dump_timeline(None, "x") is None
    assert timeline.dump_timeline(str(tmp_path / "missing" / "x"),
                                  "x") is None
    # a new target gets the spans recorded while it is attached, not
    # the ring's older ones (JAX's recorder flushes those too)
    rec = timeline.SpanRecorder()
    rec.record("decode", 0.0, 1.0)
    rec.attach(str(tmp_path / "second"))
    rec.record("prefill", 1.0, 2.0)
    rec.detach()
    assert [s["name"] for s in timeline.read_spans(
        str(tmp_path / "second"))[0]] == ["prefill"]
    assert [s["name"] for s in rec.tail()] == ["decode", "prefill"]
    off = timeline.SpanRecorder()
    off.enabled = False
    off.record("decode", 0.0, 1.0)
    assert off.tail() == []
    lines = timeline.timeline_lines(str(tmp_path))
    assert lines[0].startswith("  timeline: 1 rank(s), 6 span(s)")
    assert any("timeline dump" in ln for ln in lines)
    assert os.path.basename(path) == timeline.TIMELINE_DUMP_NAME
