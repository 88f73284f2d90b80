"""The training lane's observability in the port against the JAX
package's, on the CPU.

- **goodput**: ``build_ledger`` and ``rewind_lost_steps`` on the same
  record sets (JAX's test cases): equal ledgers, field for field, and
  equal rendered lines; ``PhaseTracker`` emits the same records.
- **fleet**: ``StepEwma`` over one sample sequence, ``compute_skew``.
- **efficiency**: ``mfu_report`` and ``mfu_lines`` (the measured source
  label aside), ``load_fabric_ceiling`` on an OSU sweep export, the
  ceiling and busbw arithmetic, ``collective_overlap``; the FLOP probe
  on a matmul and a conv, where ``FlopCounterMode`` counts exactly.
- **memory**: ``grad_allreduce_bytes`` and the parameter and batch
  bytes of ``analytic_memory_table`` on ncf_tiny's weights carried over
  by ``convert.py``, against JAX's on the Flax tree; the ledger and its
  fold, ``memory_lines``.
- **trace**: ``tests/test_obs.py``'s perfetto fixture rewritten as
  Kineto events (kernels on GPU streams, ``ProfilerStep#k`` device
  annotations, a host ``cpu_op`` track): the port's ``summarize_trace``
  gives JAX's buckets, step for step, on the fixture whose step track
  tiles the window as the port's steps do (Kineto's annotation covers
  only its thread's kernels, so a step runs to the next one's start);
  without a step track, on the original; no device track raises; the
  port's classify rules.
- **summarize**: one hand-built training record set through both
  packages' ``summarize_run``: the same lines, the manifest's version
  line aside and the memory report's and budget line's words for what
  measured them (the first warmup step here, the AOT analysis in JAX).
- **the driver**: a CPU run with ``--trace_dir`` warns in one line and
  exits 0; obs on leaves the losses and the state bit-equal to obs off;
  ``obs summarize`` renders a training run.
Host-side folds are held exactly; no tolerance is needed anywhere but
``pytest.approx`` on sums of microseconds.
"""

from __future__ import annotations

import functools
import io
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_hc_bench import flags as jax_flags
from tpu_hc_bench.models import ncf as jax_ncf
from tpu_hc_bench.obs import efficiency as jax_eff
from tpu_hc_bench.obs import fleet as jax_fleet
from tpu_hc_bench.obs import goodput as jax_goodput
from tpu_hc_bench.obs import memory as jax_memory
from tpu_hc_bench.obs import metrics as jax_metrics
from tpu_hc_bench.obs import trace as jax_trace
from tpu_hc_bench.train import step as jax_step
from tpu_hc_bench_torch import convert, flags, launcher
from tpu_hc_bench_torch.models import ncf
from tpu_hc_bench_torch.obs import efficiency, fleet, goodput, memory
from tpu_hc_bench_torch.obs import metrics, trace
from tpu_hc_bench_torch.obs.__main__ import main as obs_main
from tpu_hc_bench_torch.train import driver
from tpu_hc_bench_torch.train import step as step_mod
from tpu_hc_bench_torch.utils import checkpoint as ckpt
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parent))
from conftest import ceiling_file  # noqa: E402
from test_obs import STEP0, STEP1, fixture_events  # noqa: E402


# --- goodput -----------------------------------------------------------------


def _phase(p, t, step=None):
    return {"kind": "phase", "phase": p, "t": t, "step": step}


LEDGER_CASES = [
    [_phase("init", 0.0), _phase("compile", 2.0), _phase("step", 4.0),
     {"kind": "phase_acc", "phase": "data_wait", "seconds": 0.5, "step": 8},
     _phase("checkpoint", 10.0, 8), _phase("step", 11.0, 8),
     _phase("end", 14.0, 10)],
    [],
    [_phase("init", 0.0)],
    [_phase("init", 0.0), _phase("step", 1.0),
     {"kind": "rewind", "step": 6, "restored_step": 3, "lost_steps": 4},
     {"kind": "nonfinite_skip", "step": 8, "new_bad": 2},
     _phase("end", 11.0, 10)],
    [_phase("init", 0.0), _phase("step", 1.0), _phase("checkpoint", 3.0, 2)],
    [_phase("init", 0.0), _phase("compile", 1.5), _phase("step", 3.0),
     _phase("rewind_replay", 5.0, 4), _phase("step", 5.25, 4),
     _phase("checkpoint_async", 7.0, 6), _phase("step", 7.1, 6),
     _phase("emergency_save", 9.0, 8), _phase("end", 9.6, 8),
     {"kind": "rewind", "step": 4, "lost_steps": 2}],
]


@pytest.mark.parametrize("case", range(len(LEDGER_CASES)))
def test_build_ledger_matches_jax(case):
    recs = LEDGER_CASES[case]
    for fold in (True, False):
        mine = goodput.build_ledger(recs, fold_resilience=fold)
        ref = jax_goodput.build_ledger(recs, fold_resilience=fold)
        if ref is None:
            assert mine is None
            continue
        assert vars(mine) == vars(ref)
        assert mine.goodput == ref.goodput
        assert mine.format_lines() == ref.format_lines()


@pytest.mark.parametrize("args", [(6, 3, 0, 1), (6, 103, 100, 1),
                                  (6, 100, 100, 1), (6, 100, 100, 50),
                                  (0, 5, 0, 1), (12, 9, 2, 3)])
def test_rewind_lost_steps_matches_jax(args):
    assert goodput.rewind_lost_steps(*args) == \
        jax_goodput.rewind_lost_steps(*args)


class _Sink:
    def __init__(self):
        self.records = []

    def event(self, kind, **fields):
        self.records.append({"kind": kind, **fields})


def test_phase_tracker_matches_jax(monkeypatch):
    clock = iter(float(t) for t in range(100))
    for mod in (goodput, jax_goodput):
        monkeypatch.setattr(mod.time, "monotonic", lambda: next(clock))
    out = []
    for mod in (goodput, jax_goodput):
        clock = iter(float(t) for t in range(100))
        sink = _Sink()
        pt = mod.PhaseTracker(sink)
        pt.enter("compile")
        pt.enter("step", step=0)
        pt.note_data_wait(0.25)
        pt.note_data_wait(0.5)
        pt.flush(4)
        pt.note_skipped_updates(1)
        pt.note_lost_steps(2)
        pt.end(step=8)
        out.append((sink.records, vars(pt.ledger())))
    assert out[0] == out[1]


# --- fleet ---------------------------------------------------------------------


def test_step_ewma_and_skew_match_jax():
    mine, ref = fleet.StepEwma(), jax_fleet.StepEwma()
    for step, t in ((0, 0.0), (16, 1.6), (32, 3.0), (32, 3.5), (48, 6.1),
                    (64, 6.9)):
        assert mine.update(step, now=t) == ref.update(step, now=t)
    for steps, ewmas in (([5], [2.0]), ([10, 12, 9, 10], [1.0, 2.0, 3.0,
                                                           4.0]),
                         ([3, 3, 3], [])):
        assert fleet.compute_skew(steps, ewmas) == \
            jax_fleet.compute_skew(steps, ewmas)
    assert fleet.straggler_gather(7, 3.5) == jax_fleet.compute_skew(
        [7], [3.5])


# --- efficiency -----------------------------------------------------------------


@pytest.mark.parametrize("args", [
    (None, 1e12, 0.1, 1e15), (1.2e12, 1e12, 0.1, 1e15),
    (1.05e12, 1e12, 0.1, 1e15), (1e12, 0.0, 0.1, 1e15),
    (1e12, 1e12, 0.0, 1e15)])
def test_mfu_report_and_lines_match_jax(args):
    mine, ref = efficiency.mfu_report(*args), jax_eff.mfu_report(*args)
    if ref["mfu_source"] == "measured":
        assert mine["mfu_source"] == efficiency.MEASURED_SOURCE
        mine = dict(mine, mfu_source="measured")
    assert mine == ref
    assert efficiency.mfu_lines(mine) == jax_eff.mfu_lines(ref)


def test_fabric_ceiling_and_its_arithmetic_match_jax(tmp_path):
    path = ceiling_file(tmp_path)
    mine = efficiency.load_fabric_ceiling(path)
    assert mine == jax_eff.load_fabric_ceiling(path)
    for bad, err in ((str(tmp_path / "nope.json"), FileNotFoundError),
                     (str(tmp_path / "bad.json"), ValueError)):
        (tmp_path / "bad.json").write_text("{}")
        with pytest.raises(err) as a:
            efficiency.load_fabric_ceiling(bad)
        with pytest.raises(err) as b:
            jax_eff.load_fabric_ceiling(bad)
        assert str(a.value).replace("tpu_hc_bench_torch", "tpu_hc_bench") \
            == str(b.value)
    summary = {"mean_step_ms": 100.0, "total_workers": 8,
               "allreduce_bytes_per_step": 100 * 10**6}
    traces = [None,
              {"buckets": {"compute": 70.0, "collective": 30.0},
               "steps": 2, "collective_ops": {"allreduce": 30.0}},
              {"buckets": {"compute": 70.0, "collective": 30.0},
               "collective_ops": {"reduce_scatter": 18.0,
                                  "all_gather": 12.0}},
              {"buckets": {"compute": 70.0, "collective": 0.0}},
              {"buckets": {"compute": 70.0, "collective": 30.0},
               "collective_ops": {"all_to_all": 30.0}}]
    for tr in traces:
        for s in (summary, dict(summary, total_workers=4),
                  dict(summary, total_workers=1), {}):
            assert efficiency.ceiling_utilization_lines(s, tr, mine) == \
                jax_eff.ceiling_utilization_lines(s, tr, mine)
            assert efficiency.collective_busbw_lines(s, tr) == \
                jax_eff.collective_busbw_lines(s, tr)
    assert "5.83 GB/s busbw = 58% of measured ceiling" in "\n".join(
        efficiency.ceiling_utilization_lines(
            summary, traces[1], {"world_size": 8, "ceilings": {
                "allreduce": {"busbw_gbps": 10.0,
                              "message_bytes": 1 << 20}}}))


@pytest.mark.parametrize("intervals", [
    [("fusion.backward", 0, 100), ("all-reduce.1", 100, 140)],
    [("fusion.backward", 0, 100), ("all-reduce.1", 70, 110)],
    [("fusion.fwd", 0.0, 10.0)],
    [("ncclDevKernel_AllReduce_Sum_f32", 5, 25), ("a", 0, 10),
     ("b", 20, 22), ("all-gather.3", 30, 31)]])
def test_collective_overlap_matches_jax(intervals):
    assert efficiency.collective_overlap(intervals) == \
        jax_eff.collective_overlap(
            [(n.replace("ncclDevKernel_AllReduce", "all-reduce"), s, e)
             for n, s, e in intervals])
    ops = {n: float(e - s) for n, s, e in intervals}
    jops = {n.replace("ncclDevKernel_AllReduce", "all-reduce"): v
            for n, v in ops.items()}
    assert efficiency.collective_kind_times(ops) == \
        jax_eff.collective_kind_times(jops)


def test_flop_probe_counts_matmuls_and_kernels():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    rec = efficiency.probe_step_flops(lambda: a @ b)
    assert rec == {"flops": 2.0 * 8 * 16 * 4, "aten_flops": 2.0 * 8 * 16 * 4,
                   "kernel_flops": 0.0}

    def with_kernel():
        efficiency.kernel_ops(1000)
        torch.nn.functional.conv2d(torch.randn(1, 3, 5, 5),
                                   torch.randn(2, 3, 3, 3))
    rec = efficiency.probe_step_flops(with_kernel)
    assert rec["kernel_flops"] == 1000.0
    assert rec["aten_flops"] == 2.0 * 3 * 3 * 3 * 2 * 3 * 3
    efficiency.kernel_ops(5)                # no probe running: nothing
    assert efficiency._KERNEL_OPS is None
    assert efficiency.attn_pairs(4, 4, True) == 10
    assert efficiency.attn_pairs(3, 5, False) == 15
    assert efficiency.attn_pairs(6, 4, True) == 10 + 2 * 4


# --- memory -----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ncf_params() -> dict:
    v = jax.tree_util.tree_map(np.asarray, jax_ncf.ncf_tiny().init(
        jax.random.PRNGKey(3), jnp.zeros((1, 2), jnp.int32)))
    return v["params"]


def test_memory_table_and_allreduce_bytes_match_jax():
    params = _ncf_params()
    port = ncf.ncf_tiny()
    port.load_state_dict(convert.ncf_params_from_flax(params))
    cfg = flags.BenchmarkConfig(model="ncf_tiny", device="cpu")
    state = step_mod.make_train_state(port, cfg)
    ids = torch.zeros((8, 2), dtype=torch.int64)
    labels = torch.zeros((8,), dtype=torch.int64)
    state, _ = step_mod.train_step(state, (ids, labels))   # momentum made
    tx = jax_step.make_optimizer(jax_flags.BenchmarkConfig())
    jstate = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
        opt_state=tx.init(params), apply_fn=jax_ncf.ncf_tiny().apply, tx=tx)
    jbatch = (np.zeros((8, 2), np.int32), np.zeros((8,), np.int32))
    want = jax_memory.analytic_memory_table(jstate, jbatch)
    got = memory.analytic_memory_table(
        state.model, state.optimizer,
        (ids.to(torch.int32), labels.to(torch.int32)))
    assert got == want
    for wire in ("f32", "bf16"):
        assert efficiency.grad_allreduce_bytes(
            list(state.model.parameters()), wire) == \
            jax_eff.grad_allreduce_bytes(params, wire)
    meas = {"argument_bytes": want["state_bytes"] * 2, "temp_bytes": 10,
            "total_bytes": 3 * want["state_bytes"]}
    for m in (None, meas, dict(meas, argument_bytes=want["state_bytes"])):
        rep = memory.memory_report(m, got)
        assert rep == jax_memory.memory_report(m, want)
    assert optax is not None


def test_memory_ledger_and_fold_match_jax():
    samples = iter([
        {"source": "torch.cuda", "bytes_in_use": 100, "peak_bytes": 150,
         "bytes_limit": 1000},
        {"source": "torch.cuda", "bytes_in_use": 300, "peak_bytes": 400,
         "bytes_limit": 1000},
        {"source": "torch.cuda", "bytes_in_use": 200, "peak_bytes": 400,
         "bytes_limit": 1000}])
    jsamples = iter([dict(s, source="memory_stats") for s in (
        {"bytes_in_use": 100, "peak_bytes": 150, "bytes_limit": 1000},
        {"bytes_in_use": 300, "peak_bytes": 400, "bytes_limit": 1000},
        {"bytes_in_use": 200, "peak_bytes": 400, "bytes_limit": 1000})])
    mine = memory.MemoryLedger(sample_fn=lambda: next(samples))
    ref = jax_memory.MemoryLedger(sample_fn=lambda: next(jsamples))
    recs, jrecs = [], []
    for phase, step in (("compile", None), ("step", 4), ("checkpoint", 8)):
        recs.append({"kind": "memory", **mine.sample(phase, step)})
        jrecs.append({"kind": "memory", **ref.sample(phase, step)})
    fold, jfold = mine.fold(), ref.fold()
    assert dict(fold, source=None) == dict(jfold, source=None)
    assert memory.fold_memory_records(recs)["per_phase"] == \
        jax_memory.fold_memory_records(jrecs)["per_phase"]
    assert [ln.replace("torch.cuda", "memory_stats")
            for ln in memory.memory_lines(fold)] == \
        jax_memory.memory_lines(jfold)
    assert memory.fold_memory_records([]) is None
    assert memory.MemoryLedger(torch.device("cpu")).sample("step")[
        "bytes_in_use"] is None


# --- trace -----------------------------------------------------------------------


def kineto_events(with_steps: bool = True) -> list[dict]:
    """``tests/test_obs.py``'s fixture as Kineto writes a trace: device
    work as ``kernel`` events on GPU 0's streams (pid 0, tids 1 and 2),
    the host on a ``cpu_op`` track, and the steps as ``ProfilerStep#k``
    annotations mirrored onto the device (``gpu_user_annotation``)."""
    out = [{"ph": "M", "pid": 0, "name": "process_name",
            "args": {"name": "GPU 0"}}]
    for e in fixture_events(with_step_track=False):
        if e.get("ph") != "X":
            continue
        if e["pid"] == 100:
            out.append({**e, "pid": 0, "cat": "kernel"})
        else:
            out.append({**e, "cat": "cpu_op"})
    if with_steps:
        for k, (lo, hi) in enumerate([(0, 100), (120, 220)], start=1):
            out.append({"ph": "X", "pid": 0, "tid": 1, "ts": lo,
                        "dur": hi - lo, "name": f"ProfilerStep#{k}",
                        "cat": "gpu_user_annotation"})
            out.append({"ph": "X", "pid": 1, "tid": 7, "ts": lo - 5,
                        "dur": 3, "name": f"ProfilerStep#{k}",
                        "cat": "user_annotation"})
    return out


def _tiled_jax_events() -> list[dict]:
    """JAX's fixture with its step track tiling the window, [0, 120) and
    [120, 220): the port's steps from Kineto's annotations (each to the
    next step's start)."""
    out = []
    for e in fixture_events(with_step_track=True):
        if e.get("pid") == 100 and e.get("tid") == 9 and e.get("ph") == "X":
            e = {**e, "dur": 120} if e["name"] == "1" else e
        out.append(e)
    return out


@pytest.mark.parametrize("with_steps", [True, False])
def test_trace_buckets_match_jax(with_steps):
    mine = trace.summarize_trace(kineto_events(with_steps))
    ref = jax_trace.summarize_trace(_tiled_jax_events() if with_steps
                                    else fixture_events(False))
    assert mine.step_source == ref.step_source
    assert [s.buckets for s in mine.steps] == [s.buckets for s in ref.steps]
    # the 20 us between the steps is step 0's idle here, JAX's hand
    # count on its own track leaves it out
    assert mine.steps[0].buckets == pytest.approx(
        {**STEP0, "idle-bubble": 30.0} if with_steps else STEP0)
    assert mine.steps[1].buckets == pytest.approx(STEP1)
    assert mine.totals == ref.totals
    assert trace.format_summary(mine) == jax_trace.format_summary(ref)
    assert trace.leaf_intervals(kineto_events(with_steps)) == \
        jax_trace.leaf_intervals(fixture_events(with_steps))


def test_trace_loud_without_device_track_and_classify(tmp_path):
    host_only = [e for e in kineto_events() if e.get("pid") != 0]
    with pytest.raises(RuntimeError, match="no GPU device track"):
        trace.summarize_trace(host_only)
    for name, bucket in (
            ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", "collective"),
            ("ncclDevKernel_ReduceScatter_Sum_bf16(x)", "collective"),
            ("Memcpy HtoD (Pageable -> Device)", "host-transfer"),
            ("Memcpy DtoH (Device -> Pinned)", "host-transfer"),
            ("Memcpy DtoD (Device -> Device)", "compute"),
            ("void flash_fwd_sm90_kernel<64, true>(Params)", "compute"),
            ("fused_bn_relu_conv_wgmma_kernel<128>", "compute"),
            ("xent_bwd_kernel", "compute"), ("max_pool_bwd_kernel", "compute"),
            ("void paged_decode_split_kernel<64>", "compute"),
            ("_ZN17cutlass__5x_cudnn6KernelINS_4conv6kernel23Implicit"
             "GemmConvolutionIN8collectiveE", "compute"),
            ("all-reduce.1", "collective"), ("infeed.3", "host-transfer")):
        assert trace.bucket_of(name) == bucket, name
    for name in ("all-reduce.1", "convert_reduce_fusion", "sort.2",
                 "select-and-scatter", "copy.1", "conv.3", "dot.4",
                 "infeed", "mult.7"):
        assert trace.classify(name) == jax_trace.classify(name), name
    f = tmp_path / "rank0.pt.trace.json"
    f.write_text(json.dumps({"traceEvents": kineto_events()}))
    out = io.StringIO()
    assert obs_main(["summarize", str(tmp_path)], out=out) == 0
    assert "idle-bubble" in out.getvalue()


# --- summarize -------------------------------------------------------------------


def _training_records() -> list[dict]:
    recs = [_phase("init", 0.0), _phase("compile", 1.0),
            {"kind": "memory", "source": "torch.cuda", "bytes_in_use": 2**30,
             "peak_bytes": 2**31, "bytes_limit": 2**36, "phase": "compile",
             "step": None},
            _phase("step", 3.0)]
    for i, (rate, loss) in enumerate(((900.0, 6.9), (950.0, 6.7)), 1):
        recs.append({"kind": "window", "step": 10 * i, "rate": rate,
                     "step_ms": 1e3 * 128 / rate, "loss": loss})
    recs += [
        {"kind": "phase_acc", "phase": "data_wait", "seconds": 0.125,
         "step": 16},
        {"kind": "injected_fault", "fault": "nan_loss", "step": 12},
        {"kind": "nonfinite_skip", "step": 16, "new_bad": 1, "streak": 0,
         "total": 1},
        {"kind": "straggler", "step": 16, "host_steps": [16, 15],
         "skew_steps": 0.5, "skew_ms": 70.0, "median_step_ewma_ms": 140.0},
        {"kind": "memory", "source": "torch.cuda", "bytes_in_use": 3 * 2**30,
         "peak_bytes": 5 * 2**30, "bytes_limit": 2**36, "phase": "step",
         "step": 16},
        {"kind": "hbm_budget", "budget_bytes": 4 * 2**30,
         "total_bytes": 5 * 2**30, "exceeded": True},
        {"kind": "memory_report",
         "analytic": {"params_bytes": 10, "opt_bytes": 10, "batch_bytes": 5,
                      "state_bytes": 25}, "mem_source": "analytic"},
        {"kind": "resume", "restored_step": 40, "saved_world": 1,
         "live_world": 2, "arm": "psum"},
        {"kind": "rewind", "step": 18, "restored_step": 40, "lost_steps": 2},
        _phase("end", 9.0, 20),
        {"kind": "trace_buckets",
         "buckets": {"compute": 70.0, "collective": 25.0,
                     "host-transfer": 1.0, "idle-bubble": 4.0},
         "steps": 3, "collective_ops": {"allreduce": 25.0},
         "overlap": {"collective_us": 25.0, "exposed_us": 5.0,
                     "exposed_frac": 0.2, "overlapped_frac": 0.8}},
        {"kind": "summary", "total_images_per_sec": 925.5,
         "images_per_sec_per_chip": 462.75, "mean_step_ms": 138.3,
         "p50_step_ms": 137.9, "p50_step_granularity": 1, "mfu": 0.31,
         "mfu_source": "analytic", "total_workers": 2,
         "allreduce_bytes_per_step": 102 * 2**20},
    ]
    return recs


def test_summarize_training_lines_match_jax(tmp_path):
    manifest = {"schema": 1, "model": "resnet50", "fabric": "ib",
                "process_count": 2, "device_count": 2, "git_sha": "a" * 40,
                "platform": "gpu", "torch_version": "2", "cuda_version": "12",
                "jax_version": "0", "jaxlib_version": "0"}
    w = metrics.MetricsWriter(str(tmp_path), manifest)
    for r in _training_records():
        w.event(**r)
    w.close()
    for ceiling in (None, ceiling_file(tmp_path)):
        mine = metrics.summarize_run(str(tmp_path), fabric_ceiling=ceiling)
        ref = jax_metrics.summarize_run(str(tmp_path),
                                        fabric_ceiling=ceiling)
        assert mine[0] == ref[0] and mine[1] == ref[1]
        assert mine[2].startswith("  torch=") and ref[2].startswith("  jax=")
        # the memory report's head names what measured it: the first
        # warmup step's allocator peak here, the AOT analysis in JAX; the
        # analytic half after it is the same
        head = ("  memory (first step): unavailable on this device",
                "  memory (AOT): unavailable on this arm/backend")
        assert [ln.replace("tpu_hc_bench_torch", "tpu_hc_bench")
                .replace(*head).replace("EXCEEDED (measured", "EXCEEDED (AOT")
                for ln in mine[3:]] == ref[3:]
    text = "\n".join(mine)
    for want in ("goodput:", "MFU 31.0%", "memory: peak", "hbm budget: "
                 "EXCEEDED", "trace buckets", "collective exposure",
                 "resilience: injected_faultx1", "fabric: allreduce"):
        assert want in text, want


# --- the driver on the CPU -----------------------------------------------------


def _cfg(**kw) -> flags.BenchmarkConfig:
    base = dict(model="resnet20_cifar", device="cpu", batch_size=2,
                num_warmup_batches=1, num_batches=4, display_every=2,
                num_classes=10)
    base.update(kw)
    return flags.BenchmarkConfig(**base).resolve()


def _losses(monkeypatch):
    seen: list[torch.Tensor] = []
    real = step_mod.train_step

    def spy(state, batch):
        state, m = real(state, batch)
        seen.append(m["loss"].detach().clone())
        return state, m

    monkeypatch.setattr(step_mod, "train_step", spy)
    return seen


def test_obs_change_nothing_the_step_computes(tmp_path, monkeypatch):
    seen = _losses(monkeypatch)
    off = driver.run_benchmark(_cfg(train_dir=str(tmp_path / "off")),
                               print_fn=lambda _m: None)
    losses_off = list(seen)
    seen.clear()
    out: list[str] = []
    on = driver.run_benchmark(_cfg(
        train_dir=str(tmp_path / "on"), metrics_dir=str(tmp_path / "m"),
        trace_dir=str(tmp_path / "tr"), profile_steps="2:3",
        hbm_budget="1GB", flight_recorder="on"), print_fn=out.append)
    assert [float(x) for x in seen] == [float(x) for x in losses_off]
    assert on.checkpoint["fingerprint"] == off.checkpoint["fingerprint"]
    assert on.goodput_phases and 0 < on.goodput < 1
    text = "\n".join(out)
    assert "profiler trace written to" in text
    unavailable = [ln for ln in out if ln.startswith("trace summary "
                                                     "unavailable")]
    assert len(unavailable) == 1 and "no GPU device track" in unavailable[0]
    assert "WARNING: --hbm_budget: no memory report" in text
    rendered = io.StringIO()
    assert obs_main(["summarize", str(tmp_path / "m")], out=rendered) == 0
    for want in ("goodput:", "flops source:", "memory (first step)",
                 "timeline: 1 rank(s)", "heartbeats: 1 host file(s)"):
        assert want in rendered.getvalue(), want
    assert (tmp_path / "m" / "spans.0.jsonl").exists()
    assert ckpt.latest_step(tmp_path / "on") == 5


def test_trace_dir_on_the_cpu_warns_once_and_exits_0(tmp_path, capsys):
    rc = launcher.main(["1", "1", "2", "sock", "--model=resnet20_cifar",
                        "--device=cpu", "--num_classes=10",
                        "--num_warmup_batches=1", "--num_batches=3",
                        f"--trace_dir={tmp_path}"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("trace summary unavailable") == 1
    assert "profiler trace written to" in out


def test_profile_window_past_the_run_warns_loudly(tmp_path):
    out: list[str] = []
    driver.run_benchmark(_cfg(trace_dir=str(tmp_path / "never"),
                              profile_steps="50:60", num_batches=3),
                         print_fn=out.append)
    text = "\n".join(out)
    assert "profile window 50:60 never started" in text
    assert "profiler trace written" not in text


def test_driver_rejects_a_missing_ceiling_before_warmup(tmp_path):
    with pytest.raises(FileNotFoundError, match="fabric_ceiling"):
        driver.run_benchmark(_cfg(fabric_ceiling=str(tmp_path / "n.json")),
                             print_fn=lambda _m: None)
