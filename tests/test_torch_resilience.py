"""The port's training-lane guards and survival paths against the JAX
package, on the CPU.

- **guards**: ``finite_flag`` on seeded losses and gradient trees with
  NaN and inf entries, ``select_state`` and ``GuardTracker`` over one
  flag sequence, ``guard_mode`` over the policy table: equal to the JAX
  functions (booleans and int counters: exact).
- **inject**: ``parse_plan`` over the same specs, valid (the plans'
  fields) and malformed (the same loud message, naming both lanes'
  grammars); ``nan_loss`` on an integer-only batch refuses as JAX does.
- **the fused conv's NaN**: ``fused_bn_relu_conv_plain`` and its
  backward on a ``y1`` with NaN entries against ``jax.vjp`` of the
  Pallas kernel (interpret mode): NaN in the same places, the rest
  within the ops tests' bounds (1e-5 and 1e-4 of the largest finite
  magnitude); ``test_torch_kernels_card.py`` holds the card's kernel
  to the plain version on such an input.
- **the step**: under ``skip`` a poisoned step leaves parameters, BN
  statistics and optimizer state (momentum, Adam's moments and count,
  RMSprop's) bit-equal, also as the first step; under ``flag``
  (``rewind``'s detection) it is counted and applied.
- **the driver**, tiny ResNet on the CPU: ``nan_loss@3`` under ``skip``
  ends bit-equal to a two-step fault-free run; ``abort`` stops with
  JAX's message; a run poisoned on every step ends on
  ``--max_bad_steps`` under ``skip`` and ``rewind``; ``rewind`` restores,
  replays and completes with goodput below 1; ``sigterm@N`` exits 75
  with an emergency checkpoint and ``--resume=auto`` ends on the
  uninterrupted run's fingerprint; ``hang@N:S`` exits 70 with the
  thread dump (these two in subprocesses: they signal and end the
  process).
- **four gloo ranks**: ``all_processes_any`` and ``straggler_gather``.
- **flags**: the eleven ported flags parse and validate as JAX's; the
  eight still missing refuse loudly.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_hc_bench import flags as jax_flags
from tpu_hc_bench.ops import fused_conv as jax_fused_conv
from tpu_hc_bench.resilience import guards as jax_guards
from tpu_hc_bench.resilience import inject as jax_inject
from tpu_hc_bench_torch import flags
from tpu_hc_bench_torch.data.synthetic import SyntheticImages, to_device
from tpu_hc_bench_torch.ops.fused_conv import (
    fused_bn_relu_conv, fused_bn_relu_conv_plain)
from tpu_hc_bench_torch.resilience import guards, inject, preempt
from tpu_hc_bench_torch.train import driver
from tpu_hc_bench_torch.train import step as step_mod
from tpu_hc_bench_torch.utils import checkpoint as ckpt
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
CONV_TOL = 1e-5
CONV_GRAD_TOL = 1e-4
MODEL = "resnet20_cifar"


# --- guards ------------------------------------------------------------------


def _cases():
    rng = np.random.default_rng(7)
    out = []
    for loss_bad, grad_bad in ((None, None), ("nan", None), (None, "nan"),
                               (None, "inf"), ("inf", "nan")):
        loss = np.float32(rng.standard_normal())
        if loss_bad:
            loss = np.float32(loss_bad)
        grads = [rng.standard_normal(s).astype(np.float32)
                 for s in ((3, 4), (5,), (2, 2, 2))]
        if grad_bad:
            grads[1][2] = np.float32(grad_bad)
        out.append((loss, grads))
    # finite entries whose squares overflow: the global norm is inf
    out.append((np.float32(1.0), [np.full((4,), 3e19, np.float32)]))
    return out


@pytest.mark.parametrize("case", range(6))
def test_finite_flag_matches_jax(case):
    loss, grads = _cases()[case]
    want = bool(jax_guards.finite_flag(jnp.asarray(loss),
                                       [jnp.asarray(g) for g in grads]))
    got = guards.finite_flag(torch.tensor(loss),
                             [torch.from_numpy(g) for g in grads])
    assert got.dtype == torch.bool and got.dim() == 0
    assert bool(got) == want
    assert bool(guards.finite_flag(torch.tensor(loss))) == bool(
        jax_guards.finite_flag(jnp.asarray(loss)))
    assert int(guards.nonfinite_metric(got)) == int(
        jax_guards.nonfinite_metric(jnp.asarray(want)))


@pytest.mark.parametrize("ok", [True, False])
def test_select_state_matches_jax(ok):
    rng = np.random.default_rng(3)
    new = [rng.standard_normal((3, 2)).astype(np.float32),
           np.array([np.nan, 1.0], np.float32)]
    old = [rng.standard_normal((3, 2)).astype(np.float32),
           np.array([2.0, 3.0], np.float32)]
    want = jax_guards.select_state(jnp.asarray(ok), [jnp.asarray(a)
                                                      for a in new],
                                   [jnp.asarray(a) for a in old])
    got = [torch.from_numpy(a.copy()) for a in new]
    guards.select_state(torch.tensor(ok), got, [torch.from_numpy(a)
                                                 for a in old])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_guard_tracker_matches_jax():
    flags_seq = [0, 1, 1, 0, 1, 1, 1, 0, 0, 1]
    mine, ref = guards.GuardTracker(), jax_guards.GuardTracker()
    for i, bad in enumerate(flags_seq):
        mine.update(torch.tensor(bad, dtype=torch.int32))
        ref.update(jnp.asarray(bad, jnp.int32))
        assert mine.poll() == ref.poll(), i
        assert mine.fetch(mine.handles()) == ref.poll()
    mine.reset()
    ref.reset()
    assert mine.poll() == ref.poll() == (0, 0, 0)


@pytest.mark.parametrize("kw", [
    {}, {"on_nonfinite": "skip"}, {"on_nonfinite": "rewind"},
    {"on_nonfinite": "skip", "forward_only": True},
    {"on_nonfinite": "rewind", "eval": True}])
def test_guard_mode_matches_jax(kw):
    cfg = flags.BenchmarkConfig(**kw)
    assert guards.guard_mode(cfg) == jax_guards.guard_mode(
        jax_flags.BenchmarkConfig(**kw))


# --- inject ------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    None, "", "nan_loss@3", "nan_loss@3,nan_loss@4", "hang@80:30",
    "sigterm@120", "io_error@ckpt",
    "nan_loss@40,hang@80:30.5,sigterm@120,io_error@ckpt", " nan_loss@2 , "])
def test_parse_plan_matches_jax(spec):
    mine, ref = inject.parse_plan(spec), jax_inject.parse_plan(spec)
    if ref is None:
        assert mine is None
        return
    assert (mine.nan_loss, mine.hang, mine.sigterm, mine.io_error) == \
        (ref.nan_loss, ref.hang, ref.sigterm, ref.io_error)
    assert bool(mine) == bool(ref)


@pytest.mark.parametrize("spec", [
    "nan_loss", "nan_loss@", "@3", "nan_loss@0", "nan_loss@3:1",
    "hang@3", "hang@3:0", "hang@3:", "sigterm@x", "io_error@disk",
    "nan_logits@3", "pool_squeeze@1:2", "bogus@1"])
def test_parse_plan_refusals_match_jax(spec):
    with pytest.raises(ValueError) as ref:
        jax_inject.parse_plan(spec)
    with pytest.raises(ValueError) as mine:
        inject.parse_plan(spec)
    assert str(mine.value) == str(ref.value)
    assert "serve grammar" in str(mine.value)
    with pytest.raises(ValueError, match="malformed fault entry"):
        flags.parse_benchmark_flags([f"--inject_fault={spec}"])


def test_poison_batch_and_its_refusal_match_jax():
    plan = inject.parse_plan("nan_loss@2,io_error@ckpt")
    imgs = torch.ones((2, 3)), torch.tensor([1, 2])
    assert plan.poison_batch(1, imgs, print) is imgs
    out: list[str] = []
    got = plan.poison_batch(2, imgs, out.append)
    assert torch.isnan(got[0]).all() and torch.equal(got[1], imgs[1])
    assert torch.equal(imgs[0], torch.ones((2, 3)))    # not in place
    assert out == ["inject: nan_loss at timed step 2"]
    ids = (torch.zeros((2, 4), dtype=torch.int64),) * 3
    with pytest.raises(ValueError) as mine:
        plan.poison_batch(2, ids, print)
    with pytest.raises(ValueError) as ref:
        jax_inject.parse_plan("nan_loss@2").poison_batch(
            2, tuple(jnp.zeros((2, 4), jnp.int32) for _ in range(3)),
            print)
    assert str(mine.value) == str(ref.value)
    with pytest.raises(OSError, match="injected io_error@ckpt"):
        plan.maybe_io_error("ckpt")
    plan.maybe_io_error("ckpt")                         # one-shot


def test_preemption_handler_agrees_alone_and_restores_handlers():
    import signal

    before = signal.getsignal(signal.SIGTERM)
    h = preempt.PreemptionHandler(print_fn=lambda _m: None).install()
    try:
        assert not h.requested() and not h.agreed(1)
        h._on_signal(signal.SIGTERM, None)
        assert h.requested() and h.agreed(1)
    finally:
        h.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before
    err = preempt.PreemptedError(4, True, 15, {"world": 2})
    assert "world 2" in str(err) and "--resume=auto" in str(err)


# --- the fused conv keeps NaN ------------------------------------------------


def _nan_conv_inputs(n=2, h=8, cin=16, cout=32):
    rng = np.random.default_rng(5)
    y1 = rng.standard_normal((n, h, h, cin)).astype(np.float32)
    y1[0, 2, 3, 1] = np.nan
    y1[1, 5, 0, 7] = np.nan
    a = (0.5 + 0.5 * np.abs(rng.standard_normal(cin))).astype(np.float32)
    b = (0.1 * rng.standard_normal(cin)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, cin, cout))).astype(np.float32)
    return y1, a, b, w


def _same_nan_close(got, want, tol, what):
    got = np.asarray(torch.as_tensor(got).detach().float())
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    fin = np.isfinite(want)
    scale = max(float(np.abs(want[fin]).max(initial=0.0)), 1.0)
    err = float(np.abs(got[fin] - want[fin]).max(initial=0.0))
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def test_fused_conv_keeps_nan_like_jax():
    """relu(NaN * a + b) is NaN in the Pallas kernel (``jnp.maximum``)
    and in the port's plain version (``torch.relu``): the conv carries
    it to y2 and the stats, and the backward's relu mask (``xn > 0``,
    False at NaN) and BN-apply gradient match ``jax.vjp``."""
    y1, a, b, w = _nan_conv_inputs()
    rng = np.random.default_rng(1)
    g_y = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    g_s1 = rng.standard_normal(32).astype(np.float32)
    g_s2 = (0.01 * rng.standard_normal(32)).astype(np.float32)
    want, vjp = jax.vjp(jax_fused_conv.fused_bn_relu_conv,
                        *(jnp.asarray(v) for v in (y1, a, b, w)))
    want_grads = vjp(tuple(jnp.asarray(g) for g in (g_y, g_s1, g_s2)))
    assert np.isnan(np.asarray(want[0])).any()
    assert np.isfinite(np.asarray(want[0])).any()
    args = [torch.from_numpy(v).requires_grad_() for v in (y1, a, b, w)]
    got = fused_bn_relu_conv(*args)
    plain = fused_bn_relu_conv_plain(*(t.detach() for t in args))
    for g, p, wnt, name in zip(got, plain, want, ("y2", "s1", "s2")):
        _same_nan_close(g, wnt, CONV_TOL, name)
        _same_nan_close(p, wnt, CONV_TOL, f"plain {name}")
    torch.autograd.backward(got, [torch.from_numpy(g)
                                  for g in (g_y, g_s1, g_s2)])
    for t, wnt, name in zip(args, want_grads, ("dy1", "da", "db", "dw")):
        _same_nan_close(t.grad, wnt, CONV_GRAD_TOL, name)


# --- the guarded step --------------------------------------------------------


def _state(opt: str, policy: str):
    from tpu_hc_bench_torch.models import create_model

    cfg = flags.BenchmarkConfig(model=MODEL, batch_size=4, device="cpu",
                                optimizer=opt, on_nonfinite=policy,
                                num_classes=10)
    model, spec = create_model(MODEL, torch.float32, device="cpu", seed=0,
                               train=True, num_classes=10)
    batch = to_device(SyntheticImages(4, spec.input_shape, 10, 0).batch(),
                      torch.device("cpu"))
    return step_mod.make_train_state(model, cfg), batch


def _snapshot(state) -> list[torch.Tensor]:
    return [t.detach().clone() for t in guards.state_tensors(
        state.model, state.optimizer)]


@pytest.mark.parametrize("opt", ["momentum", "adam", "rmsprop"])
def test_skip_leaves_the_state_bit_equal(opt):
    state, batch = _state(opt, "skip")
    bad = (batch[0] * float("nan"), batch[1])
    state, m = step_mod.train_step(state, bad)       # a first step, bad
    assert int(m["nonfinite"]) == 1
    fresh, _ = _state(opt, "skip")
    for a, b in zip(state.model.state_dict().values(),
                    fresh.model.state_dict().values()):
        assert torch.equal(a, b)
    state, m = step_mod.train_step(state, batch)
    ref, _ = _state(opt, "skip")
    ref, _ = step_mod.train_step(ref, batch)
    before = _snapshot(state)
    state, m = step_mod.train_step(state, bad)
    assert int(m["nonfinite"]) == 1 and torch.isnan(m["loss"])
    after = _snapshot(state)
    assert len(before) == len(after)
    for x, y in zip(before, after):
        assert torch.equal(x, y)
    state, m = step_mod.train_step(state, batch)
    ref, m_ref = step_mod.train_step(ref, batch)
    assert int(m["nonfinite"]) == 0 and torch.equal(m["loss"], m_ref["loss"])
    assert ckpt.fingerprint(state.model.state_dict()) == \
        ckpt.fingerprint(ref.model.state_dict())


def test_flag_counts_and_applies_the_update():
    state, batch = _state("momentum", "rewind")
    assert state.guard == "flag" and state.held is None
    state, m = step_mod.train_step(state, batch)
    assert int(m["nonfinite"]) == 0
    state, m = step_mod.train_step(state, (batch[0] * float("nan"),
                                           batch[1]))
    assert int(m["nonfinite"]) == 1
    assert any(torch.isnan(p).any() for p in state.model.parameters())


def test_no_guard_no_metric():
    state, batch = _state("momentum", "abort")
    assert state.guard == "off"
    _, m = step_mod.train_step(state, batch)
    assert set(m) == {"loss"}


# --- the driver --------------------------------------------------------------


def _cfg(tmp=None, **kw) -> flags.BenchmarkConfig:
    base = dict(model=MODEL, device="cpu", batch_size=2,
                num_warmup_batches=0, display_every=1, num_classes=10)
    base.update(kw)
    return flags.BenchmarkConfig(
        train_dir=None if tmp is None else str(tmp), **base).resolve()


def _run(cfg, out=None) -> driver.BenchmarkResult:
    return driver.run_benchmark(cfg, print_fn=(out.append if out is not None
                                               else lambda _m: None))


def test_skip_run_equals_a_shorter_fault_free_run(tmp_path):
    out: list[str] = []
    skip = _run(_cfg(tmp_path / "skip", num_batches=3,
                     inject_fault="nan_loss@3", on_nonfinite="skip"), out)
    clean = _run(_cfg(tmp_path / "clean", num_batches=2))
    assert skip.checkpoint["fingerprint"] == clean.checkpoint["fingerprint"]
    assert any("nonfinite: dropped 1 update(s)" in ln for ln in out)
    assert skip.goodput_phases and skip.goodput < 1.0


def test_abort_stops_with_jax_message():
    with pytest.raises(guards.NonFiniteError,
                       match=r"non-finite loss at display step\(s\) \[2, 3\]"
                             r" \(--on_nonfinite=abort; use skip or rewind"):
        _run(_cfg(num_batches=3, inject_fault="nan_loss@2"))


@pytest.mark.parametrize("policy", ["skip", "rewind"])
def test_budget_ends_a_poisoned_run(tmp_path, policy):
    spec = ",".join(f"nan_loss@{i}" for i in range(1, 13))
    match = ("consecutive non-finite steps" if policy == "skip"
             else "consecutive rewinds without a clean window")
    with pytest.raises(guards.GuardBudgetError,
                       match=match + r" \(--max_bad_steps=2\)"):
        _run(_cfg(tmp_path, num_batches=12, inject_fault=spec,
                  on_nonfinite=policy, max_bad_steps=2, display_every=2))


def test_rewind_restores_replays_and_completes(tmp_path):
    out: list[str] = []
    res = _run(_cfg(tmp_path, num_batches=8, display_every=2,
                    inject_fault="nan_loss@3", on_nonfinite="rewind",
                    save_model_steps=2, metrics_dir=str(tmp_path / "m")),
               out)
    assert any(ln.startswith("rewind: non-finite step(s) in window")
               for ln in out)
    assert np.isfinite(res.final_loss) and res.goodput < 1.0
    assert res.goodput_phases.get("rewind_replay", 0) > 0
    params = ckpt.load_payload(tmp_path)[1]["model"]
    assert all(torch.isfinite(t).all() for t in params.values()
               if t.is_floating_point())


def _cli(*args, timeout=240):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return subprocess.run(
        [sys.executable, "-m", "tpu_hc_bench_torch", "1", "1", "2", "sock",
         f"--model={MODEL}", "--device=cpu", "--num_classes=10",
         "--num_warmup_batches=0", "--display_every=1", *args],
        capture_output=True, text=True, timeout=timeout, env=env,
        cwd=str(REPO))


def test_sigterm_exits_75_and_resume_ends_on_the_uninterrupted_run(
        tmp_path):
    d = tmp_path / "split"
    first = _cli("--num_batches=5", f"--train_dir={d}",
                 "--inject_fault=sigterm@2")
    assert first.returncode == 75, first.stderr[-2000:]
    assert "preemption: stopping after timed step 2" in first.stdout
    saved = [ln for ln in first.stdout.splitlines()
             if ln.startswith("state fingerprint:")]
    assert len(saved) == 1 and ckpt.latest_step(d) == 2
    second = _cli("--num_batches=3", f"--train_dir={d}", "--resume=auto")
    assert second.returncode == 0, second.stderr[-2000:]
    assert f"restored checkpoint step 2 from {d}" in second.stdout
    assert saved[0] in second.stdout
    # the result line, then the launcher's ``log: <path>`` (JAX's order)
    out = second.stdout.strip().splitlines()
    assert out[-1].startswith("log: ")
    resumed = json.loads(out[-2])
    whole = _run(_cfg(tmp_path / "whole", num_batches=5))
    assert resumed["checkpoint"]["fingerprint"] == \
        whole.checkpoint["fingerprint"]


def test_hang_exits_70_with_the_thread_dump():
    run = _cli("--num_batches=4", "--inject_fault=hang@2:60",
               "--step_timeout_s=1.5", timeout=120)
    assert run.returncode == 70, run.stderr[-2000:]
    assert "watchdog: no step completed in" in run.stderr
    assert "Thread 0x" in run.stderr or "Current thread" in run.stderr
    assert "inject: hang at timed step 2 seconds=60.0" in run.stdout


# --- four gloo ranks ----------------------------------------------------------

_WORKER = """
import json, sys
import torch.distributed as dist
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=world)
from tpu_hc_bench_torch.obs import fleet
from tpu_hc_bench_torch.utils.sync import all_processes_any
out = {"none": all_processes_any(False), "one": all_processes_any(rank == 2),
       "skew": fleet.straggler_gather(10 + rank, 5.0 * (rank + 1))}
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_four_gloo_ranks_agree_and_gather():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), "4",
                               str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for r in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    from tpu_hc_bench_torch.obs import fleet

    want = fleet.compute_skew([10, 11, 12, 13], [5.0, 10.0, 15.0, 20.0])
    for o, _ in outs:
        rec = json.loads(o.strip().splitlines()[-1])
        assert rec["none"] is False and rec["one"] is True
        assert rec["skew"] == want


# --- flags --------------------------------------------------------------------

PORTED = {
    "on_nonfinite": "skip", "max_bad_steps": "3", "step_timeout_s": "auto",
    "inject_fault": "nan_loss@4,hang@5:2", "trace_dir": "/tmp/t",
    "profile_steps": "2:4", "metrics_dir": "/tmp/m", "flight_recorder": "off",
    "fabric_ceiling": "/tmp/sweep.json", "hbm_budget": "16GB",
    "compile_cache": "off"}


def test_the_eleven_flags_parse_and_the_eight_refuse():
    """None of the eight refuses now: ``--virtual_devices`` is ported
    since (``tests/test_torch_fleet.py``; the CPU only), ``--config`` since
    (``tests/test_torch_tune.py``), ``--sequence_parallel`` since
    (``tests/test_torch_sp_train.py``), ``--num_slices``,
    ``--model_parallel`` and ``--expert_parallel`` since
    (``tests/test_torch_multislice.py``,
    ``tests/test_torch_tensor_parallel.py``), ``--pipeline_parallel`` and
    ``--num_microbatches`` since (``tests/test_torch_pipeline.py``)."""
    cfg = flags.parse_benchmark_flags([f"--{k}={v}"
                                       for k, v in PORTED.items()])
    for k, v in PORTED.items():
        assert str(getattr(cfg, k)) == v, k
    assert set(PORTED).isdisjoint(flags.LATER_SLICE_TRAIN_FLAGS)
    # --virtual_devices is ported since (tests/test_torch_fleet.py): a
    # CPU host's worker count, refused on the card and below 1
    assert "virtual_devices" not in flags.LATER_SLICE_TRAIN_FLAGS
    with pytest.raises(ValueError, match="two NCCL ranks cannot share"):
        flags.parse_benchmark_flags(["--virtual_devices=2"])
    with pytest.raises(ValueError, match="must be >= 1"):
        flags.parse_benchmark_flags(["--virtual_devices=-1",
                                     "--device=cpu"])
    assert flags.parse_benchmark_flags(
        ["--virtual_devices=2", "--device=cpu"]).virtual_devices == 2
    assert "config" not in flags.LATER_SLICE_TRAIN_FLAGS
    with pytest.raises(ValueError, match="manual|auto"):
        flags.parse_benchmark_flags(["--config=2"])
    for name in ("sequence_parallel", "num_slices", "model_parallel",
                 "expert_parallel", "pipeline_parallel",
                 "num_microbatches"):
        assert name not in flags.LATER_SLICE_TRAIN_FLAGS
        assert getattr(flags.parse_benchmark_flags(
            [f"--{name}=2", "--model=moe_tiny"]), name) == 2
    assert flags.parse_benchmark_flags(
        ["--sequence_parallel=2"]).sequence_parallel == 2


@pytest.mark.parametrize("kw", [
    {"on_nonfinite": "flag"},
    {"on_nonfinite": "skip", "forward_only": True},
    {"on_nonfinite": "rewind"},
    {"on_nonfinite": "rewind", "train_dir": "/x", "resume": "never"},
    {"max_bad_steps": 0},
    {"step_timeout_s": "-1"}, {"step_timeout_s": "soon"},
    {"profile_steps": "1:2"},
    {"profile_steps": "3:2", "trace_dir": "/x"},
    {"profile_steps": "1:2", "trace_dir": "/x", "eval": True},
    {"hbm_budget": "lots"}, {"flight_recorder": "maybe"},
])
def test_flag_refusals_match_jax(kw):
    with pytest.raises(ValueError) as ref:
        jax_flags.BenchmarkConfig(**kw).resolve()
    with pytest.raises(ValueError) as mine:
        flags.BenchmarkConfig(**kw).resolve()
    assert str(mine.value) == str(ref.value)
