"""The port's checkpoints (``tpu_hc_bench_torch.utils.checkpoint`` and the
driver's ``--train_dir`` flow) on the CPU, held to the JAX package's
contract (``tests/test_checkpoint*.py``, ``test_elastic.py``,
``test_multiprocess.py::test_two_process_checkpoint_roundtrip``):

- **round trip**: save, then restore into a state built from other
  weights: parameters, BatchNorm buffers, the optimizer state and the
  step bit-equal, and the next step bit-equal too, under momentum, adam
  and rmsprop;
- **resume**: ``run_benchmark`` saving at step k, then a fresh
  ``run_benchmark`` resuming to 2k, bit-equal to 2k steps in one run:
  resnet50 on synthetic input, and bert_tiny with dropout, whose masks
  continue (a resume whose dropout generator started over parts);
  across two gloo ranks too (rank 0 writes, both restore);
- **the commit protocol**: async and sync writes give one fingerprint; a
  ``.tmp`` and a directory without its sentinel are skipped and
  ``restore`` falls back to the newest complete step; the driver warns
  on a directory of crashed saves; ``--keep_checkpoints=N`` keeps the
  newest N;
- **topology**: JAX's matrix on the port's records (world and arm moves
  of a host-layout state restore; zero1 and other layouts raise one
  ``TopologyMismatchError`` naming both sides), and the sidecar's fields
  are JAX's ``topology_record``'s less the mesh;
- **eval**: train with ``--train_dir``, then ``--eval`` reads the saved
  state: its loss and top-1 equal the eval of the in-memory final state;
  ``--eval`` on an empty ``--train_dir`` raises, as ``--resume=must``
  does; ``--resume=elastic`` raises "not ported yet".
"""

from __future__ import annotations

import json
import math
import shutil
import sys

import pytest
import torch

from tpu_hc_bench_torch import flags, launcher
from tpu_hc_bench_torch.data.synthetic import SyntheticImages, to_device
from tpu_hc_bench_torch.models import dropout_seed, resnet
from tpu_hc_bench_torch.train import driver
from tpu_hc_bench_torch.train import step as step_mod
from tpu_hc_bench_torch.utils import checkpoint as ckpt
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

NARROW = dict(num_classes=10, num_filters=8)
K = 2                                  # steps before the save


def _narrow(seed: int) -> resnet.ResNet:
    model = resnet.ResNet([1, 1, 1, 1], resnet.BottleneckBlock, **NARROW)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(memory_format=torch.channels_last)


def _batch():
    return to_device(SyntheticImages(4, (32, 32, 3), 10, seed=1).batch(),
                     torch.device("cpu"))


def _state(optimizer: str, seed: int = 0) -> step_mod.TrainState:
    cfg = flags.BenchmarkConfig(optimizer=optimizer, device="cpu").resolve()
    return step_mod.make_train_state(_narrow(seed), cfg)


def _assert_states_equal(a: step_mod.TrainState, b: step_mod.TrainState):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys() and oa["state"]
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(ob["state"][i][k])), (i, k)


@pytest.mark.parametrize("optimizer", ["momentum", "adam", "rmsprop"])
def test_round_trip_is_bit_equal(tmp_path, optimizer):
    state = _state(optimizer)
    for _ in range(K):
        step_mod.train_step(state, _batch())
    path = ckpt.save(state, tmp_path)
    assert path == tmp_path / "step_00000002"
    other = _state(optimizer, seed=9)
    payload = ckpt.restore(other, tmp_path)
    assert payload["step"] == K and payload["rng"] == {"dropout": None}
    _assert_states_equal(other, state)
    for s in (state, other):
        step_mod.train_step(s, _batch())
    _assert_states_equal(other, state)


def _cfg(tmp, **kw) -> flags.BenchmarkConfig:
    base = dict(device="cpu", batch_size=2, num_warmup_batches=0,
                display_every=1, seed=3)
    base.update(kw)
    return flags.BenchmarkConfig(
        train_dir=None if tmp is None else str(tmp), **base).resolve()


def _final(tmp) -> dict:
    return ckpt.load_payload(tmp)[1]


def _run(cfg) -> driver.BenchmarkResult:
    return driver.run_benchmark(cfg, print_fn=lambda _m: None)


@pytest.mark.parametrize("model", ["resnet50", "bert_tiny"])
def test_resume_continues_bit_equal_to_one_run(tmp_path, monkeypatch,
                                               model):
    """k steps saved, then a fresh run resuming to 2k steps, against 2k
    steps in one run: every tensor of the final checkpoints bit-equal
    (bert_tiny's dropout masks continue from the saved generator: a
    resume that starts the generator over parts)."""
    kw = dict(model=model, num_batches=K, async_checkpoint=False)
    first = _run(_cfg(tmp_path / "split", **kw))
    assert first.checkpoint["final_step"] == K and first.resume is None
    second = _run(_cfg(tmp_path / "split", resume="must", **kw))
    assert second.resume["restored_step"] == K
    assert second.resume["fingerprint"] == first.checkpoint["fingerprint"]
    whole = _run(_cfg(tmp_path / "whole", model=model, num_batches=2 * K))
    got, want = _final(tmp_path / "split"), _final(tmp_path / "whole")
    assert got["step"] == want["step"] == 2 * K
    assert ckpt.fingerprint(got) == ckpt.fingerprint(want)
    assert second.checkpoint["fingerprint"] == \
        whole.checkpoint["fingerprint"]
    if model != "bert_tiny":
        assert got["rng"]["dropout"] is None
        return
    assert len(got["rng"]["dropout"]) == 1
    restore = ckpt.restore

    def restarted_masks(state, directory, **kw):
        payload = restore(state, directory, **kw)
        state.model.dropout_generator.manual_seed(dropout_seed(3))
        return payload

    monkeypatch.setattr(ckpt, "restore", restarted_masks)
    for p in (tmp_path / "split").glob("step_00000004*"):
        p.unlink() if p.is_file() else shutil.rmtree(p)
    third = _run(_cfg(tmp_path / "split", resume="must", **kw))
    assert third.resume["restored_step"] == K
    assert third.checkpoint["fingerprint"] != \
        whole.checkpoint["fingerprint"]


def test_async_and_sync_writes_give_one_fingerprint(tmp_path):
    state = _state("momentum")
    step_mod.train_step(state, _batch())
    writer = ckpt.AsyncCheckpointWriter(tmp_path / "async")
    assert writer.submit(state) == 1
    step_mod.train_step(state, _batch())     # the snapshot is a copy
    writer.wait()
    assert not writer.in_flight and writer.commits[0]["step"] == 1
    other = _state("momentum")
    step_mod.train_step(other, _batch())
    ckpt.save(other, tmp_path / "sync")
    a, b = _final(tmp_path / "async"), _final(tmp_path / "sync")
    assert ckpt.fingerprint(a) == ckpt.fingerprint(b)
    assert ckpt.fingerprint(a["model"]) != \
        ckpt.fingerprint(state.model.state_dict())


def test_async_write_error_reraises_at_wait(tmp_path):
    (tmp_path / "file").write_text("not a directory")
    writer = ckpt.AsyncCheckpointWriter(tmp_path / "file" / "sub")
    writer.submit(_state("momentum"))
    with pytest.raises(OSError):
        writer.wait()
    writer.wait()                            # raised once


def test_crash_debris_is_skipped_and_restore_falls_back(tmp_path):
    state = _state("momentum")
    step_mod.train_step(state, _batch())
    ckpt.save(state, tmp_path)
    want = ckpt.fingerprint(state.model.state_dict())
    step_mod.train_step(state, _batch())
    ckpt.save(state, tmp_path)
    # a save that died in the write (a .tmp) and one that died between
    # the rename and the sentinel
    (tmp_path / "step_00000003.tmp").mkdir()
    (tmp_path / "step_00000003.tmp" / "state.pt").write_bytes(b"junk")
    ckpt._marker(tmp_path, 2).unlink()
    assert ckpt.complete_steps(tmp_path) == [1]
    assert ckpt.latest_step(tmp_path) == 1
    other = _state("momentum", seed=5)
    ckpt.restore(other, tmp_path)
    assert other.step == 1
    assert ckpt.fingerprint(other.model.state_dict()) == want
    with pytest.raises(FileNotFoundError, match="incomplete"):
        ckpt.restore(other, tmp_path, step=2)


def test_driver_warns_on_crashed_saves_and_must_raises(tmp_path):
    (tmp_path / "step_00000004").mkdir()
    lines: list[str] = []
    cfg = _cfg(tmp_path, model="bert_tiny", num_batches=1)
    assert driver._maybe_restore(_state("momentum"), cfg, {}, 0,
                                 lines.append) is None
    assert "without a commit sentinel (step_00000004)" in lines[0]
    with pytest.raises(FileNotFoundError, match="--resume=must"):
        _run(_cfg(tmp_path, model="bert_tiny", num_batches=1,
                  resume="must"))
    never = _cfg(tmp_path, model="bert_tiny", num_batches=1, resume="never")
    assert driver._maybe_restore(None, never, {}, 0, lines.append) is None


def test_keep_checkpoints_keeps_the_newest_n(tmp_path):
    state = _state("sgd")
    (tmp_path / "step_00000099").mkdir(parents=True)   # no sentinel
    for _ in range(5):
        step_mod.train_step(state, _batch())
        ckpt.save(state, tmp_path)
        (tmp_path / "step_00000077.tmp").mkdir(exist_ok=True)
        ckpt.gc_checkpoints(tmp_path, 2)
    assert ckpt.complete_steps(tmp_path) == [4, 5]
    assert not list(tmp_path.glob("*.tmp"))
    assert (tmp_path / "step_00000099").is_dir()        # left alone
    assert sorted(p.name for p in tmp_path.glob("*.topology.json")) == []
    res = _run(_cfg(tmp_path / "run", model="bert_tiny", num_batches=4,
                    save_model_steps=1, keep_checkpoints=2))
    assert [s["step"] for s in res.checkpoint["saves"]] == [1, 2, 3, 4]
    assert ckpt.complete_steps(tmp_path / "run") == [3, 4]
    assert ckpt.read_topology(tmp_path / "run") == {
        "schema": 1, "world": 1, "process_count": 1,
        "mesh": {"data": 1, "model": 1},
        "variable_update": "psum", "pipeline_parallel": 1, "layout": "host",
        "dtype": "float32"}


def test_topology_record_and_plan_follow_jax():
    from tpu_hc_bench import flags as jax_flags
    from tpu_hc_bench import topology

    rec = ckpt.topology_record(4, flags.BenchmarkConfig(device="cpu"))
    jax_rec = topology.topology_record(
        topology.discover_layout(), topology.build_mesh(
            topology.discover_layout()), jax_flags.BenchmarkConfig())
    assert set(rec) == set(jax_rec)
    assert rec["mesh"] == {"data": 4, "model": 1}
    for k in ("schema", "variable_update", "pipeline_parallel", "layout",
              "dtype"):
        assert rec[k] == jax_rec[k], k
    live = dict(rec, world=1)
    cases = [(rec, rec, "ok"), (rec, live, "noop"),
             (rec, dict(live, variable_update="replicated"), "noop"),
             (dict(rec, variable_update="zero1"), live, "refuse"),
             (rec, dict(rec, variable_update="zero1"), "refuse"),
             (dict(rec, variable_update="zero1"),
              dict(live, variable_update="zero1"), "reshard"),
             (dict(rec, layout="pp-native"), rec, "refuse"),
             (dict(rec, layout="sharded"), rec, "refuse")]
    for saved, now, action in cases:
        assert ckpt.elastic_plan(saved, now)[0] == action, (saved, now)
        jax_saved = dict(jax_rec, **{k: saved[k] for k in
                                     ("world", "variable_update", "layout")})
        jax_now = dict(jax_rec, **{k: now[k] for k in
                                   ("world", "variable_update", "layout")})
        jax_action = topology.elastic_plan(jax_saved, jax_now)[0]
        assert jax_action == action, (saved, now)
    assert "dtype policy" in ckpt.elastic_plan(
        rec, dict(live, dtype="bfloat16"))[1]


def test_topology_mismatch_raises_naming_both_sides(tmp_path):
    state = _state("momentum")
    step_mod.train_step(state, _batch())
    cfg = flags.BenchmarkConfig(device="cpu").resolve()
    saved = dict(ckpt.topology_record(4, cfg), variable_update="zero1")
    ckpt.save(state, tmp_path, topology=saved)
    live = ckpt.topology_record(1, cfg)
    with pytest.raises(ckpt.TopologyMismatchError) as e:
        ckpt.restore(_state("momentum", 2), tmp_path, expect_topology=live)
    msg = str(e.value)
    assert "saved world=4" in msg and "arm=zero1" in msg
    assert "live world=1" in msg and "arm=psum" in msg
    with pytest.raises(ckpt.TopologyMismatchError):
        _run(_cfg(tmp_path, model="bert_tiny", num_batches=1))
    # a psum state saved at world 4 restores at world 1
    ckpt.save(state, tmp_path / "psum", topology=ckpt.topology_record(
        4, cfg))
    other = _state("momentum", 2)
    ckpt.restore(other, tmp_path / "psum", expect_topology=live)
    _assert_states_equal(other, state)


def test_train_then_eval_reads_the_saved_state(tmp_path, monkeypatch):
    """JAX's ``test_train_checkpoint_eval_roundtrip``: ``--eval`` with
    the training run's ``--train_dir`` measures the saved state; its
    loss and top-1 equal those of an eval of the training run's
    in-memory final model."""
    built = []
    create = driver.create_model

    def keep(*a, **kw):
        model, spec = create(*a, **kw)
        built.append(model)
        return model, spec

    monkeypatch.setattr(driver, "create_model", keep)
    kw = dict(model="resnet50", num_batches=2, batch_size=2)
    train = _run(_cfg(tmp_path, **kw))
    trained = {k: v.clone() for k, v in built[0].state_dict().items()}
    ev = _run(_cfg(tmp_path, eval=True, **kw))
    assert ev.resume["restored_step"] == train.checkpoint["final_step"]
    assert ev.resume["fingerprint"] == train.checkpoint["fingerprint"]

    def trained_model(*a, **k):
        model, spec = create(*a, **k)
        model.load_state_dict(trained)
        return model, spec

    monkeypatch.setattr(driver, "create_model", trained_model)
    lines: list[str] = []
    want = driver.run_benchmark(_cfg(None, eval=True, **kw),
                                print_fn=lines.append)
    assert driver.RANDOM_INIT_EVAL_WARNING in lines
    assert ev.final_loss == want.final_loss
    assert ev.eval_top_1 == want.eval_top_1
    assert math.isfinite(ev.final_loss)


def test_eval_on_an_empty_train_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="--eval: no checkpoint"):
        _run(_cfg(tmp_path, model="bert_tiny", num_batches=1, eval=True))


@pytest.mark.parametrize("argv,match", [
    (["--resume=elastic"], "--resume=elastic needs --train_dir"),
    (["--resume=must"], "needs --train_dir"),
    (["--resume=sometimes"], "auto|never|must"),
    (["--keep_checkpoints=-1"], "keep_checkpoints"),
    (["--save_model_steps=-2"], "save_model_steps"),
])
def test_checkpoint_flag_refusals(argv, match):
    with pytest.raises(ValueError, match=match):
        flags.parse_benchmark_flags(["--device=cpu"] + argv)


def test_checkpoint_flags_follow_jax_defaults():
    from tpu_hc_bench import flags as jax_flags

    mine, jax_cfg = flags.BenchmarkConfig(), jax_flags.BenchmarkConfig()
    for k in ("train_dir", "save_model_steps", "async_checkpoint", "resume",
              "keep_checkpoints"):
        assert getattr(mine, k) == getattr(jax_cfg, k), k
        assert k not in flags.LATER_SLICE_TRAIN_FLAGS


def test_two_ranks_save_once_and_both_restore(tmp_path):
    """Two gloo ranks (bert_tiny, dropout on each rank): 2k steps in one
    launch that saves at step k (rank 0 writes), then a launch resuming
    from that step k to 2k: bit-equal at 2k, so both ranks restored the
    same parameters and their own dropout generators."""
    def launch(train_dir, steps, *extra):
        lines: list[str] = []
        rc = launcher.main(
            ["1", "2", "2", "ib", "--model=bert_tiny", "--device=cpu",
             "--num_warmup_batches=0", f"--num_batches={steps}",
             f"--train_dir={train_dir}", *extra], print_fn=lines.append)
        assert rc == 0, lines[-5:]
        return json.loads([ln for ln in lines if ln.startswith("{")][-1])

    whole = launch(tmp_path / "whole", 2 * K, f"--save_model_steps={K}")
    assert [(s["step"], s["async"]) for s in whole["checkpoint"]["saves"]] \
        == [(K, False), (2 * K, False)]
    assert len(_final(tmp_path / "whole")["rng"]["dropout"]) == 2
    split = tmp_path / "split"
    split.mkdir()
    for p in (tmp_path / "whole").glob(f"step_{K:08d}*"):
        (shutil.copytree if p.is_dir() else shutil.copy)(p, split / p.name)
    second = launch(split, K, "--resume=must")
    assert second["resume"]["restored_step"] == K
    assert second["resume"]["saved_world"] == 2
    assert second["checkpoint"]["fingerprint"] == \
        whole["checkpoint"]["fingerprint"]


def test_checkpoint_module_imports_no_jax():
    import subprocess

    code = ("import sys, tpu_hc_bench_torch.utils.checkpoint, "
            "tpu_hc_bench_torch.data.service; "
            "assert not [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'tpu_hc_bench.'))]")
    subprocess.run([sys.executable, "-c", code], check=True)
