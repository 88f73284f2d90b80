"""The port's elastic resume (``--resume=elastic``) against the JAX
package, on the CPU (gloo; no card here).

- **the resplit**: ``zero1_resplit_rows`` bit-equal to JAX's over a grid
  of sizes and worlds, both ways; ``resplit_zero1_opt`` on a momentum
  state whose parameter is shaped like its own stack (JAX's regression
  case: ``(8, 16)`` at world 8) bit-equal to JAX's ``resplit_zero1_opt``
  and the identity at the same world.
- **the plan**: the port's topology record carries JAX's ``mesh``, and
  ``elastic_plan`` gives JAX's action for every pair of JAX's matrix;
  ``describe_topology`` renders JAX's line.
- **the round trip**: four gloo ranks (this file run as a worker script
  by the port's ``spawn_local``) take a zero1 step on the narrow ResNet
  of ``test_torch_dp.py`` and save; two ranks restore it elastically
  and save; four ranks restore that: the model's fingerprint equal at
  every hop, the optimizer's real elements bit-equal to the first save's
  (JAX's ``test_zero1_elastic_restore_8_to_4_to_8`` at 4 -> 2 -> 4).
  A psum checkpoint restores at another world as it is; the zero1
  restore without the flag raises JAX's pinned error.
- **the launcher**: ``1 4 2 ib --variable_update=zero1`` saves, ``1 2 2
  ib --resume=elastic`` prints the plan and records ``elastic``, and
  the same resume without the flag fails.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_hc_bench_torch import flags, launcher
from tpu_hc_bench_torch.parallel import collectives, distributed
from torch_threads import cpu_share, jax_private_cache  # noqa: F401


# --- the resplit -----------------------------------------------------------


def test_resplit_rows_are_jaxs_bit_for_bit():
    from tpu_hc_bench.parallel import collectives as jax_coll

    rng = np.random.default_rng(1)
    for size in (1, 2, 3, 7, 8, 10, 16, 33, 100, 1001):
        flat = rng.standard_normal(size).astype(np.float32)
        for n_old in (1, 2, 3, 4, 8):
            rows = jax_coll.zero1_resplit_rows(flat, size, n_old)
            for n_new in (1, 2, 3, 4, 8):
                want = jax_coll.zero1_resplit_rows(rows, size, n_new)
                got = collectives.zero1_resplit_rows(rows, size, n_new)
                assert got.dtype == want.dtype and np.array_equal(got,
                                                                  want)
                back = collectives.zero1_resplit_rows(got, size, n_old)
                assert np.array_equal(back, rows)


def _port_shards(stacked: dict, n: int) -> list[dict]:
    """Every rank's SGD ``state_dict`` of its zero1 shards from the
    stacked ``[n, k]`` momentum of each parameter (in ``state_dict``
    order)."""
    return [{"state": {i: {"momentum_buffer": torch.from_numpy(
        np.ascontiguousarray(rows[r]))}
        for i, rows in enumerate(stacked.values())},
        "param_groups": [{"lr": 0.1, "momentum": 0.9,
                          "params": list(range(len(stacked)))}]}
        for r in range(n)]


def test_resplit_opt_of_a_param_shaped_like_its_stack_is_jaxs():
    import jax
    import jax.numpy as jnp
    import optax

    from tpu_hc_bench.train import step as jax_step

    params = {"b": np.arange(5, dtype=np.float32),
              "w": np.arange(128, dtype=np.float32).reshape(8, 16)}
    tx = optax.sgd(0.1, momentum=0.9)
    stacked8 = jax.tree.map(
        lambda p: jax_step._stack_param_shards(jnp.asarray(p), 8), params)
    from tpu_hc_bench.parallel.collectives import zero1_resplit_rows

    opt8 = jax.tree.map(np.asarray, tx.init(stacked8))
    # non-zero traces (zero padding, as a step leaves it), so the bits
    # carry information
    trace = {k: zero1_resplit_rows(np.arange(p.size, dtype=np.float32)
                                   * 0.37 + 1.0, p.size, 8)
             for k, p in params.items()}
    opt8 = (opt8[0]._replace(trace=trace),) + tuple(opt8[1:])
    want4 = jax_step.resplit_zero1_opt(opt8, params, tx, 8, 4)
    traces8 = {k: np.asarray(opt8[0].trace[k]) for k in params}
    traces4 = {k: np.asarray(want4[0].trace[k]) for k in params}
    sizes = [params[k].size for k in params]
    got4 = collectives.resplit_zero1_opt(_port_shards(traces8, 8), sizes, 4)
    assert len(got4) == 4
    for i, k in enumerate(params):
        rows = np.stack([got4[r]["state"][i]["momentum_buffer"].numpy()
                         for r in range(4)])
        assert rows.shape == traces4[k].shape
        assert np.array_equal(rows, traces4[k]), k
    back = collectives.resplit_zero1_opt(got4, sizes, 8)
    for i, k in enumerate(params):
        rows = np.stack([back[r]["state"][i]["momentum_buffer"].numpy()
                         for r in range(8)])
        assert np.array_equal(rows, traces8[k]), k
    same = collectives.resplit_zero1_opt(_port_shards(traces8, 8), sizes, 8)
    for i, k in enumerate(params):
        for r in range(8):
            assert np.array_equal(same[r]["state"][i]["momentum_buffer"],
                                  traces8[k][r])


def test_resplit_keeps_the_scalars():
    shards = [{"state": {0: {"step": torch.tensor(3.0),
                             "exp_avg": torch.full((2,), float(r))}},
               "param_groups": [{"lr": 1e-3, "params": [0]}]}
              for r in range(2)]
    out = collectives.resplit_zero1_opt(shards, [3], 1)
    assert out[0]["state"][0]["step"] == 3.0
    assert out[0]["state"][0]["exp_avg"].tolist() == [0.0, 0.0, 1.0]
    assert out[0]["param_groups"] == shards[0]["param_groups"]


# --- the plan ----------------------------------------------------------------


def _records():
    import jax

    from tpu_hc_bench import flags as jax_flags
    from tpu_hc_bench import topology
    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    devices = jax.devices()
    out = {}
    for arm in ("psum", "zero1"):
        for world in (8, 4):
            lay = topology.compute_layout(1, world, len(devices))
            mesh = topology.build_mesh(lay)
            jcfg = jax_flags.BenchmarkConfig(variable_update=arm).resolve()
            cfg = flags.BenchmarkConfig(device="cpu",
                                        variable_update=arm).resolve()
            out[(arm, world)] = (
                ckpt.topology_record(world, cfg,
                                     mesh=distributed.mesh_shape(world)),
                topology.topology_record(lay, mesh, jcfg))
    return out


def test_topology_record_has_jaxs_mesh():
    from tpu_hc_bench import topology
    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    for (arm, world), (mine, ref) in _records().items():
        assert ref == dict(mine, process_count=ref["process_count"]), (
            arm, world)
        assert ckpt.describe_topology(mine) == \
            topology.describe_topology(dict(
                mine, process_count=ref["process_count"]))
    assert ckpt.describe_topology(None).startswith("unknown")
    cfg = flags.BenchmarkConfig(device="cpu", model="bert_tiny",
                                model_parallel=2).resolve()
    rec = ckpt.topology_record(8, cfg, mesh=distributed.mesh_shape(
        8, model_parallel=2))
    assert rec["mesh"] == {"data": 4, "model": 2}
    assert rec["variable_update"] == "replicated"


def test_elastic_plan_is_jaxs_matrix():
    from tpu_hc_bench import topology
    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    recs = _records()
    t = {k: v[0] for k, v in recs.items()}
    j = {k: v[1] for k, v in recs.items()}

    def both(s_key, l_key, saved=None, live=None):
        s_over, l_over = saved or {}, live or {}
        mine = ckpt.elastic_plan(dict(t[s_key], **s_over),
                                 dict(t[l_key], **l_over))
        ref = topology.elastic_plan(dict(j[s_key], **s_over),
                                    dict(j[l_key], **l_over))
        assert mine == ref, (s_key, l_key, saved, live, mine, ref)
        return mine

    assert both(("psum", 8), ("psum", 8))[0] == "ok"
    action, plan = both(("psum", 8), ("psum", 4))
    assert action == "noop" and "8->4" in plan
    assert both(("psum", 8), ("psum", 4),
                live={"variable_update": "replicated"})[0] == "noop"
    action, plan = both(("zero1", 8), ("zero1", 4))
    assert action == "reshard" and "resplit [8, k]->[4, k']" in plan
    assert both(("zero1", 8), ("psum", 4))[0] == "refuse"
    assert both(("psum", 8), ("zero1", 4))[0] == "refuse"
    assert both(("psum", 8), ("psum", 4),
                saved={"layout": "pp-native", "pipeline_parallel": 4}
                )[0] == "refuse"
    assert both(("psum", 8), ("psum", 4), saved={"layout": "sharded"},
                live={"layout": "sharded"})[0] == "refuse"
    action, plan = both(("psum", 8), ("psum", 4), live={"dtype": "bfloat16"})
    assert action == "noop" and "dtype policy" in plan
    # a TP mesh against plain data parallelism: the host tree re-placed
    action, plan = both(("psum", 4), ("psum", 4),
                        saved={"mesh": {"data": 2, "model": 2},
                               "variable_update": "replicated"})
    assert action == "noop" and "data:2xmodel:2" in plan


# --- the round trip on gloo ranks --------------------------------------------


def _cfg(vu: str) -> flags.BenchmarkConfig:
    from test_torch_zero1 import _cfg as zero1_cfg

    return zero1_cfg(vu)


def _worker(out_dir: str, phase: str) -> None:
    """``save4``: a zero1 step and a psum save at world 4; ``elastic2``:
    the zero1 save restored elastically at world 2, then saved there;
    ``elastic4``: that restored at world 4."""
    assert "jax" not in sys.modules and "tpu_hc_bench" not in sys.modules
    from test_torch_dp import _batch, _init_state
    from test_torch_zero1 import _state

    from tpu_hc_bench_torch.train import step as step_mod
    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    worker = distributed.worker_from_env()
    rank, world = worker.rank, worker.world_size
    distributed.init_group("gloo", worker)
    base = Path(out_dir)
    try:
        cfg = _cfg("zero1")
        topo = ckpt.topology_record(world, cfg)
        out = {}
        if phase == "save4":
            state = _state(cfg, _init_state())
            state, _ = step_mod.train_step(state, _batch(rank))
            ckpt.save(state, base / "z4", topology=topo, write=rank == 0)
            pcfg = _cfg("psum")
            pstate = _state(pcfg, _init_state())
            pstate, _ = step_mod.train_step(pstate, _batch(rank))
            ckpt.save(pstate, base / "p4", write=rank == 0,
                      topology=ckpt.topology_record(world, pcfg))
            pstate.dp.grads.close()
        else:
            src = base / ("z4" if phase == "elastic2" else "z2")
            saved = ckpt.read_topology(src)
            state = _state(cfg, {k: torch.zeros_like(v) for k, v in
                                 _init_state().items()})
            if phase == "elastic2":
                with pytest.raises(ckpt.TopologyMismatchError) as e:
                    ckpt.restore(state, src, expect_topology=topo)
                out["refused"] = str(e.value)
            action, plan = ckpt.check_topology(saved, topo, src,
                                               elastic=True)
            ckpt.restore_elastic(state, src, saved, world, rank=rank)
            out["plan"] = (action, plan)
            if phase == "elastic2":
                ckpt.save(state, base / "z2", topology=topo,
                          write=rank == 0)
        out["fingerprint"] = ckpt.fingerprint(state.model.state_dict())
        out["optimizer"] = state.optimizer.state_dict()
        out["step"] = state.step
        state.dp.grads.close()
        torch.save(out, base / f"{phase}.rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(out_dir: Path, phase: str, world: int) -> list[dict]:
    workers = [distributed.Worker(r, r, world,
                                  f"file://{out_dir}/store_{phase}")
               for r in range(world)]
    rc = distributed.spawn_local(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         str(out_dir), phase], workers, print)
    assert rc == 0
    return [torch.load(out_dir / f"{phase}.rank{r}.pt")
            for r in range(world)]


@pytest.fixture(scope="module")
def round_trip(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("elastic")
    return {"save4": _spawn(out_dir, "save4", 4),
            "elastic2": _spawn(out_dir, "elastic2", 2),
            "elastic4": _spawn(out_dir, "elastic4", 4)}, out_dir


def _real_elements(ranks: list[dict], sizes: list[int]) -> list[np.ndarray]:
    """Each parameter's momentum, its shards concatenated over the ranks
    and cut to its real elements."""
    return [np.concatenate([r["optimizer"]["state"][i]["momentum_buffer"]
                            .numpy() for r in ranks])[:n]
            for i, n in enumerate(sizes)]


def test_zero1_elastic_round_trip_4_to_2_to_4(round_trip):
    from test_torch_dp import _narrow_port

    runs, _ = round_trip
    sizes = [p.numel() for p in _narrow_port().parameters()]
    want = _real_elements(runs["save4"], sizes)
    fp = runs["save4"][0]["fingerprint"]
    for phase, world in (("elastic2", 2), ("elastic4", 4)):
        ranks = runs[phase]
        assert len(ranks) == world
        for r in ranks:
            assert r["fingerprint"] == fp, phase
            assert r["step"] == 1
            assert r["plan"][0] == "reshard"
            old = 4 if phase == "elastic2" else 2
            assert f"resplit [{old}, k]->[{world}, k']" in r["plan"][1]
            for i, n in enumerate(sizes):
                k = collectives.zero1_shard_len(n, world)
                assert r["optimizer"]["state"][i]["momentum_buffer"] \
                    .shape == (k,)
        for got, ref in zip(_real_elements(ranks, sizes), want):
            assert np.array_equal(got, ref), phase
    # 4 -> 2 -> 4 lands on the first save's shards, padding included
    for a, b in zip(runs["elastic4"], runs["save4"]):
        for i in range(len(sizes)):
            assert torch.equal(a["optimizer"]["state"][i]["momentum_buffer"],
                               b["optimizer"]["state"][i]["momentum_buffer"])


def test_zero1_restore_without_the_flag_raises_jaxs_error(round_trip):
    runs, _ = round_trip
    msg = runs["elastic2"][0]["refused"]
    import re

    assert re.search(r"checkpoint topology mismatch.*saved world=4 "
                     r".*vs live world=2 .*--resume=elastic", msg), msg


def test_psum_checkpoint_is_world_neutral(round_trip):
    from test_torch_dp import _init_state
    from test_torch_zero1 import _state

    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    _, out_dir = round_trip
    _, payload = ckpt.load_payload(out_dir / "p4")
    distributed.init_single("gloo")
    try:
        cfg = _cfg("psum")
        state = _state(cfg, {k: torch.zeros_like(v) for k, v in
                             _init_state().items()})
        saved = ckpt.read_topology(out_dir / "p4")
        action, plan = ckpt.check_topology(saved,
                                           ckpt.topology_record(1, cfg))
        assert action == "noop" and "world 4->1" in plan
        ckpt.restore(state, out_dir / "p4",
                     expect_topology=ckpt.topology_record(1, cfg))
        assert ckpt.fingerprint(state.model.state_dict()) == \
            ckpt.fingerprint(payload["model"])
        assert ckpt.fingerprint(state.optimizer.state_dict()["state"]) == \
            ckpt.fingerprint(payload["optimizer"]["state"])
        state.dp.grads.close()
    finally:
        dist.destroy_process_group()


# --- flags and the launcher --------------------------------------------------


def test_elastic_flag_needs_a_train_dir():
    with pytest.raises(ValueError, match="--resume=elastic needs "
                                         "--train_dir"):
        flags.parse_benchmark_flags(["--device=cpu", "--resume=elastic"])
    cfg = flags.parse_benchmark_flags(["--device=cpu", "--resume=elastic",
                                       "--train_dir=/tmp/x"])
    assert cfg.resume == "elastic"


def _launch(workers: int, *extra: str) -> tuple[int, list[str]]:
    lines: list[str] = []
    rc = launcher.main(["1", str(workers), "2", "ib",
                        "--model=resnet20_cifar", "--device=cpu",
                        "--variable_update=zero1", "--num_warmup_batches=1",
                        "--num_batches=1", "--display_every=1", *extra],
                       print_fn=lines.append)
    return rc, lines


def test_launcher_resumes_elastic_at_another_world(tmp_path):
    d = str(tmp_path / "run")
    rc, lines = _launch(4, f"--train_dir={d}")
    assert rc == 0
    saved_fp = json.loads([ln for ln in lines if ln.startswith("{")][-1])[
        "checkpoint"]["fingerprint"]
    rc, lines = _launch(2, f"--train_dir={d}")
    assert rc != 0                          # zero1 at 2 without the flag
    rc, lines = _launch(2, f"--train_dir={d}", "--resume=elastic")
    assert rc == 0
    assert any("elastic resume: zero1 optimizer shards resplit "
               "[4, k]->[2, k']" in ln for ln in lines)
    assert f"state fingerprint: {saved_fp}" in lines
    res = json.loads([ln for ln in lines if ln.startswith("{")][-1])
    assert res["resume"]["elastic"] is True
    assert (res["resume"]["saved_world"], res["resume"]["live_world"]) == (
        4, 2)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2], sys.argv[3])
