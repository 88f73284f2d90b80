"""The port's ``--variable_update=zero1`` on the CPU (gloo; no card here).

JAX's own zero1 test fails (``tests/test_zero1.py::
test_zero1_matches_psum_bitwise``), so JAX's zero1 step is no oracle:
the arm is held against the port's own ``psum`` arm, and its layout
against JAX's layout functions.

- **layout**: ``zero1_shard_len`` and ``leaf_to_rows`` against JAX's
  ``zero1_shard_len`` and ``_leaf_to_rows`` bit for bit; at world 4
  ``reduce_scatter_tree`` and ``all_gather_tree`` (a 64-byte threshold:
  several buckets, float32 and bfloat16 tensors of sizes that do not
  divide by 4) against JAX's under ``shard_map`` over 4 virtual devices,
  bit for bit (integer-valued inputs: every order of the sums is exact,
  so what is held is the layout).
- **the step**: four gloo ranks (this file run as a worker script by
  the port's own ``spawn_local``), the narrow ResNet of
  ``test_torch_dp.py`` (BatchNorm statistics through the fused buckets)
  two steps from seeded weights, zero1 against psum: momentum with
  overlap on and off, accumulation 2 (float32 and the bf16
  accumulator), and rmsprop (optax's, a slot a parameter); the losses
  within ``LOSS_RTOL`` and every parameter and statistic within
  ``PARAM_TOL`` of its scale (``test_torch_train.py``'s), every rank's
  state bit-equal to rank 0's.  The two arms sum the gradients in other
  orders (a reduce-scatter a bucket against an all-reduce), so they are
  not bit-equal at world 4; Adam, whose first steps are ``lr * g / (|g|
  + eps)``, turns a last-bit difference of a gradient near 0 into one of
  up to ``2 lr`` (8e-4 at lr 1e-3 measured), so it is held at world 1,
  where every collective is a copy and the arms are bit-equal, with
  momentum, through the launcher.
- **memory**: each rank's optimizer state is its shards' only, about
  1/4 of psum's.
- **the guard**: the squared gradient norm summed over the ranks' shards
  equals psum's full norm, and ``--on_nonfinite=skip`` drops a step
  whose NaN sits on one rank only on every rank.
- **checkpoints**: a zero1 save at step 1 restored into fresh states at
  the same world steps on bit-equal to the unbroken run; at another
  world, or on psum, the restore is refused.
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

WORLD = 4
THRESHOLD = 4096                       # several buckets in the narrow net
TREE_THRESHOLD = 64
# arm -> the step's flags (zero1 and psum run each)
ARMS = {"momentum": {}, "overlap_off": dict(overlap_grad_comm="off"),
        "accum2": dict(gradient_accumulation_steps=2),
        "accum2_bf16": dict(gradient_accumulation_steps=2,
                            accum_dtype="bf16"),
        "rmsprop": dict(optimizer="rmsprop")}
# the layout cases: (shape, dtype) of each tensor of the tree
TREE = (((3, 5), np.float32), ((7,), np.float32), ((2, 2, 3), "bfloat16"),
        ((1,), np.float32), ((33,), np.float32), ((4, 4), "bfloat16"))


def _cfg(variable_update: str, **kw) -> flags.BenchmarkConfig:
    """``test_torch_dp.py``'s step flags (momentum at lr 0.01, 2 images
    a rank) with ``kw`` over them."""
    kw = {"optimizer": "momentum", "init_learning_rate": 0.01, **kw}
    return flags.BenchmarkConfig(
        batch_size=2, momentum=0.9, device="cpu",
        variable_update=variable_update, fusion_threshold_bytes=THRESHOLD,
        **kw).resolve()


def _tree(rank: int) -> list[torch.Tensor]:
    """Rank ``rank``'s integer-valued tree."""
    rng = np.random.default_rng(40)
    out = []
    for shape, dtype in TREE:
        a = rng.integers(-8, 8, shape).astype(np.float32) + rank
        t = torch.from_numpy(a)
        out.append(t.to(torch.bfloat16) if dtype == "bfloat16" else t)
    return out


def _state(cfg, init):
    from test_torch_dp import _narrow_port

    from tpu_hc_bench_torch.parallel.fabric import Fabric
    from tpu_hc_bench_torch.train import step as step_mod

    model = _narrow_port()
    model.load_state_dict(init)
    return step_mod.make_train_state(model, cfg, Fabric.ICI)


def _worker(out_dir: str) -> None:
    """One rank: the layout functions, every arm zero1 and psum, the
    guard and the checkpoint round trip."""
    assert "jax" not in sys.modules and "tpu_hc_bench" not in sys.modules
    from test_torch_dp import _batch, _init_state

    from tpu_hc_bench_torch.train import step as step_mod
    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    worker = distributed.worker_from_env()
    rank = worker.rank
    distributed.init_group("gloo", worker)
    try:
        out = {}
        tree = _tree(rank)
        shards = collectives.reduce_scatter_tree(tree, None, TREE_THRESHOLD)
        out["tree"] = {"shards": shards, "gathered":
                       collectives.all_gather_tree(shards, tree, None,
                                                   TREE_THRESHOLD)}
        init = _init_state()
        batch = _batch(rank)
        for arm, kw in ARMS.items():
            for vu in ("psum", "zero1"):
                state = _state(_cfg(vu, **kw), init)
                losses = []
                for _ in range(2):
                    state, metrics = step_mod.train_step(state, batch)
                    losses.append(float(metrics["loss"]))
                grads = state.dp.grads
                rec = {"losses": losses,
                       "state": state.model.state_dict(),
                       "opt_bytes": step_mod.optimizer_state_bytes(
                           state.optimizer),
                       "calls": state.dp.allreduce_calls}
                if arm == "momentum":
                    rec["grad_sq"] = float(
                        grads.grad_sq_sum() if vu == "zero1" else sum(
                            (p.grad.double() ** 2).sum()
                            for p in state.model.parameters()))
                grads.close()
                out[f"{vu}_{arm}"] = rec
        # the guard: a NaN in rank 2's images only
        state = _state(_cfg("zero1", on_nonfinite="skip"), init)
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        bad = (batch[0].clone(), batch[1])
        if rank == 2:
            bad[0][0, 0, 0, 0] = float("nan")
        state, metrics = step_mod.train_step(state, bad)
        out["skip"] = {"nonfinite": int(metrics["nonfinite"]),
                       "unchanged": all(torch.equal(v, before[k]) for k, v
                                        in state.model.state_dict().items())}
        state.dp.grads.close()
        # checkpoints: save at step 1, restore into a fresh state, step
        cfg = _cfg("zero1")
        topo = ckpt.topology_record(WORLD, cfg)
        state = _state(cfg, init)
        state, _ = step_mod.train_step(state, batch)
        ckpt.save(state, Path(out_dir) / "ckpt", topology=topo,
                  write=rank == 0)
        dist.barrier()
        state.dp.grads.close()
        fresh = _state(cfg, {k: torch.zeros_like(v)
                             for k, v in init.items()})
        ckpt.restore(fresh, Path(out_dir) / "ckpt", expect_topology=topo,
                     rank=rank)
        fresh, _ = step_mod.train_step(fresh, batch)
        out["resumed"] = fresh.model.state_dict()
        fresh.dp.grads.close()
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def zero1_runs(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("zero1")
    workers = [distributed.Worker(r, r, WORLD, f"file://{out_dir}/store")
               for r in range(WORLD)]
    rc = distributed.spawn_local(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         str(out_dir)], workers, print)
    assert rc == 0
    return [torch.load(out_dir / f"rank{r}.pt") for r in range(WORLD)], \
        out_dir


# --- layout ------------------------------------------------------------------


def test_shard_len_and_rows_are_jaxs_bit_for_bit():
    import jax.numpy as jnp

    from tpu_hc_bench.parallel import collectives as jax_coll

    rng = np.random.default_rng(0)
    for size in (1, 3, 4, 7, 8, 13, 100, 1001):
        for n in (1, 2, 3, 4, 8):
            assert collectives.zero1_shard_len(size, n) == \
                jax_coll.zero1_shard_len(size, n)
            a = rng.standard_normal(size).astype(np.float32).reshape(
                (size,) if size % 2 else (2, size // 2))
            want = np.asarray(jax_coll._leaf_to_rows(jnp.asarray(a), n,
                                                     jnp.float32))
            got = collectives.leaf_to_rows(torch.from_numpy(a), n).numpy()
            assert got.shape == want.shape and np.array_equal(got, want)


def _jax_tree_pair():
    """JAX's reduce-scatter and all-gather of the four ranks' trees under
    ``shard_map`` over 4 virtual devices: each device's shards and the
    gathered tree."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from tpu_hc_bench.parallel import collectives as jax_coll
    from tpu_hc_bench.topology import DATA_AXIS

    def to_jax(t):
        a = t.float().numpy()
        return jnp.asarray(a, jnp.bfloat16 if t.dtype == torch.bfloat16
                           else jnp.float32)

    stacked = [jnp.stack([to_jax(_tree(r)[i]) for r in range(WORLD)])
               for i in range(len(TREE))]
    mesh = Mesh(np.array(jax.devices()[:WORLD]), (DATA_AXIS,))

    def body(*leaves):
        local = [x[0] for x in leaves]
        shards = jax_coll.reduce_scatter_tree(
            local, axis_name=DATA_AXIS, threshold_bytes=TREE_THRESHOLD)
        full = jax_coll.all_gather_tree(shards, local, axis_name=DATA_AXIS,
                                        threshold_bytes=TREE_THRESHOLD)
        return [s[None] for s in shards], [f[None] for f in full]

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=tuple(P(DATA_AXIS) for _ in TREE),
        out_specs=P(DATA_AXIS), check_vma=False))
    shards, full = fn(*stacked)
    return ([np.asarray(s.astype(jnp.float32)) for s in shards],
            [np.asarray(f.astype(jnp.float32)) for f in full])


def test_reduce_scatter_and_all_gather_trees_are_jaxs(zero1_runs):
    port, _ = zero1_runs
    shards, full = _jax_tree_pair()
    for r in range(WORLD):
        got = port[r]["tree"]
        for i, (t, (_, dtype)) in enumerate(zip(got["shards"], TREE)):
            assert t.dtype == (torch.bfloat16 if dtype == "bfloat16"
                               else torch.float32)
            assert np.array_equal(t.float().numpy(), shards[i][r]), (r, i)
            assert np.array_equal(got["gathered"][i].float().numpy(),
                                  full[i][r]), (r, i)


# --- the step ------------------------------------------------------------------


@pytest.mark.parametrize("arm", list(ARMS))
def test_zero1_matches_psum_at_world_4(zero1_runs, arm):
    from test_torch_dp import _close
    from test_torch_train import LOSS_RTOL, PARAM_TOL

    port, _ = zero1_runs
    got, want = port[0][f"zero1_{arm}"], port[0][f"psum_{arm}"]
    for i, (a, b) in enumerate(zip(got["losses"], want["losses"])):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (arm, i, a, b)
    for name, t in got["state"].items():
        _close(t, want["state"][name], PARAM_TOL, f"{arm} {name}")
    for r in range(1, WORLD):
        mine = port[r][f"zero1_{arm}"]
        assert mine["losses"] == got["losses"], (arm, r)
        for name, t in mine["state"].items():
            assert torch.equal(t, got["state"][name]), (arm, r, name)


def test_optimizer_state_is_a_quarter_a_rank(zero1_runs):
    from test_torch_dp import _narrow_port

    port, _ = zero1_runs
    params = list(_narrow_port().parameters())
    padded = sum(WORLD * collectives.zero1_shard_len(p.numel(), WORLD)
                 for p in params)
    for arm in ("momentum", "rmsprop"):
        psum = port[0][f"psum_{arm}"]["opt_bytes"]
        for r in range(WORLD):
            mine = port[r][f"zero1_{arm}"]["opt_bytes"]
            # the momentum trace, or rmsprop's nu, over this rank's
            # shards
            assert mine < psum / WORLD * 1.05, (arm, r, mine, psum)
            assert mine >= psum / WORLD * sum(p.numel() for p in params) \
                / padded * 0.95, (arm, r, mine, psum)
    # an all-gather a gradient bucket on top of psum's calls (its
    # reduce-scatters stand where psum's all-reduces do)
    buckets = len(collectives.plan_buckets(params, THRESHOLD))
    assert buckets > 1
    assert port[0]["zero1_momentum"]["calls"] == \
        port[0]["psum_momentum"]["calls"] + buckets


def test_guard_sees_the_whole_gradient_on_every_rank(zero1_runs):
    port, _ = zero1_runs
    want = port[0]["psum_momentum"]["grad_sq"]
    for r in range(WORLD):
        assert port[r]["zero1_momentum"]["grad_sq"] == pytest.approx(
            want, rel=1e-5)
        assert port[r]["skip"] == {"nonfinite": 1, "unchanged": True}, r


def test_checkpoint_round_trip_at_the_same_world(zero1_runs):
    port, _ = zero1_runs
    for r in range(WORLD):
        for name, t in port[r]["resumed"].items():
            assert torch.equal(t, port[0]["zero1_momentum"]["state"][name]), \
                (r, name)


def test_checkpoint_refused_at_another_world_and_arm(zero1_runs):
    from test_torch_dp import _init_state

    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    _, out_dir = zero1_runs
    saved = ckpt.read_topology(out_dir / "ckpt")
    assert (saved["world"], saved["variable_update"]) == (WORLD, "zero1")
    distributed.init_single("gloo")
    try:
        for vu, match in (("zero1", "relaunch with --resume=elastic"),
                          ("psum", "zero1 optimizer-state tree")):
            cfg = _cfg(vu)
            state = _state(cfg, _init_state())
            with pytest.raises(ckpt.TopologyMismatchError, match=match):
                ckpt.restore(state, out_dir / "ckpt",
                             expect_topology=ckpt.topology_record(1, cfg))
            state.dp.grads.close()
        # --resume=elastic resplits the four ranks' shards for world 1
        state = _state(_cfg("zero1"), _init_state())
        ckpt.restore_elastic(state, out_dir / "ckpt", saved, 1)
        _, payload = ckpt.load_payload(out_dir / "ckpt")
        assert ckpt.fingerprint(state.model.state_dict()) == \
            ckpt.fingerprint(payload["model"])
        shards = payload["optimizer"]["zero1_shards"]
        for i, p in enumerate(state.dp.grads.params):
            got = state.optimizer.state_dict()["state"][i]
            want = torch.cat([s["state"][i]["momentum_buffer"]
                              for s in shards])[:p.numel()]
            assert torch.equal(got["momentum_buffer"], want), i
        state.dp.grads.close()
    finally:
        dist.destroy_process_group()


# --- flags and the launcher ------------------------------------------------------


@pytest.mark.parametrize("argv,match", [
    (["--variable_update=zero1", "--sequence_parallel=2"],
     "plain data parallelism only"),
    (["--variable_update=zero1", "--attention_impl=ring"],
     "plain data parallelism only"),
    (["--variable_update=zero1", "--forward_only=true"],
     "forward-only runs have none"),
])
def test_zero1_flag_refusals(argv, match):
    with pytest.raises(ValueError, match=match):
        flags.parse_benchmark_flags(["--device=cpu"] + argv)


def test_zero1_refuses_the_host_fabric_and_no_group():
    from test_torch_dp import _init_state

    with pytest.raises(ValueError, match="needs a device fabric"):
        launcher.main(["1", "1", "2", "sock", "--model=trivial",
                       "--device=cpu", "--variable_update=zero1"])
    with pytest.raises(ValueError, match="there is none"):
        from tpu_hc_bench_torch.train import step as step_mod
        from test_torch_dp import _narrow_port

        model = _narrow_port()
        model.load_state_dict(_init_state())
        step_mod.make_train_state(model, _cfg("zero1"), None)


@pytest.mark.parametrize("optimizer", ["momentum", "adam"])
def test_zero1_launcher_world1_is_bit_equal_to_psum(optimizer):
    """``1 1 2 ib``: a one-rank group, where the shards are the whole
    parameters and every collective a copy; the losses equal psum's, and
    the optimizer bytes too."""
    res = {}
    for vu in ("psum", "zero1"):
        lines: list[str] = []
        assert launcher.main(
            ["1", "1", "2", "ib", "--model=resnet20_cifar", "--device=cpu",
             f"--variable_update={vu}", f"--optimizer={optimizer}",
             "--num_warmup_batches=1", "--num_batches=2",
             "--display_every=1"], print_fn=lines.append) == 0
        res[vu] = json.loads(lines[-1]), [ln for ln in lines
                                          if "\tloss: " in ln]
    (z, zl), (p, pl) = res["zero1"], res["psum"]
    assert z["variable_update"] == "zero1" and len(zl) == 2
    assert [ln[ln.index("\tloss"):] for ln in zl] == \
        [ln[ln.index("\tloss"):] for ln in pl]
    assert z["final_loss"] == p["final_loss"]
    assert z["optimizer_state_bytes"] == p["optimizer_state_bytes"]


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
