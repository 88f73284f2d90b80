"""The port's multislice layout (``fabric=dcn``, ``--num_slices``)
against the JAX package, on the CPU (gloo; no card here).

- **the mesh**: ``distributed.mesh_shape`` against JAX's
  ``topology.build_mesh`` on the conftest's virtual devices (a leading
  ``dcn`` axis splitting the data axis; the minor axes after it), and
  JAX's errors word for word.
- **the hierarchical all-reduce**: on four gloo ranks (this file run as
  a worker script by the port's ``spawn_local``) at 2 slices of 2, the
  three steps (reduce-scatter in the slice, all-reduce across slices,
  all-gather in the slice) of buffers whose sizes do not divide by the
  slice (integer values: every order of the sums is exact) equal the
  flat all-reduce bit for bit, async (the buckets' hooks) too.
- **the step**: the narrow ResNet of ``test_torch_dp.py`` (several
  gradient buckets, BatchNorm statistics through the fused buckets) two
  steps under ``dcn`` at 2 slices against the flat ``ib`` step, and
  ``replicated`` (sync-BN's sums hierarchical) against its flat form:
  the losses within JAX's ``rtol=1e-5``, every parameter within
  ``PARAM_TOL``, every rank's state equal to rank 0's.
- **the launcher**: ``1 4 2 dcn --num_slices=2`` against ``1 4 2 ib``
  (the final loss within ``rtol=1e-5``, JAX's banner ``dcn(2) x
  data(2)``), the eval arm's top-1 and loss against ``ib``'s, one host
  with no ``--num_slices`` degenerating to one slice, and JAX's guards.
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

WORLD, SLICES = 4, 2
SIZES = (1, 3, 7, 64, 129)             # flat buffers; none divides by 4


# --- the mesh ----------------------------------------------------------------


@pytest.mark.parametrize("world,hosts,kw", [
    (8, 1, dict(num_slices=2)), (8, 1, dict(num_slices=4)),
    (8, 1, dict(num_slices=8)), (8, 1, dict()),
    (8, 1, dict(sequence_parallel=2)), (8, 1, dict(model_parallel=4)),
    (8, 1, dict(num_slices=2, model_parallel=2)),
    (4, 1, dict(num_slices=1))])
def test_mesh_shape_is_jaxs(world, hosts, kw):
    import jax

    from tpu_hc_bench import topology

    layout = topology.compute_layout(hosts, world // hosts,
                                     world // hosts)
    devices = jax.devices()[:world]
    want = dict(topology.build_mesh(layout, devices, **kw).shape)
    got = distributed.mesh_shape(world, num_hosts=hosts, **kw)
    assert list(got.items()) == list(want.items())


@pytest.mark.parametrize("world,hosts,kw", [
    (8, 1, dict(num_slices=3)), (8, 2, dict(num_slices=3)),
    (8, 1, dict(model_parallel=3)), (8, 1, dict(num_slices=0)),
    (8, 1, dict(model_parallel=0)),
    (8, 1, dict(num_slices=8, model_parallel=2))])
def test_mesh_errors_are_jaxs(world, hosts, kw):
    import jax

    from tpu_hc_bench import topology

    layout = topology.compute_layout(hosts, world // hosts,
                                     world // hosts)
    with pytest.raises(ValueError) as want:
        topology.build_mesh(layout, jax.devices()[:world], **kw)
    with pytest.raises(ValueError) as got:
        distributed.mesh_shape(world, num_hosts=hosts, **kw)
    assert str(got.value) == str(want.value)


# --- the worker: the all-reduce and the step ---------------------------------


def _cfg(vu: str) -> flags.BenchmarkConfig:
    from test_torch_zero1 import _cfg as zero1_cfg

    return zero1_cfg(vu)


def _worker(out_dir: str) -> None:
    assert "jax" not in sys.modules and "tpu_hc_bench" not in sys.modules
    from test_torch_dp import _batch, _init_state, _narrow_port

    from tpu_hc_bench_torch.parallel.fabric import Fabric
    from tpu_hc_bench_torch.train import step as step_mod

    worker = distributed.worker_from_env()
    rank = worker.rank
    distributed.init_group("gloo", worker)
    try:
        mesh = distributed.build_mesh(num_slices=SLICES,
                                      force_seq_axis=False)
        out = {"mesh": (mesh.dp, mesh.num_slices, mesh.data_index,
                        mesh.hier.slice_size, mesh.shape)}
        sums = {}
        for size in SIZES:
            x = torch.arange(size, dtype=torch.float32) * (rank + 1) + rank
            flat, hier, work = x.clone(), x.clone(), x.clone()
            dist.all_reduce(flat)
            collectives.all_reduce_(hier, hier=mesh.hier)
            collectives.all_reduce_(work, hier=mesh.hier,
                                    async_op=True).wait()
            sums[size] = (flat, hier, work)
        out["sums"] = sums
        init, batch = _init_state(), _batch(rank)
        for vu in ("psum", "replicated"):
            for fabric, m in (("ib", None), ("dcn", mesh)):
                model = _narrow_port()
                model.load_state_dict(init)
                state = step_mod.make_train_state(
                    model, _cfg(vu), Fabric.DCN if m else Fabric.ICI, m)
                losses = []
                for _ in range(2):
                    state, metrics = step_mod.train_step(state, batch)
                    losses.append(float(metrics["loss"]))
                out[f"{vu}_{fabric}"] = {"losses": losses,
                                         "state": model.state_dict(),
                                         "calls": state.dp.allreduce_calls}
                state.dp.grads.close()
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def slices(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("multislice")
    workers = [distributed.Worker(r, r, WORLD, f"file://{out_dir}/store")
               for r in range(WORLD)]
    rc = distributed.spawn_local(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         str(out_dir)], workers, print)
    assert rc == 0
    return [torch.load(out_dir / f"rank{r}.pt") for r in range(WORLD)]


def test_worker_mesh_is_two_slices_of_two(slices):
    for r, out in enumerate(slices):
        dp, n, data_index, slice_size, shape = out["mesh"]
        assert (dp, n, data_index, slice_size) == (WORLD, SLICES, r, 2)
        assert list(shape.items()) == [("dcn", 2), ("data", 2),
                                       ("model", 1)]


@pytest.mark.parametrize("size", SIZES)
def test_hierarchical_all_reduce_is_the_flat_sum(slices, size):
    for out in slices:
        flat, hier, work = out["sums"][size]
        assert torch.equal(hier, flat) and torch.equal(work, flat)


@pytest.mark.parametrize("vu", ["psum", "replicated"])
def test_dcn_step_matches_ib(slices, vu):
    from test_torch_dp import _close
    from test_torch_train import PARAM_TOL

    got, want = slices[0][f"{vu}_dcn"], slices[0][f"{vu}_ib"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for k, t in got["state"].items():
        _close(t, want["state"][k], PARAM_TOL, f"{vu} {k}")
    assert got["calls"] == want["calls"]
    for r in range(1, WORLD):
        for k, t in slices[r][f"{vu}_dcn"]["state"].items():
            assert torch.equal(t, got["state"][k]), (vu, r, k)


# --- the launcher ------------------------------------------------------------


def _launch(fabric: str, *extra: str) -> tuple[dict, list[str]]:
    lines: list[str] = []
    rc = launcher.main(["1", str(WORLD), "2", fabric,
                        "--model=resnet20_cifar", "--device=cpu",
                        "--num_warmup_batches=1", "--num_batches=2",
                        "--display_every=1", *extra],
                       print_fn=lines.append)
    assert rc == 0, lines[-5:]
    return json.loads([ln for ln in lines if ln.startswith("{")][-1]), lines


def test_launcher_dcn_two_slices_matches_ib():
    ib, _ = _launch("ib")
    dcn, lines = _launch("dcn", "--num_slices=2")
    assert any(ln.startswith("multislice: 2 slices x virtual slices on 1 "
                             "host(s) — data axis = dcn(2) x data(2)")
               for ln in lines)
    assert (dcn["num_slices"], dcn["fabric"]) == (2, "dcn")
    assert dcn["global_batch"] == ib["global_batch"] == 8
    np.testing.assert_allclose(dcn["final_loss"], ib["final_loss"],
                               rtol=1e-5)
    one, lines = _launch("dcn")            # one host: one slice
    assert one["num_slices"] == 1
    assert not any(ln.startswith("multislice") for ln in lines)
    np.testing.assert_allclose(one["final_loss"], ib["final_loss"],
                               rtol=1e-5)


def test_eval_under_multislice_matches_ib(tmp_path):
    d = str(tmp_path / "run")
    _launch("ib", f"--train_dir={d}")
    ev = {}
    for fabric, extra in (("ib", ()), ("dcn", ("--num_slices=2",))):
        res, lines = _launch(fabric, f"--train_dir={d}", "--eval=true",
                             *extra)
        ev[fabric] = (res, [ln for ln in lines
                            if ln.startswith("eval top_1 accuracy")][0])
    assert ev["dcn"][1] == ev["ib"][1]
    np.testing.assert_allclose(ev["dcn"][0]["final_loss"],
                               ev["ib"][0]["final_loss"], rtol=1e-5)
    assert ev["dcn"][0]["num_slices"] == 2


@pytest.mark.parametrize("fabric,kw,match", [
    ("ib", dict(num_slices=2), "--num_slices requires fabric=dcn"),
    ("sock", dict(num_slices=2), "--num_slices requires fabric=dcn"),
    ("dcn", dict(num_slices=2, model_parallel=2, model="bert_tiny"),
     "fabric=dcn multislice currently composes with data parallelism "
     "only"),
    ("dcn", dict(num_slices=2, variable_update="zero1"),
     "single-slice data parallelism only"),
    ("dcn", dict(num_slices=3), "data degree 4 not divisible by "
                                "num_slices=3")])
def test_multislice_guards(fabric, kw, match):
    from tpu_hc_bench_torch.parallel.fabric import resolve_fabric
    from tpu_hc_bench_torch.train import driver

    cfg = flags.BenchmarkConfig(device="cpu", **kw).resolve()
    with pytest.raises(ValueError, match=match):
        if "num_slices=3" in match:
            distributed.mesh_shape(WORLD, num_slices=3)
        driver._mesh(cfg, resolve_fabric(fabric), True, WORLD, 1)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
