"""The port's data-parallel training path against the JAX package, on the
CPU (gloo; no card here).

- **buckets**: ``collectives.flatten_to_buckets`` returns JAX's
  ``_flatten_to_buckets`` index lists on the same size and dtype lists
  (mixed float32/bfloat16, a tensor over the threshold, the narrow
  ResNet's parameters), at thresholds 0, 1, 4096 and 1<<27, in both
  orders.
- **the step**: four gloo ranks (this file run as a worker script by the
  port's own spawn, ``FileStore`` under ``tmp_path``) against JAX
  ``build_train_step`` on a 4-device mesh of the conftest's 8 CPU
  devices: the narrow bottleneck ResNet ``[1,1,1,1]`` (8 filters, 10
  classes; ``test_torch_train.py``'s ``_narrow``, built at 32x32) with
  weights from ``convert.resnet_variables_from_flax``, two momentum-SGD
  steps at the lane's default learning rate (0.01) on
  ``SyntheticImages(8, (64, 64, 3), 10)``, 2 images a rank (1 a
  microbatch under accumulation).  The images are 64x64, not 32x32:
  at 32x32 JAX's own two steps move by over 10x the tolerance when the
  weights move one float32 ulp, and at 64x64 by under a tenth of it
  (``test_step_conditioning_at_the_image_sizes``).
  The learning rate is the lane's default, 0.01: at
  ``test_torch_train.py``'s 0.05 the accumulation arm misses JAX's by
  11x the tolerance at seed 3, because after the first step one ReLU
  input of one one-image microbatch sits within rounding of 0, positive
  on one side and negative on the other; the step with no accumulation
  on the same microbatches misses by as much, and on each side the two
  agree within the tolerance
  (``test_accumulation_miss_at_lr_005_is_a_relu_kink``).
  Arms: ``psum`` with overlap on and off (several buckets: a 4096-byte
  threshold on both sides), ``replicated``, accumulation 2 and the host
  arm.  ``replicated`` (one all-reduce a tensor, and sync-BN: every
  BatchNorm all-reduces its per-channel sum, sum of squares and count)
  is held against JAX's own ``replicated`` arm, ``_build_gspmd_step``,
  GSPMD over the global batch, with ``--fused_conv`` false and true
  (the fused block's three BatchNorm routes).  On batches whose ranks
  differ clearly in their statistics (each rank's images scaled and
  shifted by its rank: the ``_skewed`` arms) ``replicated`` still
  matches GSPMD, ``psum`` still matches JAX's per-worker psum arm, and
  the two part by far more than the tolerance.  Checks: the loss
  of each step within 1e-4 relative, every parameter and BN running
  statistic within 1e-4 of its scale (``test_torch_train.py``'s
  ``LOSS_RTOL`` and ``PARAM_TOL``), and every rank's state bit-equal to
  rank 0's.
- **world 1**: the fast arm in a one-rank gloo group is bit-equal to
  the one-worker step, overlap on and off; the hooks launch the buckets
  during the backward only with overlap on.
- **the launcher** at world 4 on the CPU (``1 4 2 ib|sock``, bert_tiny
  with flash and the fused xent's plain versions), the spawn's failure
  path, four workers building the kernels at once (one compiles), the
  flags and the hostfile contract.
- **OSU**: a world-4 gloo sweep of every op; the busbw factors against
  JAX's ``_busbw_factor``.

JAX is imported inside the test functions only: the workers run this
file and import nothing of JAX (they check it).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_hc_bench_torch import flags, launcher
from tpu_hc_bench_torch.data.synthetic import (SyntheticImages, rank_rows,
                                               to_device)
from tpu_hc_bench_torch.microbench import osu
from tpu_hc_bench_torch.models import resnet
from tpu_hc_bench_torch.parallel import collectives, distributed
from tpu_hc_bench_torch.parallel.fabric import Fabric, resolve_fabric
from tpu_hc_bench_torch.train import step as step_mod
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

WORLD = 4
PER_RANK = 2                           # the step's images a rank
IMAGE = (64, 64, 3)
LAUNCH_BATCH = 2                       # the launcher runs' batch a worker
LR = 0.01                              # the lane's default
STEPS = 2
THRESHOLD = 4096                       # several buckets in the narrow net
NARROW = dict(num_classes=10, num_filters=8)
# arm -> (port flags, JAX flags, JAX fabric)
ARMS = {
    "psum_overlap_on": (
        dict(overlap_grad_comm="on", fusion_threshold_bytes=THRESHOLD),
        dict(overlap_grad_comm="on", fusion_threshold_bytes=THRESHOLD),
        "ib"),
    "psum_overlap_off": (
        dict(overlap_grad_comm="off", fusion_threshold_bytes=THRESHOLD),
        dict(overlap_grad_comm="off", fusion_threshold_bytes=THRESHOLD),
        "ib"),
    "replicated": (
        dict(variable_update="replicated"),
        dict(variable_update="replicated"), "ib"),
    "replicated_fused": (
        dict(variable_update="replicated"),
        dict(variable_update="replicated"), "ib"),
    "replicated_skewed": (
        dict(variable_update="replicated"),
        dict(variable_update="replicated"), "ib"),
    "psum_skewed": (
        dict(fusion_threshold_bytes=THRESHOLD),
        dict(fusion_threshold_bytes=THRESHOLD), "ib"),
    "accum2": (
        dict(gradient_accumulation_steps=2,
             fusion_threshold_bytes=THRESHOLD),
        dict(gradient_accumulation_steps=2,
             fusion_threshold_bytes=THRESHOLD), "ib"),
    "host": ({}, {}, "sock"),
}
# the arms on the fused block (--fused_conv=true), and on batches whose
# ranks differ in their statistics
FUSED_ARMS = ("replicated_fused",)
SKEWED_ARMS = ("replicated_skewed", "psum_skewed")
# where replicated and psum part on the skewed batches, in PARAM_TOL
SKEW_APART = 100.0
REPO = Path(__file__).resolve().parent.parent


def _narrow_port(fused: bool = False) -> resnet.ResNet:
    return resnet.ResNet([1, 1, 1, 1], resnet.BottleneckBlock,
                         fused_conv=fused, **NARROW)


def _port_cfg(lr: float = LR, per_rank: int = PER_RANK,
              **kw) -> flags.BenchmarkConfig:
    return flags.BenchmarkConfig(
        batch_size=per_rank, optimizer="momentum", init_learning_rate=lr,
        momentum=0.9, device="cpu", **kw).resolve()


def _images(image=IMAGE, skew: bool = False):
    """The one global batch of the step tests: ``WORLD * PER_RANK``
    images; with ``skew`` rank r's rows scaled by ``1 + r`` and shifted
    by ``r``, so each rank's batch statistics differ clearly."""
    images, labels = SyntheticImages(WORLD * PER_RANK, image, 10,
                                     seed=3).batch()
    if skew:
        r = np.repeat(np.arange(WORLD, dtype=np.float32), PER_RANK)
        images = images * (1 + r)[:, None, None, None] + \
            r[:, None, None, None]
    return images, labels


def _batch(rank: int, per_rank: int = PER_RANK, skew: bool = False):
    return to_device(rank_rows(_images(skew=skew), rank, per_rank),
                     torch.device("cpu"))


# --- the buckets ------------------------------------------------------------

F32, BF16 = np.float32, np.dtype("V2")   # bf16's item size is what counts
SIZE_LISTS = {
    "mixed": [(1000, F32), (3, BF16), (50000, F32), (7, F32), (2048, BF16),
              (1024, F32), (1, F32), (40000, BF16), (10, F32)],
    "narrow_resnet": [(p.numel(), F32)
                      for p in _narrow_port().parameters()],
}


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("threshold", [0, 1, 4096, 1 << 27])
@pytest.mark.parametrize("sizes", sorted(SIZE_LISTS))
def test_buckets_are_jaxs(sizes, threshold, reverse):
    from tpu_hc_bench.parallel import collectives as jax_coll

    leaves = [np.zeros(n, dt) for n, dt in SIZE_LISTS[sizes]]
    order = list(range(len(leaves)))[::-1] if reverse else None
    want = jax_coll._flatten_to_buckets(leaves, threshold, order)
    got = collectives.flatten_to_buckets(
        [a.size for a in leaves], [a.dtype.itemsize for a in leaves],
        threshold, order)
    assert got == want
    assert collectives.bucket_order(len(leaves), reverse) == \
        jax_coll._bucket_order(len(leaves), reverse)


def test_plan_buckets_rule_and_wire_dtype():
    ts = [torch.zeros(1000), torch.zeros(3, dtype=torch.bfloat16),
          torch.zeros(50000)]
    assert collectives.plan_buckets(ts, 1 << 27, fuse=True, overlap=True) \
        == [[2, 1, 0]]
    assert collectives.plan_buckets(ts, 1 << 27, fuse=False,
                                    overlap=False) == [[0], [1], [2]]
    assert collectives.plan_buckets(ts, 4006, overlap=False) == \
        [[0, 1], [2]]
    assert collectives._wire_dtype(ts) == torch.float32
    assert collectives._wire_dtype(ts[1:2]) == torch.bfloat16


# --- world 1: the fast arm in a one-rank group ------------------------------


@pytest.fixture
def one_rank_group():
    distributed.init_single("gloo")
    try:
        yield
    finally:
        dist.destroy_process_group()


def _init_state() -> dict:
    """Seeded weights for the narrow net (running variances near 1)."""
    gen = torch.Generator().manual_seed(0)
    return {k: torch.randn(t.shape, generator=gen) * 0.1
            + (1.0 if t.ndim == 1 else 0.0)
            for k, t in _narrow_port().state_dict().items()}


def _two_steps(fabric, cfg, init, rank=0, fused=False, skew=False):
    model = _narrow_port(fused)
    model.load_state_dict(init)
    state = step_mod.make_train_state(model, cfg, fabric)
    losses = []
    for _ in range(STEPS):
        state, metrics = step_mod.train_step(
            state, _batch(rank, cfg.batch_size, skew))
        losses.append(float(metrics["loss"]))
    return state, losses


def test_world1_fast_arm_is_bit_equal_to_one_worker(one_rank_group):
    """A one-rank sum divided by 1 at float32 is exact: parameters, BN
    statistics and losses bit-equal to the one-worker step."""
    init = _init_state()
    want_state, want_losses = _two_steps(None, _port_cfg(), init)
    want = want_state.model.state_dict()
    for overlap in ("on", "off"):
        cfg = _port_cfg(overlap_grad_comm=overlap,
                        fusion_threshold_bytes=THRESHOLD)
        state, losses = _two_steps(Fabric.ICI, cfg, init)
        assert losses == want_losses, overlap
        for k, t in state.model.state_dict().items():
            assert torch.equal(t, want[k]), (overlap, k)
        n_buckets = len(state.dp.grads.buckets)
        assert n_buckets > 1
        n_stats = len(collectives.plan_buckets(
            list(state.model.buffers()), THRESHOLD))
        assert state.dp.allreduce_calls == n_buckets + n_stats + 1


def test_world1_replicated_is_bit_equal_to_psum(one_rank_group):
    """Sync-BN over one rank is the identity: ``replicated`` (every
    BatchNorm's sums through an all-reduce, forward and backward) gives
    ``psum``'s parameters, statistics and losses bit for bit, fused and
    not; its all-reduce calls a step are one a parameter, the loss, and
    two a BatchNorm."""
    init = _init_state()
    for fused in (False, True):
        runs = {}
        for update in ("psum", "replicated"):
            model = _narrow_port(fused)
            model.load_state_dict(init)
            state = step_mod.make_train_state(
                model, _port_cfg(variable_update=update), Fabric.ICI)
            losses = [float(step_mod.train_step(state, _batch(0))[1]["loss"])
                      for _ in range(STEPS)]
            runs[update] = (model.state_dict(), losses,
                            state.dp.allreduce_calls)
            state.dp.grads.close()
        (want, want_losses, _), (got, losses, calls) = runs.values()
        assert losses == want_losses, fused
        for k in want:
            assert torch.equal(got[k], want[k]), (fused, k)
        bns = sum(isinstance(m, resnet.BatchNorm) for m in model.modules())
        assert calls == len(list(model.parameters())) + 1 + 2 * bns


def test_hooks_launch_buckets_during_backward_only_with_overlap(
        one_rank_group):
    for overlap, launched in (("on", True), ("off", False)):
        cfg = _port_cfg(overlap_grad_comm=overlap,
                        fusion_threshold_bytes=THRESHOLD)
        model = _narrow_port()
        model.load_state_dict(_init_state())
        state = step_mod.make_train_state(model, cfg, Fabric.ICI)
        grads = state.dp.grads
        grads.arm()
        step_mod.batch_loss(model, _batch(0)).backward()
        assert (grads._next == len(grads.buckets)) is launched, overlap
        assert grads.finish() == len(grads.buckets)
        with pytest.raises(RuntimeError, match="arm"):
            grads.finish()
        grads.close()


def test_unreached_parameter_gets_reduced_zeros(one_rank_group):
    used, unused = torch.nn.Parameter(torch.ones(3)), \
        torch.nn.Parameter(torch.ones(2))
    for overlap in (True, False):
        used.grad = unused.grad = None
        grads = collectives.GradReducer([used, unused], overlap=overlap)
        grads.arm()
        (2 * used).sum().backward()
        grads.finish()
        assert torch.equal(used.grad, torch.full((3,), 2.0))
        assert torch.equal(unused.grad, torch.zeros(2))
        grads.close()


# --- four gloo ranks against JAX build_train_step ---------------------------


# The witness that the accumulation arm's miss at test_torch_train.py's
# learning rate is no accumulation fault: that arm at 0.05, and the step
# with no accumulation on the same one-image microbatches (one image a
# rank over WORLD * PER_RANK ranks), on both sides.
WITNESS_LR = 0.05
WITNESS_ARMS = {
    "accum2_lr005": dict(gradient_accumulation_steps=2,
                         fusion_threshold_bytes=THRESHOLD),
    "one_image_lr005": dict(per_rank=1, fusion_threshold_bytes=THRESHOLD),
}
GRAD_RTOL = 1e-3       # a one-image gradient, of its parameter's largest
KINK_TOL = 1e-5        # a ReLU input's sign flip, of its tensor's largest


def _worker(out_dir: str, arms: str) -> None:
    """One rank: the arms of ``ARMS`` and the witness's ``accum2_lr005``
    (``arms`` "main", at ``WORLD`` ranks), or ``one_image_lr005`` (at
    ``WORLD * PER_RANK`` ranks), from the saved weights, two steps each;
    losses and the final state saved for the test."""
    assert "jax" not in sys.modules and "tpu_hc_bench" not in sys.modules
    worker = distributed.worker_from_env()
    distributed.init_group("gloo", worker)
    try:
        inits = {fused: torch.load(Path(out_dir) / f"init{tag}.pt")
                 for fused, tag in ((False, ""), (True, "_fused"))}
        if arms == "main":
            todo = {arm: (resolve_fabric(fabric), _port_cfg(**port_kw))
                    for arm, (port_kw, _, fabric) in ARMS.items()}
            todo["accum2_lr005"] = (Fabric.ICI, _port_cfg(
                WITNESS_LR, **WITNESS_ARMS["accum2_lr005"]))
        else:
            todo = {arms: (Fabric.ICI, _port_cfg(WITNESS_LR,
                                                 **WITNESS_ARMS[arms]))}
        out = {}
        for arm, (fabric, cfg) in todo.items():
            fused = arm in FUSED_ARMS
            state, losses = _two_steps(fabric, cfg, inits[fused],
                                       worker.rank, fused,
                                       arm in SKEWED_ARMS)
            out[arm] = {"losses": losses,
                        "state": state.model.state_dict(),
                        "allreduce_calls": state.dp.allreduce_calls}
        torch.save(out, Path(out_dir) / f"{arms}_rank{worker.rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn_port(out_dir: Path, arms: str, world: int) -> list[dict]:
    """``world`` gloo ranks running ``_worker``; each rank's results."""
    workers = [distributed.Worker(r, r, world,
                                  f"file://{out_dir}/{arms}_store")
               for r in range(world)]
    rc = distributed.spawn_local(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         str(out_dir), arms], workers, print)
    assert rc == 0
    return [torch.load(out_dir / f"{arms}_rank{r}.pt")
            for r in range(world)]


def _jax_steps(model, variables, devices: int, per_rank: int, lr: float,
               jax_kw: dict, fabric: str,
               image=IMAGE, skew: bool = False) -> tuple[list, list]:
    """JAX ``build_train_step`` on a ``devices``-device mesh from
    ``variables`` (``--variable_update=replicated``: its GSPMD arm,
    ``_build_gspmd_step``), ``STEPS`` steps on ``_images(image, skew)``:
    the losses and the state after each step, as ``(params,
    batch_stats)`` numpy trees."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from test_torch_train import _np_tree
    from tpu_hc_bench import flags as jax_flags
    from tpu_hc_bench.models import ModelSpec
    from tpu_hc_bench.parallel import fabric as jax_fabric
    from tpu_hc_bench.topology import DATA_AXIS
    from tpu_hc_bench.train import step as jax_step

    mesh = Mesh(np.array(jax.devices()[:devices]), (DATA_AXIS,))
    batch = jax_step.shard_batch(_images(image, skew), mesh)
    cfg = jax_flags.BenchmarkConfig(
        model="resnet50", batch_size=per_rank, optimizer="momentum",
        init_learning_rate=lr, momentum=0.9, num_classes=10, **jax_kw)
    tx = jax_step.make_optimizer(cfg)
    state = jax_step.replicate_state(jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), apply_fn=model.apply,
        tx=tx), mesh)
    step_fn = jax_step.build_train_step(
        mesh, cfg, ModelSpec("narrow", None, image, 1e6),
        jax_fabric.resolve_fabric(fabric))
    losses, states = [], []
    for _ in range(STEPS):
        state, metrics = step_fn(state, batch, jax.random.PRNGKey(0))
        losses.append(float(metrics["loss"]))
        states.append((_np_tree(state.params), _np_tree(state.batch_stats)))
    return losses, states


def _port_layout(state) -> dict:
    from tpu_hc_bench_torch import convert

    return convert.resnet_variables_from_flax(*state)


@pytest.fixture(scope="module")
def narrow_flax():
    """The narrow Flax ResNet and its perturbed variables (the weights
    of every step test)."""
    from test_torch_train import _narrow

    return _narrow(False)


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory, narrow_flax):
    """The port's four ranks (spawned) and JAX's 4-device steps, every
    arm, from the same perturbed weights (the fused arms from the fused
    Flax ResNet's); the ranks also run the witness's accumulation
    arm."""
    from test_torch_train import _narrow

    from tpu_hc_bench_torch import convert

    nets = {False: narrow_flax, True: _narrow(True)}
    out_dir = tmp_path_factory.mktemp("dp")
    for fused, tag in ((False, ""), (True, "_fused")):
        variables = nets[fused][1]
        torch.save(convert.resnet_variables_from_flax(
            variables["params"], variables["batch_stats"]),
            out_dir / f"init{tag}.pt")
    port = _spawn_port(out_dir, "main", WORLD)
    ref = {}
    for arm, (_, jax_kw, fabric) in ARMS.items():
        model, variables = nets[arm in FUSED_ARMS]
        losses, states = _jax_steps(model, variables, WORLD, PER_RANK, LR,
                                    jax_kw, fabric,
                                    skew=arm in SKEWED_ARMS)
        ref[arm] = {"losses": losses, "state": _port_layout(states[-1])}
    return port, ref, out_dir


def _worst(got: dict, want: dict) -> float:
    """The largest error of any tensor of ``got``, each of its
    ``want``'s scale (as ``_close`` measures it)."""
    return max(float(np.abs(np.asarray(t) - np.asarray(want[n])).max())
               / max(float(np.abs(np.asarray(want[n])).max()), 1.0)
               for n, t in got.items())


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    scale = max(float(np.abs(want).max()), 1.0)
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"


@pytest.mark.parametrize("arm", list(ARMS))
def test_four_ranks_match_jax_step(dp_runs, arm):
    from test_torch_train import LOSS_RTOL, PARAM_TOL

    port, ref, _ = dp_runs
    want = ref[arm]
    for i, (got, loss) in enumerate(zip(port[0][arm]["losses"],
                                        want["losses"])):
        assert abs(got - loss) <= LOSS_RTOL * abs(loss), (arm, i, got, loss)
    state = port[0][arm]["state"]
    assert set(state) == set(want["state"])
    for name, t in state.items():
        _close(t, want["state"][name], PARAM_TOL, f"{arm} {name}")


@pytest.mark.parametrize("arm", list(ARMS))
def test_four_ranks_hold_one_state(dp_runs, arm):
    """Every rank's parameters, statistics and losses bit-equal to rank
    0's, and the all-reduce calls a step as the arm's buckets say."""
    port, _, _ = dp_runs
    r0 = port[0][arm]
    for r in range(1, WORLD):
        assert port[r][arm]["losses"] == r0["losses"], (arm, r)
        for name, t in port[r][arm]["state"].items():
            assert torch.equal(t, r0["state"][name]), (arm, r, name)
    model = _narrow_port(arm in FUSED_ARMS)
    params, stats = list(model.parameters()), list(model.buffers())
    fuse = not arm.startswith("replicated")
    threshold = ARMS[arm][0].get("fusion_threshold_bytes",
                                 flags.DEFAULT_FUSION_THRESHOLD_BYTES)
    # replicated: no running-statistics all-reduce, and sync-BN's two
    # (forward and backward) a BatchNorm
    bns = sum(isinstance(m, resnet.BatchNorm) for m in model.modules())
    expected = 1 if arm == "host" else (
        len(collectives.plan_buckets(params, threshold, fuse)) + 1
        + (2 * bns if not fuse else
           len(collectives.plan_buckets(stats, threshold, fuse))))
    assert r0["allreduce_calls"] == expected


def test_replicated_normalizes_over_the_global_batch(dp_runs):
    """On ranks whose batches differ clearly in their statistics,
    ``replicated`` (sync-BN, as JAX's GSPMD arm) and ``psum`` (each
    worker's own statistics, as Horovod) train different models: their
    parameters part by more than ``SKEW_APART`` x ``PARAM_TOL``, while
    each matches its JAX arm within ``PARAM_TOL``
    (``test_four_ranks_match_jax_step``)."""
    from test_torch_train import PARAM_TOL

    port, ref, _ = dp_runs
    rep = port[0]["replicated_skewed"]["state"]
    per_worker = port[0]["psum_skewed"]["state"]
    apart = _worst(rep, per_worker) / PARAM_TOL
    jax_apart = _worst(ref["replicated_skewed"]["state"],
                       ref["psum_skewed"]["state"]) / PARAM_TOL
    print(f"replicated vs psum on skewed ranks, in PARAM_TOL: port "
          f"{apart:.4g}, JAX {jax_apart:.4g}")
    assert apart > SKEW_APART and jax_apart > SKEW_APART


# --- the witness at learning rate 0.05 --------------------------------------


@pytest.fixture(scope="module")
def witness_runs(dp_runs, narrow_flax):
    """At ``WITNESS_LR``: the accumulation arm and the one-image-a-rank
    step over ``WORLD * PER_RANK`` ranks (the same microbatches, no
    accumulation), on both sides; JAX's states after each step."""
    model, variables = narrow_flax
    port, _, out_dir = dp_runs
    n = WORLD * PER_RANK
    one = _spawn_port(out_dir, "one_image_lr005", n)
    for r in range(1, n):
        assert one[r]["one_image_lr005"]["losses"] == \
            one[0]["one_image_lr005"]["losses"]
    jax_kw = WITNESS_ARMS["accum2_lr005"]
    ref = {"accum2_lr005": _jax_steps(model, variables, WORLD, PER_RANK,
                                      WITNESS_LR, jax_kw, "ib"),
           "one_image_lr005": _jax_steps(
               model, variables, n, 1, WITNESS_LR,
               dict(fusion_threshold_bytes=THRESHOLD), "ib")}
    return ({"accum2_lr005": port[0]["accum2_lr005"],
             "one_image_lr005": one[0]["one_image_lr005"]}, ref)


def _relu_inputs(port_model, flax_model, variables, image):
    """Every tensor that enters a ReLU in the narrow ResNet's train-mode
    forward of ``image`` (bn_init, each block's bn1 and bn2, and the
    residual sum), NHWC, from the port and from JAX."""
    cap = {}

    def keep(name):
        return lambda _m, _i, out: cap.__setitem__(name, out.detach())

    names = ["bn_init"] + [f"blocks.{i}.{bn}" for i in range(4)
                           for bn in ("bn1", "bn2", "bn3", "shortcut_bn")]
    hooks = [port_model.get_submodule(n).register_forward_hook(keep(n))
             for n in names]
    with torch.no_grad():
        port_model(to_device((image[0], image[1]), torch.device("cpu"))[0])
    for h in hooks:
        h.remove()
    _, inter = flax_model.apply(
        variables, image[0], train=True, capture_intermediates=True,
        mutable=["batch_stats", "intermediates"])
    inter = inter["intermediates"]

    def flax_out(path):
        node = inter
        for k in path:
            node = node[k]
        return np.asarray(node["__call__"][0])

    def nhwc(t):
        return t.permute(0, 2, 3, 1).numpy()

    pairs = [(nhwc(cap["bn_init"]), flax_out(["bn_init"]))]
    for i in range(4):
        blk, pre = [f"BottleneckBlock_{i}"], f"blocks.{i}."
        pairs += [(nhwc(cap[pre + "bn1"]), flax_out(blk + ["BatchNorm_0"])),
                  (nhwc(cap[pre + "bn2"]), flax_out(blk + ["BatchNorm_1"])),
                  (nhwc(cap[pre + "bn3"] + cap[pre + "shortcut_bn"]),
                   flax_out(blk + ["BatchNorm_2"])
                   + flax_out(blk + ["shortcut_bn"]))]
    return pairs


def test_accumulation_miss_at_lr_005_is_a_relu_kink(witness_runs,
                                                    narrow_flax):
    """At ``test_torch_train.py``'s learning rate (0.05) the accumulation
    arm can miss JAX's by more than ``PARAM_TOL``.  This test pins
    that miss on rounding, not on the accumulation:

    - on each side, the accumulation arm (``WORLD`` ranks, two one-image
      microbatches a rank) equals the step with no accumulation on the
      same one-image microbatches (one image a rank over ``WORLD *
      PER_RANK`` ranks) within ``PARAM_TOL`` and ``LOSS_RTOL``: the same
      mean gradient, one BatchNorm decay toward the mean of the
      microbatch statistics, the same loss;
    - after JAX's first step, each one-image gradient of the port is
      within ``GRAD_RTOL`` of JAX's, or some ReLU input of that image has
      opposite signs on the two sides; every such flip is within
      ``KINK_TOL`` of its tensor's largest value, so a rounding-level
      difference, and a ReLU passes the gradient on one side only;
    - where the accumulation arm misses JAX's by more than ``PARAM_TOL``,
      such a flip exists."""
    import jax
    import optax

    from test_torch_train import LOSS_RTOL, PARAM_TOL

    port, ref = witness_runs
    flax_model, _ = narrow_flax
    for side, got, want in (
            ("port", port["accum2_lr005"]["losses"],
             port["one_image_lr005"]["losses"]),
            ("jax", ref["accum2_lr005"][0], ref["one_image_lr005"][0])):
        for a, b in zip(got, want):
            assert abs(a - b) <= LOSS_RTOL * abs(b), (side, got, want)
    jax_accum = _port_layout(ref["accum2_lr005"][1][-1])
    jax_one = _port_layout(ref["one_image_lr005"][1][-1])
    for name, t in port["accum2_lr005"]["state"].items():
        _close(t, port["one_image_lr005"]["state"][name], PARAM_TOL,
               f"port accumulation vs one image a rank: {name}")
        _close(jax_accum[name], jax_one[name], PARAM_TOL,
               f"JAX accumulation vs one image a rank: {name}")

    params, stats = ref["one_image_lr005"][1][0]
    variables = {"params": params, "batch_stats": stats}

    def loss(p, x, y):
        logits, _ = flax_model.apply({"params": p, "batch_stats": stats},
                                     x, train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    grad = jax.jit(jax.grad(loss))
    images, labels = _images()
    flipped = []
    for i in range(len(images)):
        image = (images[i:i + 1], labels[i:i + 1])
        port_model = _narrow_port()
        port_model.load_state_dict(_port_layout((params, stats)))
        step_mod.batch_loss(port_model, to_device(
            image, torch.device("cpu"))).backward()
        want = _port_layout((jax.tree.map(np.asarray, grad(params, *image)),
                             stats))
        agrees = all(
            float((p.grad - want[n]).abs().max())
            <= GRAD_RTOL * float(want[n].abs().max())
            for n, p in port_model.named_parameters())
        flips = []
        for got, exp in _relu_inputs(port_model, flax_model, variables,
                                     image):
            sign = (got > 0) != (exp > 0)
            flips += [max(abs(got[k]), abs(exp[k])) / np.abs(exp).max()
                      for k in zip(*np.nonzero(sign))]
        assert all(f <= KINK_TOL for f in flips), (i, max(flips))
        assert agrees or flips, f"image {i}: no ReLU input flips sign"
        if flips:
            flipped.append((i, float(max(flips))))
    port_accum = port["accum2_lr005"]["state"]
    port_one = port["one_image_lr005"]["state"]
    miss = _worst(port_accum, jax_accum)
    print("in PARAM_TOL: accumulation vs one image a rank, port "
          f"{_worst(port_accum, port_one) / PARAM_TOL:.4g}, JAX "
          f"{_worst(jax_accum, jax_one) / PARAM_TOL:.4g}; port vs JAX, "
          f"accumulation {miss / PARAM_TOL:.4g}, one image a rank "
          f"{_worst(port_one, jax_one) / PARAM_TOL:.4g}; "
          f"(image, largest flip / scale): {flipped}")
    assert miss <= PARAM_TOL or flipped, miss


@pytest.mark.parametrize("side,nudged_below,nudged_above",
                         [(32, None, 10.0), (64, 0.1, None)],
                         ids=["32x32", "64x64"])
def test_step_conditioning_at_the_image_sizes(narrow_flax, side,
                                              nudged_below, nudged_above):
    """Why the step tests run 64x64 images: JAX's own two psum steps
    (``WORLD`` devices, ``PER_RANK`` images each, ``LR``) from weights
    one float32 ulp up from ``narrow_flax``'s move, at 32x32, by more
    than 10 x ``PARAM_TOL`` (the last stage is 1x1 there, and each
    BatchNorm of it normalizes over a rank's two values), so no port
    can be held to that tolerance at that size; at 64x64 they move by
    under a tenth of it."""
    import jax

    from test_torch_train import PARAM_TOL

    model, variables = narrow_flax
    nudged = jax.tree.map(
        lambda a: np.nextafter(np.asarray(a), np.float32(np.inf)), variables)
    kw = dict(fusion_threshold_bytes=THRESHOLD)
    runs = [_port_layout(_jax_steps(model, v, WORLD, PER_RANK, LR, kw, "ib",
                                    (side, side, 3))[1][-1])
            for v in (variables, nudged)]
    moved = _worst(runs[1], runs[0]) / PARAM_TOL
    print(f"{side}x{side}: one ulp moves two steps {moved:.4g} x PARAM_TOL")
    if nudged_below is not None:
        assert moved < nudged_below, moved
    if nudged_above is not None:
        assert moved > nudged_above, moved


# --- the launcher at world 4 ------------------------------------------------


@pytest.mark.parametrize("fabric", ["ib", "sock"])
def test_launcher_world4_on_the_cpu(fabric):
    lines: list[str] = []
    rc = launcher.main(
        ["1", str(WORLD), str(LAUNCH_BATCH), fabric, "--model=bert_tiny",
         "--device=cpu", "--attention_impl=flash", "--fused_xent=true",
         "--num_warmup_batches=1", "--num_batches=2", "--display_every=1"],
        print_fn=lines.append)
    assert rc == 0
    results = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert len(results) == 1
    res = results[0]
    assert res["total_workers"] == WORLD and \
        res["global_batch"] == WORLD * LAUNCH_BATCH
    assert math.isfinite(res["final_loss"])
    assert res["images_per_sec_per_chip"] == pytest.approx(
        res["total_images_per_sec"] / WORLD)
    assert res["allreduce_per_step"] >= 1
    assert sum("\texamples/sec: " in ln for ln in lines) == 2


def test_launcher_rejects_what_the_world_cannot_run(monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="host"):
        launcher.main(["1", "4", "2", "sock", "--device=cpu",
                       "--gradient_accumulation_steps=2"])
    hostfile = tmp_path / "nodeips.txt"
    hostfile.write_text("# coordinator first\n10.0.0.1\n\n10.0.0.2\n")
    monkeypatch.setenv(distributed.HOSTFILE_ENV, str(hostfile))
    with pytest.raises(ValueError, match="hostfile lists 2"):
        launcher.main(["3", "1", "2", "ib", "--device=cpu"])
    with pytest.raises(ValueError, match="PROCESS_ID"):
        launcher.main(["2", "1", "2", "ib", "--device=cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="cards"):
        launcher.main(["1", "2", "2", "ib"])


def test_hostfile_contract(monkeypatch, tmp_path):
    hostfile = tmp_path / "nodeips.txt"
    hostfile.write_text("10.0.0.1\n# a comment\n10.0.0.2\n")
    monkeypatch.setenv(distributed.HOSTFILE_ENV, str(hostfile))
    monkeypatch.setenv(distributed.PROCESS_ID_ENV, "1")
    assert distributed.read_hostfile() == ["10.0.0.1", "10.0.0.2"]
    assert distributed.multi_host_store(2) == (1, "tcp://10.0.0.1:9944")
    monkeypatch.setenv(distributed.PORT_ENV, "29500")
    assert distributed.multi_host_store(2) == (1, "tcp://10.0.0.1:29500")
    monkeypatch.setenv(distributed.PROCESS_ID_ENV, "2")
    with pytest.raises(ValueError, match="outside"):
        distributed.multi_host_store(2)
    (tmp_path / "empty.txt").write_text("# nobody\n")
    with pytest.raises(ValueError, match="no hosts"):
        distributed.read_hostfile(tmp_path / "empty.txt")
    w = distributed.Worker(5, 1, 8, "file:///x")
    assert distributed.worker_from_env(w.env()) == w
    assert distributed.worker_from_env({}) is None


def test_spawn_stops_the_world_when_a_rank_fails():
    # rank 0 prints its line in one write, and rank 2 fails a second
    # after starting: on a loaded host rank 2 used to fail before rank 0
    # had written its whole line
    script = ("import os, sys, time\n"
              "r = int(os.environ['TPU_HC_BENCH_RANK'])\n"
              "sys.stdout.write(f'rank {r}\\n'); sys.stdout.flush()\n"
              "time.sleep(1.0) if r == 2 else None\n"
              "sys.exit(3) if r == 2 else time.sleep(120)\n")
    workers = [distributed.Worker(r, r, WORLD, "file:///unused")
               for r in range(WORLD)]
    lines: list[str] = []
    rc = distributed.spawn_local([sys.executable, "-c", script], workers,
                                 lines.append)
    assert rc == 3
    assert lines == ["rank 0"]


STUB_NVCC = """#!{python}
import sys, time
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(("link" if "-shared" in args else "compile") + "\\n")
time.sleep(0.3)
with open(args[args.index("-o") + 1], "w") as f:
    f.write("stub")
"""


def test_workers_build_the_kernels_once(monkeypatch, tmp_path):
    """Four workers that start the kernel build together on an empty
    build directory (a stub ``nvcc`` that records its calls): one
    compiles every source and links once, the others wait on the lock
    and take its library."""
    from tpu_hc_bench_torch.ops import _build

    bin_dir, build_dir = tmp_path / "bin", tmp_path / "build"
    bin_dir.mkdir()
    log = tmp_path / "nvcc.log"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(STUB_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    script = ("import json, os, sys\n"
              "from pathlib import Path\n"
              "from tpu_hc_bench_torch.ops import _build\n"
              "lib, secs, _ = _build.build(Path(sys.argv[1]))\n"
              "r = os.environ['TPU_HC_BENCH_RANK']\n"
              "Path(sys.argv[1], f'rank{r}.json').write_text(\n"
              "    json.dumps([str(lib), secs]))\n")
    workers = [distributed.Worker(r, r, WORLD, "file:///unused")
               for r in range(WORLD)]
    rc = distributed.spawn_local(
        [sys.executable, "-c", script, str(build_dir)], workers, print)
    assert rc == 0
    calls = log.read_text().split()
    assert calls.count("compile") == len(_build._sources())
    assert calls.count("link") == 1
    results = [json.loads((build_dir / f"rank{r}.json").read_text())
               for r in range(WORLD)]
    lib = build_dir / _build._LIB_NAME
    assert {path for path, _ in results} == {str(lib)}
    assert sum(secs > 0 for _, secs in results) == 1
    assert lib.read_text() == "stub"


def test_data_parallel_modules_import_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, tpu_hc_bench_torch.parallel.fabric, "
         "tpu_hc_bench_torch.parallel.distributed, "
         "tpu_hc_bench_torch.parallel.collectives, "
         "tpu_hc_bench_torch.microbench.osu, tpu_hc_bench_torch.launcher, "
         "tpu_hc_bench_torch.train.step, tpu_hc_bench_torch.train.driver; "
         "assert 'jax' not in sys.modules; "
         "assert 'tpu_hc_bench' not in sys.modules"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode == 0, proc.stderr


def test_fabric_names():
    assert launcher.FABRICS == ("ib", "ici", "dcn", "sock", "host")
    assert resolve_fabric(" IB ") is Fabric.ICI
    assert resolve_fabric("sock") is Fabric.HOST
    assert resolve_fabric("dcn").is_fast and not Fabric.HOST.is_fast
    with pytest.raises(ValueError, match="unknown fabric"):
        resolve_fabric("tcp")


# --- flags ------------------------------------------------------------------


def test_data_parallel_flags_follow_jax():
    from tpu_hc_bench import flags as jax_flags

    d, j = flags.BenchmarkConfig(), jax_flags.BenchmarkConfig()
    for name in ("overlap_grad_comm", "fusion_threshold_bytes",
                 "variable_update", "gradient_accumulation_steps"):
        assert getattr(d, name) == getattr(j, name), name
    assert flags.DEFAULT_FUSION_THRESHOLD_BYTES == \
        jax_flags.DEFAULT_FUSION_THRESHOLD_BYTES == 134217728
    cfg = flags.parse_benchmark_flags(
        ["--variable_update=horovod", "--batch_size=8",
         "--gradient_accumulation_steps=4", "--overlap_grad_comm=off",
         "--fusion_threshold_bytes=0"])
    assert (cfg.variable_update, cfg.gradient_accumulation_steps,
            cfg.overlap_grad_comm, cfg.fusion_threshold_bytes) == \
        ("psum", 4, "off", 0)
    assert flags.parse_benchmark_flags(
        ["--variable_update=replicated"]).variable_update == "replicated"
    assert flags.parse_benchmark_flags(
        ["--variable_update=zero1"]).variable_update == "zero1"
    for bad, match in ((["--variable_update=zero1",
                         "--sequence_parallel=2"], "plain data"),
                       (["--rnn_impl=lstm"], "hoisted|bidi|flax"),
                       (["--variable_update=ring"], "psum"),
                       (["--batch_size=6", "--gradient_accumulation_steps=4"],
                        "divisible"),
                       (["--gradient_accumulation_steps=0"], ">= 1"),
                       (["--overlap_grad_comm=maybe"], "on|off"),
                       (["--fusion_threshold_bytes=-1"], ">= 0")):
        with pytest.raises(ValueError, match=match):
            flags.parse_benchmark_flags(bad)


def test_rank_rows_and_dropout_seeds():
    from tpu_hc_bench_torch.models import DROPOUT_SEED_OFFSET, dropout_seed

    images, labels = SyntheticImages(8, (4, 4, 3), 10, seed=1).batch()
    rows = [rank_rows((images, labels), r, 2) for r in range(WORLD)]
    np.testing.assert_array_equal(np.concatenate([x for x, _ in rows]),
                                  images)
    np.testing.assert_array_equal(rows[3][1], labels[6:])
    with pytest.raises(ValueError, match="outside"):
        rank_rows((images, labels), 4, 2)
    assert dropout_seed(7) == dropout_seed(7, 0) == 7 + DROPOUT_SEED_OFFSET
    seeds = {dropout_seed(7, r) for r in range(8)}
    assert len(seeds) == 8 and dropout_seed(7, 3) == dropout_seed(7, 3)


# --- OSU --------------------------------------------------------------------


def test_busbw_factors_are_jaxs():
    from tpu_hc_bench.microbench import osu as jax_osu

    for op in osu.OSU_OPS:
        for n in range(1, 9):
            assert osu.busbw_factor(op, n) == jax_osu._busbw_factor(op, n)


def test_osu_sweep_world4(tmp_path):
    path = tmp_path / "sweep.json"
    lines: list[str] = []
    rc = osu.main(["--op", "all", "--nproc", str(WORLD), "--device", "cpu",
                   "--min_bytes", "1024", "--max_bytes", "4096",
                   "--warmup", "1", "--iters", "3", "--json", str(path)],
                  print_fn=lines.append)
    assert rc == 0
    data = json.loads(path.read_text())
    assert data["world_size"] == WORLD and data["device_kind"] == "cpu"
    assert set(data["sweeps"]) == set(osu.OSU_OPS)
    for op, rows in data["sweeps"].items():
        assert [r["message_bytes"] for r in rows] == [1024, 2048, 4096]
        for r in rows:
            assert r["mean_us"] > 0
            assert r["busbw_gbps"] == pytest.approx(
                r["algbw_gbps"] * osu.busbw_factor(op, WORLD))
    assert sum(ln.startswith("# cpu collective") for ln in lines) == 4


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2], sys.argv[3])
