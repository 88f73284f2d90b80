"""The port's tensor and expert parallelism against the JAX package's
GSPMD arm, on the CPU (gloo; no card here).

- **the rules**: for every parameter of ``bert_tiny``, ``moe_tiny``,
  ``llama_tiny`` and ``vit_tiny``, the port's ``tp_param_rule`` cuts the
  elements JAX's ``tp_param_spec`` puts on each model-axis shard of the
  Flax counterpart: each Flax leaf is filled with the index of the
  shard that holds each element (-1 where replicated), carried through
  ``convert``, and every rank's cut must hold its own index only (the
  fused ``qkv``'s three strided blocks included); ``mode="ep"`` keeps
  the expert tensors alone.
- **the steps**: four gloo ranks (this file run as a worker script by
  the port's ``spawn_local``) at dp 2 x tp 2 on ``bert_tiny``,
  ``llama_tiny`` and ``vit_tiny``, and ``moe_tiny`` at ep 2 (dp 2) and ep
  4 (dp 1), against JAX's ``build_train_step`` on a (data, model) mesh of
  the conftest's virtual devices (``shard_state_tp``, tp or ep mode),
  from perturbed Flax weights carried over by
  ``convert.sharded_params_from_flax``, two momentum-SGD steps, dropout
  off on both sides: each step's loss within ``TP_RTOL`` (JAX's own
  tolerance between its TP and replicated arms), every gathered
  parameter within ``PARAM_TOL``; the ranks of a model group hold
  bit-equal replicated parameters; a rank holds ``heads / tp`` heads and
  ``E / ep`` experts; the MoE aux loss is the global batch's (JAX's
  sown ``losses`` on the whole batch) and the dropped fraction the
  unsharded model's on the whole batch.
- **checkpoints**: the tp 2 llama state saved (gathered, the full tree)
  resumes at tp 2 on the ranks and at tp 1 here, bit for bit.
- **errors and flags**: ``lenet`` under TP and a dense member under EP
  raise JAX's errors; the TP/EP flag rules and translation notes equal
  JAX's ``resolve`` on the same flags.
"""

from __future__ import annotations

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_hc_bench_torch import flags
from tpu_hc_bench_torch.parallel import distributed, tensor
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

WORLD = 4
ROWS = 4                       # the global batch
SEQ = 32
STEPS = 2
# arm -> (model, mode, model-axis size)
ARMS = {"bert_tiny": ("bert_tiny", "tp", 2),
        "llama_tiny": ("llama_tiny", "tp", 2),
        "vit_tiny": ("vit_tiny", "tp", 2),
        "moe_ep2": ("moe_tiny", "ep", 2),
        "moe_ep4": ("moe_tiny", "ep", 4)}
NUM_CLASSES = 10


def _tp_rtol() -> float:
    from tpu_hc_bench._compat import CAPABILITIES

    # JAX's own tolerance between its TP and replicated arms
    return 1e-4 if CAPABILITIES["exact_gspmd_numerics"] else 2e-2


def _global_batch(name: str):
    from tpu_hc_bench_torch.data.synthetic import (SyntheticImages,
                                                   SyntheticTokens)
    from tpu_hc_bench_torch.models import get_model_spec

    spec = get_model_spec(name)
    if spec.is_text:
        return SyntheticTokens(ROWS, SEQ, 1024, seed=4,
                               causal_lm=spec.causal_lm).batch()
    return SyntheticImages(ROWS, (32, 32, 3), NUM_CLASSES, seed=3).batch()


def _cfg(name: str, mode: str, size: int) -> flags.BenchmarkConfig:
    key = "model_parallel" if mode == "tp" else "expert_parallel"
    return flags.BenchmarkConfig(model=name, device="cpu",
                                 batch_size=ROWS * size // WORLD,
                                 num_classes=NUM_CLASSES,
                                 **{key: size}).resolve()


def _worker(out_dir: str) -> None:
    """One rank: every arm, two steps from the saved weights; then the
    llama checkpoint at tp 2."""
    assert "jax" not in sys.modules and "tpu_hc_bench" not in sys.modules
    from tpu_hc_bench_torch.data.synthetic import (rank_rows, to_device,
                                                   tokens_to_device)
    from tpu_hc_bench_torch.models import create_model, get_model_spec
    from tpu_hc_bench_torch.parallel.fabric import Fabric
    from tpu_hc_bench_torch.train import step as step_mod
    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    worker = distributed.worker_from_env()
    distributed.init_group("gloo", worker)
    out: dict = {}
    try:
        for arm, (name, mode, size) in ARMS.items():
            mesh = distributed.build_mesh(model_parallel=size,
                                          force_seq_axis=False)
            model, spec = create_model(name, device="cpu", seed=1,
                                       train=True, num_classes=NUM_CLASSES)
            model.load_state_dict(torch.load(Path(out_dir) / f"{name}.pt"))
            tp = tensor.shard_model_(model, mesh.model_group, mode,
                                     mesh.data_group)
            cfg = _cfg(name, mode, size)
            state = step_mod.make_train_state(model, cfg, Fabric.ICI, mesh,
                                              tp)
            state.model.eval()                 # dropout off, as JAX's
            rows = rank_rows(_global_batch(name), mesh.data_index,
                             ROWS // mesh.dp)
            batch = (tokens_to_device(rows, torch.device("cpu"))
                     if spec.is_text else to_device(rows,
                                                    torch.device("cpu")))
            rec = {"losses": [], "aux": [], "dropped": []}
            for _ in range(STEPS):
                state, metrics = step_mod.train_step(state, batch)
                rec["losses"].append(float(metrics["loss"]))
                if getattr(model, "aux_loss", None) is not None:
                    rec["aux"].append(float(model.aux_loss))
                    rec["dropped"].append(float(model.moe_dropped))
            rec["local"] = {k: v.clone() for k, v in
                            model.state_dict().items()}
            rec["full"] = tensor.full_state_dict(model, tp)
            rec["mesh"] = (mesh.dp, mesh.tp, mesh.data_index,
                           mesh.model_index)
            out[arm] = rec
            if arm == "llama_tiny":
                topo = ckpt.topology_record(WORLD, cfg, mesh=mesh.shape)
                ckpt.save(state, Path(out_dir) / "ckpt", topology=topo,
                          write=worker.rank == 0)
                dist.barrier()
                full_opt = tensor.full_optimizer_state(state.optimizer,
                                                       model, tp)
                fresh, _ = create_model(name, device="cpu", seed=9,
                                        train=True)
                ftp = tensor.shard_model_(fresh, mesh.model_group, mode,
                                          mesh.data_group)
                fstate = step_mod.make_train_state(fresh, cfg, Fabric.ICI,
                                                   mesh, ftp)
                ckpt.restore(fstate, Path(out_dir) / "ckpt",
                             expect_topology=topo, rank=worker.rank)
                out["resumed_tp2"] = {
                    "model": ckpt.fingerprint(
                        tensor.full_state_dict(fresh, ftp)),
                    "saved": ckpt.fingerprint(rec["full"]),
                    "optimizer": ckpt.fingerprint(
                        tensor.full_optimizer_state(fstate.optimizer, fresh,
                                                    ftp)["state"]),
                    "saved_optimizer": ckpt.fingerprint(full_opt["state"])}
                fstate.dp.grads.close()
            state.dp.grads.close()
        torch.save(out, Path(out_dir) / f"rank{worker.rank}.pt")
    finally:
        dist.destroy_process_group()


def _flax_params(name: str, seed: int):
    import jax
    import jax.numpy as jnp

    from test_torch_lm import _perturb
    from tpu_hc_bench.models import create_model as jax_create

    model, spec = jax_create(name, num_classes=NUM_CLASSES)
    x = (jnp.zeros((1, 8), jnp.int32) if spec.is_text
         else jnp.zeros((1, 32, 32, 3), jnp.float32))
    return model, _perturb(model.init(jax.random.PRNGKey(seed), x,
                                      train=False)["params"], seed + 10)


def _jax_steps(name: str, mode: str, size: int, model, params):
    """JAX's GSPMD TP/EP step on a (data, model) mesh of four virtual
    devices, dropout off: each step's loss and the final params."""
    import jax
    import jax.numpy as jnp

    from test_torch_train import _np_tree
    from tpu_hc_bench import flags as jax_flags
    from tpu_hc_bench.models import get_model_spec
    from tpu_hc_bench.topology import (DATA_AXIS, MODEL_AXIS, build_mesh,
                                       compute_layout)
    from tpu_hc_bench.train import step as jax_step

    mesh = build_mesh(compute_layout(1, WORLD, len(jax.devices())),
                      model_parallel=size)
    assert dict(mesh.shape) == {DATA_AXIS: WORLD // size, MODEL_AXIS: size}
    key = "model_parallel" if mode == "tp" else "expert_parallel"
    cfg = jax_flags.BenchmarkConfig(model=name, batch_size=1,
                                    variable_update="replicated",
                                    num_classes=NUM_CLASSES,
                                    **{key: size}).resolve()
    tx = jax_step.make_optimizer(cfg)
    state = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
        opt_state=tx.init(params),
        apply_fn=lambda v, x, train, rngs, mutable: model.apply(
            v, x, train=False, rngs=rngs, mutable=mutable),
        tx=tx)
    state = jax_step.shard_state_tp(state, mesh, mode)
    step_fn = jax_step.build_train_step(mesh, cfg, get_model_spec(name))
    batch = jax_step.shard_batch(_global_batch(name), mesh)
    losses = []
    for _ in range(STEPS):
        state, metrics = step_fn(state, batch, jax.random.PRNGKey(0))
        losses.append(float(metrics["loss"]))
    return losses, _np_tree(state.params)


def _jax_moe_aux(model, params, name: str) -> float:
    """JAX's summed aux terms of the whole batch (its sown ``losses``)
    at ``params``."""
    import jax

    tokens = _global_batch(name)[0]
    _, col = model.apply({"params": params}, tokens, train=False,
                         mutable=["losses"])
    return float(sum(np.sum(np.asarray(t))
                     for t in jax.tree_util.tree_leaves(col["losses"])))


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    from tpu_hc_bench_torch import convert

    out_dir = tmp_path_factory.mktemp("tp_runs")
    flax = {}
    for name in sorted({name for name, _, _ in ARMS.values()}):
        model, params = _flax_params(name, 3)
        flax[name] = (model, params)
        full = convert.sharded_params_from_flax(name, params, 1, 0)
        torch.save(full, out_dir / f"{name}.pt")
    workers = [distributed.Worker(r, r, WORLD, f"file://{out_dir}/store")
               for r in range(WORLD)]
    rc = distributed.spawn_local(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         str(out_dir)], workers, print)
    assert rc == 0
    port = [torch.load(out_dir / f"rank{r}.pt") for r in range(WORLD)]
    ref = {arm: _jax_steps(name, mode, size, *flax[name])
           for arm, (name, mode, size) in ARMS.items()}
    aux0 = _jax_moe_aux(*flax["moe_tiny"], "moe_tiny")
    return port, ref, flax, aux0, out_dir


# --- the rule table ----------------------------------------------------------


def _marked_tree(params, mode: str, size: int):
    """Each Flax leaf filled with the model-axis shard index of each
    element under JAX's ``tp_param_spec`` (-1: replicated)."""
    import jax

    from tpu_hc_bench.topology import MODEL_AXIS
    from tpu_hc_bench.train import step as jax_step

    def mark(path, leaf):
        spec = jax_step.tp_param_spec(
            "/".join(getattr(k, "key", str(k)) for k in path), leaf.ndim,
            mode)
        out = np.full(leaf.shape, -1.0, np.float32)
        for axis, name in enumerate(spec):
            if name == MODEL_AXIS:
                n = leaf.shape[axis]
                idx = (np.arange(n) // (n // size)).astype(np.float32)
                shape = [1] * leaf.ndim
                shape[axis] = n
                out = np.broadcast_to(idx.reshape(shape),
                                      leaf.shape).copy()
        return out

    return jax.tree_util.tree_map_with_path(mark, params)


@pytest.mark.parametrize("name,mode", [
    ("bert_tiny", "tp"), ("moe_tiny", "tp"), ("moe_tiny", "ep"),
    ("llama_tiny", "tp"), ("vit_tiny", "tp")])
def test_rules_split_what_jax_splits(name, mode):
    import jax
    import jax.numpy as jnp

    from tpu_hc_bench.models import create_model as jax_create
    from tpu_hc_bench_torch import convert

    size = 2
    model, spec = jax_create(name, num_classes=NUM_CLASSES)
    x = (jnp.zeros((1, 8), jnp.int32) if spec.is_text
         else jnp.zeros((1, 32, 32, 3), jnp.float32))
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), x, train=False))["params"]
    marked = _marked_tree(shapes, mode, size)
    full = convert.sharded_params_from_flax(name, marked, 1, 0, mode)
    split = 0
    for k, v in full.items():
        rule = tensor.tp_param_rule(k, v.dim(), mode)
        if rule is None:
            assert (v == -1).all(), k
            continue
        split += 1
        for r in range(size):
            piece = tensor.cut(v, rule, size, r)
            assert (piece == r).all(), (k, r)
        pieces = [tensor.cut(v, rule, size, r) for r in range(size)]
        assert torch.equal(tensor.join(pieces, rule), v), k
    assert split > 0
    # the sharded converter is the full one cut
    for r in range(size):
        mine = convert.sharded_params_from_flax(name, marked, size, r, mode)
        for k, v in mine.items():
            rule = tensor.tp_param_rule(k, v.dim(), mode)
            assert (v == (r if rule else -1)).all(), (k, r)


# --- the steps against JAX ---------------------------------------------------


@pytest.mark.parametrize("arm", list(ARMS))
def test_steps_match_jax(tp_runs, arm):
    from test_torch_dp import _close
    from test_torch_train import PARAM_TOL
    from tpu_hc_bench_torch import convert

    port, ref, _, _, _ = tp_runs
    name = ARMS[arm][0]
    losses, params = ref[arm]
    for i, (got, want) in enumerate(zip(port[0][arm]["losses"], losses)):
        assert abs(got - want) <= _tp_rtol() * abs(want), (arm, i, got,
                                                           want)
    want = convert.sharded_params_from_flax(name, params, 1, 0)
    state = port[0][arm]["full"]
    assert set(state) == set(want)
    for k, t in state.items():
        _close(t, want[k], PARAM_TOL, f"{arm} {k}")


@pytest.mark.parametrize("arm", list(ARMS))
def test_model_groups_hold_one_state(tp_runs, arm):
    port, _, _, _, _ = tp_runs
    name, mode, size = ARMS[arm]
    for r in range(WORLD):
        assert port[r][arm]["losses"] == port[0][arm]["losses"], (arm, r)
        dp_, tp_, data_index, model_index = port[r][arm]["mesh"]
        assert (dp_, tp_) == (WORLD // size, size)
        assert (data_index, model_index) == (r // size, r % size)
        for k, t in port[r][arm]["full"].items():
            assert torch.equal(t, port[0][arm]["full"][k]), (arm, r, k)
        for k, t in port[r][arm]["local"].items():
            rule = tensor.tp_param_rule(k, t.dim(), mode)
            if rule is None:
                assert torch.equal(t, port[0][arm]["local"][k]), (arm, r, k)


def test_a_rank_holds_its_share_of_heads_and_experts(tp_runs):
    port, _, _, _, _ = tp_runs
    bert_local = port[1]["bert_tiny"]["local"]
    # bert_tiny: 4 heads of 32, FFN 512, 2 ways
    assert bert_local["layers.0.attn.qkv.weight"].shape == (3 * 2 * 32, 128)
    assert bert_local["layers.0.attn.out.weight"].shape == (128, 2 * 32)
    assert bert_local["layers.0.fc.weight"].shape == (256, 128)
    assert bert_local["layers.0.proj.bias"].shape == (128,)
    llama = port[1]["llama_tiny"]["local"]       # 8 q / 2 kv heads of 16
    assert llama["layers.0.attn.wq.weight"].shape == (4 * 16, 128)
    assert llama["layers.0.attn.wk.weight"].shape == (1 * 16, 128)
    assert llama["layers.0.down.weight"].shape == (128, 128)
    for arm, size in (("moe_ep2", 2), ("moe_ep4", 4)):
        local = port[0][arm]["local"]
        assert local["layers.0.moe.wi"].shape == (4 // size, 128, 256)
        # EP leaves the attention whole
        assert local["layers.0.attn.qkv.weight"].shape == (384, 128)


@pytest.mark.parametrize("arm", ["moe_ep2", "moe_ep4"])
def test_moe_aux_and_drops_are_the_global_batch(tp_runs, arm):
    from tpu_hc_bench_torch.data.synthetic import tokens_to_device
    from tpu_hc_bench_torch.models import create_model

    port, _, flax, aux0, out_dir = tp_runs
    got = port[0][arm]
    assert abs(got["aux"][0] - aux0) <= 1e-5 * abs(aux0), (got["aux"],
                                                           aux0)
    for r in range(WORLD):
        assert port[r][arm]["aux"] == got["aux"]
        assert port[r][arm]["dropped"] == got["dropped"]
    # the unsharded model on the whole batch drops the same pairs
    model, _ = create_model("moe_tiny", device="cpu", seed=1, train=False)
    model.load_state_dict(torch.load(out_dir / "moe_tiny.pt"))
    tokens = tokens_to_device(_global_batch("moe_tiny"),
                              torch.device("cpu"))[0]
    with torch.no_grad():
        model(tokens)
    assert abs(float(model.moe_dropped) - got["dropped"][0]) <= 1e-6
    assert abs(float(model.aux_loss) - got["aux"][0]) <= 1e-5 * aux0


# --- checkpoints -------------------------------------------------------------


def test_tp_checkpoint_resumes_at_tp2_and_tp1(tp_runs):
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.train import step as step_mod
    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    port, _, _, _, out_dir = tp_runs
    for r in range(WORLD):
        rec = port[r]["resumed_tp2"]
        assert rec["model"] == rec["saved"], r
        assert rec["optimizer"] == rec["saved_optimizer"], r
    saved = ckpt.read_topology(out_dir / "ckpt")
    assert saved["mesh"] == {"data": 2, "model": 2}
    assert saved["variable_update"] == "replicated"
    cfg = flags.BenchmarkConfig(model="llama_tiny", device="cpu",
                                variable_update="replicated").resolve()
    live = ckpt.topology_record(1, cfg)
    action, plan = ckpt.check_topology(saved, live)
    assert action == "noop" and "data:2xmodel:2" in plan
    model, _ = create_model("llama_tiny", device="cpu", seed=9, train=True)
    state = step_mod.make_train_state(model, cfg)
    ckpt.restore(state, out_dir / "ckpt", expect_topology=live)
    assert ckpt.fingerprint(model.state_dict()) == \
        port[0]["resumed_tp2"]["saved"]
    assert state.step == STEPS


# --- errors and flags --------------------------------------------------------


@pytest.mark.parametrize("name,mode", [("lenet", "tp"), ("bert_tiny", "ep"),
                                       ("gpt2", "ep")])
def test_unmatched_models_raise_jaxs_errors(name, mode):
    import jax

    from tpu_hc_bench.models import create_model as jax_create
    from tpu_hc_bench.train import step as jax_step
    from tpu_hc_bench_torch.models import get_model_spec

    jmodel, spec = jax_create(name, num_classes=NUM_CLASSES)
    shape = ((1, 8) if spec.is_text else (1, *spec.input_shape))
    x = jax.numpy.zeros(shape, jax.numpy.int32 if spec.is_text
                        else jax.numpy.float32)
    params = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x,
                                                train=False))["params"]
    with pytest.raises(ValueError) as want:
        jax_step.shard_state_tp(types.SimpleNamespace(params=params), None,
                                mode)
    kw = {} if get_model_spec(name).is_text else {
        "num_classes": NUM_CLASSES}
    distributed.init_single("gloo")
    try:
        with torch.device("meta"):
            model = get_model_spec(name).create(**kw)
        with pytest.raises(ValueError) as got:
            tensor.shard_model_(model, dist.group.WORLD, mode)
        assert str(got.value) == str(want.value)
    finally:
        dist.destroy_process_group()


def test_llama_tp_must_divide_the_kv_heads(monkeypatch):
    from tpu_hc_bench_torch.models import get_model_spec

    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    with torch.device("meta"):
        model = get_model_spec("llama_tiny").create()     # 2 KV heads
    with pytest.raises(ValueError, match="model_parallel=4 must divide "
                                         "num_kv_heads=2"):
        tensor.shard_model_(model, "model-group", "tp")


def test_gradients_average_over_the_data_group_under_a_model_axis_only():
    """The seq ranks of sequence parallelism hold the same parameters and
    average over the whole world; the ranks of a model group hold
    different shards and average over their data group (the mesh's
    gradient group, ``distributed.build_mesh``)."""
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.parallel.fabric import Fabric
    from tpu_hc_bench_torch.train import step as step_mod

    distributed.init_single("gloo")
    try:
        cfg = flags.BenchmarkConfig(model="llama_tiny",
                                    device="cpu").resolve()
        data = dist.new_group([0])
        for tp_, want in ((1, None), (2, data)):
            mesh = distributed.Mesh(dp=1, sp=1, data_index=0, seq_index=0,
                                    data_group=data, tp=tp_,
                                    grad_group=want)
            model, _ = create_model("llama_tiny", device="cpu", seed=0)
            state = step_mod.make_train_state(model, cfg, Fabric.ICI, mesh)
            assert state.dp.group is want and state.dp.grads.group is want
            state.dp.grads.close()
    finally:
        dist.destroy_process_group()


FLAG_CASES = [
    dict(model_parallel=2),
    dict(model_parallel=2, variable_update="horovod"),
    dict(model_parallel=2, variable_update="replicated"),
    dict(expert_parallel=2, model="moe_tiny"),
    dict(expert_parallel=4, model="moe_tiny", moe_impl="auto",
         seq_len=4096),
    dict(model_parallel=2, model="moe_tiny", moe_impl="auto"),
    dict(expert_parallel=2, model="moe_tiny", moe_impl="ragged"),
    dict(model_parallel=2, model="moe_tiny", moe_impl="ragged"),
    dict(model_parallel=2, expert_parallel=2),
    dict(model_parallel=2, variable_update="zero1"),
    dict(expert_parallel=2, variable_update="zero1", model="moe_tiny"),
    dict(model_parallel=2, gradient_accumulation_steps=2, batch_size=4),
    dict(expert_parallel=2, sequence_parallel=2, model="moe_tiny"),
    dict(model_parallel=2, attention_impl="ring"),
    dict(expert_parallel=2, attention_impl="ulysses_flash",
         model="moe_tiny"),
    dict(num_slices=2),
    dict(resume="elastic"),
    dict(resume="elastic", train_dir="/x"),
]


@pytest.mark.parametrize("kw", FLAG_CASES,
                         ids=["-".join(f"{k}={v}" for k, v in kw.items())
                              for kw in FLAG_CASES])
def test_tp_ep_flag_rules_follow_jax(kw):
    from tpu_hc_bench import flags as jax_flags

    kw = dict({"model": "llama_tiny"}, **kw)

    def resolve(make):
        try:
            return make(**kw).resolve(), None
        except ValueError as e:
            return None, str(e)

    mine, my_err = resolve(lambda **k: flags.BenchmarkConfig(device="cpu",
                                                             **k))
    ref, ref_err = resolve(jax_flags.BenchmarkConfig)
    assert my_err == ref_err
    if ref is None:
        return
    for name in ("variable_update", "model_parallel", "expert_parallel",
                 "num_slices", "moe_impl", "resume"):
        assert getattr(mine, name) == getattr(ref, name), name
    for key in ("moe_impl", "variable_update"):
        assert mine.translations.get(key) == ref.translations.get(key), key


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
