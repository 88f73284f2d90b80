"""The port's 3-D hybrids, DP x PP x TP and DP x SP x TP, against the
JAX package's hybrid steps, on the CPU (gloo; no card here).

- **the mesh**: ``distributed.mesh_shape`` gives JAX's ``build_mesh``
  axes and sizes, (data, pipe, model) and (data, seq, model), and its
  "not divisible" error word for word; on four gloo ranks each rank's
  indexes, neighbours and groups follow the axis order.
- **the steps**: four gloo ranks (this file run as a worker script by
  the port's ``spawn_local``, one spawn for the whole file): a tiny GPT
  at pp 2 x tp 2 against JAX's ``build_pp_train_step(tp=True)`` on a
  (pipe 2, model 2) mesh, and ``llama_tiny`` (ring attention) at sp 2 x
  tp 2 against JAX's ``build_train_step`` on a (seq 2, model 2) mesh,
  from perturbed Flax weights, dropout off, three momentum-SGD steps:
  each loss within 1e-4 (JAX's own tolerance between its hybrid and its
  control, ``tests/test_hybrid_mesh.py``).
- **the driver**: ``run_benchmark`` on the ranks prints JAX's
  ``tensor parallel: 2-way (hybrid with PP|SP)`` lines; Ulysses under
  SP x TP refuses heads that do not split, naming the numbers; the
  unsupported pairings raise JAX's errors at flag time.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_hc_bench_torch import flags
from tpu_hc_bench_torch.parallel import distributed, pipeline, tensor
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

WORLD = 4
STEPS = 3
HYBRID_RTOL = 1e-4
GPT = dict(vocab_size=64, hidden=32, num_layers=4, heads=4, ffn=64,
           max_len=16)
PP_ROWS, PP_SEQ, PP_M = 8, 16, 2
SP_ROWS, SP_SEQ = 4, 64


def _pp_batch():
    from tpu_hc_bench_torch.data.synthetic import SyntheticTokens

    return SyntheticTokens(PP_ROWS, PP_SEQ, vocab_size=64, seed=0,
                           causal_lm=True).batch()


def _sp_batch():
    from tpu_hc_bench_torch.data.synthetic import SyntheticTokens

    return SyntheticTokens(SP_ROWS, SP_SEQ, vocab_size=1024, seed=0,
                           causal_lm=True).batch()


# --- the worker --------------------------------------------------------------


def _pp_tp(out_dir: Path) -> dict:
    """The tiny GPT at pp 2 x tp 2, three steps."""
    from tpu_hc_bench_torch.data.synthetic import tokens_to_device
    from tpu_hc_bench_torch.models.gpt import GPTLM
    from tpu_hc_bench_torch.parallel.fabric import Fabric
    from tpu_hc_bench_torch.train import step as step_mod

    mesh = distributed.build_mesh(model_parallel=2, pipeline_parallel=2,
                                  force_seq_axis=False)
    model = GPTLM(**GPT, layer_range=pipeline.cut_stage(4, 2,
                                                        mesh.pipe_index))
    model.load_state_dict(torch.load(out_dir / f"gpt.stage"
                                     f"{mesh.pipe_index}.pt"))
    tp = tensor.shard_model_(model, mesh.model_group, "tp")
    cfg = flags.BenchmarkConfig(model="gpt2", device="cpu",
                                batch_size=PP_ROWS, pipeline_parallel=2,
                                model_parallel=2,
                                num_microbatches=PP_M).resolve()
    pipe = pipeline.make_pipeline(mesh, 4, PP_M)
    state = step_mod.make_train_state(model, cfg, Fabric.ICI, mesh, tp, pipe)
    state.model.eval()                     # dropout off, as JAX's
    batch = tokens_to_device(_pp_batch(), torch.device("cpu"))
    losses = []
    for _ in range(STEPS):
        state, m = step_mod.train_step(state, batch)
        losses.append(float(m["loss"]))
    rec = {"losses": losses, "heads": model.layers[0].attn.heads,
           "mesh": (mesh.dp, mesh.pp, mesh.tp, mesh.pipe_index,
                    mesh.model_index, mesh.pipe_prev, mesh.pipe_next),
           "full": pipeline.full_state_dict(model, tp, pipe)}
    state.dp.grads.close()
    return rec


def _sp_tp(out_dir: Path) -> dict:
    """llama_tiny (ring) at sp 2 x tp 2, three steps."""
    from tpu_hc_bench_torch.data.synthetic import seq_slice, tokens_to_device
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.parallel.fabric import Fabric
    from tpu_hc_bench_torch.train import step as step_mod

    mesh = distributed.build_mesh(sequence_parallel=2, model_parallel=2)
    model, _ = create_model("llama_tiny", device="cpu", seed=1, train=True,
                            attention_impl="ring",
                            seq_axis=mesh.seq_group)
    model.load_state_dict(torch.load(out_dir / "llama_tiny.pt"))
    tp = tensor.shard_model_(model, mesh.model_group, "tp")
    cfg = flags.BenchmarkConfig(model="llama_tiny", device="cpu",
                                batch_size=SP_ROWS, sequence_parallel=2,
                                model_parallel=2,
                                attention_impl="ring").resolve()
    state = step_mod.make_train_state(model, cfg, Fabric.ICI, mesh, tp)
    batch = tokens_to_device(seq_slice(_sp_batch(), mesh.seq_index, 2),
                             torch.device("cpu"))
    losses = []
    for _ in range(STEPS):
        state, m = step_mod.train_step(state, batch)
        losses.append(float(m["loss"]))
    rec = {"losses": losses,
           "heads": (model.layers[0].attn.heads,
                     model.layers[0].attn.kv_heads),
           "mesh": (mesh.dp, mesh.sp, mesh.tp, mesh.seq_index,
                    mesh.model_index,
                    dist.get_process_group_ranks(mesh.seq_group),
                    dist.get_process_group_ranks(mesh.model_group),
                    dist.get_process_group_ranks(mesh.grad_group))}
    state.dp.grads.close()
    return rec


def _driver(cfg_kw: dict, lines: list | None = None):
    """``run_benchmark`` on the ranks: its result, or its error's text."""
    from tpu_hc_bench_torch.train import driver

    cfg = flags.BenchmarkConfig(device="cpu", num_warmup_batches=1,
                                num_batches=2, display_every=1,
                                **cfg_kw).resolve()
    try:
        return driver.run_benchmark(
            cfg, fabric="ib", local_workers=WORLD,      # one host
            print_fn=(lines.append if lines is not None else
                      lambda _m: None)).json_line()
    except ValueError as e:
        return str(e)


def _worker(out_dir: str) -> None:
    """One rank: every arm of the file."""
    assert "jax" not in sys.modules and "tpu_hc_bench" not in sys.modules
    worker = distributed.worker_from_env()
    distributed.init_group("gloo", worker)
    out_dir = Path(out_dir)
    out: dict = {}
    try:
        out["pp_tp"] = _pp_tp(out_dir)
        out["sp_tp"] = _sp_tp(out_dir)
        for arm, kw in (
                ("drv_pp", dict(model="moe_tiny", batch_size=4,
                                pipeline_parallel=2, model_parallel=2)),
                ("drv_sp", dict(model="llama_tiny", batch_size=2,
                                sequence_parallel=2, model_parallel=2,
                                attention_impl="ring")),
                ("drv_sp_eval", dict(model="llama_tiny", batch_size=2,
                                     sequence_parallel=2, model_parallel=2,
                                     attention_impl="ring", eval=True))):
            lines: list[str] = []
            out[arm] = (_driver(kw, lines), lines)
        out["ulysses"] = _driver(dict(
            model="llama_tiny", batch_size=2, sequence_parallel=2,
            model_parallel=2, attention_impl="ulysses_flash"))
        torch.save(out, out_dir / f"rank{worker.rank}.pt")
    finally:
        dist.destroy_process_group()


# --- the JAX side ------------------------------------------------------------


def _jax_pp_tp(params):
    """JAX's ``build_pp_train_step(tp=True)`` on a (pipe 2, model 2) mesh
    of four virtual devices, dropout off: each step's loss."""
    import jax
    import optax

    from tpu_hc_bench import flags as jax_flags
    from tpu_hc_bench.models.gpt import GPTLM
    from tpu_hc_bench.parallel import pipeline as jax_pp
    from tpu_hc_bench.topology import build_mesh, compute_layout

    mesh = build_mesh(compute_layout(1, WORLD, len(jax.devices())),
                      pipeline_parallel=2, model_parallel=2)
    assert dict(mesh.shape) == {"data": 1, "pipe": 2, "model": 2}
    cfg = jax_flags.BenchmarkConfig(model="gpt2", batch_size=PP_ROWS,
                                    pipeline_parallel=2).resolve()
    stacked = jax_pp.stack_layer_params(params, 4)
    tx = optax.sgd(cfg.init_learning_rate, momentum=cfg.momentum)
    stacked, opt = jax_pp.place_pp_state(stacked, tx.init(stacked), mesh,
                                         tp=True)
    step, _ = jax_pp.build_pp_train_step(mesh, GPTLM(**GPT), cfg, PP_M,
                                         stacked, opt, deterministic=True,
                                         tp=True)
    losses = []
    for _ in range(STEPS):
        stacked, opt, loss = step(stacked, opt, _pp_batch())
        losses.append(float(loss))
    return losses


def _jax_sp_tp(model, params):
    """JAX's ``build_train_step`` on a (data 1, seq 2, model 2) mesh,
    ring attention: each step's loss."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tpu_hc_bench import flags as jax_flags
    from tpu_hc_bench.models import get_model_spec
    from tpu_hc_bench.topology import (DATA_AXIS, SEQ_AXIS, build_mesh,
                                       compute_layout)
    from tpu_hc_bench.train import step as jax_step

    mesh = build_mesh(compute_layout(1, WORLD, len(jax.devices())),
                      sequence_parallel=2, model_parallel=2)
    assert dict(mesh.shape) == {"data": 1, "seq": 2, "model": 2}
    cfg = jax_flags.BenchmarkConfig(
        model="llama_tiny", batch_size=SP_ROWS, sequence_parallel=2,
        model_parallel=2, attention_impl="ring").resolve()
    tx = jax_step.make_optimizer(cfg)
    state = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
        opt_state=tx.init(params), apply_fn=model.apply, tx=tx)
    state = jax_step.shard_state_tp(state, mesh)
    step_fn = jax_step.build_train_step(mesh, cfg,
                                        get_model_spec("llama_tiny"))
    batch = jax_step.shard_batch(_sp_batch(), mesh, P(DATA_AXIS, SEQ_AXIS))
    losses = []
    for _ in range(STEPS):
        state, metrics = step_fn(state, batch, jax.random.PRNGKey(0))
        losses.append(float(metrics["loss"]))
    return losses


@pytest.fixture(scope="module")
def hybrid_runs(tmp_path_factory):
    import jax

    from test_torch_lm import _perturb
    from tpu_hc_bench.models import create_model as jax_create
    from tpu_hc_bench.models.gpt import GPTLM
    from tpu_hc_bench.topology import SEQ_AXIS
    from tpu_hc_bench_torch import convert

    out_dir = tmp_path_factory.mktemp("hybrid_runs")
    gpt = _perturb(GPTLM(**GPT).init(jax.random.PRNGKey(0),
                                     _pp_batch()[0][:1],
                                     train=False)["params"], 10)
    for s in range(2):
        torch.save(convert.pp_stage_params_from_flax("gpt", gpt, 2, s),
                   out_dir / f"gpt.stage{s}.pt")
    llama, _ = jax_create("llama_tiny", attention_impl="ring",
                          seq_axis=SEQ_AXIS)
    init = llama.clone(attention_impl="dense", seq_axis=None)
    lparams = _perturb(init.init(jax.random.PRNGKey(1), _sp_batch()[0][:1],
                                 train=False)["params"], 11)
    torch.save(convert.llama_params_from_flax(lparams),
               out_dir / "llama_tiny.pt")
    workers = [distributed.Worker(r, r, WORLD, f"file://{out_dir}/store")
               for r in range(WORLD)]
    rc = distributed.spawn_local(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         str(out_dir)], workers, print)
    assert rc == 0
    port = [torch.load(out_dir / f"rank{r}.pt") for r in range(WORLD)]
    ref = {"pp_tp": _jax_pp_tp(gpt), "sp_tp": _jax_sp_tp(llama, lparams)}
    return port, ref


# --- the mesh ----------------------------------------------------------------


def test_mesh_shapes_and_errors_are_jaxs():
    import jax

    from tpu_hc_bench.topology import build_mesh, compute_layout

    layout = compute_layout(1, 8, len(jax.devices()))
    for kw in (dict(pipeline_parallel=2, model_parallel=2),
               dict(sequence_parallel=2, model_parallel=2),
               dict(pipeline_parallel=4), dict(pipeline_parallel=8), {}):
        want = build_mesh(layout, **kw)
        got = distributed.mesh_shape(8, **kw)
        assert tuple(got) == want.axis_names, kw
        assert got == dict(want.shape), kw
    for kw in (dict(pipeline_parallel=3, model_parallel=2),
               dict(sequence_parallel=3, model_parallel=2)):
        with pytest.raises(ValueError) as want:
            build_mesh(layout, **kw)
        with pytest.raises(ValueError) as got:
            distributed.mesh_shape(8, **kw)
        assert str(got.value) == str(want.value)
        assert "not divisible by the minor-axis product" in str(got.value)


def test_a_rank_sits_on_the_mesh_in_jaxs_axis_order(hybrid_runs):
    port, _ = hybrid_runs
    for r in range(WORLD):
        # (data, pipe, model): rank = pipe x 2 + model
        dp, pp, tp, pipe_i, model_i, prev, nxt = port[r]["pp_tp"]["mesh"]
        assert (dp, pp, tp) == (1, 2, 2)
        assert (pipe_i, model_i) == (r // 2, r % 2)
        assert prev == (r - 2 if pipe_i == 1 else None)
        assert nxt == (r + 2 if pipe_i == 0 else None)
        assert port[r]["pp_tp"]["heads"] == GPT["heads"] // 2
        # (data, seq, model): the seq group strides over the model ranks
        dp, sp, tp, seq_i, model_i, seq_g, model_g, grad_g = \
            port[r]["sp_tp"]["mesh"]
        assert (dp, sp, tp, seq_i, model_i) == (1, 2, 2, r // 2, r % 2)
        assert seq_g == [r % 2, r % 2 + 2]
        assert model_g == [r - r % 2, r - r % 2 + 1]
        assert grad_g == seq_g             # (data, seq) at one model index
        assert port[r]["sp_tp"]["heads"] == (4, 1)


# --- the steps against JAX ---------------------------------------------------


@pytest.mark.parametrize("arm", ["pp_tp", "sp_tp"])
def test_hybrid_steps_match_jax(hybrid_runs, arm):
    port, ref = hybrid_runs
    for r in range(WORLD):
        assert port[r][arm]["losses"] == port[0][arm]["losses"], (arm, r)
    np.testing.assert_allclose(port[0][arm]["losses"], ref[arm],
                               rtol=HYBRID_RTOL)


def test_pp_tp_gathers_one_model(hybrid_runs):
    port, _ = hybrid_runs
    full = port[0]["pp_tp"]["full"]
    assert sum(1 for k in full if k.endswith(".ln1.weight")) == 4
    assert full["layers.0.attn.qkv.weight"].shape == (3 * 32, 32)
    for r in range(WORLD):
        for k, t in port[r]["pp_tp"]["full"].items():
            assert torch.equal(t, full[k]), (r, k)


# --- the driver --------------------------------------------------------------


@pytest.mark.parametrize("arm,line", [
    ("drv_pp", "tensor parallel: 2-way (hybrid with PP)"),
    ("drv_sp", "tensor parallel: 2-way (hybrid with SP)"),
    ("drv_sp_eval", "tensor parallel: 2-way (hybrid with SP)")])
def test_launcher_prints_the_hybrid_lines(hybrid_runs, arm, line):
    port, _ = hybrid_runs
    res, lines = port[0][arm]
    assert isinstance(res, dict), res
    assert line in lines
    assert np.isfinite(res["final_loss"])
    assert res["model_parallel"] == 2 and res["total_workers"] == WORLD
    if arm == "drv_pp":
        assert "pipeline: 2 stages x 4 microbatches (2 layers/stage)" in lines
        assert res["global_batch"] == 4
    else:
        assert res["sequence_parallel"] == 2 and res["global_batch"] == 2
    if arm == "drv_sp_eval":
        assert res["eval_top_1"] is not None


def test_ulysses_refuses_heads_that_do_not_split(hybrid_runs):
    port, _ = hybrid_runs
    assert port[0]["ulysses"] == (
        "--attention_impl=ulysses_flash under DPxSPxTP splits a rank's "
        "heads / model_parallel over the seq axis: heads=8 (kv_heads=2) / "
        "model_parallel=2 not divisible by sequence_parallel=2")


@pytest.mark.parametrize("kw,match", [
    (dict(model="bert_tiny", pipeline_parallel=2, sequence_parallel=2),
     "not a supported composition"),
    (dict(model="moe_tiny", model_parallel=2, expert_parallel=2),
     "'model' axis"),
    (dict(model="moe_tiny", expert_parallel=2, pipeline_parallel=2),
     "data parallelism only"),
    (dict(model="moe_tiny", expert_parallel=2, sequence_parallel=2),
     "data parallelism only")])
def test_unsupported_pairings_raise_jaxs_errors(kw, match):
    from tpu_hc_bench import flags as jax_flags

    with pytest.raises(ValueError, match=match) as want:
        jax_flags.BenchmarkConfig(batch_size=2, **kw).resolve()
    with pytest.raises(ValueError) as got:
        flags.BenchmarkConfig(device="cpu", batch_size=2, **kw).resolve()
    assert str(got.value) == str(want.value)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
