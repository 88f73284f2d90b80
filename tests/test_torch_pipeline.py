"""The port's pipeline parallelism against the JAX package's GPipe step,
on the CPU (gloo; no card here).

- **layouts**: ``stack_layer_params``/``unstack_layer_params`` and the
  momentum state's restack round-trip bit for bit; JAX's stacked PP tree
  carried by ``convert.pp_stage_params_from_flax`` equals the unrolled
  tree cut to the stage.
- **the steps**: four gloo ranks (this file run as a worker script by
  the port's ``spawn_local``, one spawn for the whole file) train a tiny
  GPT (vocab 256, hidden 32, 4 layers, 4 heads, ffn 64) at dp 1 x pp 4
  (M 2) and dp 2 x pp 2 (M 4), and a tiny llama at dp 1 x pp 4, two
  momentum-SGD steps from perturbed Flax weights, dropout off, against
  JAX's ``build_pp_train_step`` on the conftest's virtual devices at the
  same mesh: each loss within ``rtol=1e-5``, every parameter within
  ``rtol=2e-4, atol=1e-5`` (JAX's own tolerances against its unsharded
  step); the MoE member's loss against JAX's grouped aux reference; every
  rank of a pipe group holds bit-equal embedding and head, and ``L /
  pp`` layers; the dropout mode trains.
- **the driver**: ``run_benchmark`` on the ranks prints JAX's
  ``pipeline:`` line; a CNN, a batch the microbatches do not divide and
  layers the stages do not divide raise JAX's errors; ``--forward_only``
  and ``--eval`` at pp 2 give DP's numbers on the same checkpoint.
- **checkpoints**: DP -> pp 2 -> pp 4 and pp 2 -> world 1 through the
  host layout, the pp-native layout from pp 2 to pp 4 and to world 1,
  bit for bit; ``elastic_plan`` refuses pp-native <-> host in JAX's
  words.
- **flags**: the PP rules and notes equal JAX's ``resolve``.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_hc_bench_torch import flags
from tpu_hc_bench_torch.parallel import distributed, pipeline
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

WORLD = 4
ROWS = 8                       # the global batch
SEQ = 16
STEPS = 2
GPT = dict(vocab_size=256, hidden=32, num_layers=4, heads=4, ffn=64,
           max_len=32)
LLAMA = dict(vocab_size=256, hidden=32, num_layers=4, heads=4,
             num_kv_heads=2, ffn=64, max_len=32)
MOE = dict(GPT, num_experts=4, top_k=2)
# arm -> (family, dp, pp, microbatches); the last arm's reference is
# JAX's grouped aux statistic, the others' JAX's PP step
ARMS = {"gpt_dp1_pp4_m2": ("gpt", 1, 4, 2),
        "gpt_dp2_pp2_m4": ("gpt", 2, 2, 4),
        "llama_dp1_pp4_m2": ("llama", 1, 4, 2),
        "moe_dp2_pp2_m2": ("moe", 2, 2, 2)}
JAX_ARMS = [a for a in ARMS if not a.startswith("moe")]
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-4, 1e-5
CK_ROWS, CK_SEQ = 8, 64        # llama_tiny's checkpoint runs


def _batch():
    from tpu_hc_bench_torch.data.synthetic import SyntheticTokens

    return SyntheticTokens(ROWS, SEQ, vocab_size=256, seed=3,
                           causal_lm=True).batch()


def _ck_batch():
    from tpu_hc_bench_torch.data.synthetic import SyntheticTokens

    return SyntheticTokens(CK_ROWS, CK_SEQ, vocab_size=1024, seed=4,
                           causal_lm=True).batch()


def _tiny(family: str, layer_range=None):
    from tpu_hc_bench_torch.models.gpt import GPTLM
    from tpu_hc_bench_torch.models.llama import LlamaLM

    if family == "llama":
        return LlamaLM(**LLAMA, layer_range=layer_range)
    return GPTLM(**(MOE if family == "moe" else GPT),
                 layer_range=layer_range)


# --- the worker --------------------------------------------------------------


def _cfg(dp: int, pp: int, m: int = 0, model: str = "gpt2", **kw):
    return flags.BenchmarkConfig(model=model, device="cpu",
                                 batch_size=ROWS // dp, pipeline_parallel=pp,
                                 num_microbatches=m, **kw).resolve()


def _pp_state(family, dp, pp, m, out_dir, arm, train=False):
    """A tiny stage from the saved weights and its state at dp x pp."""
    from tpu_hc_bench_torch.parallel.fabric import Fabric
    from tpu_hc_bench_torch.train import step as step_mod

    mesh = distributed.build_mesh(pipeline_parallel=pp, force_seq_axis=False)
    model = _tiny(family, pipeline.cut_stage(4, pp, mesh.pipe_index))
    model.load_state_dict(torch.load(
        Path(out_dir) / f"{arm}.stage{mesh.pipe_index}.pt"))
    pipe = pipeline.make_pipeline(mesh, 4, m)
    state = step_mod.make_train_state(model, _cfg(dp, pp, m), Fabric.ICI,
                                      mesh, None, pipe)
    if not train:
        state.model.eval()                 # dropout off, as JAX's
    return mesh, state


def _rows(mesh, batch, dp):
    from tpu_hc_bench_torch.data.synthetic import rank_rows, tokens_to_device

    return tokens_to_device(rank_rows(batch, mesh.data_index,
                                      batch[0].shape[0] // dp),
                            torch.device("cpu"))


def _llama_state(cfg, mesh, seed: int, pp: int):
    """llama_tiny (the registry's) at ``pp`` stages on ``mesh``."""
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.parallel.fabric import Fabric
    from tpu_hc_bench_torch.train import step as step_mod

    model, _ = create_model(
        "llama_tiny", device="cpu", seed=seed, train=True,
        pipeline=(pp, mesh.pipe_index) if pp > 1 else None)
    pipe = (pipeline.make_pipeline(mesh, model.num_layers,
                                   pipeline.default_microbatches(
                                       cfg.batch_size, pp))
            if pp > 1 else None)
    return step_mod.make_train_state(model, cfg, Fabric.ICI, mesh, None,
                                     pipe)


def _fingerprints(state) -> tuple[str, str]:
    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    opt = pipeline.full_optimizer_state(state.optimizer, state.model, None,
                                        state.pipe)
    return ckpt.model_fingerprint(state), ckpt.fingerprint(opt["state"])


def _driver(cfg_kw: dict, lines: list | None = None):
    """``run_benchmark`` on the ranks: its result, or its error's text."""
    from tpu_hc_bench_torch.train import driver

    cfg = flags.BenchmarkConfig(device="cpu", num_warmup_batches=1,
                                num_batches=1, display_every=1,
                                **cfg_kw).resolve()
    try:
        return driver.run_benchmark(
            cfg, fabric="ib", local_workers=WORLD,      # one host
            print_fn=(lines.append if lines is not None else
                      lambda _m: None)).json_line()
    except ValueError as e:
        return str(e)


def _checkpoints(out: Path, rank: int) -> dict:
    """DP -> pp 2 -> pp 4 through the host layout, pp 2 -> pp 4 through
    the pp-native one; each state's fingerprints."""
    from tpu_hc_bench_torch.data.synthetic import rank_rows, tokens_to_device
    from tpu_hc_bench_torch.train import step as step_mod
    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    rec = {}
    batch = _ck_batch()
    cfg_dp = flags.BenchmarkConfig(model="llama_tiny", device="cpu",
                                   batch_size=CK_ROWS // WORLD).resolve()
    dp = _llama_state(cfg_dp, None, 1, 1)
    rows = tokens_to_device(rank_rows(batch, rank, CK_ROWS // WORLD),
                            torch.device("cpu"))
    step_mod.train_step(dp, rows)
    ckpt.save(dp, out / "ck_dp", topology=ckpt.topology_record(
        WORLD, cfg_dp), write=rank == 0)
    dist.barrier()
    rec["dp_saved"] = _fingerprints(dp)
    dp.dp.grads.close()

    cfg2 = flags.BenchmarkConfig(model="llama_tiny", device="cpu",
                                 batch_size=CK_ROWS // 2,
                                 pipeline_parallel=2).resolve()
    mesh2 = distributed.build_mesh(pipeline_parallel=2, force_seq_axis=False)
    topo2 = ckpt.topology_record(WORLD, cfg2, mesh=mesh2.shape)
    s2 = _llama_state(cfg2, mesh2, 9, 2)
    ckpt.restore(s2, out / "ck_dp", expect_topology=topo2, rank=rank)
    rec["pp2_from_dp"] = _fingerprints(s2)
    rec["pp2_layers"] = len(s2.model.layers)
    step_mod.train_step(s2, _rows(mesh2, batch, 2))
    ckpt.save(s2, out / "ck_pp2", topology=topo2, write=rank == 0)
    dist.barrier()
    rec["pp2_saved"] = _fingerprints(s2)
    native = ckpt.topology_record(WORLD, cfg2, layout="pp-native",
                                  mesh=mesh2.shape)
    ckpt.save(s2, out / "ck_native", topology=native)
    s2.dp.grads.close()

    cfg4 = flags.BenchmarkConfig(model="llama_tiny", device="cpu",
                                 batch_size=CK_ROWS, pipeline_parallel=4
                                 ).resolve()
    mesh4 = distributed.build_mesh(pipeline_parallel=4, force_seq_axis=False)
    s4 = _llama_state(cfg4, mesh4, 9, 4)
    ckpt.restore(s4, out / "ck_pp2", expect_topology=ckpt.topology_record(
        WORLD, cfg4, mesh=mesh4.shape), rank=rank)
    rec["pp4_from_pp2"] = _fingerprints(s4)
    rec["pp4_step"] = s4.step
    s4n = _llama_state(cfg4, mesh4, 11, 4)
    ckpt.restore(s4n, out / "ck_native", rank=rank)
    rec["pp4_from_native"] = _fingerprints(s4n)
    s4.dp.grads.close()
    s4n.dp.grads.close()
    return rec


def _driver_arms(out: Path, rank: int) -> dict:
    """The launcher's path on the ranks: the banner, JAX's errors,
    forward-only and eval at pp 2 against DP from one checkpoint."""
    rec = {}
    lines: list[str] = []
    rec["pp4"] = _driver(dict(model="llama_tiny", batch_size=4,
                              pipeline_parallel=4), lines)
    rec["pp4_lines"] = lines
    rec["cnn"] = _driver(dict(model="trivial", num_classes=10,
                              batch_size=1, pipeline_parallel=4))
    rec["microbatch"] = _driver(dict(model="llama_tiny", batch_size=3,
                                     pipeline_parallel=2))
    if rank == 0:
        for name in ("eval_dp", "eval_pp", "fwd_dp", "fwd_pp"):
            shutil.copytree(out / "ck_pp2", out / name)
    dist.barrier()
    for arm, kw in (("eval", dict(eval=True)),
                    ("fwd", dict(forward_only=True))):
        rec[f"{arm}_dp"] = _driver(dict(
            model="llama_tiny", batch_size=CK_ROWS // WORLD,
            train_dir=str(out / f"{arm}_dp"), resume="must", **kw))
        rec[f"{arm}_pp"] = _driver(dict(
            model="llama_tiny", batch_size=CK_ROWS // 2,
            pipeline_parallel=2, train_dir=str(out / f"{arm}_pp"),
            resume="must", **kw))
    return rec


def _worker(out_dir: str) -> None:
    """One rank: every arm of the file."""
    assert "jax" not in sys.modules and "tpu_hc_bench" not in sys.modules
    from tpu_hc_bench_torch.models import dropout_seed
    from tpu_hc_bench_torch.train import step as step_mod

    worker = distributed.worker_from_env()
    distributed.init_group("gloo", worker)
    out_dir = Path(out_dir)
    out: dict = {}
    try:
        batch = _batch()
        for arm, (family, dp, pp, m) in ARMS.items():
            mesh, state = _pp_state(family, dp, pp, m, out_dir, arm)
            rows = _rows(mesh, batch, dp)
            losses = []
            for _ in range(STEPS):
                state, metrics = step_mod.train_step(state, rows)
                losses.append(float(metrics["loss"]))
            out[arm] = {
                "losses": losses,
                "full": pipeline.full_state_dict(state.model, None,
                                                 state.pipe),
                "shared": {n: p.detach().clone() for n, p in
                           state.model.named_parameters()
                           if not n.startswith("layers.")},
                "layers": len(state.model.layers),
                "mesh": (mesh.dp, mesh.pp, mesh.data_index,
                         mesh.pipe_index)}
            state.dp.grads.close()
        # the dropout mode: the masks drawn, one step
        mesh, state = _pp_state("gpt", 2, 2, 2, out_dir, "gpt_dp2_pp2_m4",
                                train=True)
        state.model.dropout_generator = torch.Generator().manual_seed(
            dropout_seed(0, worker.rank))
        before = float(state.model.wte.weight.abs().sum())
        state, metrics = step_mod.train_step(state, _rows(mesh, batch, 2))
        out["dropout"] = {"loss": float(metrics["loss"]),
                          "wte_before": before,
                          "wte_after": float(
                              state.model.wte.weight.abs().sum())}
        state.dp.grads.close()
        out["ckpt"] = _checkpoints(out_dir, worker.rank)
        out["driver"] = _driver_arms(out_dir, worker.rank)
        torch.save(out, out_dir / f"rank{worker.rank}.pt")
    finally:
        dist.destroy_process_group()


# --- the JAX side ------------------------------------------------------------


def _flax(family: str, seed: int = 0):
    """A tiny Flax decoder and its perturbed weights."""
    import jax

    from test_torch_lm import _perturb
    from tpu_hc_bench.models.gpt import GPTLM
    from tpu_hc_bench.models.llama import LlamaLM

    model = (LlamaLM(**LLAMA) if family == "llama"
             else GPTLM(**(MOE if family == "moe" else GPT)))
    tokens = _batch()[0]
    params = model.init(jax.random.PRNGKey(seed), tokens[:1],
                        train=False)["params"]
    return model, _perturb(params, seed + 10)


def _jax_pp_steps(model, params, dp: int, pp: int, m: int):
    """JAX's ``build_pp_train_step`` on a (data dp, pipe pp) mesh of
    four virtual devices, dropout off: each step's loss and the final
    stacked params."""
    import jax
    import optax

    from test_torch_train import _np_tree
    from tpu_hc_bench import flags as jax_flags
    from tpu_hc_bench.parallel import pipeline as jax_pp
    from tpu_hc_bench.topology import build_mesh, compute_layout

    mesh = build_mesh(compute_layout(1, WORLD, len(jax.devices())),
                      pipeline_parallel=pp)
    assert dict(mesh.shape) == {"data": dp, "pipe": pp}
    cfg = jax_flags.BenchmarkConfig(model="gpt2", batch_size=1,
                                    pipeline_parallel=pp).resolve()
    stacked = jax_pp.stack_layer_params(params, 4)
    tx = optax.sgd(cfg.init_learning_rate, momentum=cfg.momentum)
    opt = tx.init(stacked)
    step, _ = jax_pp.build_pp_train_step(mesh, model, cfg, m, stacked, opt,
                                         deterministic=True)
    losses = []
    for _ in range(STEPS):
        stacked, opt, loss = step(stacked, opt, _batch())
        losses.append(float(loss))
    return losses, _np_tree(stacked)


def _jax_grouped_moe(model, params, groups: int) -> float:
    """JAX's grouped reference (``tests/test_pipeline.py``): the task
    loss of the whole batch plus ``AUX_LOSS_COEF`` times the Switch aux
    averaged over row groups of ``groups``."""
    import jax
    import jax.numpy as jnp
    import optax

    from tpu_hc_bench.models.moe import AUX_LOSS_COEF

    tokens, targets, weights = _batch()
    logits = model.apply({"params": params}, tokens, train=False)
    losses = optax.softmax_cross_entropy_with_integer_labels(logits, targets)
    task = float((losses * weights).sum() / jnp.maximum(weights.sum(), 1.0))
    aux = []
    for g in range(0, tokens.shape[0], groups):
        _, upd = model.apply({"params": params}, tokens[g:g + groups],
                             train=False, mutable=["losses"])
        aux.append(float(sum(jnp.sum(t)
                             for t in jax.tree_util.tree_leaves(
                                 upd["losses"]))))
    return task + AUX_LOSS_COEF * float(np.mean(aux))


@pytest.fixture(scope="module")
def pp_runs(tmp_path_factory):
    from tpu_hc_bench_torch import convert

    out_dir = tmp_path_factory.mktemp("pp_runs")
    flax = {f: _flax(f) for f in ("gpt", "llama", "moe")}
    for arm, (family, _, pp, _) in ARMS.items():
        for s in range(pp):
            torch.save(convert.pp_stage_params_from_flax(
                family, flax[family][1], pp, s),
                out_dir / f"{arm}.stage{s}.pt")
    workers = [distributed.Worker(r, r, WORLD, f"file://{out_dir}/store")
               for r in range(WORLD)]
    rc = distributed.spawn_local(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         str(out_dir)], workers, print)
    assert rc == 0
    port = [torch.load(out_dir / f"rank{r}.pt") for r in range(WORLD)]
    ref = {arm: _jax_pp_steps(*flax[ARMS[arm][0]], *ARMS[arm][1:])
           for arm in JAX_ARMS}
    moe_dp, _, moe_m = ARMS["moe_dp2_pp2_m2"][1:]
    ref["moe_dp2_pp2_m2"] = _jax_grouped_moe(*flax["moe"],
                                             ROWS // moe_dp // moe_m)
    return port, ref, flax, out_dir


# --- layouts -----------------------------------------------------------------


def test_stack_unstack_round_trip():
    torch.manual_seed(0)
    model = _tiny("gpt")
    with torch.no_grad():
        for p in model.parameters():
            p.normal_()
    sd = model.state_dict()
    stacked = pipeline.stack_layer_params(sd, 4)
    assert stacked["trunk.ln1.weight"].shape[0] == 4
    assert not any(k.startswith("layers.") for k in stacked)
    back = pipeline.unstack_layer_params(stacked, 4)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    # the momentum state restacked with its parameters
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    names = [n for n, _ in model.named_parameters()]
    per = pipeline.named_optimizer_state(opt.state_dict(), names)
    params, st = pipeline.pp_state_from_train_state(sd, per, 4)
    assert st["trunk.ln1.weight"]["momentum_buffer"].shape[0] == 4
    p2, st2 = pipeline.train_state_from_pp(params, st, 4)
    assert set(st2) == set(per)
    for n, s in per.items():
        assert torch.equal(st2[n]["momentum_buffer"],
                           s["momentum_buffer"]), n
    for k, v in sd.items():
        assert torch.equal(p2[k], v), k


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_jax_stacked_tree_converts_to_each_stage(family):
    from tpu_hc_bench.parallel import pipeline as jax_pp
    from tpu_hc_bench_torch import convert

    _, params = _flax(family)
    stacked = jax_pp.stack_layer_params(params, 4)
    for pp in (1, 2, 4):
        for s in range(pp):
            got = convert.pp_stage_params_from_flax(family, stacked, pp, s)
            want = convert.pp_stage_params_from_flax(family, params, pp, s)
            assert set(got) == set(want)
            assert sum(1 for k in got if k.endswith(".attn_norm.weight")
                       or k.endswith(".ln1.weight")) == 4 // pp
            for k in got:
                assert torch.equal(got[k], want[k]), (pp, s, k)
            model = _tiny(family, pipeline.cut_stage(4, pp, s))
            model.load_state_dict(got)          # the stage's exact keys


# --- the steps against JAX ---------------------------------------------------


@pytest.mark.parametrize("arm", JAX_ARMS)
def test_pp_steps_match_jax(pp_runs, arm):
    from tpu_hc_bench_torch import convert

    port, ref, _, _ = pp_runs
    family = ARMS[arm][0]
    losses, params = ref[arm]
    np.testing.assert_allclose(port[0][arm]["losses"], losses,
                               rtol=LOSS_RTOL)
    want = convert.pp_stage_params_from_flax(family, params, 1, 0)
    got = port[0][arm]["full"]
    assert set(got) == set(want)
    for k, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[k].numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=f"{arm} {k}")


def test_pp_moe_aux_matches_jaxs_grouped_reference(pp_runs):
    port, ref, _, _ = pp_runs
    got = port[0]["moe_dp2_pp2_m2"]["losses"][0]
    np.testing.assert_allclose(got, ref["moe_dp2_pp2_m2"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("arm", list(ARMS))
def test_pipe_groups_hold_one_embedding_and_head(pp_runs, arm):
    port, _, _, _ = pp_runs
    _, dp, pp, _ = ARMS[arm]
    for r in range(WORLD):
        rec = port[r][arm]
        assert rec["mesh"] == (dp, pp, r // pp, r % pp)
        assert rec["layers"] == 4 // pp
        assert rec["losses"] == port[0][arm]["losses"]
        for k, t in rec["shared"].items():     # every rank, every stage
            assert torch.equal(t, port[0][arm]["shared"][k]), (arm, r, k)
        for k, t in rec["full"].items():
            assert torch.equal(t, port[0][arm]["full"][k]), (arm, r, k)


def test_pp_dropout_mode_trains(pp_runs):
    port, _, _, _ = pp_runs
    for r in range(WORLD):
        rec = port[r]["dropout"]
        assert np.isfinite(rec["loss"])
        assert rec["wte_after"] != rec["wte_before"]
        assert rec["loss"] == port[0]["dropout"]["loss"]


# --- the driver --------------------------------------------------------------


def test_launcher_prints_the_pipeline_line(pp_runs):
    port, _, _, _ = pp_runs
    rec = port[0]["driver"]
    lines = rec["pp4_lines"]
    assert "pipeline: 4 stages x 4 microbatches (1 layers/stage)" in lines
    assert any("translated: variable_update: psum->n/a (pipeline_parallel="
               "4 runs the dedicated GPipe" in ln for ln in lines)
    res = rec["pp4"]
    assert res["pipeline_parallel"] == 4 and res["num_microbatches"] == 4
    assert res["global_batch"] == 4 and np.isfinite(res["final_loss"])


def test_pp_refusals_are_jaxs(pp_runs):
    from tpu_hc_bench_torch.models import create_model

    port, _, _, _ = pp_runs
    rec = port[0]["driver"]
    assert rec["cnn"] == (
        "--pipeline_parallel requires a decoder implementing the PP "
        "interface (pp_embed/pp_layer_module/pp_head: the GPT and llama "
        "families), not trivial")
    assert rec["microbatch"] == ("per-worker batch 3 not divisible by "
                                 "num_microbatches=2")
    with pytest.raises(ValueError, match=r"^llama_tiny: 4 layers not "
                       r"divisible by pipeline_parallel=3$"):
        create_model("llama_tiny", device="cpu", pipeline=(3, 0))
    assert pipeline.default_microbatches(8, 2) == 4
    assert pipeline.default_microbatches(2, 2) == 2


@pytest.mark.parametrize("arm", ["eval", "fwd"])
def test_forward_only_and_eval_give_dps_numbers(pp_runs, arm):
    port, _, _, _ = pp_runs
    rec = port[0]["driver"]
    dp, pp = rec[f"{arm}_dp"], rec[f"{arm}_pp"]
    assert isinstance(dp, dict) and isinstance(pp, dict), (dp, pp)
    assert pp["pipeline_parallel"] == 2 and dp["pipeline_parallel"] == 1
    assert pp["resume"]["restored_step"] == dp["resume"]["restored_step"]
    np.testing.assert_allclose(pp["final_loss"], dp["final_loss"],
                               rtol=1e-6)
    if arm == "eval":
        assert pp["eval_top_1"] == dp["eval_top_1"]


# --- checkpoints ---------------------------------------------------------------


def test_pp_checkpoints_interchange_with_dp(pp_runs):
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.train import step as step_mod
    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    port, _, _, out_dir = pp_runs
    saved_dp = port[0]["ckpt"]["dp_saved"]
    saved_pp2 = port[0]["ckpt"]["pp2_saved"]
    for r in range(WORLD):
        rec = port[r]["ckpt"]
        assert rec["dp_saved"] == saved_dp
        assert rec["pp2_from_dp"] == saved_dp, r      # DP -> pp 2
        assert rec["pp2_saved"] == saved_pp2
        assert rec["pp4_from_pp2"] == saved_pp2, r    # pp 2 -> pp 4
        assert rec["pp4_from_native"] == saved_pp2, r
        assert rec["pp4_step"] == 2 and rec["pp2_layers"] == 2
    # pp 2 -> world 1, plain data parallel, the host layout
    _, payload = ckpt.load_payload(out_dir / "ck_pp2")
    assert ckpt.fingerprint(payload["model"]) == saved_pp2[0]
    assert ckpt.fingerprint(payload["optimizer"]["state"]) == saved_pp2[1]
    cfg = flags.BenchmarkConfig(model="llama_tiny", device="cpu").resolve()
    saved = ckpt.read_topology(out_dir / "ck_pp2")
    assert saved["pipeline_parallel"] == 2
    assert saved["mesh"] == {"data": 2, "pipe": 2}
    for directory in ("ck_pp2", "ck_native"):
        model, _ = create_model("llama_tiny", device="cpu", seed=5,
                                train=True)
        state = step_mod.make_train_state(model, cfg)
        ckpt.restore(state, out_dir / directory)
        assert ckpt.fingerprint(model.state_dict()) == saved_pp2[0]
        assert ckpt.fingerprint(state.optimizer.state_dict()["state"]) == \
            saved_pp2[1], directory
        assert state.step == 2


def test_elastic_plan_refuses_pp_native_against_host(pp_runs):
    from tpu_hc_bench import topology as jax_topology
    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    _, _, _, out_dir = pp_runs
    native = ckpt.read_topology(out_dir / "ck_native")
    host = ckpt.read_topology(out_dir / "ck_pp2")
    assert native["layout"] == "pp-native" and host["layout"] == "host"
    for saved, live in ((native, host), (host, native)):
        got = ckpt.elastic_plan(saved, live)
        assert got == jax_topology.elastic_plan(saved, live)
        assert got[0] == "refuse" and "pp-native stacked-trunk" in got[1]
    with pytest.raises(ckpt.TopologyMismatchError, match="pp-native"):
        ckpt.check_topology(native, host, out_dir / "ck_native")
    # pp-native at another pipe degree re-places as it is
    other = dict(native, pipeline_parallel=4,
                 mesh={"data": 1, "pipe": 4})
    assert ckpt.elastic_plan(native, other) == \
        jax_topology.elastic_plan(native, other)


# --- flags ---------------------------------------------------------------------

FLAG_CASES = [
    dict(pipeline_parallel=2),
    dict(pipeline_parallel=2, variable_update="horovod"),
    dict(pipeline_parallel=2, variable_update="replicated"),
    dict(pipeline_parallel=2, model_parallel=2),
    dict(pipeline_parallel=2, variable_update="zero1"),
    dict(pipeline_parallel=2, gradient_accumulation_steps=2, batch_size=4),
    dict(pipeline_parallel=2, sequence_parallel=2),
    dict(pipeline_parallel=2, expert_parallel=2, model="moe_tiny"),
    dict(pipeline_parallel=2, attention_impl="ring"),
    dict(pipeline_parallel=2, on_nonfinite="skip"),
    dict(pipeline_parallel=2, on_nonfinite="rewind", train_dir="/x"),
    dict(pipeline_parallel=2, on_nonfinite="abort"),
    dict(sequence_parallel=2, model_parallel=2),
    dict(sequence_parallel=2, model_parallel=2, variable_update="replicated"),
]


@pytest.mark.parametrize("kw", FLAG_CASES,
                         ids=["-".join(f"{k}={v}" for k, v in kw.items())
                              for kw in FLAG_CASES])
def test_pp_flag_rules_follow_jax(kw):
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
    for name in ("variable_update", "pipeline_parallel", "num_microbatches",
                 "model_parallel", "sequence_parallel", "attention_impl"):
        assert getattr(mine, name) == getattr(ref, name), name
    # the port's own horovod note ("the fusion-bucket all-reduce") leads
    # where JAX's says XLA; the notes after it are JAX's
    for key in ("variable_update", "attention_impl"):
        got, want = (t.translations.get(key) for t in (mine, ref))
        if kw.get("variable_update") == "horovod" and key == "variable_update":
            got, want = got.split("; ", 1)[1], want.split("; ", 1)[1]
        assert got == want, key
    summary = "\n".join(mine.summary_lines())
    assert (f"pipeline_parallel={mine.pipeline_parallel} "
            f"num_microbatches=auto") in summary


def test_later_flags_still_refuse():
    # --virtual_devices is ported since (tests/test_torch_fleet.py): the
    # CPU only, N >= 1
    with pytest.raises(ValueError, match="CPU host's worker count"):
        flags.parse_benchmark_flags(["--virtual_devices=8"])
    with pytest.raises(ValueError, match=">= 1"):
        flags.parse_benchmark_flags(["--virtual_devices=0", "--device=cpu"])
    assert flags.parse_benchmark_flags(
        ["--virtual_devices=8", "--device=cpu"]).virtual_devices == 8
    # --config is ported since (tests/test_torch_tune.py): only its
    # values are refused
    with pytest.raises(ValueError, match="manual|auto"):
        flags.parse_benchmark_flags(["--config=x"])
    cfg = flags.parse_benchmark_flags(["--pipeline_parallel=2",
                                       "--num_microbatches=4",
                                       "--device=cpu"])
    assert (cfg.pipeline_parallel, cfg.num_microbatches) == (2, 4)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
