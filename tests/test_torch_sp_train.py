"""The port's sequence-parallel training step, launcher and flags against
the JAX package, on the CPU (gloo; no card here).

- **the step**: four gloo ranks on a (data 2, seq 2) mesh (this file run
  as a worker script by the port's own ``spawn_local``) against JAX's
  ``build_train_step`` on a (data 2, seq 2) mesh of the conftest's
  virtual CPU devices: ``llama_tiny`` (no dropout, so both steps see one
  function) from perturbed Flax weights, two momentum-SGD steps (the
  lane's defaults, lr 0.01) on ``SyntheticTokens(4, 64)`` (2 sequences
  a data group, 32 tokens a rank), with ``ring``, with
  ``ulysses_flash`` (the flash kernels' plain version here, JAX's Pallas
  kernel in interpret mode), with ``ring`` at
  ``--gradient_accumulation_steps=2``, and with both under
  ``--gradient_checkpointing`` (the recompute re-issues the ring's
  shifts and the all-to-alls in the backward; it changes no value, so
  those arms are held to JAX's plain step).  The loss of each step within
  ``LOSS_RTOL``, every parameter within ``PARAM_TOL`` of its scale
  (``test_torch_train.py``'s), and every rank's parameters bit-equal to
  rank 0's.
- **the launcher**: ``1 4 2 ib --model=llama_tiny --sequence_parallel=2``
  with ``ring`` and ``ulysses_flash``: the result counts the world's
  sequences (``global_batch`` 4), not its shards, and names
  ``sequence_parallel``; the host fabric and a non-text member refuse.
- **the flags**: the port's rules and translation notes against JAX's
  ``BenchmarkConfig.resolve`` on the same flags.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_hc_bench_torch import flags, launcher
from tpu_hc_bench_torch.parallel import distributed
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

WORLD, SP = 4, 2
PER_RANK = 2                   # sequences a rank (of its data group)
SEQ = 64
VOCAB = 1024
STEPS = 2
# arm -> (attention_impl, gradient_accumulation_steps,
# --gradient_checkpointing); remat changes no value, so its arm is held
# to the plain JAX step
ARMS = {"ring": ("ring", 1, False),
        "ulysses_flash": ("ulysses_flash", 1, False),
        "ring_accum2": ("ring", 2, False), "ring_remat": ("ring", 1, True),
        "ulysses_flash_remat": ("ulysses_flash", 1, True)}


def _cfg(impl: str, accum: int, remat: bool) -> flags.BenchmarkConfig:
    return flags.BenchmarkConfig(
        model="llama_tiny", device="cpu", batch_size=PER_RANK,
        sequence_parallel=SP, attention_impl=impl,
        gradient_accumulation_steps=accum,
        gradient_checkpointing=remat).resolve()


def _global_batch():
    from tpu_hc_bench_torch.data.synthetic import SyntheticTokens

    return SyntheticTokens(WORLD // SP * PER_RANK, SEQ, VOCAB, seed=5,
                           causal_lm=True).batch()


def _worker(out_dir: str) -> None:
    """One rank: every arm, two steps from the saved weights."""
    assert "jax" not in sys.modules and "tpu_hc_bench" not in sys.modules
    from tpu_hc_bench_torch.data.synthetic import (rank_rows, seq_slice,
                                                   tokens_to_device)
    from tpu_hc_bench_torch.models import llama
    from tpu_hc_bench_torch.parallel.fabric import Fabric
    from tpu_hc_bench_torch.train import step as step_mod

    worker = distributed.worker_from_env()
    distributed.init_group("gloo", worker)
    try:
        init = torch.load(Path(out_dir) / "init.pt")
        mesh = distributed.build_mesh(SP)
        batch = tokens_to_device(seq_slice(
            rank_rows(_global_batch(), mesh.data_index, PER_RANK),
            mesh.seq_index, SP), torch.device("cpu"))
        out = {}
        for arm, (impl, accum, remat) in ARMS.items():
            model = llama.llama_tiny(attention_impl=impl, remat=remat,
                                     seq_axis=mesh.seq_group)
            model.load_state_dict(init)
            state = step_mod.make_train_state(
                model, _cfg(impl, accum, remat), Fabric.ICI)
            losses = []
            for _ in range(STEPS):
                state, metrics = step_mod.train_step(state, batch)
                losses.append(float(metrics["loss"]))
            state.dp.grads.close()
            out[arm] = {"losses": losses, "state": model.state_dict()}
        torch.save(out, Path(out_dir) / f"rank{worker.rank}.pt")
    finally:
        dist.destroy_process_group()


def _jax_steps(params, impl: str, accum: int):
    """JAX's SP step on a (data 2, seq 2) mesh: the losses and the final
    params."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from test_torch_train import _np_tree
    from tpu_hc_bench import flags as jax_flags
    from tpu_hc_bench.models import get_model_spec
    from tpu_hc_bench.models import llama as jax_llama
    from tpu_hc_bench.topology import (DATA_AXIS, SEQ_AXIS, build_mesh,
                                       compute_layout)
    from tpu_hc_bench.train import step as jax_step

    mesh = build_mesh(compute_layout(1, WORLD, len(jax.devices())),
                      sequence_parallel=SP)
    assert dict(mesh.shape) == {DATA_AXIS: 2, SEQ_AXIS: 2}
    cfg = jax_flags.BenchmarkConfig(
        model="llama_tiny", batch_size=PER_RANK, sequence_parallel=SP,
        attention_impl=impl, gradient_accumulation_steps=accum).resolve()
    model = jax_llama.llama_tiny(attention_impl=impl, seq_axis=SEQ_AXIS)
    tx = jax_step.make_optimizer(cfg)
    state = jax_step.replicate_state(jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
        opt_state=tx.init(params), apply_fn=model.apply, tx=tx), mesh)
    step_fn = jax_step.build_train_step(mesh, cfg,
                                        get_model_spec("llama_tiny"))
    batch = jax_step.shard_batch(_global_batch(), mesh,
                                 P(DATA_AXIS, SEQ_AXIS))
    losses = []
    for _ in range(STEPS):
        state, metrics = step_fn(state, batch, jax.random.PRNGKey(0))
        losses.append(float(metrics["loss"]))
    return losses, _np_tree(state.params)


@pytest.fixture(scope="module")
def sp_train(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from test_torch_lm import _perturb
    from tpu_hc_bench.models import llama as jax_llama
    from tpu_hc_bench_torch import convert

    params = _perturb(jax_llama.llama_tiny().init(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32),
        train=False)["params"], 13)
    out_dir = tmp_path_factory.mktemp("sp_train")
    torch.save(convert.llama_params_from_flax(params), out_dir / "init.pt")
    workers = [distributed.Worker(r, r, WORLD, f"file://{out_dir}/store")
               for r in range(WORLD)]
    rc = distributed.spawn_local(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         str(out_dir)], workers, print)
    assert rc == 0
    port = [torch.load(out_dir / f"rank{r}.pt") for r in range(WORLD)]
    ref = {arm: _jax_steps(params, impl, accum)
           for arm, (impl, accum, _) in ARMS.items()}
    return port, ref


@pytest.mark.parametrize("arm", list(ARMS))
def test_dp2_sp2_steps_match_jax(sp_train, arm):
    from test_torch_train import LOSS_RTOL, PARAM_TOL

    from test_torch_dp import _close
    from tpu_hc_bench_torch import convert

    port, ref = sp_train
    losses, params = ref[arm]
    for i, (got, want) in enumerate(zip(port[0][arm]["losses"], losses)):
        assert abs(got - want) <= LOSS_RTOL * abs(want), (arm, i, got, want)
    want = convert.llama_params_from_flax(params)
    state = port[0][arm]["state"]
    assert set(state) == set(want)
    for name, t in state.items():
        _close(t, want[name], PARAM_TOL, f"{arm} {name}")


@pytest.mark.parametrize("arm", list(ARMS))
def test_dp2_sp2_ranks_hold_one_state(sp_train, arm):
    port, _ = sp_train
    for r in range(1, WORLD):
        assert port[r][arm]["losses"] == port[0][arm]["losses"], (arm, r)
        for name, t in port[r][arm]["state"].items():
            assert torch.equal(t, port[0][arm]["state"][name]), (arm, r,
                                                                 name)


@pytest.mark.parametrize("impl", ["ring", "ulysses_flash"])
def test_launcher_sp2_counts_sequences(impl):
    lines: list[str] = []
    rc = launcher.main(
        ["1", str(WORLD), "2", "ib", "--model=llama_tiny", "--device=cpu",
         f"--sequence_parallel={SP}", f"--attention_impl={impl}",
         "--num_warmup_batches=1", "--num_batches=2", "--display_every=1"],
        print_fn=lines.append)
    assert rc == 0
    res = [json.loads(ln) for ln in lines if ln.startswith("{")][-1]
    assert res["total_workers"] == WORLD and res["sequence_parallel"] == SP
    assert res["global_batch"] == WORLD * 2 // SP
    assert res["attention_impl"] == impl and math.isfinite(
        res["final_loss"])
    assert any(ln.startswith("sequence parallel: mesh data=2 x seq=2")
               for ln in lines)
    assert sum("\texamples/sec: " in ln for ln in lines) == 2


def test_sp_refusals():
    from tpu_hc_bench_torch.train import driver

    with pytest.raises(ValueError, match="requires a device fabric"):
        launcher.main(["1", "1", "2", "sock", "--model=llama_tiny",
                       "--device=cpu", "--attention_impl=ring",
                       "--num_warmup_batches=0", "--num_batches=1"])
    distributed.init_single("gloo")
    try:
        with pytest.raises(ValueError, match="only applies to text"):
            driver.run_benchmark(flags.BenchmarkConfig(
                model="resnet20_cifar", device="cpu", batch_size=2,
                attention_impl="ring", num_warmup_batches=0,
                num_batches=1).resolve(), fabric="ib")
        with pytest.raises(ValueError, match="not divisible by "
                                             "sequence_parallel"):
            from tpu_hc_bench_torch.data.synthetic import seq_slice

            seq_slice((np.zeros((2, 9)),), 0, 2)
        with pytest.raises(ValueError, match="does not divide 1 workers"):
            driver.run_benchmark(flags.BenchmarkConfig(
                model="llama_tiny", device="cpu", batch_size=2,
                sequence_parallel=2, num_warmup_batches=0,
                num_batches=1).resolve(), fabric="ib")
    finally:
        dist.destroy_process_group()


def test_global_position_ids_take_the_shard_offset(monkeypatch):
    from tpu_hc_bench_torch.models import bert

    monkeypatch.setattr(dist, "get_world_size", lambda g: 4)
    monkeypatch.setattr(dist, "get_rank", lambda g: 3)
    assert bert.global_position_ids(8, "seq", 32).tolist() == list(
        range(24, 32))
    with pytest.raises(ValueError, match="global sequence 36 exceeds"):
        bert.global_position_ids(9, "seq", 32)
    assert bert.global_position_ids(8, None, 8).tolist() == list(range(8))


# --- the flags against JAX's -------------------------------------------------

FLAG_CASES = [
    dict(sequence_parallel=2),
    dict(sequence_parallel=2, attention_impl="flash"),
    dict(sequence_parallel=2, variable_update="replicated"),
    dict(sequence_parallel=2, variable_update="horovod"),
    dict(sequence_parallel=4, attention_impl="ulysses"),
    dict(attention_impl="ring"),
    dict(attention_impl="ulysses_flash", variable_update="replicated"),
    dict(attention_impl="ring", gradient_accumulation_steps=2,
         variable_update="replicated", batch_size=4),
    dict(sequence_parallel=2, gradient_accumulation_steps=2,
         variable_update="replicated", batch_size=4),
    dict(variable_update="zero1"),
    dict(variable_update="zero1", sequence_parallel=2),
    dict(variable_update="zero1", attention_impl="ring"),
    dict(variable_update="zero1", forward_only=True),
]


@pytest.mark.parametrize("kw", FLAG_CASES,
                         ids=["-".join(f"{k}={v}" for k, v in kw.items())
                              for kw in FLAG_CASES])
def test_sp_and_zero1_flag_rules_follow_jax(kw):
    from tpu_hc_bench import flags as jax_flags

    def resolve(make):
        try:
            return make(**kw).resolve(), None
        except ValueError as e:
            return None, str(e)

    mine, my_err = resolve(lambda **k: flags.BenchmarkConfig(
        device="cpu", model="llama_tiny", **k))
    ref, ref_err = resolve(lambda **k: jax_flags.BenchmarkConfig(
        model="llama_tiny", **k))
    assert my_err == ref_err
    if ref is None:
        return
    for name in ("attention_impl", "variable_update", "sequence_parallel",
                 "gradient_accumulation_steps"):
        assert getattr(mine, name) == getattr(ref, name), name
    for key in ("attention_impl", "sequence_parallel"):
        assert mine.translations.get(key) == ref.translations.get(key), key
    jax_note = ref.translations.get("variable_update", "")
    # the reference's horovod note names XLA, the port's the fusion
    # buckets; the SP notes after it are JAX's word for word
    assert mine.translations.get("variable_update", "").split("; ")[-1:] \
        == jax_note.split("; ")[-1:] or "horovod" in kw.get(
            "variable_update", "")
    assert mine.sp_active == (ref.sequence_parallel > 1
                              or ref.attention_impl in jax_flags
                              .SEQ_SHARDED_IMPLS)


def test_sequence_parallel_is_ported_and_elastic_still_refuses():
    assert "sequence_parallel" not in flags.LATER_SLICE_TRAIN_FLAGS
    cfg = flags.parse_benchmark_flags(["--sequence_parallel=2",
                                       "--model=llama_tiny"])
    assert (cfg.sequence_parallel, cfg.attention_impl) == (2, "ring")
    assert any("sequence_parallel=2" in ln for ln in cfg.summary_lines())
    with pytest.raises(ValueError, match="--sequence_parallel must be >= 1"):
        flags.parse_benchmark_flags(["--sequence_parallel=0"])
    # elastic resume is ported since (tests/test_torch_elastic.py), the
    # DPxSPxTP hybrid and pipeline parallelism since
    # (tests/test_torch_hybrid.py, tests/test_torch_pipeline.py);
    # --virtual_devices on the CPU (tests/test_torch_fleet.py); --config
    # refuses only bad values
    assert flags.parse_benchmark_flags(
        ["--resume=elastic", "--train_dir=/x"]).resume == "elastic"
    cfg = flags.parse_benchmark_flags(["--model=llama_tiny",
                                       "--sequence_parallel=2",
                                       "--model_parallel=2"])
    assert (cfg.sequence_parallel, cfg.model_parallel) == (2, 2)
    cfg = flags.parse_benchmark_flags(["--model=llama_tiny",
                                       "--pipeline_parallel=2",
                                       "--num_microbatches=4"])
    assert (cfg.pipeline_parallel, cfg.num_microbatches) == (2, 4)
    with pytest.raises(ValueError, match="CPU host's worker count"):
        flags.parse_benchmark_flags(["--model=llama_tiny",
                                     "--virtual_devices=8"])
    with pytest.raises(ValueError, match=">= 1"):
        flags.parse_benchmark_flags(["--model=llama_tiny", "--device=cpu",
                                     "--virtual_devices=0"])
    assert flags.parse_benchmark_flags(
        ["--model=llama_tiny", "--device=cpu", "--sequence_parallel=2",
         "--virtual_devices=8"]).virtual_devices == 8
    with pytest.raises(ValueError, match="manual|auto"):
        flags.parse_benchmark_flags(["--model=llama_tiny",
                                     "--config=x.json"])


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
