"""The port's sequence-parallel attention against the JAX package's, on
the CPU (gloo; no card here).

- **the impls**: ``ring``, ``ulysses`` and ``ulysses_flash`` over a seq
  group of 2 and of 4 gloo ranks (this file run as a worker script by
  the port's own ``spawn_local``), causal and not, without GQA and with
  ``kv_repeat=2``, against ``local_attention`` of JAX's
  ``parallel/sequence.py`` under ``jax.shard_map`` over a seq axis of
  the conftest's virtual CPU devices: the output, and the gradients of
  ``sum(out * ct)`` with respect to q, k and v (``jax.vjp`` of the
  mapped function at the global level; each port rank backpropagates
  its own shard's term, and the collectives' backward carries the
  rest).  q/k/v/ct are ``[2, 32, 8, 8]`` (k/v ``[2, 32, 4, 8]`` under
  GQA) float32 from a numpy seed.  ``ulysses_flash`` runs the flash
  kernels' plain version here, JAX's Pallas kernel in interpret mode.
  Tolerance: ``FWD_TOL`` and ``GRAD_TOL`` of the reference's largest
  magnitude (at least 1).
- **offsets**: ``dense_attention``'s ``q_offset``/``k_offset`` (a
  shard's causal mask at global positions) against JAX's.
- **the degenerate axis**: in a one-rank group ``ring`` is ``dense``
  (forward and gradients within ``FWD_TOL``/``GRAD_TOL``) and
  ``ulysses_flash`` is ``flash`` bit for bit; the exchanges are copies.
- **whole models** at sp = 2: ``BertMLM`` and ``GPTLM`` with ``ring``,
  ``LlamaLM`` with ``ring`` and ``ulysses_flash``, narrow (2 layers,
  hidden 32), weights carried over from Flax: each rank's logits on its
  half of the sequence against the unsharded JAX forward (dense), as
  JAX's own ``test_sequence.py`` and ``test_llama.py`` hold theirs; the
  position offsets (learned and RoPE) and the causal mask across
  shards are what they test.  Tolerance ``MODEL_TOL``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_hc_bench_torch.parallel import collectives, distributed
from tpu_hc_bench_torch.parallel import sequence as seq
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

B, S, H, D = 2, 32, 8, 8
IMPLS = ("ring", "ulysses", "ulysses_flash")
WORLDS = (2, 4)
FWD_TOL = 1e-5
GRAD_TOL = 1e-5
MODEL_TOL = 2e-4               # JAX's own whole-model SP tolerance
MODEL_SEQ = 32
# model case -> (family, port impl)
MODEL_CASES = {"bert_ring": ("bert", "ring"), "gpt_ring": ("gpt", "ring"),
               "llama_ring": ("llama", "ring"),
               "llama_ulysses_flash": ("llama", "ulysses_flash")}
NARROW = dict(vocab_size=64, hidden=32, num_layers=2, heads=4, ffn=64,
              max_len=MODEL_SEQ)


def _case_name(impl: str, causal: bool, kv_repeat: int) -> str:
    return f"{impl}_causal{int(causal)}_kv{kv_repeat}"


def _cases() -> dict:
    """name -> (impl, causal, kv_repeat, q, k, v, ct) as numpy."""
    out = {}
    for i, (impl, causal, kv_repeat) in enumerate(
            (impl, causal, kv) for impl in IMPLS for causal in (False, True)
            for kv in (1, 2)):
        rng = np.random.default_rng(100 + i)
        q = rng.standard_normal((B, S, H, D), np.float32)
        k = rng.standard_normal((B, S, H // kv_repeat, D), np.float32)
        v = rng.standard_normal((B, S, H // kv_repeat, D), np.float32)
        ct = rng.standard_normal((B, S, H, D), np.float32)
        out[_case_name(impl, causal, kv_repeat)] = (impl, causal, kv_repeat,
                                                    q, k, v, ct)
    return out


def _shard(a: np.ndarray, r: int, n: int) -> torch.Tensor:
    k = a.shape[1] // n
    return torch.from_numpy(np.ascontiguousarray(a[:, r * k:(r + 1) * k]))


def _port_case(impl, causal, kv_repeat, q, k, v, ct, group):
    """This rank's output and q/k/v gradients of its shard."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    qs, ks, vs = (_shard(a, r, n).requires_grad_() for a in (q, k, v))
    out = seq.local_attention(qs, ks, vs, impl, seq_group=group,
                              causal=causal, kv_repeat=kv_repeat)
    (out * _shard(ct, r, n)).sum().backward()
    return out.detach(), qs.grad, ks.grad, vs.grad


def _port_model(family: str, impl: str, group):
    from tpu_hc_bench_torch.models import bert, gpt, llama

    if family == "bert":
        return bert.BertMLM(**NARROW, attention_impl=impl, seq_axis=group)
    if family == "gpt":
        return gpt.GPTLM(**NARROW, attention_impl=impl, seq_axis=group)
    return llama.LlamaLM(**NARROW, num_kv_heads=2, attention_impl=impl,
                         seq_axis=group)


def _worker(out_dir: str) -> None:
    """One rank: every attention case over the world as one seq group;
    at world 2 also the whole-model forwards."""
    assert "jax" not in sys.modules and "tpu_hc_bench" not in sys.modules
    worker = distributed.worker_from_env()
    distributed.init_group("gloo", worker)
    try:
        mesh = distributed.build_mesh(worker.world_size)
        group = mesh.seq_group
        out = {}
        for name, case in torch.load(Path(out_dir) / "cases.pt",
                                     weights_only=False).items():
            out[name] = _port_case(*case, group=group)
        if worker.world_size == 2:
            models = torch.load(Path(out_dir) / "models.pt",
                                weights_only=False)
            for name, (family, impl) in MODEL_CASES.items():
                sd, tokens = models[family]
                model = _port_model(family, impl, group)
                model.load_state_dict(sd)
                with torch.no_grad():
                    out[name] = model.eval()(_shard(tokens, mesh.seq_index,
                                                    2))
        torch.save(out, Path(out_dir) / f"w{worker.world_size}_rank"
                                         f"{worker.rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(out_dir: Path, world: int) -> list[dict]:
    workers = [distributed.Worker(r, r, world, f"file://{out_dir}/s{world}")
               for r in range(world)]
    rc = distributed.spawn_local(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         str(out_dir)], workers, print)
    assert rc == 0
    return [torch.load(out_dir / f"w{world}_rank{r}.pt", weights_only=False)
            for r in range(world)]


def _jax_attention(case, n: int):
    """JAX's sharded ``local_attention`` under ``shard_map`` over ``n``
    virtual devices: the global output and ``jax.vjp``'s q/k/v
    gradients at ``ct``."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from tpu_hc_bench.parallel import sequence as jseq
    from tpu_hc_bench.topology import SEQ_AXIS

    impl, causal, kv_repeat, q, k, v, ct = case
    spec = P(None, SEQ_AXIS)
    mapped = jax.shard_map(
        lambda q, k, v: jseq.local_attention(
            q, k, v, impl=impl, axis_name=SEQ_AXIS, causal=causal,
            kv_repeat=kv_repeat),
        mesh=Mesh(np.array(jax.devices()[:n]), (SEQ_AXIS,)),
        in_specs=(spec, spec, spec), out_specs=spec, check_vma=False)

    @jax.jit
    def run(q, k, v, ct):
        out, vjp = jax.vjp(mapped, q, k, v)
        return out, vjp(ct)

    out, grads = run(q, k, v, ct)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _jax_models() -> dict:
    """family -> (the Flax module, its perturbed params, tokens)."""
    import jax

    from test_torch_lm import _perturb
    from tpu_hc_bench.models.bert import BertMLM
    from tpu_hc_bench.models.gpt import GPTLM
    from tpu_hc_bench.models.llama import LlamaLM

    mods = {"bert": BertMLM(**NARROW), "gpt": GPTLM(**NARROW),
            "llama": LlamaLM(**NARROW, num_kv_heads=2)}
    out = {}
    for i, (family, mod) in enumerate(mods.items()):
        tokens = np.random.default_rng(7 + i).integers(
            1, NARROW["vocab_size"], (2, MODEL_SEQ)).astype(np.int32)
        params = _perturb(mod.init(jax.random.PRNGKey(i), tokens,
                                   train=False)["params"], 20 + i)
        out[family] = (mod, params, tokens)
    return out


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    """The port's ranks at worlds 2 and 4 (spawned) and the JAX
    references, every case."""
    import jax

    from tpu_hc_bench_torch import convert

    out_dir = tmp_path_factory.mktemp("sp")
    cases = _cases()
    torch.save(cases, out_dir / "cases.pt")
    flax = _jax_models()
    to_port = {"bert": convert.bert_params_from_flax,
               "gpt": convert.gpt_params_from_flax,
               "llama": convert.llama_params_from_flax}
    torch.save({f: (to_port[f](params), tokens)
                for f, (_, params, tokens) in flax.items()},
               out_dir / "models.pt")
    port = {n: _spawn(out_dir, n) for n in WORLDS}
    ref = {(name, n): _jax_attention(case, n)
           for name, case in cases.items() for n in WORLDS}
    logits = {f: np.asarray(jax.jit(
        lambda p, t, mod=mod: mod.apply({"params": p}, t, train=False))(
            params, tokens)) for f, (mod, params, tokens) in flax.items()}
    return port, ref, logits


def _close(got, want, tol, what):
    got = np.asarray(torch.as_tensor(got).detach().float())
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = max(float(np.abs(want).max()), 1.0)
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"


@pytest.mark.parametrize("kv_repeat", [1, 2])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("impl", IMPLS)
def test_sharded_attention_matches_jax(sp_runs, impl, n, causal,
                                       kv_repeat):
    port, ref, _ = sp_runs
    name = _case_name(impl, causal, kv_repeat)
    want_out, want_grads = ref[(name, n)]
    k = S // n
    for r in range(n):
        out, gq, gk, gv = port[n][r][name]
        rows = slice(r * k, (r + 1) * k)
        _close(out, want_out[:, rows], FWD_TOL, f"{name} n{n} r{r} out")
        for what, got, want in zip("qkv", (gq, gk, gv), want_grads):
            _close(got, want[:, rows], GRAD_TOL,
                   f"{name} n{n} r{r} d{what}")


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_whole_model_at_sp2_matches_unsharded_jax(sp_runs, case):
    port, _, logits = sp_runs
    family = MODEL_CASES[case][0]
    want = logits[family]
    k = MODEL_SEQ // 2
    for r in range(2):
        _close(port[2][r][case], want[:, r * k:(r + 1) * k], MODEL_TOL,
               f"{case} rank {r}")


@pytest.mark.parametrize("q_offset,k_offset", [(0, 0), (16, 0), (8, 24)])
def test_dense_attention_offsets_match_jax(q_offset, k_offset):
    """A shard's causal mask at global positions (JAX's ``q_offset`` and
    ``k_offset``)."""
    import jax.numpy as jnp

    from tpu_hc_bench.parallel import sequence as jseq

    _, _, _, q, k, v, _ = _cases()[_case_name("ring", True, 1)]
    q, k, v = q[:, :16], k[:, :16], v[:, :16]
    want = jseq.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True,
                                q_offset=q_offset, k_offset=k_offset)
    got = seq.dense_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True, q_offset=q_offset,
                              k_offset=k_offset)
    _close(got, np.asarray(want), FWD_TOL, f"offsets {q_offset} {k_offset}")


# --- the degenerate seq axis: a one-rank group ------------------------------


@pytest.fixture
def one_rank_group():
    distributed.init_single("gloo")
    try:
        yield distributed.build_mesh(1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kv_repeat", [1, 2])
@pytest.mark.parametrize("causal", [False, True])
def test_degenerate_ring_is_dense(one_rank_group, causal, kv_repeat):
    mesh = one_rank_group
    assert (mesh.dp, mesh.sp, mesh.seq_index) == (1, 1, 0)
    _, _, _, q, k, v, ct = _cases()[_case_name("ring", causal, kv_repeat)]
    got = _port_case("ring", causal, kv_repeat, q, k, v, ct,
                     mesh.seq_group)
    want = _port_case("dense", causal, kv_repeat, q, k, v, ct, None)
    for what, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        _close(a, b, FWD_TOL if what == "out" else GRAD_TOL, what)


@pytest.mark.parametrize("kv_repeat", [1, 2])
def test_degenerate_ulysses_flash_is_flash_bit_for_bit(one_rank_group,
                                                       kv_repeat):
    group = one_rank_group.seq_group
    _, _, _, q, k, v, ct = _cases()[_case_name("ulysses_flash", True,
                                               kv_repeat)]
    got = _port_case("ulysses_flash", True, kv_repeat, q, k, v, ct, group)
    want = _port_case("flash", True, kv_repeat, q, k, v, ct, None)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_collectives_are_copies_in_a_one_rank_group(one_rank_group):
    group = one_rank_group.seq_group
    x = torch.randn(3, 4, 6, requires_grad=True)
    for y in (collectives.ring_shift(x, group),
              collectives.all_to_all(x, group, 2, 1)):
        assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
        y.sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 2.0))


def test_sharded_impls_need_a_seq_group_and_divisible_heads():
    q = torch.zeros((1, 8, 2, 8))
    for impl in ("ring", "ulysses", "ulysses_flash"):
        with pytest.raises(ValueError, match="requires a seq group"):
            seq.local_attention(q, q, q, impl)
    with pytest.raises(ValueError, match="unknown attention impl"):
        seq.local_attention(q, q, q, "paged")


def test_mesh_is_data_major_and_seq_minor(monkeypatch):
    """rank = data index x sp + seq index: a seq group holds consecutive
    ranks (JAX ``build_mesh``'s device order, seq inside data)."""
    made = []
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 8)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 5)
    monkeypatch.setattr(dist, "new_group", lambda ranks: made.append(
        tuple(ranks)) or tuple(ranks))
    mesh = distributed.build_mesh(2)
    assert (mesh.dp, mesh.sp, mesh.data_index, mesh.seq_index) == (4, 2, 2,
                                                                    1)
    assert mesh.seq_group == (4, 5) and mesh.data_group == (1, 3, 5, 7)
    assert made == [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2, 4, 6),
                    (1, 3, 5, 7)]
    with pytest.raises(ValueError, match="not divisible by the minor-axis "
                                         "product 3"):
        distributed.build_mesh(3)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
