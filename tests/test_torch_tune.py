"""The port's autotuner (``tpu_hc_bench_torch/tune``) and ``--config``
against the JAX package's, on the CPU.

Pure host work on the same inputs through both packages:

- ``member_space``/``serve_member_space``: the same candidate keys, in
  order, for every seed member (axes and grid);
- ``static_prune`` with no lint pass: the same survivors, skip classes
  and reasons for every seed member (flag-time ``resolve()`` of the
  port's two config classes against JAX's one);
- ``run_search`` over JAX's deterministic stub surface: equal journals
  (the port's adds only ``"lints"``, the lint class it ran: ``"off"``
  with no ``lint_fn``) through a completed
  search, a kill and its resume, budget exhaustion and its resume, the
  ``max_candidates`` truncation, all-failed, the deepest-rung rule and
  the model/hardware guards;
- the registry: ``promote``/``lookup`` round trips (``@serve`` rows
  too), ``resolve_auto`` in both lanes (the row applied, an explicit
  flag winning, an explicit default pinning, the loud baseline, a stale
  row, a lane-crossed lever) with the same notes as JAX's;
- ``classify_exit``, ``hardware_key`` (the pin, the CPU on request, a
  raise with no card), the runner's parse and exit classes, the CLI.

One real micro-search on ``trivial`` through the port's launcher (the
runner wrapped to add ``--device=cpu``), then a ``--config=auto`` run
of the promoted row, is slow-marked.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

from tpu_hc_bench import flags as jax_flags
from tpu_hc_bench import resilience as jax_resilience
from tpu_hc_bench.tune import prune as jax_prune
from tpu_hc_bench.tune import registry as jax_registry
from tpu_hc_bench.tune import runner as jax_runner
from tpu_hc_bench.tune import search as jax_search
from tpu_hc_bench.tune import space as jax_space
from tpu_hc_bench_torch import flags, resilience
from tpu_hc_bench_torch.tune import prune, registry, runner, search, space
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

HW = "cpu-test-w1"
TRAIN_MEMBERS = tuple(jax_space.SEED_CONFIGS)
SERVE_MEMBERS = tuple(jax_space.SEED_SERVE_CONFIGS)


def make_stub(peak_overrides: dict, calls: list | None = None,
              wall_s: float = 1.0):
    """JAX's test surface (``tests/test_tune.py``): the score decays
    with distance from ``peak_overrides`` in (log2 batch, log2 accum,
    toggles) space; any package's ``Candidate`` works."""

    def stub(c, rung: int, batches: int) -> dict:
        if calls is not None:
            calls.append((c.key, rung))
        d = dict(c.overrides)
        peak = dict(peak_overrides)
        dist = 0.0
        dist += abs(np.log2(d.get("batch_size", 64))
                    - np.log2(peak.get("batch_size", 64)))
        dist += abs(np.log2(d.get("gradient_accumulation_steps", 1))
                    - np.log2(peak.get("gradient_accumulation_steps", 1)))
        for k in ("accum_dtype", "gradient_checkpointing", "scan_layers",
                  "fusion_threshold_bytes", "variable_update"):
            if d.get(k) != peak.get(k):
                dist += 1.0
        return {"per_chip": round(1000.0 * 0.8 ** dist, 3),
                "goodput": 0.9, "wall_s": wall_s}

    return stub


def _quiet(_msg: str) -> None:
    pass


def _ours(journal: dict) -> dict:
    """The port's journal less its one extra key (no ``lint_fn``, so the
    lint class is off)."""
    out = dict(journal)
    assert out.pop("lints") == "off"
    return out


# --------------------------------------------------------------- space


@pytest.mark.parametrize("mode", ("axes", "grid"))
@pytest.mark.parametrize("model", TRAIN_MEMBERS)
def test_member_space_keys_equal_jax(model, mode):
    mine = space.member_space(model, mode)
    ref = jax_space.member_space(model, mode)
    assert [c.key for c in mine] == [c.key for c in ref]
    assert [dict(c.base) for c in mine] == [dict(c.base) for c in ref]
    assert [c.to_flags() for c in mine] == [c.to_flags() for c in ref]
    assert mine[0] == space.seed_candidate(model)


@pytest.mark.parametrize("model", SERVE_MEMBERS)
def test_serve_member_space_keys_equal_jax(model):
    mine = space.serve_member_space(model)
    ref = jax_space.serve_member_space(model)
    assert [c.key for c in mine] == [c.key for c in ref]
    assert all(c.workload == "serve" for c in mine)


def test_seed_tables_and_levers_equal_jax():
    assert space.SEED_CONFIGS == jax_space.SEED_CONFIGS
    assert space.SEED_SERVE_CONFIGS == jax_space.SEED_SERVE_CONFIGS
    assert (space.LEVERS, space.SERVE_LEVERS) == (jax_space.LEVERS,
                                                  jax_space.SERVE_LEVERS)
    assert space.seed_matrix() == jax_space.seed_matrix()
    assert space.seed_extra_flags("gpt2") == jax_space.seed_extra_flags(
        "gpt2")
    # every lever is a field of the matching port config class, with
    # JAX's default
    for levers, cls in ((space.LEVERS, flags.BenchmarkConfig),
                        (space.SERVE_LEVERS, flags.ServeConfig)):
        d, j = cls(), jax_flags.BenchmarkConfig()
        for k in levers:
            assert getattr(d, k) == getattr(j, k), k
    assert isinstance(space.seed_candidate("gpt2").to_config(),
                      flags.BenchmarkConfig)
    assert isinstance(space.serve_seed_candidate("gpt2").to_config(),
                      flags.ServeConfig)
    with pytest.raises(ValueError, match="not a tunable lever"):
        space.Candidate.make("trivial", {"model": "x"})
    with pytest.raises(ValueError, match="no seeded config"):
        space.seed_candidate("llama_tiny")


# --------------------------------------------------------------- prune


def _skips(result) -> list[tuple]:
    return [(s.candidate.key, s.cls, s.reason, s.hbm_source)
            for s in result.skipped]


@pytest.mark.parametrize("model", TRAIN_MEMBERS)
def test_static_prune_equals_jax(model):
    for mode in ("axes", "grid"):
        mine = prune.static_prune(space.member_space(model, mode))
        ref = jax_prune.static_prune(jax_space.member_space(model, mode))
        assert ([c.key for c in mine.survivors]
                == [c.key for c in ref.survivors]), mode
        assert _skips(mine) == _skips(ref), mode


@pytest.mark.parametrize("model", SERVE_MEMBERS)
def test_serve_static_prune_equals_jax(model):
    mine = prune.static_prune(space.serve_member_space(model))
    ref = jax_prune.static_prune(jax_space.serve_member_space(model))
    assert [c.key for c in mine.survivors] == [c.key for c in ref.survivors]
    assert _skips(mine) == _skips(ref)


def test_prune_measured_anchor_and_lint_class_equal_jax():
    rows = [{"overrides": {"batch_size": 64}, "peak_hbm_bytes": 8 << 30,
             "hbm_bytes_limit": 80 << 30},
            {"overrides": {"batch_size": 256}, "error":
             "torch.OutOfMemoryError: CUDA out of memory. Tried to "
             "allocate 2.00 GiB"}]
    for mine, ref in ((prune.hbm_model_for("trivial", rows),
                       jax_prune.hbm_model_for("trivial", rows)),
                      (prune.hbm_model_for("gpt2_moe", rows[:1]),
                       jax_prune.hbm_model_for("gpt2_moe", rows[:1]))):
        assert mine.source == ref.source == "measured"
        assert ((mine.max_microbatch, mine.headroom,
                 mine.needs_bf16_accum_at)
                == (ref.max_microbatch, ref.headroom,
                    ref.needs_bf16_accum_at))
    # PyTorch's OOM spelling caps the anchor below its microbatch
    assert prune.hbm_model_for("trivial", rows).max_microbatch == 255
    lint = lambda m: ("host sync in step",)           # noqa: E731
    mine = prune.static_prune(space.member_space("trivial"), lint_fn=lint)
    ref = jax_prune.static_prune(jax_space.member_space("trivial"),
                                 lint_fn=lint)
    assert _skips(mine) == _skips(ref) and not mine.survivors
    assert mine.skipped_classes == {"lint"}


# -------------------------------------------------------------- search


def _both(tmp_path, name, model, settings_kw, runner_of, **kw):
    """One search through each package, same inputs."""
    j = jax_search.run_search(
        model, str(tmp_path / f"jax-{name}"), HW,
        settings=jax_search.SearchSettings(**settings_kw),
        runner=runner_of(), print_fn=_quiet, **kw)
    m = search.run_search(
        model, str(tmp_path / f"port-{name}"), HW,
        settings=search.SearchSettings(**settings_kw),
        runner=runner_of(), print_fn=_quiet, **kw)
    return j, m


@pytest.mark.parametrize("model", ("trivial", "gpt2_moe", "gpt2"))
def test_stub_search_journal_equals_jax(tmp_path, model):
    seed = dict(space.seed_candidate(model).overrides)
    j, m = _both(tmp_path, "full", model, dict(budget_s=1e9),
                 lambda: make_stub(seed))
    assert _ours(m) == j
    assert m["status"] == "complete"
    assert m["best"]["key"] == space.seed_candidate(model).key
    on_disk = search.load_journal(str(tmp_path / "port-full"))
    assert on_disk == m


def test_stub_search_resume_after_kill_equals_jax(tmp_path):
    def dying_of():
        base, n = make_stub({"batch_size": 512}), [0]

        def dying(c, rung, batches):
            n[0] += 1
            if n[0] > 4:
                raise KeyboardInterrupt("killed")
            return base(c, rung, batches)
        return dying

    for pkg, out in ((jax_search, "jax"), (search, "port")):
        with pytest.raises(KeyboardInterrupt):
            pkg.run_search("trivial", str(tmp_path / out), HW,
                           settings=pkg.SearchSettings(budget_s=1e9),
                           runner=dying_of(), print_fn=_quiet)
    killed_j = jax_search.load_journal(str(tmp_path / "jax"))
    killed_m = search.load_journal(str(tmp_path / "port"))
    assert killed_m["status"] == "running"
    assert _ours(killed_m) == killed_j
    calls_j: list = []
    calls_m: list = []
    j = jax_search.run_search(
        "trivial", str(tmp_path / "jax"), HW,
        settings=jax_search.SearchSettings(budget_s=1e9),
        runner=make_stub({"batch_size": 512}, calls_j), print_fn=_quiet)
    m = search.run_search(
        "trivial", str(tmp_path / "port"), HW,
        settings=search.SearchSettings(budget_s=1e9),
        runner=make_stub({"batch_size": 512}, calls_m), print_fn=_quiet)
    assert calls_m == calls_j
    done = {(k, int(r)) for k, v in killed_m["measurements"].items()
            for r in v}
    assert len(done) == 4 and not (done & set(calls_m))
    assert _ours(m) == j and m["status"] == "complete"


def test_stub_search_budget_exhaustion_and_resume_equals_jax(tmp_path):
    j, m = _both(tmp_path, "budget", "trivial", dict(budget_s=250.0),
                 lambda: make_stub({"batch_size": 512}, wall_s=100.0))
    assert _ours(m) == j
    assert m["status"] == "budget-exhausted"
    assert m["spent_s"] == pytest.approx(300.0)
    j2 = jax_search.run_search(
        "trivial", str(tmp_path / "jax-budget"), HW,
        settings=jax_search.SearchSettings(budget_s=1e9),
        runner=make_stub({"batch_size": 512}), print_fn=_quiet)
    m2 = search.run_search(
        "trivial", str(tmp_path / "port-budget"), HW,
        settings=search.SearchSettings(budget_s=1e9),
        runner=make_stub({"batch_size": 512}), print_fn=_quiet)
    assert _ours(m2) == j2
    assert m2["status"] == "complete"
    assert m2["best"]["key"] == "batch_size=512"


def test_stub_search_truncation_all_failed_and_rerun_equal_jax(tmp_path):
    j, m = _both(tmp_path, "trunc", "trivial",
                 dict(budget_s=1e9, max_candidates=3),
                 lambda: make_stub({"batch_size": 512}))
    assert _ours(m) == j
    assert m["truncated"] > 0 and len(m["rungs"][0]["measured"]) == 3
    j, m = _both(tmp_path, "failed", "trivial",
                 dict(budget_s=1e9, max_candidates=2),
                 lambda: (lambda c, r, b: {"error": "exit-1",
                                           "wall_s": 1.0}))
    assert _ours(m) == j
    assert m["status"] == "all-failed" and m["best"] is None
    # a finished search is immutable: no measurement on a rerun
    calls: list = []
    again = search.run_search(
        "trivial", str(tmp_path / "port-trunc"), HW,
        settings=search.SearchSettings(budget_s=1e9, max_candidates=3),
        runner=make_stub({"batch_size": 512}, calls), print_fn=_quiet)
    assert not calls and again["status"] == "complete"


def test_stub_search_deepest_rung_and_guards_equal_jax(tmp_path):
    r0 = {"batch_size=128": 100.0, "batch_size=256": 99.0,
          "batch_size=512": 70.0, "batch_size=1024": 40.0}
    r1 = {"batch_size=128": 60.0, "batch_size=256": 59.0}

    def runner_of():
        return lambda c, rung, b: {"per_chip": (r0 if rung == 0
                                                else r1)[c.key],
                                   "wall_s": 1.0}

    out = {}
    for pkg, sp, name in ((jax_search, jax_space, "jax"),
                          (search, space, "port")):
        cands = [sp.Candidate.make("trivial", {"batch_size": b})
                 for b in (128, 256, 512, 1024)]
        out[name] = pkg.run_search(
            "trivial", str(tmp_path / name), HW,
            settings=pkg.SearchSettings(budget_s=1e9, rung0_batches=8,
                                        max_rungs=2),
            runner=runner_of(), space=cands, print_fn=_quiet)
    assert _ours(out["port"]) == out["jax"]
    assert out["port"]["best"]["key"] == "batch_size=128"
    assert out["port"]["best"]["record"]["measured_batches"] == 16
    with pytest.raises(ValueError, match="is for model"):
        search.run_search("lenet", str(tmp_path / "port"), HW,
                          runner=make_stub({}), print_fn=_quiet)
    with pytest.raises(ValueError, match="per-hardware"):
        search.run_search("trivial", str(tmp_path / "port"),
                          "nvidia_h100-79gb-w1", runner=make_stub({}),
                          print_fn=_quiet)


def test_stub_serve_search_equals_jax(tmp_path):
    def runner_of():
        return lambda c, rung, b: {
            "per_chip": 100.0 + dict(c.overrides).get("max_in_flight", 0),
            "wall_s": 1.0}

    j = jax_search.run_search(
        "llama_1b", str(tmp_path / "jax"), HW,
        settings=jax_search.SearchSettings(budget_s=1e9, max_candidates=4),
        runner=runner_of(), space=jax_space.serve_member_space("llama_1b"),
        print_fn=_quiet)
    m = search.run_search(
        "llama_1b", str(tmp_path / "port"), HW,
        settings=search.SearchSettings(budget_s=1e9, max_candidates=4),
        runner=runner_of(), space=space.serve_member_space("llama_1b"),
        print_fn=_quiet)
    assert _ours(m) == j and m["workload"] == "serve"


def test_commit_json_leaves_no_tmp(tmp_path):
    path = str(tmp_path / "tune_state.json")
    search.commit_json(path, {"ok": 1})
    assert json.load(open(path)) == {"ok": 1}
    assert not os.path.exists(path + ".tmp")


# ------------------------------------------------------------ registry


def _searched(tmp_path, model="trivial", pkg="port"):
    sp, se = (space, search) if pkg == "port" else (jax_space, jax_search)
    seed = dict(sp.seed_candidate(model).overrides)
    return se.run_search(model, str(tmp_path / f"{pkg}-search-{model}"), HW,
                         settings=se.SearchSettings(budget_s=1e9),
                         runner=make_stub(seed), print_fn=_quiet)


def test_promote_lookup_round_trip_equals_jax(tmp_path):
    regs = {"port": tmp_path / "reg-port", "jax": tmp_path / "reg-jax"}
    for pkg, reg in ((registry, regs["port"]), (jax_registry, regs["jax"])):
        name = "port" if pkg is registry else "jax"
        for model in ("trivial", "gpt2_moe"):
            path, row = pkg.promote(_searched(tmp_path, model, name),
                                    registry_dir=reg)
            assert path == reg / f"{HW}.json"
            assert pkg.lookup(model, HW, reg) == row
    assert (registry.load_rows(HW, regs["port"])
            == jax_registry.load_rows(HW, regs["jax"]))
    row = registry.lookup("trivial", HW, regs["port"])
    assert row["overrides"] == {"batch_size": 512}
    assert row["measured_batches"] == 32
    # a serve journal's row is lane-keyed
    serve = search.run_search(
        "llama_tiny", str(tmp_path / "serve"), HW,
        settings=search.SearchSettings(budget_s=1e9, max_candidates=3),
        runner=lambda c, r, b: {"per_chip": 10.0, "wall_s": 1.0},
        space=space.serve_member_space("llama_tiny"), print_fn=_quiet)
    registry.promote(serve, registry_dir=regs["port"])
    assert set(registry.load_rows(HW, regs["port"])) == {
        "trivial", "gpt2_moe", "llama_tiny@serve"}
    with pytest.raises(ValueError, match="no successful measurement"):
        registry.promote({"model": "trivial", "hardware": HW,
                          "status": "all-failed", "best": None})


def _note(text: str) -> str:
    return text.replace("tpu_hc_bench_torch.tune", "tpu_hc_bench.tune")


@pytest.fixture
def registry_dir(tmp_path, monkeypatch):
    reg = tmp_path / "reg"
    reg.mkdir()
    (reg / f"{HW}.json").write_text(json.dumps({
        "hardware": HW,
        "members": {
            "trivial": {"overrides": {"batch_size": 512,
                                      "gradient_accumulation_steps": 2},
                        "base": {}, "score": 1.0},
            "gpt2": {"overrides": {"batch_size": 128, "dead_flag": 1,
                                   "max_in_flight": 4},
                     "base": {"attention_impl": "flash"}, "score": 2.0},
            "llama_tiny@serve": {
                "overrides": {"max_in_flight": 16, "kv_page_size": 8,
                              "decode_attention": "paged",
                              "batch_size": 7},
                "base": {}, "score": 3.0},
            "alexnet": {"overrides": {"accum_dtype": "bf16"}, "base": {},
                        "score": 4.0}}}))
    monkeypatch.setenv(registry.REGISTRY_ENV, str(reg))
    monkeypatch.setenv(registry.HW_ENV, HW)
    return reg


@pytest.mark.parametrize("kw", [
    dict(model="trivial"),                       # the row applied
    dict(model="trivial", batch_size=192),       # an explicit flag wins
    dict(model="gpt2"),                          # stale and crossed keys
    dict(model="lenet"),                         # no row: loud baseline
])
def test_config_auto_train_equals_jax(registry_dir, kw):
    mine = flags.BenchmarkConfig(config="auto", device="cpu",
                                 **kw).resolve()
    ref = jax_flags.BenchmarkConfig(config="auto", **kw).resolve()
    assert mine.config_source == ref.config_source
    assert mine.tuned_config == ref.tuned_config
    assert _note(mine.translations["config"]) == ref.translations["config"]
    for k in space.LEVERS + ("attention_impl",):
        assert getattr(mine, k) == getattr(ref, k), k
    if kw["model"] == "lenet":
        assert mine.config_source == "baseline"
        note = mine.translations["config"]
        assert ("no tuned row" in note
                and "python -m tpu_hc_bench_torch.tune search" in note)
        assert any(ln.startswith("translated: config: auto->BASELINE")
                   for ln in mine.summary_lines())
    if kw["model"] == "gpt2":
        note = mine.translations["config"]
        assert "dead_flag (unknown flag)" in note
        assert "max_in_flight (not a train-lane lever)" in note


@pytest.mark.parametrize("kw", [
    dict(model="llama_tiny"),
    dict(model="llama_tiny", max_in_flight=2),
    dict(model="gpt2"),
])
def test_config_auto_serve_equals_jax(registry_dir, kw):
    mine = flags.ServeConfig(config="auto", device="cpu", **kw).resolve()
    ref = jax_flags.BenchmarkConfig(config="auto", workload="serve",
                                    **kw).resolve()
    assert mine.config_source == ref.config_source
    assert mine.tuned_config == ref.tuned_config
    assert _note(mine.translations["config"]) == ref.translations["config"]
    for k in space.SERVE_LEVERS:
        assert getattr(mine, k) == getattr(ref, k), k
    if kw == dict(model="llama_tiny"):
        assert (mine.max_in_flight, mine.kv_page_size,
                mine.decode_attention) == (16, 8, "paged")
        assert "batch_size (not a serve-lane lever)" in \
            mine.translations["config"]
        assert any(ln.startswith("translated: config: auto->tuned row")
                   for ln in mine.summary_lines())


def test_config_auto_typed_default_pins_in_both_parsers(registry_dir):
    # through the parsers, a typed flag at its default value pins
    cfg = flags.parse_benchmark_flags(["--model=trivial", "--config=auto",
                                       "--batch_size=64", "--device=cpu"])
    ref = jax_flags.parse_flags(["--model=trivial", "--config=auto",
                                 "--batch_size=64"])
    assert cfg.explicit_flags == ("batch_size", "config", "device",
                                  "model")
    assert cfg.batch_size == ref.batch_size == 64
    assert cfg.gradient_accumulation_steps == 2
    assert "explicit flag wins" in cfg.translations["config"]
    # the launcher's positional batch counts as typed
    cfg = flags.parse_benchmark_flags(["--batch_size", "64",
                                       "--model=trivial", "--config=auto",
                                       "--device=cpu"])
    assert cfg.batch_size == 64 and "batch_size" in cfg.explicit_flags
    cfg = flags.parse_benchmark_flags(["--model=trivial", "--config=auto",
                                       "--device=cpu"])
    assert (cfg.batch_size, cfg.config_source) == (512, "auto")
    cfg = flags.parse_flags(["--model=llama_tiny", "--config=auto",
                             "--device=cpu", "--kv_page_size=16"])
    ref = jax_flags.parse_flags(["--model=llama_tiny", "--config=auto",
                                 "--kv_page_size=16"], workload="serve")
    assert (cfg.kv_page_size, cfg.max_in_flight) == (16, 16)
    assert (ref.kv_page_size, ref.max_in_flight) == (16, 16)
    assert _note(cfg.translations["config"]) == ref.translations["config"]


def test_config_auto_applied_row_is_validated(registry_dir):
    # an applied row meets resolve()'s checks like a typed flag: the
    # bf16 accumulator without accumulation
    with pytest.raises(ValueError, match="accum_dtype") as mine:
        flags.BenchmarkConfig(config="auto", device="cpu",
                              model="alexnet").resolve()
    with pytest.raises(ValueError) as ref:
        jax_flags.BenchmarkConfig(config="auto", model="alexnet").resolve()
    assert str(mine.value) == str(ref.value)


def test_config_manual_default_and_bad_values():
    for cfg in (flags.BenchmarkConfig(device="cpu").resolve(),
                flags.ServeConfig(device="cpu").resolve()):
        assert (cfg.config, cfg.config_source, cfg.tuned_config) == (
            "manual", "manual", None)
        assert "config" not in cfg.translations
    for build in (lambda: flags.BenchmarkConfig(config="bogus"),
                  lambda: flags.ServeConfig(config="bogus")):
        with pytest.raises(ValueError, match="manual|auto") as mine:
            build().resolve()
        with pytest.raises(ValueError) as ref:
            jax_flags.BenchmarkConfig(config="bogus").resolve()
        assert str(mine.value) == str(ref.value)
    # --virtual_devices is ported (tests/test_torch_fleet.py): the CPU
    # only, N >= 1
    with pytest.raises(ValueError, match="CPU host's worker count"):
        flags.parse_benchmark_flags(["--virtual_devices=8"])
    with pytest.raises(ValueError, match=">= 1"):
        flags.parse_benchmark_flags(["--virtual_devices=0", "--device=cpu"])
    assert flags.parse_benchmark_flags(
        ["--virtual_devices=8", "--device=cpu"]).virtual_devices == 8


# ------------------------------------------- exit classes, hardware key


@pytest.mark.parametrize("code", (0, 1, 70, 75, 3, -9))
def test_classify_exit_equals_jax(code):
    assert resilience.classify_exit(code) == \
        jax_resilience.classify_exit(code)
    assert resilience.EXIT_CLASSES == jax_resilience.EXIT_CLASSES
    assert runner.classify_exit is resilience.classify_exit


def test_hardware_key_pin_cpu_and_no_card(monkeypatch):
    import torch

    monkeypatch.setenv(registry.HW_ENV, "v5e-16gb-w4")
    assert registry.hardware_key() == "v5e-16gb-w4"
    monkeypatch.delenv(registry.HW_ENV)
    assert registry.hardware_key(device="cpu") == "cpu-0gb-w1"
    assert registry.hardware_key(world=4, device="cpu") == "cpu-0gb-w4"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.hardware_key()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flags.BenchmarkConfig(config="auto").resolve()


def test_hardware_key_format_on_a_card(monkeypatch):
    import torch

    from tpu_hc_bench_torch.obs import memory

    monkeypatch.delenv(registry.HW_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(memory, "device_memory_sample",
                        lambda dev, free=False: {"bytes_limit": 85e9})
    assert registry.hardware_key() == "nvidia_h100_80gb_hbm3-79gb-w1"
    assert registry.hardware_key(world=8) == \
        "nvidia_h100_80gb_hbm3-79gb-w8"


# -------------------------------------------------------------- runner


def test_runner_parse_and_score_equal_jax():
    # the port driver's rate line, both units
    for line in ("images/sec/chip: 1035.20  step: 123.65ms "
                 "(p50/step 123.10ms)  MFU: 1.4% (analytic)",
                 "examples/sec/chip: 186.81  step: 85.65ms "
                 "(p50/step 85.40ms)  MFU: 12.6% (measured)"):
        assert runner.parse_stdout_metrics(line) == \
            jax_runner.parse_stdout_metrics(line)
        assert set(runner.parse_stdout_metrics(line)) == {
            "per_chip", "step_ms", "mfu_pct"}
    for rec in ({"per_chip": 100.0, "goodput": 0.5}, {"per_chip": 100.0},
                {"per_chip": 100.0, "error": "timeout"},
                {"per_chip": 100.0, "goodput": float("nan")}):
        assert runner.score(rec) == jax_runner.score(rec)
    cmd = runner.build_cmd("gpt2", 128, ["--attention_impl=flash"],
                           warmup=2, batches=4)
    assert cmd[1:] == ["-m", "tpu_hc_bench_torch", "1", "0", "128", "ici",
                       "--model=gpt2", "--num_warmup_batches=2",
                       "--num_batches=4", "--use_fp16=True",
                       "--attention_impl=flash"]


def _fake_launcher(monkeypatch, body: str):
    """``run_one``'s launch replaced by a python one-liner."""
    monkeypatch.setattr(runner, "build_cmd",
                        lambda *a, **k: [sys.executable, "-c", body])


def test_run_one_reads_the_summary_and_classes_exits(tmp_path, monkeypatch):
    from tpu_hc_bench_torch.obs import metrics

    mdir = tmp_path / "m"
    writer = metrics.MetricsWriter(str(mdir), manifest={"model": "gpt2"})
    writer.event("summary", images_per_sec_per_chip=186.5,
                 mean_step_ms=85.7, mfu=0.126, goodput=0.81234,
                 peak_hbm_bytes=17 << 30, hbm_bytes_limit=85 << 30,
                 mem_source="torch.cuda")
    writer.close()
    _fake_launcher(monkeypatch, "print('examples/sec/chip: 180.0  step: "
                                "88.0ms (p50/step 87.0ms)  MFU: 12.1% "
                                "(analytic)')")
    rec = runner.run_one("gpt2", 16, metrics_dir=str(mdir))
    assert (rec["per_chip"], rec["step_ms"], rec["mfu_pct"],
            rec["goodput"]) == (186.5, 85.7, 12.6, 0.8123)
    assert (rec["peak_hbm_bytes"], rec["hbm_bytes_limit"],
            rec["mem_source"]) == (17 << 30, 85 << 30, "torch.cuda")
    assert rec["returncode"] == 0 and "error" not in rec
    _fake_launcher(monkeypatch, "import sys; sys.exit(75)")
    rec = runner.run_one("gpt2", 16)
    assert (rec["exit_class"], rec["error"]) == ("preempted", "preempted")
    _fake_launcher(monkeypatch, "import sys; print('boom'); sys.exit(3)")
    rec = runner.run_one("gpt2", 16)
    assert (rec["exit_class"], rec["error"]) == ("exit-3", "boom")
    _fake_launcher(monkeypatch, "print('no rate here')")
    assert runner.run_one("gpt2", 16)["error"] == "no-throughput-line"
    _fake_launcher(monkeypatch, "import time; time.sleep(60)")
    rec = runner.run_one("gpt2", 16, timeout_s=0.5)
    assert (rec["error"], rec["exit_class"]) == ("timeout", "timeout")
    assert rec["wall_s"] < 30


# ----------------------------------------------------------------- CLI


def test_cli_show_promote_and_journal(tmp_path, capsys):
    from tpu_hc_bench_torch.tune.__main__ import main as tune_main

    _searched(tmp_path)
    journal = tmp_path / "port-search-trivial" / "tune_state.json"
    reg = tmp_path / "reg"
    assert tune_main(["promote", "--journal", str(journal),
                      "--registry", str(reg)]) == 0
    assert "promoted: trivial" in capsys.readouterr().out
    assert tune_main(["show", "--hardware", HW, "--registry",
                      str(reg)]) == 0
    assert "batch_size=512" in capsys.readouterr().out
    assert tune_main(["show", "--hardware", "no-such-hw",
                      "--registry", str(reg)]) == 1
    capsys.readouterr()
    assert tune_main(["show", "--journal", str(journal)]) == 0
    out = capsys.readouterr().out
    assert f"search journal: trivial @ {HW}" in out
    assert "[hbm-oom/seeded]" in out and "measured:" in out
    with pytest.raises(SystemExit):
        tune_main(["search", "--model", "trivial", "--mode", "random"])


@pytest.mark.slow
def test_real_micro_search_promote_and_config_auto(tmp_path, monkeypatch):
    """A budgeted micro-search on ``trivial`` through the port's
    launcher (every run ``--device=cpu``), promoted, then a launcher
    run with ``--config=auto`` applying the row."""
    from tpu_hc_bench_torch import launcher

    monkeypatch.setenv(registry.HW_ENV, "cpu-micro-w1")
    monkeypatch.setenv(registry.REGISTRY_ENV, str(tmp_path / "reg"))
    out = str(tmp_path / "search")

    def cpu_runner(c, rung, batches):
        return runner.run_one(
            "trivial", c.batch_size, c.to_flags() + ["--device=cpu"],
            warmup=1, batches=batches, timeout_s=240.0,
            metrics_dir=os.path.join(out, "runs", f"{c.key}-r{rung}"),
            use_fp16=False)

    j = search.run_search(
        "trivial", out, "cpu-micro-w1",
        settings=search.SearchSettings(budget_s=600.0, rung0_batches=2,
                                       warmup=1, max_rungs=2,
                                       max_candidates=2),
        runner=cpu_runner, print_fn=_quiet)
    assert j["best"] is not None and j["spent_s"] <= j["budget_s"]
    assert any(s["class"] == "hbm-oom" for s in j["skipped"])
    _, row = registry.promote(j)
    lines: list[str] = []
    rc = launcher.main(["1", "1", str(row["overrides"]["batch_size"]),
                        "sock", "--model=trivial", "--device=cpu",
                        "--config=auto", "--num_warmup_batches=1",
                        "--num_batches=2"], print_fn=lines.append)
    assert rc == 0
    assert any(ln.startswith("translated: config: auto->tuned row trivial")
               for ln in lines)
