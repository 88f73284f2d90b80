"""The port's static analysis (``tpu_hc_bench_torch/analysis``) against the
JAX package's, on the CPU.

- the registry: the same 21 pass names, severities and scopes;
- ``report``: ``findings_to_json`` byte-equal for the same findings, the
  baseline round trip (the port's keeps each key's reason), the dry-run
  ``baseline`` subcommand;
- every file pass on JAX's own fixtures (``tests/test_analysis.py``):
  JAX's ``lint_source_text`` and the port's give equal findings and
  suppression counts; then the port's idiom (``.cpu()`` under
  ``torch.compile``, a sync in a CUDA graph capture, the pipeline's
  stage-gated hops clean and an ``all_reduce`` under ``if pipe.first:``
  flagged, ``torch.cuda.memory_allocated`` in a loop, ``load_library``
  and ``cudnn.benchmark`` in ``serve/`` outside warmup, ``q.float() *
  scale`` in a loop, the rank read from the environment...);
- ``contracts`` on a tree built in ``tmp_path``;
- ``zero1_shape_findings`` equal to JAX's for the same counts, and the
  op census of a world-2 ``trivial`` step under ``psum`` and ``zero1``
  against JAX's compiled HLO of the same arms (the two-process gloo twin
  is slow-marked);
- ``sharding-consistency`` on meta-device members: the same findings as
  JAX's ``check_sharding_consistency``;
- the port's tree clean against the port's baseline, under JAX's wall
  budget, through the CLI;
- the tuner's journal with and without ``--no-lints``;
- ``python -m tpu_hc_bench_torch.serve``; no import of JAX anywhere in
  the package.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import test_analysis as jax_tests
from tpu_hc_bench.analysis import contracts as jax_contracts
from tpu_hc_bench.analysis import hlo as jax_hlo
from tpu_hc_bench.analysis import lints as jax_lints
from tpu_hc_bench.analysis import registry as jax_registry
from tpu_hc_bench.analysis import report as jax_report
from tpu_hc_bench_torch.analysis import (census, contracts, dataflow, lints,
                                         registry, report)
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = sorted(n for n in dir(jax_tests) if n.endswith("_FIXTURE"))


def _rows(findings) -> list[dict]:
    return [dataclasses.asdict(f) for f in findings]


# ---------------------------------------------------------------------
# registry + report


def test_registry_matches_jax_pass_for_pass():
    mine = [(p.name, p.severity, p.scope) for p in registry.all_passes()]
    ref = [(p.name, p.severity, p.scope) for p in jax_registry.all_passes()]
    assert sorted(mine) == sorted(ref)
    assert len(mine) == 21
    for name, severity, scope, doc, _ex in registry.pass_index():
        assert doc, name
    assert registry.default_severity(dataflow.RANK_DIVERGENT) == "error"


def test_findings_json_byte_equal_to_jax():
    rows = [("host-sync-in-jit", "error", "repo", "a.py:1", "m"),
            ("sharding-consistency", "warning", "bert_tiny",
             "param:layers.0.attn.qkv.weight", "n"),
            ("recompile-hazard", "info", "repo", "b.py:9", "o")]
    mine = [report.Finding(*r) for r in rows]
    ref = [jax_report.Finding(*r) for r in rows]
    coll = {"trivial": {"all-reduce": 1, "reduce-scatter": 2}}
    sup = {"rank-divergent-collective": 2}
    assert report.findings_to_json(mine, coll, sup, 1.23456) == \
        jax_report.findings_to_json(ref, coll, sup, 1.23456)
    assert [f.key for f in mine] == [f.key for f in ref]
    # the census rides beside JAX's keys only when given
    payload = json.loads(report.findings_to_json(
        mine, census={"gpt2": {"ops": 3}}))
    assert payload["census"] == {"gpt2": {"ops": 3}}


def test_baseline_roundtrip_keeps_reasons(tmp_path):
    f1 = report.Finding("host-sync-in-jit", "error", "repo", "a.py:10", "m")
    f2 = report.Finding("fleet-blocking-wait", "error", "repo", "b.py:3",
                        "m")
    path = tmp_path / "baseline.json"
    report.save_baseline([f1, f2], path)
    data = json.loads(path.read_text())
    data["reasons"] = {f1.key: "deliberate", "stale::key": "gone"}
    path.write_text(json.dumps(data))
    added, removed = report.save_baseline([f1], path)
    assert (added, removed) == ([], [f2.key])
    assert report.load_baseline(path) == {f1.key}
    assert report.load_reasons(path) == {f1.key: "deliberate"}
    moved = report.Finding(f1.lint, f1.severity, f1.model, "a.py:99", "m")
    assert report.compare_to_baseline([moved, f2], {f1.key}) == [f2]


def test_checked_in_baseline_gives_every_key_a_reason():
    accepted = report.load_baseline()
    assert accepted == set(report.load_reasons())
    assert all(report.load_reasons().values())
    data = json.loads(report.BASELINE_PATH.read_text())
    assert sorted(accepted) == data["accepted"]


def test_baseline_subcommand_dry_run_then_update(tmp_path, monkeypatch):
    from tpu_hc_bench_torch.analysis import __main__ as cli

    f1 = report.Finding("host-sync-in-jit", "error", "repo", "x.py:3", "m")
    f2 = report.Finding("dead-info", "info", "repo", "y.py:1", "m")
    monkeypatch.setattr(
        lints, "lint_repo_sources",
        lambda root=None, files=None, counters=None: [f1, f2])
    path = tmp_path / "baseline.json"
    assert cli.main(["baseline", "--baseline", str(path)]) == 1
    assert not path.exists()
    assert cli.main(["baseline", "--update", "--baseline", str(path)]) == 0
    assert report.load_baseline(path) == {f1.key}
    assert cli.main(["baseline", "--baseline", str(path)]) == 0
    assert [p.name for p in tmp_path.iterdir()] == ["baseline.json"]


# ---------------------------------------------------------------------
# the file passes on JAX's fixtures, then on the port's idiom


@pytest.mark.parametrize("fixture", FIXTURES)
def test_file_passes_equal_jax_on_its_fixtures(fixture):
    src = getattr(jax_tests, fixture)
    for variant in (src, src.replace(
            "host = s.item()",
            "host = s.item()  # thb:lint-ok[host-sync-in-jit]")):
        mine, ref = collections.Counter(), collections.Counter()
        got = lints.lint_source_text(variant, "fixture.py", cpu_count=8,
                                     counters=mine)
        want = jax_lints.lint_source_text(variant, "fixture.py",
                                          cpu_count=8, counters=ref)
        assert _rows(got) == _rows(want)
        assert mine == ref


PORT_IDIOM = {
    "cpu_under_compile": ("""\
import torch

@torch.compile
def step(x):
    y = x.sum()
    return x * y.cpu()
""", "pkg/mod.py", {("host-sync-in-jit", 6)}),
    "sync_in_graph_capture": ("""\
import torch

def capture(g, x):
    with torch.cuda.graph(g):
        y = x * 2
        torch.cuda.synchronize()
    return y
""", "pkg/mod.py", {("host-sync-in-jit", 6)}),
    "eager_checkpoint_is_no_trace": ("""\
from torch.utils.checkpoint import checkpoint

def remat(fn, x):
    calls = 0
    def run(a):
        nonlocal calls
        calls += 1
        return fn(a)
    return checkpoint(run, x, use_reentrant=False)
""", "pkg/mod.py", set()),
    "all_reduce_under_pipe_first": ("""\
import torch.distributed as dist

def stage(pipe, x):
    if pipe.first:
        dist.all_reduce(x, group=pipe.group)
    return x
""", "pkg/mod.py", {("rank-divergent-collective", 5)}),
    "stage_gated_hops_clean": ("""\
import torch.distributed as dist

def stage(pipe, x):
    if pipe.first:
        y = x
    else:
        y = _recv(x.shape, pipe.prev, pipe.group)
    if pipe.last:
        return y
    dist.send(y, pipe.next)
    return y
""", "pkg/mod.py", set()),
    "rank_from_env_and_get_rank": ("""\
import os
import torch.distributed as dist

def a(x):
    if int(os.environ["LOCAL_RANK"]) == 0:
        dist.broadcast(x, 0)

def b(grads, x):
    if dist.get_rank() == 0:
        grads.finish()
    for k, v in x.items():
        dist.all_reduce(v)
""", "pkg/mod.py", {("rank-divergent-collective", 6),
                    ("rank-divergent-collective", 10),
                    ("nondeterministic-collective-order", 11)}),
    "memory_probe_in_loop": ("""\
import torch

def loop(steps, sync_every):
    for i in range(steps):
        torch.cuda.memory_allocated()
        if i % sync_every == 0:
            torch.cuda.mem_get_info()
""", "pkg/mod.py", {("memory-probe-in-hot-loop", 5)}),
    "dequant_float_in_loop": ("""\
def decode(layers, x):
    for w_int8, scale in layers:
        x = x @ (w_int8.float() * scale)
    return x
""", "pkg/mod.py", {("dequantize-in-hot-loop", 3)}),
    "serve_build_outside_warmup": ("""\
import torch
from tpu_hc_bench_torch.ops import _build

class Engine:
    def _warm(self):
        _build.load_library()
        torch.backends.cudnn.benchmark = True

    def step(self):
        _build.load_library()
        torch.backends.cudnn.benchmark = True
""", "tpu_hc_bench_torch/serve/engine.py",
        {("serve-bucket-recompile", 10), ("serve-bucket-recompile", 11)}),
}


@pytest.mark.parametrize("case", sorted(PORT_IDIOM))
def test_file_passes_learn_the_ports_idiom(case):
    src, filename, want = PORT_IDIOM[case]
    got = {(f.lint, int(f.location.rsplit(":", 1)[1]))
           for f in lints.lint_source_text(src, filename)
           if f.severity != "info"}
    assert got == want


def test_pipeline_schedule_yields_no_rank_divergent_finding():
    fs = lints.lint_file(ROOT / "tpu_hc_bench_torch/parallel/pipeline.py")
    assert [f for f in fs if f.lint.startswith(("rank-", "nondet"))] == []
    # the taint is live there: the schedule's branches are on pipe.first
    # and pipe.last, which a collective under them would trip
    src = (ROOT / "tpu_hc_bench_torch/parallel/pipeline.py").read_text()
    planted = src.replace(
        "            x = model.pp_embed(tokens[rows])",
        "            x = model.pp_embed(tokens[rows])\n"
        "            dist.all_reduce(x, group=pipe.group)")
    assert planted != src
    hits = [f for f in lints.lint_source_text(planted, "pipeline.py")
            if f.lint == dataflow.RANK_DIVERGENT]
    assert len(hits) == 1


def _mini_tree(tmp_path: Path) -> Path:
    """JAX's contract fixture tree, at the port's package path."""
    jax_root = jax_tests._mini_tree(tmp_path / "jax")
    for src in (jax_root / "tpu_hc_bench").rglob("*.py"):
        dst = tmp_path / "tpu_hc_bench_torch" / src.relative_to(
            jax_root / "tpu_hc_bench")
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(src.read_text())
    return tmp_path


def test_contracts_equal_jax_on_a_tmp_tree(tmp_path):
    root = _mini_tree(tmp_path)
    missing = tmp_path / "none.json"
    got = contracts.check_stream_contracts(root, allowlist_path=missing)
    want = jax_contracts.check_stream_contracts(tmp_path / "jax",
                                                allowlist_path=missing)
    assert _rows(got) == _rows(want)
    assert sorted(f.location for f in got if f.severity == "warning") == \
        ["obs/metrics.py::kind=phantom", "obs/metrics.py::typo_keyy"]
    allow = tmp_path / "allow.json"
    allow.write_text(json.dumps({
        "reads": {"typo_keyy": "seam", "phantom": "seam"},
        "writes": {"dead_field": "forensics", "hb": "external"}}))
    fs = contracts.check_stream_contracts(root, allowlist_path=allow)
    assert all(f.severity == "info" for f in fs)


def test_repo_contract_seams_allowlisted_with_reasons():
    fs = contracts.check_stream_contracts(ROOT)
    assert [f for f in fs if f.severity != "info"] == []
    allow = contracts.load_allowlist()
    assert all(allow["reads"].values()) and all(allow["writes"].values())
    # the writer seams fixed in the port: the driver writes them now
    _, _, kinds = contracts.extract_writes(ROOT)
    assert "input_service" in kinds
    broad, _, _ = contracts.extract_writes(ROOT)
    assert {"mesh_shape", "input"} <= set(broad)


def test_fixed_writer_seams_on_a_run(tmp_path, monkeypatch):
    """The contract check's finds, fixed in the driver: the manifest's
    ``mesh_shape`` (``obs summarize`` prints it), and under the input
    service the heartbeat's ``input`` and the ``input_service`` record
    (``_ServiceStats`` hands the ring's stats on)."""
    from tpu_hc_bench_torch import launcher
    from tpu_hc_bench_torch.obs import metrics
    from tpu_hc_bench_torch.train import driver

    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    run = tmp_path / "run"
    assert launcher.main(
        ["1", "1", "2", "sock", "--model=trivial", "--device=cpu",
         "--num_warmup_batches=1", "--num_batches=1", "--num_classes=10",
         f"--metrics_dir={run}"], print_fn=lambda m: None) == 0
    manifest = json.loads((run / "manifest.json").read_text())
    assert manifest["mesh_shape"] == {"data": 1, "model": 1}
    assert any("mesh={'data': 1, 'model': 1}" in ln
               for ln in metrics.summarize_run(str(run)))

    class Client:
        def stats(self):
            return {"batches": 3}

        def window_stats(self):
            return {"ring_occ": 2, "ring_depth": 4, "wait_ms": 0.5}

    class Service:
        def stats(self):
            return {"ring_occ_p50": 2}

    stats = driver._ServiceStats(Client(), Service())
    assert stats.window_stats() == {"ring_occ": 2, "ring_depth": 4,
                                    "wait_ms": 0.5}
    assert stats.stats() == {"batches": 3,
                             "service": {"ring_occ_p50": 2}}


# ---------------------------------------------------------------------
# the collective shape and the op census


@pytest.mark.parametrize("counts", [
    {"all-reduce": 5}, {"reduce-scatter": 4, "all-gather": 4,
                        "all-reduce": 6},
    {"reduce-scatter": 2, "all-gather": 2, "all-reduce": 1}, {},
    {"reduce-scatter": 1, "all-reduce": 3}])
def test_zero1_shape_findings_equal_jax(counts):
    assert _rows(lints.zero1_shape_findings("m", counts, "loc")) == \
        _rows(jax_lints.zero1_shape_findings("m", counts, "loc"))


@pytest.mark.parametrize("arm", ["psum", "zero1"])
def test_world2_census_against_jax_hlo(arm, devices):
    got = census.collective_counts(census.census_train_step(
        "trivial", batch=2, world=2, device="cpu", variable_update=arm,
        fusion_threshold_bytes=256, num_classes=10))
    want = jax_hlo.collective_counts(jax_hlo.lower_world_step_hlo(
        "trivial", batch=2, world=2, variable_update=arm,
        fusion_threshold_bytes=256, num_classes=10))
    mine = lints.zero1_shape_findings("trivial", got)
    ref = jax_lints.zero1_shape_findings("trivial", want)
    assert [f.message.split(" (")[0] for f in mine] == \
        [f.message.split(" (")[0] for f in ref]
    if arm == "zero1":
        # the same program shape: 2 gradient buckets reduce-scattered and
        # all-gathered, the loss's one all-reduce
        assert got == want == {"reduce-scatter": 2, "all-gather": 2,
                               "all-reduce": 1}
        assert lints.check_zero1_collectives(
            "trivial", fusion_threshold_bytes=256) == []
    else:
        # JAX's XLA combines the buckets into one all-reduce; the port
        # issues one a bucket plus the loss's
        assert got == {"all-reduce": 3} and want == {"all-reduce": 1}


@pytest.mark.slow
@pytest.mark.parametrize("arm", ["psum", "zero1"])
def test_world2_census_in_two_gloo_processes_equals_in_process(arm):
    twin = census.census_world("trivial", 2, variable_update=arm)
    here = census.census_train_step(
        "trivial", batch=2, world=2, device="cpu", variable_update=arm,
        fusion_threshold_bytes=256, num_classes=10).summary()
    assert twin["collectives"] == here["collectives"]
    assert twin["host_syncs"] == here["host_syncs"]


class _Syncing(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 4)
        self.gate = torch.nn.Linear(4, 1)

    def forward(self, x):
        y = self.lin(x)
        if self.gate(y).sum().item() > 0:         # a host sync
            y = y + 1
        return y[torch.nonzero(y[:, 0] > 0)[:, 0]]


def test_census_counts_syncs_products_and_launches(monkeypatch):
    model = _Syncing()
    x = torch.randn(3, 4)
    real = census.take(lambda: model(x), model)
    assert census.host_syncs(real) == {"_local_scalar_dense": 1,
                                       "nonzero": 1}
    assert sorted({w for _, w in real.syncs}) == ["_Syncing"]
    assert census.op_attribution(real) == {"gate": ["aten::addmm"],
                                           "lin": ["aten::addmm"]}
    # over data-less tensors the same syncs are found, each answered with
    # a placeholder so the forward runs on
    meta = model.to("meta")
    abstract = census.take(lambda: meta(torch.empty(3, 4, device="meta")),
                           meta, abstract=True)
    assert [op for op, _ in abstract.syncs] == [op for op, _ in real.syncs]
    # the kernels' counters, zeroed by take and read after
    from tpu_hc_bench_torch.ops.flash_attention import flash_attention

    def fake_launch():
        flash_attention.launches["fwd"] += 12

    c = census.take(fake_launch)
    assert c.launches["flash_attention_fwd"] == 12
    assert c.summary()["kernel_launches"] == {"flash_attention_fwd": 12}


@pytest.mark.parametrize("arm", ["gather", "paged"])
def test_serve_census_counts_the_engines_reads(arm):
    c = census.census_serve_step("llama_tiny", batch=3, prompt_len=16,
                                 kv_page_size=4, max_output_len=8,
                                 decode_attention=arm)
    # on the CPU the rows' ``.cpu()`` copies nothing: the first token's
    # ``int()`` is the one read; the kernels' plain versions launch none
    assert c.syncs == [("aten::_local_scalar_dense", census.SERVE)]
    assert census.collective_counts(c) == {}
    assert c.launches == dict.fromkeys(census.KERNEL_ROWS, 0)
    products = census.op_attribution(c)
    # the prefill and the decode step each run every projection once
    assert products["layers.0.attn.wq"] == ["aten::mm"] * 2
    assert census.SERVE in products


def test_card_sync_count_leaves_out_the_mode_switch(monkeypatch):
    import warnings

    def switch(mode):
        # the switch itself can warn, as the first one in a process did on
        # the card; only the step's own warnings count
        warnings.warn("called a synchronizing CUDA operation")

    def step():
        warnings.warn("called a synchronizing CUDA operation")
        warnings.warn("an unrelated warning")

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", switch)
    c = census.take(step, card_syncs=True)
    assert c.card_syncs == 1 and len(c.card_sync_sites) == 1


@pytest.mark.parametrize("name", ["bert_tiny", "llama_tiny", "vit_tiny",
                                  "moe_tiny"])
def test_sharding_consistency_equals_jax_on_meta(name):
    got = lints.check_sharding_consistency(name)
    want = jax_lints.check_sharding_consistency(name)
    assert [(f.lint, f.severity) for f in got] == \
        [(f.lint, f.severity) for f in want] == []
    # the replay is live: a block with its row-parallel half renamed
    # away is half-annotated, a rank-3 qkv drifted
    model, _ = lints._abstract_model(name)
    params = dict(model.named_parameters())
    doctored = torch.nn.Module()
    for path, p in params.items():
        mod = doctored
        parts = path.replace(".out.weight", ".out_renamed.weight").split(".")
        for part in parts[:-1]:
            if not hasattr(mod, part):
                mod.add_module(part, torch.nn.Module())
            mod = getattr(mod, part)
        mod.register_parameter(parts[-1], p)
    fs = lints.check_sharding_consistency(name, doctored, True)
    if any(p.endswith("attn.qkv.weight") for p in params):
        assert [f.location for f in fs] == ["param:attn.qkv.weight"]
    else:
        assert fs == []


@pytest.mark.parametrize("name", ["resnet20_cifar", "bert_tiny",
                                  "moe_tiny"])
def test_zoo_member_lints_clean(name):
    gating = [f for f in lints.lint_model(name)
              if f.severity in ("error", "warning")]
    assert gating == [], [f.render() for f in gating]


def test_repo_source_gate_under_wall_budget(tmp_path):
    # JAX's budget on its gate: the repo source passes through the CLI
    # in a fresh process, the gate's own wall_s; rc 0 doubles as "the
    # port's baseline is up to date"; one retry absorbs a loaded runner
    out = tmp_path / "report.json"
    for _ in range(2):
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_hc_bench_torch.analysis",
             "baseline", "--device=cpu", "--json", str(out)],
            capture_output=True, text=True, timeout=120, cwd=ROOT)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "baseline up to date" in proc.stdout
        payload = json.loads(out.read_text())
        if payload["wall_s"] < 30.0:
            break
    assert payload["wall_s"] < 30.0, payload["wall_s"]


@pytest.mark.slow
def test_all_members_gate_exits_zero():
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_hc_bench_torch.analysis", "--all",
         "--no-collectives", "--device=cpu"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]


# ---------------------------------------------------------------------
# the tuner's lint class, the serve entry point, the package boundary


def test_tuner_journal_with_and_without_lints(tmp_path, monkeypatch):
    from tpu_hc_bench_torch.tune import __main__ as tune_cli
    from tpu_hc_bench_torch.tune import prune, search

    def stub(c, rung, batches):
        return {"per_chip": 100.0 + len(c.key), "goodput": 0.9,
                "wall_s": 1.0}

    settings = search.SearchSettings(budget_s=100, max_candidates=2,
                                     max_rungs=1)
    on = search.run_search("trivial", str(tmp_path / "on"), "hw",
                           settings, runner=stub,
                           lint_fn=prune.baseline_lint_classes,
                           print_fn=lambda m: None)
    off = search.run_search("trivial", str(tmp_path / "off"), "hw",
                            settings, runner=stub,
                            print_fn=lambda m: None)
    assert (on["lints"], off["lints"]) == ("baseline", "off")
    assert not [s for s in on["skipped"] if s["class"] == "lint"]
    assert prune.baseline_lint_classes("trivial") == ()
    # the CLI passes the baseline class unless --no-lints
    seen = []
    monkeypatch.setattr(search, "run_search",
                        lambda *a, lint_fn=None, **k: seen.append(lint_fn)
                        or {"best": None})
    for extra in ([], ["--no-lints"]):
        tune_cli.main(["search", "--model", "trivial", "--hardware", "hw",
                       "--out", str(tmp_path / "cli"), *extra])
    assert seen == [prune.baseline_lint_classes, None]


def test_serve_module_entry_point(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    help_ = subprocess.run(
        [sys.executable, "-m", "tpu_hc_bench_torch.serve", "--device=cpu",
         "--help"], capture_output=True, text=True, timeout=120, env=env)
    assert help_.returncode == 0 and "--max_in_flight" in help_.stdout
    run = subprocess.run(
        [sys.executable, "-m", "tpu_hc_bench_torch.serve",
         "--model=llama_tiny", "--device=cpu", "--num_requests=3",
         "--max_prompt_len=8", "--max_output_len=3", "--max_in_flight=2",
         "--kv_page_size=4", "--arrival_rate=50",
         f"--metrics_dir={tmp_path}"],
        capture_output=True, text=True, timeout=300, env=env)
    assert run.returncode == 0, run.stdout + run.stderr
    assert (tmp_path / "manifest.json").is_file()


def test_analysis_imports_no_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["tpu_hc_bench"] = None
        import tpu_hc_bench_torch.analysis
        from tpu_hc_bench_torch.analysis import (
            __main__, census, contracts, dataflow, lints, registry, report)
        import tpu_hc_bench_torch.tune.prune
        assert len(registry.all_passes()) == 21
        lints.lint_source_text("x = 1\\n", "x.py")
        lints.check_forward_host_syncs("trivial")
        bad = [m for m, mod in sys.modules.items() if mod is not None
               and (m == "jax" or m.startswith(("jax.", "tpu_hc_bench.")))]
        assert not bad, bad
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
