"""Per-run machine-readable artifacts: ``metrics.jsonl`` + ``manifest.json``
(the port's copy of the JAX package's ``obs/metrics.py``).

A run with ``--metrics_dir`` leaves:

- ``manifest.json`` — run identity: the resolved flag set, torch's and
  CUDA's versions, the card's name, the world and the git sha (rank 0
  writes it, and the stream);
- ``metrics.jsonl`` — one ``kind``-tagged record per event.  A training
  run writes ``phase``/``phase_acc`` (the goodput ledger), ``window``,
  ``memory``, ``straggler``, the resilience records, ``memory_report``,
  ``hbm_budget``, ``trace_buckets``, ``latency_sketch`` and the final
  ``summary``; a serving run ``request``, ``serve``, ``kv_pool``,
  ``latency_sketch``, ``serve_clock``, the degradation records and the
  final ``serve_summary`` and ``serve_compile``.

The record formats are the JAX package's, so either package's
``summarize`` renders the other's run directory.  ``read_run`` /
``summarize_run`` / ``diff_runs`` are pure file operations (no torch),
so the CLI works on artifacts from any machine.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Any

SCHEMA_VERSION = 1

METRICS_NAME = "metrics.jsonl"
MANIFEST_NAME = "manifest.json"


# ---------------------------------------------------------------------
# manifest


def _git_sha() -> str:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        out = subprocess.run(
            ["git", "-C", repo, "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=5)
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return "unknown"


#: the run-identity fields a BENCH-style JSON record embeds (the port's
#: versions where JAX's record names jax's and jaxlib's)
MANIFEST_IDENTITY_KEYS = (
    "git_sha", "torch_version", "cuda_version", "platform",
    "device_kind", "process_count", "device_count", "created_unix")


def manifest_subset(manifest: dict) -> dict:
    """The BENCH-record identity slice of a full run manifest."""
    return {k: manifest.get(k) for k in MANIFEST_IDENTITY_KEYS}


def run_manifest(cfg: Any = None, device: Any = None, world: int = 1,
                 extra: dict | None = None) -> dict:
    """Assemble the run manifest; best-effort, so a manifest never kills
    a run.  ``device`` is the run's ``torch.device``: on the card the
    manifest names it (``device_kind``, JAX's key)."""
    import torch

    m: dict[str, Any] = {
        "schema": SCHEMA_VERSION,
        "created_unix": time.time(),
        "argv": list(sys.argv),
        "git_sha": _git_sha(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "world": world,
        "process_count": world,
        "device_count": 1,
        "platform": getattr(device, "type", None),
    }
    try:
        if getattr(device, "type", None) == "cuda":
            m["platform"] = "gpu"
            m["device_kind"] = torch.cuda.get_device_name(device)
        else:
            m["device_kind"] = "cpu"
    except Exception:
        pass
    if cfg is not None:
        m["config"] = dataclasses.asdict(cfg)
        m["model"] = getattr(cfg, "model", None)
    if extra:
        m.update(extra)
    return m


# ---------------------------------------------------------------------
# writer


class MetricsWriter:
    """Append-only JSONL stream + manifest for one run.

    Disabled (every method a no-op) when ``out_dir`` is falsy or
    ``primary`` is False — call sites never branch.  The manifest is
    written eagerly at construction so even a crashed run identifies
    itself.

    Transient write errors retry with bounded backoff
    (``resilience.retry``); a stream that keeps failing disables itself
    with a stderr warning rather than killing a run over telemetry.
    ``last_record`` keeps the most recent record in memory — the
    watchdog prints it beside the thread stacks when a run hangs.
    """

    def __init__(self, out_dir: str | None, manifest: dict | None = None,
                 primary: bool = True):
        self._f = None
        self.out_dir = None
        self.last_record: dict | None = None
        if not out_dir or not primary:
            return
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        if manifest is not None:
            self._write_manifest(manifest)
        self._f = open(os.path.join(out_dir, METRICS_NAME), "w")

    def _write_manifest(self, manifest: dict) -> None:
        # tmp -> fsync -> rename: update_manifest rewrites an already-
        # good manifest, and a crash mid-rewrite must not destroy it
        path = os.path.join(self.out_dir, MANIFEST_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2, default=str)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def update_manifest(self, fields: dict) -> None:
        """Merge ``fields`` into the on-disk manifest (facts known only
        after construction: whether the kernel library was built or
        loaded).  Best-effort: an amendment must never kill a run."""
        if self._f is None:
            return
        try:
            path = os.path.join(self.out_dir, MANIFEST_NAME)
            with open(path) as f:
                manifest = json.load(f)
            manifest.update(fields)
            self._write_manifest(manifest)
        except (OSError, json.JSONDecodeError) as e:
            sys.stderr.write(f"WARNING: manifest update failed: {e}\n")

    @property
    def enabled(self) -> bool:
        return self._f is not None

    def event(self, kind: str, **fields) -> None:
        rec = {"kind": kind}
        rec.update(fields)
        self.last_record = rec
        if self._f is None:
            return
        from tpu_hc_bench_torch.resilience.retry import retry_io

        line = json.dumps(rec, default=str) + "\n"
        # a failed flush can leave ANY prefix of the line on disk, so a
        # blind re-append could produce a corrupt fragment OR a
        # duplicated record; rewinding to the pre-write offset makes the
        # retry idempotent
        pos = self._f.tell()

        def _write():
            self._f.seek(pos)
            self._f.truncate()
            self._f.write(line)
            self._f.flush()

        try:
            retry_io(_write, what=f"metrics write ({kind})",
                     attempts=3, base_delay_s=0.05)
        except OSError as e:
            sys.stderr.write(
                f"WARNING: metrics stream disabled after repeated I/O "
                f"errors: {e}\n")
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None

    def close(self) -> None:
        """Flush AND fsync before closing: the watchdog and drain paths
        call this last, and the stream's tail must reach the disk."""
        if self._f is not None:
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except OSError:
                pass        # closing a dying stream must never raise
            self._f.close()
            self._f = None


# ---------------------------------------------------------------------
# reading / summarize (pure file ops)


def read_jsonl(path: str) -> list[dict]:
    """Tolerant JSONL read: blank and corrupt lines skipped (a stream
    interrupted by the very death it documents must still render), an
    unreadable file is an empty list."""
    out: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except OSError:
        pass
    return out


def resolve_run(path: str) -> tuple[str | None, str]:
    """Resolve a run path to ``(manifest_path_or_None, metrics_path)``:
    the metrics directory or the ``metrics.jsonl`` file itself."""
    if os.path.isdir(path):
        metrics = os.path.join(path, METRICS_NAME)
    else:
        metrics = path
    if not os.path.isfile(metrics):
        raise FileNotFoundError(f"no {METRICS_NAME} at {path}")
    manifest = os.path.join(os.path.dirname(metrics), MANIFEST_NAME)
    return (manifest if os.path.isfile(manifest) else None), metrics


def read_run(path: str,
             problems: list[str] | None = None) -> tuple[dict, list[dict]]:
    """Load ``(manifest, records)`` for a run (manifest {} if absent).

    Tolerant of a degraded run dir — a missing or corrupt manifest, or
    corrupt/truncated jsonl lines.  Each degradation is one line,
    appended to ``problems`` when given (the CLI turns a non-empty list
    into a nonzero exit), else written to stderr.  Raises
    ``FileNotFoundError`` only when there is no metrics stream at all.
    """
    def note(msg: str) -> None:
        if problems is not None:
            problems.append(msg)
        else:
            sys.stderr.write(f"WARNING: {msg}\n")

    manifest_path, metrics_path = resolve_run(path)
    manifest = {}
    if manifest_path is None:
        note(f"{os.path.dirname(metrics_path) or '.'}: no "
             f"{MANIFEST_NAME} (crashed before the eager manifest "
             f"write, or a partial copy?)")
    else:
        try:
            with open(manifest_path) as f:
                manifest = json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            note(f"{manifest_path}: unreadable manifest ({e}); "
                 f"rendering records without run identity")
            manifest = {}
    records = []
    corrupt = 0
    with open(metrics_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                corrupt += 1
    if corrupt:
        note(f"{metrics_path}: skipped {corrupt} corrupt/truncated "
             f"line(s) (interrupted write?)")
    return manifest, records


# resilience-event record kinds of both lanes: surfaced by summarize_run
# so a run that skipped, rewound, retried or shed its way to the finish
# line says so instead of passing as clean
RESILIENCE_KINDS = (
    "injected_fault", "nonfinite_skip", "nonfinite_abort", "rewind",
    "emergency_ckpt", "preempt", "watchdog_dump", "io_retry",
    "shed", "quarantine",
)

#: per-kind cap on detail lines in summarize (an overload run sheds
#: hundreds of requests; the counts line carries the totals)
_RESILIENCE_DETAIL_CAP = 6


def _of_kind(records: list[dict], kind: str) -> list[dict]:
    return [r for r in records if r.get("kind") == kind]


def _last(records: list[dict], kind: str) -> dict | None:
    recs = _of_kind(records, kind)
    return recs[-1] if recs else None


def compile_lines(rec: dict | None) -> list[str]:
    """The ``serve_compile`` record's kernel-library and budget lines
    (the port's counterparts of the JAX lane's compile-cache account)."""
    if not rec:
        return []
    lines = []
    lib = rec.get("kernel_library")
    if lib:
        lines.append(
            f"  kernels: library {'built' if lib.get('built') else 'loaded'}"
            f" in {lib.get('seconds', 0.0):.1f}s from {rec.get('cache_dir')}"
            f" ({rec.get('post_warmup_builds', 0)} build(s) after warmup)")
    budget = rec.get("hbm_budget")
    if budget and budget.get("budget_bytes"):
        peak = (budget.get("measured") or {}).get("total_bytes")
        lines.append(
            f"  hbm budget: "
            + ("unchecked (no memory report)" if not peak else
               f"{'EXCEEDED' if peak > budget['budget_bytes'] else 'ok'} "
               f"(measured peak {peak / 2**30:.2f} GiB vs budget "
               f"{budget['budget_bytes'] / 2**30:.2f} GiB)"))
    return lines


def _identity_lines(manifest: dict) -> list[str]:
    """The manifest's two lines: a training run's in JAX's form (model,
    fabric, world), a serving run's with its workload; then the
    versions."""
    if manifest.get("workload") == "serve" or "fabric" not in manifest:
        head = (f"  model={manifest.get('model')} "
                f"workload={manifest.get('workload')} "
                f"world={manifest.get('world')} "
                f"device={manifest.get('device_kind')}")
    else:
        mesh = manifest.get("mesh_shape")
        head = (f"  model={manifest.get('model')} "
                f"fabric={manifest.get('fabric')} "
                f"world={manifest.get('process_count')}proc/"
                f"{manifest.get('device_count')}dev "
                f"mesh={mesh if mesh else '?'}")
    return [head,
            f"  torch={manifest.get('torch_version')} "
            f"cuda={manifest.get('cuda_version')} "
            f"git={str(manifest.get('git_sha', '?'))[:12]} "
            f"platform={manifest.get('platform')}"]


def summarize_run(path: str, fabric_ceiling: str | None = None,
                  problems: list[str] | None = None) -> list[str]:
    """Render one run as text lines (JAX's ``summarize_run``): identity;
    a training run's windows, total, merged step sketch, MFU and its
    source, goodput ledger, checkpoints, stragglers, input plane,
    memory, budget, timeline, resume, resilience events, trace buckets,
    collective overlap and fabric ceiling; a serving run's section
    (``serve.slo.slo_lines``) and kernel-library lines.
    ``fabric_ceiling``: an OSU sweep export to judge the achieved
    gradient all-reduce bandwidth against."""
    from tpu_hc_bench_torch.obs import efficiency as eff_mod
    from tpu_hc_bench_torch.obs import fleet as fleet_mod
    from tpu_hc_bench_torch.obs import goodput as goodput_mod
    from tpu_hc_bench_torch.obs import memory as mem_mod
    from tpu_hc_bench_torch.obs import sketch as sketch_mod
    from tpu_hc_bench_torch.obs import timeline as timeline_mod
    from tpu_hc_bench_torch.serve import slo as slo_mod

    manifest, records = read_run(path, problems=problems)
    lines = [f"run: {path}"]
    if manifest:
        lines.extend(_identity_lines(manifest))
    windows = _of_kind(records, "window")
    if windows:
        lines.append(f"  {'step':>6s} {'ex/sec':>10s} {'step_ms':>9s} "
                     f"{'loss':>8s}")
        for w in windows:
            lines.append(
                f"  {w.get('step', '?'):>6} {w.get('rate', 0.0):10.1f} "
                f"{w.get('step_ms', 0.0):9.2f} {w.get('loss', 0.0):8.3f}")
    serve_fold = slo_mod.fold_serve_records(records)
    if serve_fold is not None:
        if not windows and not _last(records, "summary"):
            lines.append("  serving run (request-keyed metrics; no "
                         "step-keyed training records)")
        lines.extend(slo_mod.slo_lines(serve_fold))
    lines.extend(compile_lines(_last(records, "serve_compile")))
    summary = _last(records, "summary")
    if summary:
        lines.append(
            f"  total: {summary.get('total_images_per_sec', 0.0):.2f} "
            f"ex/s  mean {summary.get('mean_step_ms', 0.0):.2f}ms  "
            f"p50 {summary.get('p50_step_ms', 0.0):.2f}ms"
            f" (granularity {summary.get('p50_step_granularity', '?')} "
            f"step)  MFU {100 * (summary.get('mfu') or 0.0):.1f}%")
        step_sk = sketch_mod.merge_records(
            (r.get("fields") or {}).get("step_ms")
            for r in records if r.get("kind") == "latency_sketch")
        if step_sk is not None and step_sk.count:
            lines.append(
                f"  step ms [sketch, merged] "
                f"p50 {step_sk.quantile(50):.2f}  "
                f"p95 {step_sk.quantile(95):.2f}  "
                f"p99 {step_sk.quantile(99):.2f}")
        lines.extend(eff_mod.mfu_lines(summary))
    ledger = goodput_mod.build_ledger(records)
    if ledger is not None:
        lines.extend("  " + ln for ln in ledger.format_lines())
    commits = _of_kind(records, "checkpoint_commit")
    if commits:
        total_w = sum(float(c.get("write_s", 0) or 0) for c in commits)
        lines.append(f"  async checkpoints: {len(commits)} landed, "
                     f"{total_w:.2f}s of writes overlapped with the "
                     f"step loop")
    run_dir = None
    try:
        run_dir = os.path.dirname(resolve_run(path)[1])
        lines.extend(fleet_mod.straggler_lines(run_dir, records))
    except FileNotFoundError:
        pass
    data = _last(records, "data")
    if data:
        lines.append(
            f"  data: {data.get('examples', 0)} examples decoded, "
            f"{data.get('decode_workers', '?')} workers, "
            f"{data.get('decode_wall_s', 0.0):.1f}s decode wall")
    lines.extend(fleet_mod.input_lines(run_dir, records, ledger))
    lines.extend(mem_mod.memory_lines(mem_mod.fold_memory_records(records)))
    mem_rep = _last(records, "memory_report")
    if mem_rep:
        lines.extend(mem_mod.memory_report_lines(mem_rep))
    budget = _last(records, "hbm_budget")
    if budget:
        lines.append(
            f"  hbm budget: {'EXCEEDED' if budget.get('exceeded') else 'ok'}"
            f" (measured {budget.get('total_bytes', 0) / 2**30:.2f} GiB vs "
            f"budget {budget.get('budget_bytes', 0) / 2**30:.2f} GiB)")
    dump = _last(records, "memory_dump")
    if dump:
        lines.append(
            f"  memory dump: {dump.get('path')} "
            f"(reason {dump.get('reason')}, step {dump.get('step')})")
    lines.extend(timeline_mod.timeline_lines(run_dir))
    resume = _last(records, "resume")
    if resume:
        lines.append(
            f"  resume: step {resume.get('restored_step')}  world "
            f"{resume.get('saved_world')}->{resume.get('live_world')}  "
            f"arm={resume.get('arm')}"
            + (" (elastic reshard)" if resume.get("elastic") else ""))
    res = [r for r in records if r.get("kind") in RESILIENCE_KINDS]
    if res:
        counts: dict[str, int] = {}
        for r in res:
            counts[r["kind"]] = counts.get(r["kind"], 0) + 1
        lines.append("  resilience: " + "  ".join(
            f"{k}x{counts[k]}" for k in RESILIENCE_KINDS if k in counts))
        shown: dict[str, int] = {}
        for r in res:
            shown[r["kind"]] = shown.get(r["kind"], 0) + 1
            if shown[r["kind"]] > _RESILIENCE_DETAIL_CAP:
                continue
            detail = " ".join(f"{k}={v}" for k, v in r.items()
                              if k != "kind")
            lines.append(f"    {r['kind']}: {detail}")
        for kind, n in shown.items():
            if n > _RESILIENCE_DETAIL_CAP:
                lines.append(f"    {kind}: ... "
                             f"+{n - _RESILIENCE_DETAIL_CAP} more")
    tb = _last(records, "trace_buckets")
    if tb and tb.get("buckets"):
        total = sum(tb["buckets"].values()) or 1.0
        parts = ", ".join(f"{k} {v / total:.1%}"
                          for k, v in sorted(tb["buckets"].items(),
                                             key=lambda kv: -kv[1]))
        lines.append(f"  trace buckets: {parts}")
    if tb and tb.get("overlap"):
        lines.extend(eff_mod.overlap_lines(tb["overlap"]))
    if fabric_ceiling:
        ceiling = eff_mod.load_fabric_ceiling(fabric_ceiling)
        lines.extend(eff_mod.ceiling_utilization_lines(
            summary or {}, tb, ceiling))
    elif summary:
        lines.extend(eff_mod.collective_busbw_lines(summary, tb))
    return lines


def _pct(a: float, b: float) -> str:
    if a:
        return f"{(b - a) / a:+.1%}"
    return "new" if b else "-"


def diff_runs(path_a: str, path_b: str,
              problems: list[str] | None = None) -> list[str]:
    """Compare two metrics runs: headline metrics, per-bucket trace
    deltas, and any resolved-flag differences."""
    from tpu_hc_bench_torch.obs import trace as trace_mod

    man_a, recs_a = read_run(path_a, problems=problems)
    man_b, recs_b = read_run(path_b, problems=problems)
    lines = [f"diff: {path_a} -> {path_b}"]

    # resolved-flag drift: a perf delta with a config delta is not a
    # regression, it is a different experiment — say so first.  For
    # output-LOCATION flags only presence matters: two clean A/B runs
    # necessarily write to different paths (noise on every diff), but
    # set-vs-unset IS behavioral drift (checkpoint saves sync the
    # device, profiling perturbs the window).  The port's manifest
    # keeps the translation notes inside ``config``; JAX's beside it:
    # they follow from the flags and are not compared.
    path_flags = {"metrics_dir", "trace_dir", "train_dir",
                  "fabric_ceiling"}
    cfg_a, cfg_b = ({k: v for k, v in (m.get("config") or {}).items()
                     if k != "translations"} for m in (man_a, man_b))

    def _cmp(cfg, k):
        v = cfg.get(k)
        return (v is not None) if k in path_flags else v

    changed = {k for k in set(cfg_a) | set(cfg_b)
               if _cmp(cfg_a, k) != _cmp(cfg_b, k)}
    for k in sorted(changed):
        lines.append(f"  config: {k}: {cfg_a.get(k)!r} -> {cfg_b.get(k)!r}")
    for k in ("torch_version", "cuda_version", "git_sha", "device_kind",
              "process_count", "device_count"):
        if man_a.get(k) != man_b.get(k):
            lines.append(f"  env: {k}: {man_a.get(k)} -> {man_b.get(k)}")

    sum_a = _last(recs_a, "summary") or {}
    sum_b = _last(recs_b, "summary") or {}
    metrics = (
        ("total ex/s", "total_images_per_sec"),
        ("ex/s/chip", "images_per_sec_per_chip"),
        ("mean step ms", "mean_step_ms"),
        ("p50 step ms", "p50_step_ms"),
        ("mfu", "mfu"),
        ("goodput", "goodput"),
        ("final loss", "final_loss"),
    )
    rows = [(label, key) for label, key in metrics
            if key in sum_a or key in sum_b]
    if rows:
        lines.append(f"  {'metric':>14s} {'a':>12s} {'b':>12s} "
                     f"{'delta':>8s}")
        for label, key in rows:
            va, vb = sum_a.get(key, 0.0), sum_b.get(key, 0.0)
            lines.append(f"  {label:>14s} {va:12.4g} {vb:12.4g} "
                         f"{_pct(va, vb):>8s}")
    # serving lane: p99/goodput/tokens-per-s deltas when both runs
    # carry request-keyed records (step-free serving runs diff cleanly
    # instead of rendering an empty training table)
    from tpu_hc_bench_torch.serve import slo as slo_mod

    lines.extend(slo_mod.serve_diff_lines(
        slo_mod.fold_serve_records(recs_a),
        slo_mod.fold_serve_records(recs_b)))
    src_a = sum_a.get("mfu_source")
    src_b = sum_b.get("mfu_source")
    if (src_a or src_b) and src_a != src_b:
        # measured-vs-analytic MFUs are different quantities; say so
        # before anyone reads the delta row as a regression
        lines.append(f"  note: MFU flops source differs: "
                     f"{src_a or '?'} -> {src_b or '?'}")

    # ledger phase deltas: where the non-productive wall moved — a
    # built kernel library shows up as the compile row collapsing,
    # async checkpointing as checkpoint(blocking) -> checkpoint_async
    from tpu_hc_bench_torch.obs import goodput as goodput_mod

    led_a = goodput_mod.build_ledger(recs_a)
    led_b = goodput_mod.build_ledger(recs_b)
    if led_a is not None and led_b is not None:
        rows = [p for p in goodput_mod.PHASES
                if (led_a.seconds.get(p, 0.0) > 0.0
                    or led_b.seconds.get(p, 0.0) > 0.0)]
        if rows:
            lines.append("  ledger phases (wall s):")
            for p in rows:
                va = led_a.seconds.get(p, 0.0)
                vb = led_b.seconds.get(p, 0.0)
                lines.append(f"  {p:>14s} {va:12.2f} {vb:12.2f} "
                             f"{_pct(va, vb):>8s}")
        # input-plane delta: the fraction of wall blocked on the input
        # pipeline — the input-service A/B's headline row
        fa = (led_a.seconds.get("data_wait", 0.0) / led_a.wall_s
              if led_a.wall_s > 0 else 0.0)
        fb = (led_b.seconds.get("data_wait", 0.0) / led_b.wall_s
              if led_b.wall_s > 0 else 0.0)
        if fa > 0.0 or fb > 0.0:
            lines.append(f"  {'data_wait frac':>14s} {fa:12.4f} "
                         f"{fb:12.4f} {_pct(fa, fb):>8s}")

    tb_a = _last(recs_a, "trace_buckets")
    tb_b = _last(recs_b, "trace_buckets")
    if tb_a and tb_b and tb_a.get("buckets") and tb_b.get("buckets"):
        lines.append("  trace buckets (device us):")
        lines.extend("  " + ln for ln in trace_mod.diff_buckets(
            tb_a["buckets"], tb_b["buckets"], label_a="a", label_b="b"))
    # memory deltas (obs.memory): runtime high-water + the report's
    # byte classes — a batch/accum change shows up here as temp bytes
    # moving while args stay flat, BEFORE anything OOMs
    from tpu_hc_bench_torch.obs import memory as mem_mod

    fold_a = mem_mod.fold_memory_records(recs_a)
    fold_b = mem_mod.fold_memory_records(recs_b)
    if fold_a and fold_b:
        pa, pb = fold_a["peak_bytes"], fold_b["peak_bytes"]
        lines.append(f"  {'peak HBM MiB':>14s} {pa / 2**20:12.1f} "
                     f"{pb / 2**20:12.1f} {_pct(pa, pb):>8s}")
        if (fold_a.get("peak_phase") != fold_b.get("peak_phase")
                and (fold_a.get("peak_phase") or fold_b.get("peak_phase"))):
            lines.append(f"  note: memory high-water phase differs: "
                         f"{fold_a.get('peak_phase') or '?'} -> "
                         f"{fold_b.get('peak_phase') or '?'}")
    rep_a = _last(recs_a, "memory_report") or {}
    rep_b = _last(recs_b, "memory_report") or {}
    ma, mb = rep_a.get("measured") or {}, rep_b.get("measured") or {}
    if ma and mb:
        for label, key in (("aot args MiB", "argument_bytes"),
                           ("aot temp MiB", "temp_bytes"),
                           ("aot out MiB", "output_bytes")):
            va, vb = ma.get(key, 0), mb.get(key, 0)
            if va or vb:
                lines.append(
                    f"  {label:>14s} {va / 2**20:12.1f} "
                    f"{vb / 2**20:12.1f} {_pct(va, vb):>8s}")
    return lines
