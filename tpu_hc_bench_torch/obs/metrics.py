"""Per-run machine-readable artifacts: ``metrics.jsonl`` + ``manifest.json``
(the port's copy of the JAX package's ``obs/metrics.py``, the part the
serving lane writes and reads).

A serve run with ``--metrics_dir`` leaves:

- ``manifest.json`` — run identity: the resolved flag set, torch's and
  CUDA's versions, the card's name, the world (1: the serve lane is one
  process) and the git sha;
- ``metrics.jsonl`` — one ``kind``-tagged record per event: ``request``,
  ``serve``, ``kv_pool``, ``latency_sketch``, ``serve_clock``, the
  degradation records and the final ``serve_summary`` and
  ``serve_compile``.

The record formats are the JAX package's, so either package's
``summarize`` renders the other's run directory.  ``read_run`` /
``summarize_run`` are pure file operations (no torch), so the CLI works
on artifacts from any machine.
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


# resilience-event record kinds of the serving lane: surfaced by
# summarize_run so a degraded run says so instead of passing as clean
RESILIENCE_KINDS = (
    "injected_fault", "preempt", "watchdog_dump", "io_retry", "shed",
    "quarantine",
)

#: per-kind cap on detail lines in summarize (an overload run sheds
#: hundreds of requests; the counts line carries the totals)
_RESILIENCE_DETAIL_CAP = 6


def _last(records: list[dict], kind: str) -> dict | None:
    for r in reversed(records):
        if r.get("kind") == kind:
            return r
    return None


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


def summarize_run(path: str, problems: list[str] | None = None
                  ) -> list[str]:
    """Render one serving run as text lines: identity, the serving
    section (``serve.slo.slo_lines``, the JAX lane's lines), the kernel
    library and budget, heartbeats, the flight recorder's timeline and
    the resilience events."""
    from tpu_hc_bench_torch.obs import fleet as fleet_mod
    from tpu_hc_bench_torch.obs import timeline as timeline_mod
    from tpu_hc_bench_torch.serve import slo as slo_mod

    manifest, records = read_run(path, problems=problems)
    lines = [f"run: {path}"]
    if manifest:
        lines.append(
            f"  model={manifest.get('model')} "
            f"workload={manifest.get('workload')} "
            f"world={manifest.get('world')} "
            f"device={manifest.get('device_kind')}")
        lines.append(
            f"  torch={manifest.get('torch_version')} "
            f"cuda={manifest.get('cuda_version')} "
            f"git={str(manifest.get('git_sha', '?'))[:12]} "
            f"platform={manifest.get('platform')}")
    serve_fold = slo_mod.fold_serve_records(records)
    if serve_fold is not None:
        lines.append("  serving run (request-keyed metrics; no "
                     "step-keyed training records)")
        lines.extend(slo_mod.slo_lines(serve_fold))
    lines.extend(compile_lines(_last(records, "serve_compile")))
    run_dir = os.path.dirname(resolve_run(path)[1])
    lines.extend(fleet_mod.straggler_lines(run_dir, records))
    lines.extend(timeline_mod.timeline_lines(run_dir))
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
    return lines
