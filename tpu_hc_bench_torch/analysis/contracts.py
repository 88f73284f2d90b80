"""Stream-schema contract checker: obs readers vs metrics writers (the
JAX package's ``analysis/contracts.py`` over the port's ``obs/`` folds
and the port's writers).

The metrics stream is a JSONL contract with no schema: writers emit
``MetricsWriter.event(kind, **fields)`` records (plus kind-tagged dict
literals for heartbeats/spans), and the obs folds — summarize, diff,
watch, regress, timeline, fleet — consume keys by string literal.
Nothing ties the two sides together, so the failure mode is *silent*:
a reader key that no writer emits folds to zero (a misspelt
``mem_peak_bytes`` did exactly that), and a writer field no reader
consumes is dead weight nobody notices.  This pass extracts both sides
statically and reports the asymmetric difference:

- **stream-contract-orphan-read** (warning, gates): a key consumed by
  one of the reader folds that NO code in the tree materializes — not
  as a dict-literal key, a ``rec["key"] = ...`` store, an
  ``event(...)`` kwarg, or a ``dict(key=...)`` kwarg.  The write
  universe is deliberately BROAD (any materialization anywhere counts)
  so a hit means "this spelling exists nowhere": a typo or a reader
  that drifted from its writer.
- **stream-contract-orphan-write** (info, never gates): a field
  emitted at a stream writer site — ``event()`` kwargs and dict
  literals carrying a literal ``"kind"`` entry, the emit-anchored
  definition — that no obs module reads.  Info because
  write-side slack is intentional (records carry forensics fields for
  humans); the report keeps it visible without gating.

Reads are extracted from literal ``.get("k")`` / ``rec["k"]`` sites,
``_of_kind``/``_last`` kind arguments, ``rec.get("kind") == ...``
comparisons, and module-level key-path tables (the requests
``COMPONENTS`` pairs, the regress ``CHECKS``/``FINGERPRINT_KEYS``
paths) — table-driven reads are real reads even though no string
literal appears at the ``.get`` site.

Known intentional seams live in ``contract_allowlist.json`` next to
this module, each with a reason.  Allowlisted orphans are still
REPORTED (info) so the seam stays visible — the
zero-component normalizer (``obs/requests.py`` reads the component
keys through the ``COMPONENTS`` table and normalizes absent ones to
0.0 by design) is the canonical entry.  The allowlist is the contract
baseline: tightening the contract means deleting an entry and fixing
the orphan, not editing findings JSON by hand.
"""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

from tpu_hc_bench_torch.analysis.registry import register_pass
from tpu_hc_bench_torch.analysis.report import Finding

__all__ = [
    "ORPHAN_READ", "ORPHAN_WRITE", "READER_MODULES",
    "extract_reads", "extract_writes", "load_allowlist",
    "check_stream_contracts", "ALLOWLIST_PATH",
]

ORPHAN_READ = "stream-contract-orphan-read"
ORPHAN_WRITE = "stream-contract-orphan-write"

ALLOWLIST_PATH = Path(__file__).parent / "contract_allowlist.json"

#: the package both sides are read from, under the repo root
PACKAGE = "tpu_hc_bench_torch"

#: the seven obs reader folds whose consumed keys define the read side
#: of the contract (narrow on purpose: these are the modules that fold
#: the stream back into human-facing reports, where a missing key
#: renders as a silent zero)
READER_MODULES = (
    "obs/metrics.py",       # summarize_run / diff_runs
    "obs/watch.py",
    "obs/regress.py",
    "obs/timeline.py",
    "obs/fleet.py",
    "obs/requests.py",
    "obs/kv.py",            # the KV-pool utilization ledger
)

#: helpers whose second positional argument is a record KIND
_KIND_SELECTORS = frozenset({"_of_kind", "of_kind", "_last"})

#: keys must look like snake_case record fields; uppercase (env vars),
#: dunder and one-letter strings are out of contract scope
_KEY_RE = re.compile(r"^[a-z][a-z0-9_]{1,63}$")


def _const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _record(keys: dict[str, str], key: str | None, where: str) -> None:
    if key is not None and _KEY_RE.match(key):
        keys.setdefault(key, where)


def _loc(rel: str, node: ast.AST) -> str:
    return f"{rel}:{getattr(node, 'lineno', 0)}"


# ---------------------------------------------------------------------
# read side


def _table_strings(value: ast.AST) -> list[str]:
    """String constants inside a module-level key-path table: a
    tuple/list of rows where each row is (or contains) tuples of
    string constants.  Captures the requests ``COMPONENTS`` pairs and
    the regress ``CHECKS``/``FINGERPRINT_KEYS`` record paths."""
    if not isinstance(value, (ast.Tuple, ast.List)):
        return []
    out = []
    for row in value.elts:
        if not isinstance(row, (ast.Tuple, ast.List)):
            return []    # not a table of rows
        inner = [n for n in ast.walk(row)
                 if isinstance(n, ast.Tuple) and n is not row]
        # rows with inner key-path tuples (the regress CHECKS shape)
        # contribute only the path keys, not the direction/label
        # strings riding alongside them
        pools = inner or [row]
        for pool in pools:
            for elt in getattr(pool, "elts", []):
                s = _const_str(elt)
                if s is not None:
                    out.append(s)
    return out


def extract_reads(root: Path,
                  modules=READER_MODULES) -> tuple[dict, dict]:
    """(field_keys, kind_keys) consumed by the reader folds — each a
    ``{key: first-site}`` dict."""
    fields: dict[str, str] = {}
    kinds: dict[str, str] = {}
    for rel in modules:
        path = root / PACKAGE / rel
        if not path.is_file():
            continue
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            # rec.get("k") / rec.get("kind") == "x" comparisons
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "get" and node.args:
                _record(fields, _const_str(node.args[0]), _loc(rel, node))
            # rec["k"] loads
            elif isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Load):
                _record(fields, _const_str(node.slice), _loc(rel, node))
            # _of_kind(records, "step") / _last(records, "summary")
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Name) \
                    and node.func.id in _KIND_SELECTORS \
                    and len(node.args) >= 2:
                _record(kinds, _const_str(node.args[1]), _loc(rel, node))
            # rec.get("kind") == "x" / in ("x", "y")
            elif isinstance(node, ast.Compare):
                if not _reads_kind(node.left):
                    continue
                for comp in node.comparators:
                    for elt in ([comp] if not isinstance(
                            comp, (ast.Tuple, ast.List, ast.Set))
                            else comp.elts):
                        _record(kinds, _const_str(elt), _loc(rel, node))
        # module-level key tables (COMPONENTS, CHECKS, FINGERPRINT_KEYS,
        # RESILIENCE_KINDS-style string collections)
        for stmt in tree.body:
            if not isinstance(stmt, ast.Assign):
                continue
            name = stmt.targets[0].id \
                if isinstance(stmt.targets[0], ast.Name) else ""
            for s in _table_strings(stmt.value):
                _record(fields, s, f"{rel}:{stmt.lineno}")
            if "KIND" in name and isinstance(
                    stmt.value, (ast.Tuple, ast.List, ast.Set)):
                for elt in stmt.value.elts:
                    _record(kinds, _const_str(elt),
                            f"{rel}:{stmt.lineno}")
    return fields, kinds


def _reads_kind(node: ast.AST) -> bool:
    if isinstance(node, ast.Call) \
            and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "get" and node.args:
        return _const_str(node.args[0]) == "kind"
    if isinstance(node, ast.Subscript):
        return _const_str(node.slice) == "kind"
    # `kind = rec.get("kind")` then `kind == "phase"` — the goodput
    # fold's shape; matching the variable NAME is lexical but cheap
    return isinstance(node, ast.Name) and node.id == "kind"


# ---------------------------------------------------------------------
# write side


def writer_sources(root: Path) -> list[Path]:
    """The port's package and the port's scripts (``scripts/*torch*``;
    the JAX package's scripts write JAX's streams)."""
    paths: list[Path] = []
    base = root / PACKAGE
    if base.is_dir():
        paths.extend(sorted(base.rglob("*.py")))
    scripts = root / "scripts"
    if scripts.is_dir():
        paths.extend(sorted(scripts.glob("*torch*.py")))
    return paths


def extract_writes(root: Path) -> tuple[dict, dict, dict]:
    """(broad_fields, stream_fields, stream_kinds) over the package.

    ``broad_fields``: ANY materialization of a snake_case string key —
    dict-literal keys, ``x["k"] = ...`` stores, keyword arguments of
    any call (records are routinely built through dataclass/event
    constructors), class-body attribute names (``dataclasses.asdict``
    turns field names into record keys), and module-level all-string
    tuple/set registries (``PHASES``/``KNOWN_SPANS``-style name
    tables).  The universe the orphan-READ check tests against:
    absence here means the spelling exists nowhere in the tree.

    ``stream_fields``/``stream_kinds``: the emit-anchored subset —
    ``event(kind, **fields)``/``heartbeat()`` call sites and dict
    literals carrying a literal ``"kind"`` entry — that the
    orphan-WRITE check audits.
    """
    broad: dict[str, str] = {}
    stream: dict[str, str] = {}
    kinds: dict[str, str] = {}
    for path in writer_sources(root):
        rel = path.relative_to(root).as_posix()
        if "/analysis/" in f"/{rel}":
            continue                 # the checker itself is not a writer
        try:
            tree = ast.parse(path.read_text(), filename=str(path))
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Dict):
                keys = [_const_str(k) for k in node.keys
                        if k is not None]
                tagged = "kind" in keys
                if tagged:
                    _record(kinds, _const_str(
                        node.values[keys.index("kind")]),
                        _loc(rel, node))
                for k in keys:
                    _record(broad, k, _loc(rel, node))
                    if tagged and k != "kind":
                        _record(stream, k, _loc(rel, node))
            elif isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Store):
                _record(broad, _const_str(node.slice), _loc(rel, node))
            elif isinstance(node, ast.ClassDef):
                for stmt in node.body:
                    tgt = stmt.target if isinstance(
                        stmt, ast.AnnAssign) else (
                        stmt.targets[0] if isinstance(stmt, ast.Assign)
                        and stmt.targets else None)
                    if isinstance(tgt, ast.Name):
                        _record(broad, tgt.id, _loc(rel, stmt))
            elif isinstance(node, ast.Call):
                callee = None
                if isinstance(node.func, ast.Attribute):
                    callee = node.func.attr
                elif isinstance(node.func, ast.Name):
                    callee = node.func.id
                if callee == "event" and node.args:
                    kv = _const_str(node.args[0])
                    _record(kinds, kv, _loc(rel, node))
                    _record(broad, kv, _loc(rel, node))
                for kw in node.keywords:
                    if kw.arg:
                        _record(broad, kw.arg, _loc(rel, node))
                        if callee in ("event", "heartbeat"):
                            _record(stream, kw.arg, _loc(rel, node))
        # module-level name registries: a flat tuple/list/set of string
        # constants IS the materialization site for its names
        for stmt in tree.body:
            if isinstance(stmt, ast.Assign) and isinstance(
                    stmt.value, (ast.Tuple, ast.List, ast.Set)):
                elts = stmt.value.elts
                if elts and all(_const_str(e) is not None for e in elts):
                    for e in elts:
                        _record(broad, _const_str(e), _loc(rel, stmt))
    return broad, stream, kinds


# ---------------------------------------------------------------------
# the check


def load_allowlist(path: Path | None = None) -> dict:
    """``{"reads": {key: reason}, "writes": {key: reason}}`` — the
    committed contract baseline of intentional seams."""
    p = ALLOWLIST_PATH if path is None else Path(path)
    if not p.is_file():
        return {"reads": {}, "writes": {}}
    data = json.loads(p.read_text())
    return {"reads": dict(data.get("reads", {})),
            "writes": dict(data.get("writes", {}))}


@register_pass(
    ORPHAN_READ, "warning", "repo",
    doc="an obs fold consumes a record key no code in the tree "
        "materializes — the reader renders silent zeros (the misspelt "
        "mem_peak_bytes class)",
    example="obs/watch.py reads `.get(\"mem_peak_byte\")` but every "
            "writer spells it `mem_peak_bytes` — liveness rows show "
            "no memory forever")
@register_pass(
    ORPHAN_WRITE, "info", "repo",
    doc="a field emitted at a stream writer site (event kwargs, "
        "kind-tagged dict literals) that no obs module reads — dead "
        "weight in every record",
    example="`writer.event(\"step\", grad_norm_sq=...)` emitted every "
            "step, consumed by no fold")
def check_stream_contracts(root: str | Path | None = None,
                           allowlist_path: Path | None = None
                           ) -> list[Finding]:
    """Run both contract checks over the repo; returns findings."""
    if root is None:
        root = Path(__file__).resolve().parents[2]
    root = Path(root)
    reads, kind_reads = extract_reads(root)
    broad, stream, kind_writes = extract_writes(root)
    allow = load_allowlist(allowlist_path)
    findings: list[Finding] = []

    # read side: consumed but materialized nowhere
    for key in sorted(reads):
        if key in broad:
            continue
        site = reads[key]
        module = site.rsplit(":", 1)[0]
        if key in allow["reads"]:
            findings.append(Finding(
                ORPHAN_READ, "info", "repo",
                f"{module}::{key}",
                f"allowlisted contract seam `{key}` (read at {site}, "
                f"no literal writer): {allow['reads'][key]}"))
            continue
        findings.append(Finding(
            ORPHAN_READ, "warning", "repo", f"{module}::{key}",
            f"reader consumes `{key}` (at {site}) but no writer, dict "
            f"literal, store, or kwarg in the tree materializes that "
            f"key — the fold renders a silent zero/None; fix the "
            f"spelling or allowlist the seam in "
            f"contract_allowlist.json with a reason"))
    for kind in sorted(kind_reads):
        if kind in kind_writes or kind in allow["reads"]:
            continue
        site = kind_reads[kind]
        module = site.rsplit(":", 1)[0]
        findings.append(Finding(
            ORPHAN_READ, "warning", "repo", f"{module}::kind={kind}",
            f"reader selects records of kind `{kind}` (at {site}) but "
            f"no writer emits that kind — the selection is always "
            f"empty"))

    # write side: emitted at stream sites but read by no stream fold —
    # the read universe here is every obs module plus the serve SLO
    # fold (the one stream consumer living outside obs/)
    consumer_modules = tuple(
        p.relative_to(root / PACKAGE).as_posix()
        for p in sorted((root / PACKAGE / "obs").glob("*.py"))
    ) + ("serve/slo.py",)
    obs_reads, obs_kind_reads = extract_reads(
        root, modules=consumer_modules)
    dead = [k for k in sorted(stream)
            if k not in obs_reads and k not in allow["writes"]]
    if dead:
        shown = ", ".join(dead[:12]) + (
            f", … +{len(dead) - 12} more" if len(dead) > 12 else "")
        findings.append(Finding(
            ORPHAN_WRITE, "info", "repo", "stream-writers",
            f"{len(dead)} stream field(s) emitted but consumed by no "
            f"obs/slo fold: {shown} — forensics-only fields are fine; "
            f"prune or allowlist intentional ones"))
    dead_kinds = [k for k in sorted(kind_writes)
                  if k not in obs_kind_reads
                  and k not in allow["writes"]]
    if dead_kinds:
        findings.append(Finding(
            ORPHAN_WRITE, "info", "repo", "stream-writers::kinds",
            f"{len(dead_kinds)} record kind(s) emitted but selected by "
            f"no obs reader: {', '.join(dead_kinds[:12])}"))
    return findings
