"""The lint-pass registry: one table of every analysis pass (the JAX
package's ``analysis/registry.py``, with the port's pass modules).

The registry is the ONE home:

- every pass **registers itself** with a ``@register_pass`` decorator
  at definition site (name, default severity, scope, a one-line
  "what it catches", and an example finding for the docs table);
- ``discover()`` imports the pass-defining modules so the table is
  complete without a hand-maintained list (auto-discovery: a new
  module only has to be named in ``_PASS_MODULES``, its passes
  register themselves);
- ``_FileLinter.run()`` iterates ``file_passes()``/``jit_passes()``
  instead of a hard-coded call sequence, so a registered pass runs
  without touching the driver;
- per-pass severity lives HERE (``_emit`` looks it up by default), so
  a pass's severity is declared once next to its registration;
- ``pass_index()`` renders the README/ARCHITECTURE lint table from
  the same registrations — the docs cannot drift from the code.

Scopes:

- ``jit``: runs once per traced-function context (``_jit_contexts``).
- ``file``: runs once per source file.
- ``repo``: runs once per repository (registry staleness, stream
  contracts).
- ``model``: runs per zoo member (the sharding table, the forward's
  op census, the zero1 step's collective counts).

``changed_python_files`` backs the CLI's ``--changed-only`` mode: the
per-file passes restrict to sources ``git diff`` (plus untracked files)
names, so the CI gate stays cheap as passes multiply while repo-scope
passes still see the whole tree.
"""

from __future__ import annotations

import dataclasses
import importlib
import subprocess
from pathlib import Path
from typing import Callable

__all__ = [
    "PassInfo", "register_pass", "discover", "all_passes", "get_pass",
    "file_passes", "jit_passes", "pass_index", "changed_python_files",
]


@dataclasses.dataclass(frozen=True)
class PassInfo:
    name: str            # lint name, e.g. "rank-divergent-collective"
    severity: str        # default severity: "error" | "warning" | "info"
    scope: str           # "jit" | "file" | "repo" | "model"
    doc: str             # one line: what the pass catches
    example: str         # one example finding, for the docs table
    func: Callable | None  # the pass callable (None: run out-of-band)
    order: int           # registration order (stable run order)


_REGISTRY: dict[str, PassInfo] = {}
_ORDER = [0]

#: modules whose import populates the registry (auto-discovery: add a
#: pass module here and its ``@register_pass`` decorators do the rest)
_PASS_MODULES = (
    "tpu_hc_bench_torch.analysis.lints",
    "tpu_hc_bench_torch.analysis.dataflow",
    "tpu_hc_bench_torch.analysis.contracts",
)


def register_pass(name: str, severity: str, scope: str, doc: str,
                  example: str = ""):
    """Class/function decorator: add one pass to the registry.

    ``func`` conventions by scope — ``jit``: ``func(linter, ctx)``;
    ``file``: ``func(linter)``; ``repo``/``model``: registered for the
    severity/docs table only (their drivers call them directly).
    """
    if severity not in ("error", "warning", "info"):
        raise ValueError(f"bad severity {severity!r} for pass {name!r}")
    if scope not in ("jit", "file", "repo", "model"):
        raise ValueError(f"bad scope {scope!r} for pass {name!r}")

    def deco(fn):
        _ORDER[0] += 1
        _REGISTRY[name] = PassInfo(
            name=name, severity=severity, scope=scope, doc=doc,
            example=example, func=fn, order=_ORDER[0])
        return fn

    return deco


def discover() -> dict[str, PassInfo]:
    """Import every pass module so the registry is complete; returns it."""
    for mod in _PASS_MODULES:
        importlib.import_module(mod)
    return dict(_REGISTRY)


def all_passes() -> list[PassInfo]:
    discover()
    return sorted(_REGISTRY.values(), key=lambda p: p.order)


def get_pass(name: str) -> PassInfo | None:
    return _REGISTRY.get(name)


def default_severity(name: str, fallback: str = "warning") -> str:
    info = _REGISTRY.get(name)
    return info.severity if info is not None else fallback


def file_passes() -> list[PassInfo]:
    return [p for p in all_passes() if p.scope == "file"]


def jit_passes() -> list[PassInfo]:
    return [p for p in all_passes() if p.scope == "jit"]


def pass_index() -> list[tuple[str, str, str, str, str]]:
    """Docs rows: (name, severity, scope, what-it-catches, example) —
    the README/ARCHITECTURE lint table renders from this, so the table
    cannot drift from the registrations."""
    return [(p.name, p.severity, p.scope, p.doc, p.example)
            for p in all_passes()]


# ---------------------------------------------------------------------
# --changed-only support


def changed_python_files(root: str | Path,
                         base: str = "HEAD") -> list[Path] | None:
    """Python sources changed vs ``base`` (tracked diff + untracked),
    relative paths under ``root``.  Returns ``None`` when git is
    unavailable/not a repo — the caller falls back to the full tree
    (fail open: a broken git must widen the gate, never narrow it).
    """
    root = Path(root)
    try:
        diff = subprocess.run(
            ["git", "-C", str(root), "diff", "--name-only", base, "--"],
            capture_output=True, text=True, timeout=15)
        untracked = subprocess.run(
            ["git", "-C", str(root), "ls-files", "--others",
             "--exclude-standard"],
            capture_output=True, text=True, timeout=15)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if diff.returncode != 0:
        return None
    names = set(diff.stdout.splitlines())
    if untracked.returncode == 0:
        names |= set(untracked.stdout.splitlines())
    out = []
    for name in sorted(names):
        if not name.endswith(".py"):
            continue
        p = root / name
        if p.is_file():
            out.append(Path(name))
    return out
