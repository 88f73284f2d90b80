"""Findings, JSON reports, and the checked-in baseline gate.

A *finding* is one lint hit: ``(lint, severity, location, message)``
plus the model it was found against (or ``"repo"`` for source-level
lints that are not per-model).  Findings serialize to stable JSON so CI
can diff runs, and the repo checks in a baseline
(``tpu_hc_bench_torch/analysis/baseline_findings.json``) of the findings
the current tree is *known and accepted* to produce.  The gate
(``tests/test_torch_analysis.py``, ``python -m
tpu_hc_bench_torch.analysis``) fails
only on findings NOT in the baseline — so adding a new host sync inside
a jitted region breaks CI, while a deliberate, reviewed exception is one
baseline entry away.

Suppression: either add the finding's ``key`` to the baseline (the
CLI's ``baseline --update`` subcommand rewrites it atomically with a
loud diff), or annotate the offending source line with
``# tpu-hc: disable=<lint-name>`` (or the legacy
``# thb:lint-ok[<lint-name>]``), which the AST lints honor in place —
suppression hits are counted into the report JSON so they stay
auditable.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import asdict, dataclass, field
from pathlib import Path

__all__ = [
    "Finding", "findings_to_json", "load_baseline", "load_reasons",
    "save_baseline",
    "compare_to_baseline", "BASELINE_PATH",
]

BASELINE_PATH = Path(__file__).parent / "baseline_findings.json"

_SEVERITIES = ("error", "warning", "info")


@dataclass(frozen=True)
class Finding:
    lint: str          # pass name, e.g. "host-sync-in-jit"
    severity: str      # "error" | "warning" | "info"
    model: str         # zoo member, or "repo" for source-level passes
    location: str      # "path/to/file.py:123" or "param:layer_0/qkv"
    message: str

    @property
    def key(self) -> str:
        """Stable identity used for baseline matching.

        Deliberately excludes the message tail and the line number (code
        motion above a finding must not churn the baseline): identity is
        the lint, the model, and the location's file/object part.  Only
        a NUMERIC suffix is stripped — ``param:layer_0/qkv`` and
        ``jaxpr:pure_callback`` locations keep their full object path,
        so accepting one sharding finding never masks another.
        """
        head, _, tail = self.location.rpartition(":")
        loc = head if head and tail.isdigit() else self.location
        return f"{self.lint}::{self.model}::{loc}"

    def render(self) -> str:
        return (f"[{self.severity}] {self.lint} ({self.model}) "
                f"{self.location} — {self.message}")


@dataclass
class Report:
    """Per-run result: findings, per-model collective counts, per-lint
    suppression-hit counts, the analysis wall time, and (the port's
    addition) each member's op census: kernel launches and host syncs a
    step."""

    findings: list[Finding] = field(default_factory=list)
    collectives: dict[str, dict[str, int]] = field(default_factory=dict)
    suppressed: dict[str, int] = field(default_factory=dict)
    wall_s: float | None = None
    census: dict[str, dict] = field(default_factory=dict)

    def to_json(self) -> str:
        return findings_to_json(self.findings, self.collectives,
                                suppressed=self.suppressed,
                                wall_s=self.wall_s, census=self.census)


def findings_to_json(findings: list[Finding],
                     collectives: dict[str, dict[str, int]] | None = None,
                     suppressed: dict[str, int] | None = None,
                     wall_s: float | None = None,
                     census: dict[str, dict] | None = None,
                     ) -> str:
    payload = {
        "findings": [asdict(f) for f in sorted(
            findings, key=lambda f: (f.model, f.lint, f.location))],
    }
    if collectives:
        payload["collectives"] = {
            m: dict(sorted(c.items())) for m, c in sorted(collectives.items())
        }
    if suppressed:
        # per-lint inline-suppression hits: a suppressed finding leaves
        # the findings list but must not leave the audit trail
        payload["suppressed"] = {k: int(v) for k, v in
                                 sorted(suppressed.items()) if v}
    if wall_s is not None:
        payload["wall_s"] = round(float(wall_s), 3)
    if census:
        # the port's per-member step census (launches, host syncs, the
        # card's sync warnings); absent, the payload is JAX's byte for
        # byte
        payload["census"] = {m: c for m, c in sorted(census.items())}
    return json.dumps(payload, indent=2, sort_keys=True) + "\n"


def load_baseline(path: Path | str = BASELINE_PATH) -> set[str]:
    """Baseline = the set of accepted finding keys."""
    path = Path(path)
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    return set(data.get("accepted", []))


def load_reasons(path: Path | str = BASELINE_PATH) -> dict[str, str]:
    """The port's ``{key: why it is accepted}`` beside the keys."""
    path = Path(path)
    if not path.exists():
        return {}
    return dict(json.loads(path.read_text()).get("reasons", {}))


def save_baseline(findings: list[Finding],
                  path: Path | str = BASELINE_PATH,
                  merge: set[str] = frozenset()
                  ) -> tuple[list[str], list[str]]:
    """Write the baseline from ``findings`` (plus ``merge``, for partial
    runs that must not erase other models' accepted keys).

    Atomic: tmp → fsync → rename in the destination directory (the
    ``tune_state.json`` idiom), so a crash mid-write can never leave a
    truncated gate file that silently accepts everything.  Returns the
    ``(added, removed)`` key diff against the previous baseline so
    callers can print WHAT changed, not just that something did.
    """
    path = Path(path)
    before = load_baseline(path) if path.exists() else set()
    accepted = {f.key for f in findings} | set(merge)
    reasons = load_reasons(path)
    payload = {
        "comment": "Accepted analysis findings; regenerate with "
                   "`python -m tpu_hc_bench_torch.analysis baseline "
                   "--update --all`.  The CI gate fails only on findings whose "
                   "key is NOT listed here.",
        "accepted": sorted(accepted),
    }
    kept = {k: reasons[k] for k in sorted(accepted) if k in reasons}
    if kept:
        # the port's baseline says why each key is accepted; a rewrite
        # keeps the reasons of the keys it keeps
        payload["reasons"] = kept
    fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                               prefix=path.name + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(json.dumps(payload, indent=2) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return sorted(accepted - before), sorted(before - accepted)


def compare_to_baseline(findings: list[Finding],
                        baseline: set[str] | None = None,
                        ) -> list[Finding]:
    """The regressions: findings whose key the baseline does not accept.

    Severity "info" findings never gate (they are attribution output,
    not defects).
    """
    if baseline is None:
        baseline = load_baseline()
    return [f for f in findings
            if f.severity in ("error", "warning") and f.key not in baseline]
