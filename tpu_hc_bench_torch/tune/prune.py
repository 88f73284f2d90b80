"""Static pruning: reject candidates before paying for a run (the port's
copy of the JAX package's ``tune/prune.py``).

Free (or near-free) rejection classes, each recorded in the search
journal with its class tag so the ledger shows what the pruner bought:

- ``flag-invalid`` — the config's ``resolve()`` raises at flag time
  (the zero1 composition matrix, accum under TP/EP, the dtype lever
  without accumulation...).  The pruner gets the flag surface's rules
  for free.
- ``lint`` — per-member ``analysis`` findings (host syncs in the
  forward's op census, recompile hazards, sharding inconsistencies) not
  accepted by the port's checked-in baseline
  (``baseline_lint_classes``).  Evaluated once per member and cached —
  a member whose step is statically broken skips its whole candidate
  class.
- ``hbm-oom`` — a small device-memory model: a candidate whose
  *microbatch* (batch / accum — the activation-memory unit the card
  actually holds) exceeds the model's anchor is a known-OOM skip.
  The anchor comes from one of two provenances, journaled per skip as
  ``hbm_source``:

  - ``measured`` (preferred): prior measurements — ``tune/runner``
    records every run's memory high water + device limit
    (``obs.memory``) into the journal, and
    ``HbmModel.from_measurements`` extrapolates the largest microbatch
    the measured limit can hold (an OOM'd measurement caps the anchor
    below its own microbatch).
  - ``seeded`` (fallback): the seed configs (``tune.space.SEED_CONFIGS``,
    the JAX package's TPU operating points) — the seeded (batch, accum)
    pairing is assumed to sit near the memory ceiling, with
    ``headroom`` slack, and a member whose seed NEEDED the bf16
    accumulator rejects f32-accumulator candidates at or above the
    seeded batch.  Every memory fact here is a heuristic anchor — which
    is why measured rows win whenever they exist.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

from tpu_hc_bench_torch.tune.space import Candidate, SEED_CONFIGS, seed_candidate

__all__ = ["Skip", "PruneResult", "HbmModel", "static_prune",
           "baseline_lint_classes", "hbm_model_for",
           "measured_rows_from_journal"]

FLAG_INVALID = "flag-invalid"
LINT = "lint"
HBM_OOM = "hbm-oom"


@dataclasses.dataclass(frozen=True)
class Skip:
    candidate: Candidate
    cls: str        # flag-invalid | lint | hbm-oom
    reason: str
    hbm_source: str | None = None   # hbm-oom only: measured | seeded

    def journal_record(self) -> dict:
        rec = {"key": self.candidate.key, "class": self.cls,
               "reason": self.reason}
        if self.hbm_source is not None:
            rec["hbm_source"] = self.hbm_source
        return rec


@dataclasses.dataclass
class PruneResult:
    survivors: list[Candidate]
    skipped: list[Skip]

    @property
    def skipped_classes(self) -> set[str]:
        return {s.cls for s in self.skipped}


@dataclasses.dataclass(frozen=True)
class HbmModel:
    """Known-OOM rejection seeded from a member's best-known config.

    ``max_microbatch`` is the anchor microbatch; ``needs_bf16_accum_at``
    is the seeded batch when the seed carries ``accum_dtype=bf16``
    (meaning the f32 accumulator tree is what ran out of memory there
    on the TPU).  ``source`` is the anchor's provenance — ``seeded`` (a
    best-known-config guess with ``headroom`` slack) or ``measured``
    (extrapolated from journaled HBM measurements, ``obs.memory``) —
    and is journaled with every hbm-oom skip.
    """

    max_microbatch: int
    headroom: float = 2.0
    needs_bf16_accum_at: int | None = None
    source: str = "seeded"

    @staticmethod
    def seeded(model: str, headroom: float = 2.0) -> "HbmModel | None":
        if model not in SEED_CONFIGS:
            return None
        seed = seed_candidate(model)
        d = dict(seed.overrides)
        batch = int(d["batch_size"])
        accum = int(d.get("gradient_accumulation_steps", 1))
        bf16_at = (batch if d.get("accum_dtype") == "bf16" else None)
        return HbmModel(max_microbatch=max(1, batch // accum),
                        headroom=headroom,
                        needs_bf16_accum_at=bf16_at)

    @staticmethod
    def from_measurements(rows: list[dict], headroom: float = 1.15,
                          needs_bf16_accum_at: int | None = None,
                          ) -> "HbmModel | None":
        """A measured anchor from journal measurement rows.

        Each row is a ``tune/runner`` record (``peak_hbm_bytes`` +
        ``hbm_bytes_limit`` from the run's ``obs.memory`` summary)
        joined with its candidate ``overrides``.  Two signals:

        - a SUCCESSFUL row extrapolates linearly: a microbatch of
          ``m`` peaking at ``p`` bytes of an ``L``-byte device fits up
          to ``m * L / (p * headroom)`` — the anchor takes the largest
          such estimate (and never less than the largest microbatch
          actually measured OK);
        - an OOM'd row is ground truth the other way: the anchor is
          capped strictly below that row's microbatch.

        ``needs_bf16_accum_at`` rides along from the seeded model (the
        caller grafts it): the f32-accumulator rejection is a state-
        memory fact independent of the microbatch anchor, and a
        measured anchor must not silently drop that skip class.

        Returns None when no row carries a measurement — the caller
        falls back to the seeded guess.
        """
        best_est = 0
        oom_cap: int | None = None
        for row in rows:
            micro = _row_microbatch(row)
            if micro is None:
                continue
            if _row_oomed(row):
                oom_cap = micro if oom_cap is None else min(oom_cap, micro)
                continue
            peak = row.get("peak_hbm_bytes") or 0
            limit = row.get("hbm_bytes_limit") or 0
            if peak <= 0:
                continue
            est = micro
            if limit > 0:
                est = max(micro, int(micro * limit / (peak * headroom)))
            best_est = max(best_est, est)
        if oom_cap is not None:
            best_est = (min(best_est, oom_cap - 1) if best_est
                        else oom_cap - 1)
        if best_est <= 0:
            return None
        # headroom=1.0: the measured anchor already IS the limit
        # estimate — stacking the seeded model's 2x guess band on top
        # would re-admit the OOM wall the measurement just mapped
        return HbmModel(max_microbatch=best_est, headroom=1.0,
                        needs_bf16_accum_at=needs_bf16_accum_at,
                        source="measured")

    def check(self, c: Candidate) -> str | None:
        """A rejection reason, or None when the candidate plausibly
        fits."""
        d = dict(c.overrides)
        batch = int(d.get("batch_size", 0)) or c.batch_size
        accum = int(d.get("gradient_accumulation_steps", 1))
        micro = max(1, batch // max(1, accum))
        limit = int(self.max_microbatch * self.headroom)
        if micro > limit:
            return (f"microbatch {micro} (batch {batch} / accum {accum}) "
                    f"exceeds the {self.source} HBM anchor "
                    f"{self.max_microbatch} x headroom "
                    f"{self.headroom:g} = {limit}")
        if (self.needs_bf16_accum_at is not None
                and accum > 1
                and d.get("accum_dtype", "f32") == "f32"
                and batch >= self.needs_bf16_accum_at):
            return (f"f32 accumulator tree at batch {batch}: the seeded "
                    f"config needed accum_dtype=bf16 at batch "
                    f"{self.needs_bf16_accum_at} (f32 tree OOMs)")
        return None


# the OOM spellings live in ONE place — obs.memory.is_oom_error (the
# forensics classifier, PyTorch's "CUDA out of memory" among them); the
# pruner adds only its own journal class token.
_PRUNE_OOM_TOKENS = ("hbm-oom",)


def _row_microbatch(row: dict) -> int | None:
    """The activation-memory unit of a measurement row: batch / accum
    from the candidate overrides the row was joined with."""
    d = row.get("overrides") or {}
    batch = int(d.get("batch_size", row.get("batch_size", 0)) or 0)
    if batch <= 0:
        return None
    accum = int(d.get("gradient_accumulation_steps", 1) or 1)
    return max(1, batch // max(1, accum))


def _row_oomed(row: dict) -> bool:
    from tpu_hc_bench_torch.obs.memory import is_oom_error

    err = str(row.get("error") or "")
    return bool(err) and (is_oom_error(err)
                          or any(tok in err for tok in _PRUNE_OOM_TOKENS))


def measured_rows_from_journal(journal: dict,
                               model: str | None = None) -> list[dict]:
    """Join a search journal's measurement records with their candidate
    overrides — the row shape ``HbmModel.from_measurements`` consumes.
    Rows without a memory measurement AND without an OOM verdict carry
    no information and are dropped here."""
    rows: list[dict] = []
    if model is not None and journal.get("model") != model:
        return rows
    cands = journal.get("candidates") or {}
    for key, meas in (journal.get("measurements") or {}).items():
        overrides = (cands.get(key) or {}).get("overrides") or {}
        for rec in (meas or {}).values():
            if not isinstance(rec, dict):
                continue
            if not (rec.get("peak_hbm_bytes") or _row_oomed(rec)):
                continue
            row = dict(rec)
            row["overrides"] = dict(overrides)
            rows.append(row)
    return rows


def hbm_model_for(model: str,
                  measured_rows: list[dict] | None = None,
                  headroom: float = 2.0) -> "HbmModel | None":
    """The ONE place the anchor's provenance is decided: measured rows
    win whenever they yield a model; the seeded best-known-config guess
    is the fallback (None for members outside the seed table).  The
    seed's ``needs_bf16_accum_at`` fact is grafted onto a measured
    anchor — the f32-accumulator rejection is independent of the
    microbatch anchor and must survive the provenance switch."""
    seeded = HbmModel.seeded(model, headroom=headroom)
    if measured_rows:
        m = HbmModel.from_measurements(
            measured_rows,
            needs_bf16_accum_at=(seeded.needs_bf16_accum_at
                                 if seeded is not None else None))
        if m is not None:
            return m
    return seeded


@functools.lru_cache(maxsize=None)
def baseline_lint_classes(model: str) -> tuple[str, ...]:
    """Member-level lint regressions (findings the port's checked-in
    baseline does not accept) — evaluated once per member, cached.  The
    model passes build the member on the meta device, with no card and
    no memory (JAX's traces the jaxpr on the CPU); the stubbed tests
    inject their own ``lint_fn``."""
    from tpu_hc_bench_torch.analysis import compare_to_baseline
    from tpu_hc_bench_torch.analysis.lints import lint_model

    try:
        regressions = compare_to_baseline(lint_model(model))
    except Exception as e:        # a model that fails to trace is a skip
        return (f"lint pass failed to trace {model}: {e}",)
    return tuple(f.render() for f in regressions)


def static_prune(
    candidates: list[Candidate],
    hbm: HbmModel | None = None,
    lint_fn: Callable[[str], tuple[str, ...]] | None = None,
    measured_rows: list[dict] | None = None,
) -> PruneResult:
    """Partition candidates into survivors and classed skips.

    ``hbm=None`` resolves the HBM model through ``hbm_model_for``:
    measured journal rows when the caller has them, else the member's
    best-known-config seed (no-op for members outside the seed table).
    Every hbm-oom skip journals its anchor's provenance
    (``hbm_source=measured|seeded``).  ``lint_fn`` maps a member name
    to lint-regression reasons (default: none — the CLI passes
    ``baseline_lint_classes``; tests inject stubs).
    """
    survivors: list[Candidate] = []
    skipped: list[Skip] = []
    hbm_by_model: dict[str, HbmModel | None] = {}
    lint_by_model: dict[str, tuple[str, ...]] = {}
    for c in candidates:
        if c.model not in lint_by_model:
            lint_by_model[c.model] = lint_fn(c.model) if lint_fn else ()
        reasons = lint_by_model[c.model]
        if reasons:
            skipped.append(Skip(c, LINT, "; ".join(reasons)))
            continue
        try:
            c.to_config().resolve()
        except ValueError as e:
            skipped.append(Skip(c, FLAG_INVALID, str(e)))
            continue
        if c.model not in hbm_by_model:
            hbm_by_model[c.model] = (
                hbm if hbm is not None
                else hbm_model_for(c.model, measured_rows))
        model_hbm = hbm_by_model[c.model]
        reason = model_hbm.check(c) if model_hbm is not None else None
        if reason:
            skipped.append(Skip(c, HBM_OOM, reason,
                                hbm_source=model_hbm.source))
            continue
        survivors.append(c)
    return PruneResult(survivors=survivors, skipped=skipped)
