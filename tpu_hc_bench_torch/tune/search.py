"""Budgeted successive halving with a resumable journal (the port's copy
of the JAX package's ``tune/search.py``).

The search protocol::

    enumerate (space) -> static prune -> rung 0: measure every survivor
    for a few steps -> keep the top half by goodput-adjusted throughput
    -> rung 1: re-measure 2x longer -> ... until one survivor, the rung
    cap, or the wall-clock budget.

All measurements share one kernel build directory (the port's
``--compile_cache``): the default one, ``build/torch_kernels``, which
the first run builds (or finds built) and every later candidate loads
by its stamp, so the marginal candidate costs its steps, not an
``nvcc`` build of every kernel — the thing that makes a budgeted search
affordable at all.

State lives in ``<out_dir>/tune_state.json`` and is committed after
*every* measurement with the tmp→``os.replace`` idiom of
``utils/checkpoint.py`` — a preempted search relaunched with the same
``out_dir`` resumes exactly where it died: pruner skips are replayed
from the journal (free), completed (candidate, rung) measurements are
never re-run, and the budget accounts the spent seconds across
sessions.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable

from tpu_hc_bench_torch.tune import prune as prune_mod
from tpu_hc_bench_torch.tune import runner as runner_mod
from tpu_hc_bench_torch.tune.space import Candidate, member_space

__all__ = ["SearchSettings", "run_search", "load_journal",
           "JOURNAL_NAME", "commit_json"]

JOURNAL_NAME = "tune_state.json"
JOURNAL_VERSION = 1


def commit_json(path: str, payload: dict) -> None:
    """tmp → fsync → rename: a crash mid-write leaves the previous
    committed journal, never a truncated one (the checkpoint-layer
    commit idiom)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_journal(out_dir: str) -> dict | None:
    path = os.path.join(out_dir, JOURNAL_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class SearchSettings:
    budget_s: float = 3600.0      # wall-clock budget (spent seconds are
                                  # journaled, so it spans resumes)
    rung0_batches: int = 8        # timed steps at rung 0
    warmup: int = 4               # warmup steps per measurement
    growth: int = 2               # rung r measures rung0 * growth**r
    keep_frac: float = 0.5        # survivors kept per rung
    max_rungs: int = 3
    timeout_s: float = 900.0      # per-measurement subprocess timeout
    mode: str = "axes"            # space enumeration (axes | grid)
    max_candidates: int | None = None   # cap AFTER pruning (journaled)
    use_fp16: bool = True


def _default_runner(model: str, out_dir: str,
                    settings: SearchSettings) -> Callable:
    """The real subprocess runner: one shared kernel build directory
    (no ``--compile_cache`` flag: every candidate loads the default
    one, built once), one metrics dir per (candidate, rung) so goodput
    feeds the score."""

    def run(c: Candidate, rung: int, batches: int) -> dict:
        flags = c.to_flags()
        mdir = os.path.join(out_dir, "runs",
                            f"{c.key.replace('/', '_')}-r{rung}")
        return runner_mod.run_one(
            model, c.batch_size, flags,
            warmup=settings.warmup, batches=batches,
            timeout_s=settings.timeout_s, metrics_dir=mdir,
            use_fp16=settings.use_fp16)

    return run


def run_search(
    model: str,
    out_dir: str,
    hardware: str,
    settings: SearchSettings | None = None,
    runner: Callable[[Candidate, int, int], dict] | None = None,
    space: list[Candidate] | None = None,
    lint_fn: Callable[[str], tuple[str, ...]] | None = None,
    print_fn: Callable[[str], None] = print,
) -> dict:
    """Run (or resume) one member's budgeted search; return the final
    journal dict.

    ``runner(candidate, rung, batches) -> record`` defaults to the real
    subprocess runner; tests inject a stub with a synthetic throughput
    surface.  ``space`` defaults to ``member_space(model,
    settings.mode)``.
    """
    settings = settings or SearchSettings()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, JOURNAL_NAME)

    candidates = space if space is not None else member_space(
        model, mode=settings.mode)
    by_key = {c.key: c for c in candidates}

    journal = load_journal(out_dir)
    if journal is not None:
        if journal.get("model") != model:
            raise ValueError(
                f"journal at {path} is for model "
                f"{journal.get('model')!r}, not {model!r} — pick a "
                f"fresh --out dir")
        if journal.get("hardware") != hardware:
            raise ValueError(
                f"journal at {path} was searched on "
                f"{journal.get('hardware')!r}, not {hardware!r} — a "
                f"tuned config is per-hardware; pick a fresh --out dir")
        if journal.get("status") in ("complete", "all-failed"):
            # a FINISHED search is immutable: re-entering the rung loop
            # would burn budget on a fresh measurement past the
            # halving's stopping point (and relabel all-failed)
            print_fn(f"search at {path} already "
                     f"{journal['status']} (best: "
                     f"{(journal.get('best') or {}).get('key')}) — "
                     f"pick a fresh --out to search again")
            return journal
        print_fn(f"resuming search from {path}: "
                 f"{sum(len(v) for v in journal['measurements'].values())}"
                 f" measurement(s) already journaled, "
                 f"{journal.get('spent_s', 0.0):.0f}s spent")
        # the relaunch's budget is authoritative (a budget-exhausted
        # search resumed with a bigger budget keeps going)
        journal["budget_s"] = settings.budget_s
        journal["status"] = "running"
    else:
        result = prune_mod.static_prune(candidates, lint_fn=lint_fn)
        survivors = [c.key for c in result.survivors]
        truncated = 0
        if (settings.max_candidates is not None
                and len(survivors) > settings.max_candidates):
            # seed-first enumeration order: truncation keeps the seed
            # neighborhood; the journal says what was dropped — a
            # silent cap would read as "searched everything"
            truncated = len(survivors) - settings.max_candidates
            survivors = survivors[:settings.max_candidates]
        journal = {
            "version": JOURNAL_VERSION,
            "model": model,
            # the lane travels with the journal: promote() keys a serve
            # search's registry row `<model>@serve`, the key the
            # serving lane's --config=auto lookup reads — a bare-keyed
            # row would de-tune serving silently AND clobber the
            # member's training row
            "workload": (candidates[0].workload if candidates
                         else "train"),
            "hardware": hardware,
            "mode": settings.mode,
            "space_size": len(candidates),
            "skipped": [s.journal_record() for s in result.skipped],
            # the lint prune class this search ran: "baseline" (the
            # CLI's prune.baseline_lint_classes), "lint_fn" (a caller's
            # own), "off" (--no-lints); its skips are in "skipped"
            "lints": ("off" if lint_fn is None else "baseline"
                      if lint_fn is prune_mod.baseline_lint_classes
                      else "lint_fn"),
            "truncated": truncated,
            "candidates": {c.key: {"overrides": dict(c.overrides),
                                   "base": dict(c.base)}
                           for c in candidates},
            "rungs": [],
            "measurements": {},
            "budget_s": settings.budget_s,
            "spent_s": 0.0,
            "survivors": survivors,
            "status": "running",
            "best": None,
        }
        commit_json(path, journal)
        by_class: dict[str, int] = {}
        for s in result.skipped:
            by_class[s.cls] = by_class.get(s.cls, 0) + 1
        pruned = ", ".join(f"{k} x{v}" for k, v in sorted(by_class.items()))
        print_fn(f"{model}: {len(candidates)} candidate(s), "
                 f"{len(result.skipped)} pruned without a run"
                 + (f" ({pruned})" if pruned else "")
                 + (f", {truncated} truncated by --max_candidates"
                    if truncated else "")
                 + f"; measuring {len(survivors)}")

    if runner is None:
        runner = _default_runner(model, out_dir, settings)

    def out_of_budget() -> bool:
        return journal["spent_s"] >= settings.budget_s

    survivors = list(journal["survivors"])
    rung = len(journal["rungs"])
    # a resumed search re-enters mid-rung: the rung loop below naturally
    # skips measurements already journaled
    while survivors and rung < settings.max_rungs:
        batches = settings.rung0_batches * settings.growth ** rung
        measured: list[tuple[str, dict]] = []
        exhausted = False
        for key in survivors:
            meas = journal["measurements"].setdefault(key, {})
            rec = meas.get(str(rung))
            if rec is None:
                if out_of_budget():
                    exhausted = True
                    break
                c = by_key.get(key) or _candidate_from_journal(
                    model, journal, key)
                # measured memory re-check (obs.memory): every
                # landed measurement journals its peak bytes / OOM
                # verdict, so the known-OOM model re-anchors on
                # MEASUREMENT mid-search — a candidate the seeded guess
                # admitted is skipped for free once a measured row says
                # it cannot fit.  Candidates with their own successful
                # prior measurement are exempt: their row IS evidence
                # they fit, and a contradictory anchor (mixed dtypes,
                # a noisy limit estimate) must not retro-evict them.
                if not any(isinstance(r, dict) and not r.get("error")
                           for r in meas.values()):
                    mm = prune_mod.HbmModel.from_measurements(
                        prune_mod.measured_rows_from_journal(journal))
                    reason = mm.check(c) if mm is not None else None
                    if reason is not None:
                        # journal once: a resumed session re-enters the
                        # rung and re-derives the same verdict — the
                        # ledger must not grow a duplicate row per resume
                        if not any(s.get("key") == key
                                   and s.get("class") == prune_mod.HBM_OOM
                                   for s in journal["skipped"]):
                            skip = prune_mod.Skip(
                                c, prune_mod.HBM_OOM, reason,
                                hbm_source="measured")
                            journal["skipped"].append(skip.journal_record())
                            commit_json(path, journal)
                        print_fn(f"rung {rung}: {key} skipped without a "
                                 f"run (hbm-oom, measured): {reason}")
                        continue
                print_fn(f"rung {rung} ({batches} steps): {key}")
                rec = runner(c, rung, batches)
                # provenance: how long was THIS record measured (the
                # registry row must not claim the final rung's length
                # for a candidate cut earlier)
                rec.setdefault("measured_batches", batches)
                meas[str(rung)] = rec
                journal["spent_s"] = round(
                    journal["spent_s"] + float(rec.get("wall_s", 0.0)), 1)
                commit_json(path, journal)
                s = runner_mod.score(rec)
                print_fn(f"  -> score {s:.2f}"
                         + (f" ({rec['error']})" if rec.get("error")
                            else f" ({rec.get('per_chip', 0.0):.1f}/chip"
                                 + (f", goodput {rec['goodput']:.0%}"
                                    if rec.get("goodput") is not None
                                    else "") + ")"))
            measured.append((key, rec))
        if exhausted:
            journal["status"] = "budget-exhausted"
            break
        ranked = sorted(measured,
                        key=lambda kr: runner_mod.score(kr[1]),
                        reverse=True)
        ranked = [kr for kr in ranked if runner_mod.score(kr[1]) > 0]
        if not ranked:
            journal["status"] = "all-failed"
            journal["survivors"] = []
            break
        keep = max(1, int(len(ranked) * settings.keep_frac))
        survivors = [k for k, _ in ranked[:keep]]
        journal["rungs"].append({"rung": rung, "batches": batches,
                                 "measured": [k for k, _ in measured],
                                 "kept": survivors})
        journal["survivors"] = survivors
        commit_json(path, journal)
        rung += 1
        if len(survivors) == 1:
            break

    # best = top scorer at the DEEPEST rung anyone reached — the
    # halving's actual winner.  Comparing scores across rung depths
    # would let a noisy short-rung measurement of an eliminated
    # candidate beat the steady-state winner.  Only if every
    # deepest-rung measurement failed does the next-shallower rung
    # compete (mid-rung budget exhaustion).
    deepest_rung = -1
    for meas in journal["measurements"].values():
        if meas:
            deepest_rung = max(deepest_rung,
                               max(int(r) for r in meas))
    best_key, best_rec, best_score = None, None, 0.0
    for r in range(deepest_rung, -1, -1):
        for key, meas in journal["measurements"].items():
            rec = meas.get(str(r))
            if rec is None:
                continue
            s = runner_mod.score(rec)
            if s > best_score:
                best_key, best_rec, best_score = key, rec, s
        if best_key is not None:
            break
    if best_key is not None:
        journal["best"] = {
            "key": best_key,
            "overrides": journal["candidates"][best_key]["overrides"],
            "base": journal["candidates"][best_key]["base"],
            "score": round(best_score, 3),
            "record": best_rec,
        }
    if journal["status"] == "running":
        journal["status"] = "complete"
    commit_json(path, journal)
    if journal["best"] is not None:
        print_fn(f"best: {journal['best']['key']} "
                 f"(score {journal['best']['score']:.2f}, "
                 f"status {journal['status']}, "
                 f"{journal['spent_s']:.0f}s/"
                 f"{journal['budget_s']:.0f}s budget)")
    else:
        print_fn(f"no successful measurement (status {journal['status']})")
    return journal


def _candidate_from_journal(model: str, journal: dict,
                            key: str) -> Candidate:
    """Rebuild a Candidate from its journaled overrides (a resumed
    search whose space enumeration changed still honors the journal)."""
    rec = journal["candidates"][key]
    return Candidate.make(model, dict(rec["overrides"]),
                          dict(rec["base"]),
                          workload=journal.get("workload", "train"))
