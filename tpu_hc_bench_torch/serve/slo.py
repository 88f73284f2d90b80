"""Serve-lane latency fold and its short report.

The port keeps the JAX package's summary key names
(``p{50,95,99}_{ttft,e2e,queue}_ms``) but folds them as exact numpy
percentiles (linear interpolation) over every completed request; the
mergeable sketch of the JAX lane comes in a later slice.
``components_ms`` (the conserved e2e split of one request) and
``fold_burn_rate`` (``--slo_e2e_ms``'s windowed violations) are copies
of the JAX package's ``obs/requests.py`` and ``serve/slo.py``.
"""

from __future__ import annotations

import numpy as np

from tpu_hc_bench_torch.serve.kv import SHED_CAUSES

LATENCY_FIELDS = ("ttft_ms", "e2e_ms", "queue_ms")
DEFAULT_BURN_WINDOWS = 8


def components_ms(arrival_s: float, t_admit: float, t_first: float,
                  t_last: float, t_done: float,
                  active_s: float) -> dict[str, float]:
    """Engine instants (one clock, relative seconds) -> the component
    ms fields.  ``t_first`` ends the request's own prefill, ``t_last``
    its last decode step, ``active_s`` sums the decode steps it was
    resident for; ``decode_stall`` is the remainder after rounding, so
    the rounded components sum to the rounded e2e."""
    out = {
        "queue_ms": round(1e3 * (t_admit - arrival_s), 3),
        "prefill_ms": round(1e3 * (t_first - t_admit), 3),
        "decode_active_ms": round(1e3 * active_s, 3),
        "retire_ms": round(1e3 * (t_done - t_last), 3),
    }
    e2e_ms = round(1e3 * (t_done - arrival_s), 3)
    out["decode_stall_ms"] = round(e2e_ms - sum(out.values()), 3)
    return out


def fold_requests(request_records: list[dict]) -> dict:
    """Percentile block from per-request records."""
    out: dict = {}
    for field in LATENCY_FIELDS:
        vals = [float(r[field]) for r in request_records if field in r]
        for q in (50, 95, 99):
            out[f"p{q}_{field}"] = (round(float(np.percentile(vals, q)), 3)
                                    if vals else 0.0)
    return out


def fold_burn_rate(request_records: list[dict], slo_e2e_ms: float,
                   window_s: float | None = None) -> dict | None:
    """Windowed SLO violation tracking (round 20): violations per
    rolling window of completion time against an ``--slo_e2e_ms``
    target — a transient burst lights up one window, sustained
    overload lights up a *streak*, which endpoint-wide violation
    counts cannot distinguish.

    ``window_s`` defaults to the run span / ``DEFAULT_BURN_WINDOWS``.
    Returns None when no target or no completions.
    """
    if not slo_e2e_ms or slo_e2e_ms <= 0:
        return None
    done = []
    for r in request_records:
        e2e, arr = r.get("e2e_ms"), r.get("arrival_s")
        if isinstance(e2e, (int, float)) and isinstance(arr, (int, float)):
            done.append((float(arr) + float(e2e) / 1e3, float(e2e)))
    if not done:
        return None
    done.sort()
    t_lo, t_hi = done[0][0], done[-1][0]
    span = max(t_hi - t_lo, 1e-9)
    if window_s is None or window_s <= 0:
        window_s = span / DEFAULT_BURN_WINDOWS
    # ceil-based bin count with the t_hi completion clamped into the
    # last FULL bin — int(span/w)+1 would put the boundary completion
    # alone in a degenerate trailing window, skewing peak rate and the
    # streak/SUSTAINED denominators
    n_win = max(1, int(-(-span // window_s)))
    wins = [{"t": round(t_lo + i * window_s, 4), "n": 0, "violations": 0}
            for i in range(n_win)]
    violations = 0
    for t, e2e in done:
        i = min(int((t - t_lo) / window_s), n_win - 1)
        wins[i]["n"] += 1
        if e2e > slo_e2e_ms:
            wins[i]["violations"] += 1
            violations += 1
    streak = best_streak = 0
    peak_rate, peak_t = 0.0, wins[0]["t"]
    for w in wins:
        w["rate"] = round(w["violations"] / w["n"], 4) if w["n"] else 0.0
        if w["violations"]:
            streak += 1
            best_streak = max(best_streak, streak)
        else:
            streak = 0
        if w["rate"] > peak_rate:
            peak_rate, peak_t = w["rate"], w["t"]
    return {
        "slo_e2e_ms": slo_e2e_ms,
        "window_s": round(window_s, 4),
        "completed": len(done),
        "violations": violations,
        "violation_rate": round(violations / len(done), 4),
        "peak_window_rate": round(peak_rate, 4),
        "peak_window_t": round(peak_t, 4),
        "max_violation_streak": best_streak,
        "windows": wins,
    }


def slo_lines(fold: dict) -> list[str]:
    """Render the serve summary (the engine's final print)."""
    lines = [
        f"  serve: {fold.get('completed', 0)}/{fold.get('requests', 0)} "
        f"requests  batching={fold.get('batching', '?')}  "
        f"arrival={fold.get('arrival', '?')}@{fold.get('arrival_rate')}/s"
        f"  device={fold.get('device', '?')}",
        f"  ttft ms p50 {fold['p50_ttft_ms']:.1f}  "
        f"p95 {fold['p95_ttft_ms']:.1f}  p99 {fold['p99_ttft_ms']:.1f}   "
        f"e2e ms p50 {fold['p50_e2e_ms']:.1f}  "
        f"p95 {fold['p95_e2e_ms']:.1f}  p99 {fold['p99_e2e_ms']:.1f}",
        f"  queue ms p50 {fold['p50_queue_ms']:.1f}  "
        f"p99 {fold['p99_queue_ms']:.1f}",
        f"  tokens {fold.get('tokens', 0)} in {fold.get('wall_s', 0)}s = "
        f"{fold.get('tokens_per_s', 0)} tokens/s  "
        f"(decode steps {fold.get('decode_steps', 0)}, "
        f"prefills {fold.get('prefill_steps', 0)}, "
        f"classify steps {fold.get('classify_steps', 0)})",
    ]
    if fold.get("decode_attention"):      # None for a classify member
        lines.append(
            f"  decode arm: attention={fold.get('decode_attention')} "
            f"quant={fold.get('quant')}"
            + (f" block_pages={fold['decode_block_pages']}"
               if fold.get("decode_block_pages") else "")
            + f"  kv pages {fold.get('kv_pages')} x "
              f"{fold.get('kv_page_size')} tokens")
    kvf = fold.get("kv_pool")
    if kvf:
        lines.append(
            f"  kv: reserve={fold.get('kv_reserve')} "
            f"prefix_cache={fold.get('prefix_cache')}  util "
            f"{kvf.get('util')}  pages peak {kvf.get('pages_peak')}  "
            f"grown {kvf.get('pages_grown', 0)}  cow "
            f"{kvf.get('cow_copies', 0)}  prefix hits "
            f"{kvf.get('prefix_hits', 0)}/{kvf.get('prefix_lookups', 0)}")
    deg = fold.get("degrade")
    if deg and (deg.get("shed") or deg.get("preempts")
                or deg.get("quarantined")):
        shed = deg.get("shed") or {}
        parts = [f"shed {sum(shed.values())}"
                 + (" (" + ", ".join(
                     f"{c}x{shed[c]}" for c in SHED_CAUSES
                     if c in shed) + ")" if shed else "")]
        if deg.get("preempts"):
            parts.append(f"preempts {deg['preempts']} "
                         f"(requeued {deg.get('requeues', 0)})")
        if deg.get("quarantined"):
            parts.append(f"quarantined {deg['quarantined']}")
        lines.append(
            f"  degrade: {'  '.join(parts)}   "
            f"shed_frac {deg.get('shed_frac', 0.0):.1%}")
    burn = fold.get("slo")
    if burn:
        lines.append(
            f"  slo e2e {burn['slo_e2e_ms']:g} ms: violations "
            f"{burn['violations']}/{burn['completed']} "
            f"({burn['violation_rate']:.1%}), peak window "
            f"{burn['peak_window_rate']:.1%}, longest streak "
            f"{burn['max_violation_streak']} window(s)")
    if fold.get("drained"):
        dr = fold["drained"]
        lines.append(f"  drained: {dr['unfinished']} unfinished "
                     f"request(s) journaled to {dr['journal']}")
    return lines
