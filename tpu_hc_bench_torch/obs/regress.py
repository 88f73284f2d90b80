"""Noise-aware regression gate over the BENCH-json history (the port's
copy of the JAX package's ``obs/regress.py``).

``obs diff`` answers "what changed between these two runs"; this module
answers the CI question "is this fresh number a *real* regression
against everything we have measured before" — without a human picking
the comparison run, and without a fixed percentage threshold that
either cries wolf on a noisy metric or sleeps through a drift on a
quiet one.

Mechanism: prior BENCH records (one-line JSON ``{"metric", "value",
"unit", "extra", "manifest"}``, or the ``{"parsed": ...}`` wrapper a
harness saves as ``BENCH_*.json``) are grouped by **config
fingerprint** — metric name plus the identity fields that make numbers
comparable (global batch, chips, dtype, gradient arm, device kind: an
H100's records never gate against a TPU's history).  For each checked metric the
history's **median** is the center and its **MAD** (median absolute
deviation, scaled by 1.4826 to a sigma equivalent) is the noise scale;
a fresh value regresses when it is worse than the median by more than
``max(mad_k * sigma, rel_floor * |median|)`` — the MAD term adapts to
each metric's own run-to-run noise, the relative floor keeps a
perfectly-quiet history (MAD 0) from flagging measurement jitter.
Direction is per metric: throughput/goodput regress DOWN, latency
p99s and HBM peaks regress UP.  An unchanged rerun always passes
(delta 0 < any threshold); improvements never flag.

Wire-in: ``python -m tpu_hc_bench_torch.obs regress fresh.json
--history 'BENCH_*.json'`` (exit 0 pass / 1 regression / 2 unusable
input).
"""

from __future__ import annotations

import glob
import json
import os
import statistics

#: metric spec: (record path, direction, label).  "higher" = regression
#: is a DROP below the history median; "lower" = a RISE above it.
CHECKS = (
    (("value",), "higher", "headline"),
    (("extra", "goodput"), "higher", "goodput"),
    (("extra", "tokens_per_s"), "higher", "tokens/s"),
    (("extra", "p99_ms"), "lower", "p99 e2e ms"),
    (("extra", "p99_ttft_ms"), "lower", "p99 ttft ms"),
    (("extra", "peak_hbm_bytes"), "lower", "peak HBM bytes"),
    # round 18: the decode-kernel win — a rise in the worst decode
    # bucket's AOT temp bytes means the paged arm regressed toward the
    # dense-gather temporaries it exists to eliminate
    (("extra", "aot_decode_temp_bytes"), "lower", "aot decode temp B"),
    # round 19: the fleet soak — goodput-weighted chip-seconds over
    # pool chip-seconds under churn; a drop means the scheduler started
    # wasting the pool (thrash, slow readmission, orphaned capacity)
    (("extra", "fleet_goodput"), "higher", "fleet goodput"),
    # round 20: attribution shift — the slowest decile's e2e share
    # spent waiting (admission queue / resident-but-starved).  A rise
    # means the tail moved from compute to waiting even if p99 itself
    # sits inside the noise band; pre-r20 serve history simply lacks
    # the fields and the checks skip (never KeyError)
    (("extra", "tail_queue_wait_frac"), "lower", "tail queue_wait frac"),
    (("extra", "tail_decode_stall_frac"), "lower",
     "tail decode_stall frac"),
    # round 22 (obs.kv): allocation honesty — written-page-seconds over
    # reserved-page-seconds.  A DROP means admission got more
    # pessimistic (or outputs shortened against a fixed reservation)
    # and the pool wastes more of its bytes; pre-r22 serve history
    # lacks the field and the check skips (never KeyError)
    (("extra", "kv_pool_util"), "higher", "kv pool util"),
    # round 23: overload degradation — the fraction of the trace shed
    # by deadline policy.  A RISE means the engine keeps capacity by
    # refusing more work (capacity regression or an over-eager shed
    # heuristic); pre-r23 history lacks the field and the check skips
    (("extra", "shed_frac"), "lower", "shed frac"),
    # round 24: the fleet-wide merged-sketch tail (the per-window
    # sketches merged bucket-wise — exact across ranks, not an average
    # of per-host p99s) and the health-signal count.  Pre-r24 history
    # lacks both fields and the checks skip structurally (never
    # KeyError), the kv_pool_util precedent.
    (("extra", "p99_merged_ms"), "lower", "p99 merged ms"),
    (("extra", "signals_fired_total"), "lower", "signals fired"),
    # round 25 (obs.kv): the shared-prefix hit rate.  A DROP means the
    # cache stopped matching traffic it used to match (an eviction
    # policy regression, a trie keying bug, or admission bypassing the
    # cache) and the pool re-pays prefill writes it had been sharing;
    # pre-r25 history (and cache-off runs) lack the field and the
    # check skips structurally (never KeyError)
    (("extra", "prefix_hit_frac"), "higher", "prefix hit frac"),
)

#: identity fields folded into the fingerprint (record path order)
FINGERPRINT_KEYS = (
    ("metric",), ("unit",),
    ("extra", "global_batch"), ("extra", "chips"), ("extra", "dtype"),
    ("extra", "variable_update"), ("extra", "batching"),
    ("extra", "arrival_rate"),
    # round 18: the kernel/quant arms are config identity, not noise —
    # a gather-vs-paged pair must never share a history fingerprint
    ("extra", "decode_attention"), ("extra", "quant"),
    # round 25: the reservation/sharing arms likewise — a lazy+prefix
    # run must never gate against worst-case-reservation history
    ("extra", "kv_reserve"), ("extra", "prefix_cache"),
    ("manifest", "device_kind"), ("manifest", "process_count"),
)

# absent fingerprint keys normalize to the value older records
# effectively ran with, so pre-round-18 serve history keeps comparing
# against fresh default-arm runs instead of being silently orphaned
_FINGERPRINT_DEFAULTS = {
    ("extra", "decode_attention"): "gather",
    ("extra", "quant"): "off",
    # pre-round-25 serve history effectively ran worst-case
    # reservation with no prefix cache
    ("extra", "kv_reserve"): "worst",
    ("extra", "prefix_cache"): "off",
}

DEFAULT_MAD_K = 4.0
DEFAULT_REL_FLOOR = 0.03

#: absolute noise floors by metric label.  The relative floor protects
#: quiet histories only when the median is nonzero — a FRACTION metric
#: (round 20's attribution shares) legitimately sits at exactly 0.0 in
#: a well-provisioned config's history, where rel_floor*|0| = 0 would
#: flag any positive jitter; 5pp is the smallest shift worth a human.
ABS_FLOORS = {
    "tail queue_wait frac": 0.05,
    "tail decode_stall frac": 0.05,
    # round 22: utilization is a fraction with the same jitter shape
    "kv pool util": 0.05,
    # round 23: shed fraction is 0.0 in any well-provisioned history
    "shed frac": 0.05,
    # round 24: fired-signal counts sit at exactly 0 in a healthy
    # history — ONE fire is the smallest shift worth a human, so the
    # floor sits just under it (worse must EXCEED the threshold)
    "signals fired": 0.5,
    # round 25: the hit rate is a fraction with the same jitter shape
    # as the r20/r22 shares
    "prefix hit frac": 0.05,
}


def _get(rec: dict, path: tuple[str, ...]):
    cur = rec
    for k in path:
        if not isinstance(cur, dict):
            return None
        cur = cur.get(k)
    return cur


def load_bench_record(path: str) -> dict | None:
    """A BENCH record from any of its on-disk shapes: the bare JSON
    line, the harness wrapper (``{"parsed": {...}, "tail": "..."}``), or
    a tail whose last JSON-looking line is the record.  None when
    nothing parses — the caller reports, never raises."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(data, dict):
        return None
    if "metric" in data and "value" in data:
        return data
    parsed = data.get("parsed")
    if isinstance(parsed, dict) and "metric" in parsed:
        return parsed
    tail = data.get("tail")
    if isinstance(tail, str):
        for line in reversed(tail.splitlines()):
            line = line.strip()
            if line.startswith("{"):
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict) and "metric" in rec:
                    return rec
    return None


def fingerprint(rec: dict) -> tuple:
    return tuple(
        _FINGERPRINT_DEFAULTS.get(path) if _get(rec, path) is None
        else _get(rec, path)
        for path in FINGERPRINT_KEYS)


def load_history(specs: list[str],
                 exclude: str | None = None) -> list[tuple[str, dict]]:
    """Expand history specs (files, dirs, globs) into parsed records.
    A dir means every ``*.json`` directly under it; ``exclude`` drops
    the fresh record's own path so a gate never compares a file against
    itself."""
    paths: list[str] = []
    for spec in specs:
        if os.path.isdir(spec):
            paths.extend(sorted(glob.glob(os.path.join(spec, "*.json"))))
        elif any(c in spec for c in "*?["):
            paths.extend(sorted(glob.glob(spec)))
        elif os.path.isfile(spec):
            paths.append(spec)
    out = []
    seen = set()
    excl = os.path.abspath(exclude) if exclude else None
    for p in paths:
        ap = os.path.abspath(p)
        if ap in seen or ap == excl:
            continue
        seen.add(ap)
        rec = load_bench_record(p)
        if rec is not None:
            out.append((p, rec))
    return out


def regress_check(fresh: dict, history: list[dict],
                  mad_k: float = DEFAULT_MAD_K,
                  rel_floor: float = DEFAULT_REL_FLOOR) -> dict:
    """The verdict: compare ``fresh`` against same-fingerprint history.

    Returns ``{"checked": [...], "regressions": [...], "history_n": N,
    "lines": [...]}`` — ``regressions`` non-empty means the gate fails.
    """
    fp = fingerprint(fresh)
    matched = [h for h in history if fingerprint(h) == fp]
    lines: list[str] = []
    checked: list[dict] = []
    regressions: list[dict] = []
    if not matched:
        lines.append(
            f"regress: no history for fingerprint {fresh.get('metric')} "
            f"(of {len(history)} record(s)) — nothing to gate against")
        return {"checked": checked, "regressions": regressions,
                "history_n": 0, "lines": lines}
    for path, direction, label in CHECKS:
        v = _get(fresh, path)
        if not isinstance(v, (int, float)):
            continue
        hist = [_get(h, path) for h in matched]
        hist = [float(x) for x in hist if isinstance(x, (int, float))]
        if not hist:
            continue
        med = statistics.median(hist)
        sigma = 1.4826 * statistics.median(abs(x - med) for x in hist)
        threshold = max(mad_k * sigma, rel_floor * abs(med),
                        ABS_FLOORS.get(label, 0.0))
        worse = (med - float(v)) if direction == "higher" \
            else (float(v) - med)
        entry = {"metric": label, "value": float(v), "median": med,
                 "sigma": round(sigma, 6), "threshold": round(threshold, 6),
                 "delta_worse": round(worse, 6), "n": len(hist),
                 "direction": direction}
        checked.append(entry)
        verdict = "REGRESSION" if worse > threshold else "ok"
        rel = (worse / abs(med)) if med else 0.0
        lines.append(
            f"regress: {label}: {v:.6g} vs median {med:.6g} "
            f"(n={len(hist)}, sigma {sigma:.3g}, threshold "
            f"{threshold:.3g}) -> {verdict}"
            + (f" ({rel:+.1%} worse)" if verdict == "REGRESSION" else ""))
        if verdict == "REGRESSION":
            regressions.append(entry)
    if not checked:
        lines.append("regress: matched history carries none of the "
                     "checked metrics — nothing to gate against")
    return {"checked": checked, "regressions": regressions,
            "history_n": len(matched), "lines": lines}


def run_regress(fresh_path_or_rec, history_specs: list[str] | None,
                out=None, mad_k: float = DEFAULT_MAD_K,
                rel_floor: float = DEFAULT_REL_FLOOR) -> int:
    """CLI/bench entry.  Exit codes: 0 pass (including no-history),
    1 significant regression, 2 unusable fresh record."""
    import sys

    out = out or sys.stdout
    if isinstance(fresh_path_or_rec, dict):
        fresh, fresh_path = fresh_path_or_rec, None
    else:
        fresh_path = fresh_path_or_rec
        fresh = load_bench_record(fresh_path)
    if fresh is None:
        print(f"error: no BENCH record parseable at {fresh_path}",
              file=out)
        return 2
    specs = history_specs or ["BENCH_*.json", "artifacts"]
    history = [rec for _, rec in load_history(specs, exclude=fresh_path)]
    verdict = regress_check(fresh, history, mad_k=mad_k,
                            rel_floor=rel_floor)
    for ln in verdict["lines"]:
        print(ln, file=out)
    if verdict["regressions"]:
        names = ", ".join(r["metric"] for r in verdict["regressions"])
        print(f"regress: FAIL — significant regression in: {names}",
              file=out)
        return 1
    print(f"regress: pass ({len(verdict['checked'])} metric(s) against "
          f"{verdict['history_n']} matching record(s))", file=out)
    return 0
