"""Per-request lifecycle ledger: tail-latency attribution for serving
(the port's copy of the JAX package's ``obs/requests.py``).

The serving lane's SLO report (``serve/slo.py``) folds endpoint
percentiles — it can say *that* the p99 is 412ms but not *why*.  The
production answer (Orca/vLLM-class systems treat it as table stakes) is
a per-request decomposition of end-to-end wall into named, **conserved**
components, stamped by the engine from bookkeeping it already tracks:

- ``queue_wait``    — arrival -> admission (backpressure; the cheapest
  leading indicator of overload);
- ``prefill``       — admission -> first token (the request's own
  prompt pass);
- ``decode_active`` — decode-step wall while this request was resident
  AND the step produced it a token (useful work);
- ``decode_stall``  — resident but starved: batch-mate prefills,
  scheduler gaps between steps, bucket bookkeeping (the batching-
  interference component endpoint percentiles cannot see);
- ``retire_overhead`` — last token -> retirement record.

**Conservation invariant**: the five components sum to the measured
e2e wall per request — exactly under ``VirtualClock`` (``decode_stall``
is computed as the measured remainder of measured instants, so the
identity holds by arithmetic, not by hope) and within rounding on a
real clock.  Pinned by test.

Pure record processing, no torch: ``obs summarize``/``timeline``
render run directories on a machine with no GPU.  Records without the
component fields normalize to zero components and render labeled,
never KeyError.
"""

from __future__ import annotations

#: component name -> the flat key on the ``request`` metrics record.
#: ``queue_wait`` reuses the round-16 ``queue_ms`` field (it has been on
#: every record since the lane opened — same instant pair).
COMPONENTS = (
    ("queue_wait", "queue_ms"),
    ("prefill", "prefill_ms"),
    ("decode_active", "decode_active_ms"),
    ("decode_stall", "decode_stall_ms"),
    ("retire_overhead", "retire_ms"),
)

COMPONENT_NAMES = tuple(name for name, _ in COMPONENTS)

#: fields that only round-20+ records carry (``queue_ms`` predates the
#: ledger, so it cannot witness component support)
_R20_KEYS = tuple(key for name, key in COMPONENTS if name != "queue_wait")

#: the tail the attribution fold aggregates: slowest decile by e2e
TAIL_FRAC = 0.10

#: synthetic Chrome-trace pid for the per-request lanes (far above any
#: real process index; one tid per request id)
REQUEST_LANE_PID = 1 << 20


def components_ms(arrival_s: float, t_admit: float, t_first: float,
                  t_last: float, t_done: float,
                  active_s: float) -> dict[str, float]:
    """The engine-side stamp: measured instants -> conserved ms fields.

    All instants share one engine clock (relative seconds).  ``t_first``
    is the end of the request's own prefill (classify members pass
    ``t_admit`` — they have no prompt pass, so the whole resident window
    is the decode lane's); ``t_last`` is the end of its last decode
    step; ``active_s`` is the summed wall of decode steps it was
    resident for.  ``decode_stall`` is the *remainder after rounding*,
    so the rounded components sum to the rounded e2e to float precision
    — the conservation invariant is arithmetic, not measurement.
    """
    out = {
        "queue_ms": round(1e3 * (t_admit - arrival_s), 3),
        "prefill_ms": round(1e3 * (t_first - t_admit), 3),
        "decode_active_ms": round(1e3 * active_s, 3),
        "retire_ms": round(1e3 * (t_done - t_last), 3),
    }
    e2e_ms = round(1e3 * (t_done - arrival_s), 3)
    out["decode_stall_ms"] = round(e2e_ms - sum(out.values()), 3)
    return out


def attribution_of(record: dict) -> dict[str, float]:
    """One record's component ms, absent fields normalized to 0.0 —
    the pre-round-20 back-compat seam every consumer reads through."""
    out = {}
    for name, key in COMPONENTS:
        v = record.get(key)
        out[name] = float(v) if isinstance(v, (int, float)) else 0.0
    return out


def has_components(records: list[dict]) -> bool:
    """Whether any record carries round-20 attribution fields (a
    pre-r20 stream folds to all-zero components and must say so
    instead of rendering a confidently-zero decomposition)."""
    return any(any(k in r for k in _R20_KEYS) for r in records)


def fold_attribution(request_records: list[dict],
                     tail_frac: float = TAIL_FRAC) -> dict | None:
    """Aggregate the decomposition over the slowest ``tail_frac`` of
    requests by e2e — "where does the p99 live".

    Returns ``None`` when no request carries an e2e (nothing to fold).
    ``tail_frac`` fractions are of the tail's mean e2e, so they are the
    conserved components' shares (pre-r20 records: all zeros,
    ``has_components`` False).
    """
    rows = [(float(r["e2e_ms"]), attribution_of(r))
            for r in request_records
            if isinstance(r.get("e2e_ms"), (int, float))]
    if not rows:
        return None
    k = max(1, int(round(len(rows) * tail_frac)))
    # round 24: sketch-guided tail selection — a quantile sketch names
    # a guaranteed under-estimate of the true cut (quantile is within
    # alpha relative error, deflated by 2*alpha), so only the
    # candidate superset gets sorted: O(n + tail log tail) instead of
    # O(n log n), and the selected tail is IDENTICAL (Python's stable
    # sort keeps equal-e2e rows in input order either way; the exact
    # full sort remains the fallback when the guard over-prunes)
    from tpu_hc_bench_torch.obs import sketch as sketch_mod

    sk = sketch_mod.QuantileSketch()
    for e, _ in rows:
        sk.add(e)
    guard = sk.quantile(100.0 * (1.0 - k / len(rows))) \
        * (1.0 - 2.0 * sk.alpha)
    cand = [row for row in rows if row[0] >= guard]
    if len(cand) < k:
        cand = list(rows)
    cand.sort(key=lambda x: x[0])
    tail = cand[-k:]
    tail_e2e = sum(e for e, _ in tail) / k
    tail_ms = {name: sum(a[name] for _, a in tail) / k
               for name in COMPONENT_NAMES}
    denom = tail_e2e if tail_e2e > 0 else 1.0
    total_ms = {name: round(sum(a[name] for _, a in rows), 3)
                for name in COMPONENT_NAMES}
    return {
        "n": len(rows),
        "tail_n": k,
        "tail_cut_ms": round(tail[0][0], 3),
        "tail_e2e_ms": round(tail_e2e, 3),
        "tail_ms": {n: round(v, 3) for n, v in tail_ms.items()},
        "tail_frac": {n: round(v / denom, 4) for n, v in tail_ms.items()},
        "total_ms": total_ms,
        "has_components": has_components(request_records),
    }


def flatten_attribution(fold: dict | None) -> dict:
    """The regress/BENCH-extra projection: the two tail fractions the
    noise gate tracks (a rise in either means the tail shifted toward
    waiting — the attribution regression signal)."""
    if not fold:
        return {}
    fr = fold.get("tail_frac", {})
    return {
        "tail_queue_wait_frac": fr.get("queue_wait", 0.0),
        "tail_decode_stall_frac": fr.get("decode_stall", 0.0),
    }


def attribution_lines(fold: dict | None,
                      p99_e2e_ms: float | None = None) -> list[str]:
    """The one summarize line naming where the p99 lives."""
    if not fold:
        return []
    if not fold.get("has_components"):
        return ["  attribution: records carry no component fields "
                "(pre-round-20 stream) — components normalized to 0"]
    parts = sorted(fold["tail_frac"].items(), key=lambda kv: -kv[1])
    shown = [f"{v:.0%} {n}" for n, v in parts if v >= 0.005]
    head = (f"p99 e2e {p99_e2e_ms:.0f}ms"
            if isinstance(p99_e2e_ms, (int, float))
            else f"tail e2e {fold['tail_e2e_ms']:.0f}ms")
    return [
        f"  {head}: " + ", ".join(shown or ["(all components < 0.5%)"])
        + f"   [slowest {fold['tail_n']}/{fold['n']} requests, "
          f"e2e >= {fold['tail_cut_ms']:.0f}ms]"
    ]


def attribution_diff_lines(fold_a: dict | None,
                           fold_b: dict | None) -> list[str]:
    """``obs diff`` rows: per-component tail-fraction deltas in
    percentage points.  A side without attribution (an older stream)
    normalizes to zero components and is labeled, never a KeyError."""
    if not fold_a and not fold_b:
        return []
    fa = (fold_a or {}).get("tail_frac", {})
    fb = (fold_b or {}).get("tail_frac", {})
    lines = ["  tail attribution (% of slowest-decile e2e):"]
    for name in COMPONENT_NAMES:
        va = float(fa.get(name, 0.0))
        vb = float(fb.get(name, 0.0))
        if va == 0.0 and vb == 0.0:
            continue
        lines.append(f"  {name:>14s} {va:11.1%} {vb:11.1%} "
                     f"{100.0 * (vb - va):+7.1f}pp")
    for side, fold in (("a", fold_a), ("b", fold_b)):
        if fold is not None and not fold.get("has_components"):
            lines.append(f"  note: run {side} predates request "
                         "attribution (components read as 0)")
    return lines if len(lines) > 1 else []


# ---------------------------------------------------------------------
# per-bucket utilization


def fold_bucket_util(bucket_util: dict | None) -> list[tuple]:
    """Sorted render rows from the engine's ``bucket_util`` summary
    field: (key, steps, occupancy, wall_s), decode buckets numerically
    ordered within each program kind."""
    if not bucket_util:
        return []

    def _order(item):
        key = item[0]
        kind, _, size = key.partition("@")
        try:
            return (kind, int(size))
        except ValueError:
            return (kind, 0)

    rows = []
    for key, u in sorted(bucket_util.items(), key=_order):
        occ = u.get("occupancy")
        if occ is None:
            rows_total = u.get("rows") or 0
            occ = (u.get("active_rows", 0) / rows_total) if rows_total \
                else 0.0
        rows.append((key, u.get("steps", 0), float(occ),
                     float(u.get("wall_s", 0.0))))
    return rows


def bucket_util_lines(bucket_util: dict | None) -> list[str]:
    """The summarize heatmap table: occupancy (active rows / bucket
    rows) per warmed (kind, size) bucket — padding waste and ladder
    sizing read directly off it."""
    rows = fold_bucket_util(bucket_util)
    if not rows:
        return []
    lines = ["  bucket util (active rows / bucket rows per step):"]
    for key, steps, occ, wall in rows:
        bar = "#" * int(round(10 * min(1.0, occ)))
        lines.append(f"    {key:>12s} {bar:<10s} {occ:6.1%}  "
                     f"{steps:5d} step(s)  {wall:7.3f}s wall")
    return lines


# ---------------------------------------------------------------------
# timeline export: one async lane per request


def request_trace_events(records: list[dict]) -> list[dict]:
    """Chrome-trace events rendering every request as its own lane
    (pid ``REQUEST_LANE_PID``, tid = request id): ``queue_wait`` ->
    ``prefill`` -> ``decode`` slices in absolute unix time, merged by
    ``obs.timeline.merge_chrome_trace`` beside the cross-rank span
    view — a single slow request is visually traceable through the
    engine.

    Needs the run's ``serve_clock`` record (round 20) to place the
    engine-relative instants on the wall; without one the lanes are
    skipped (pre-r20 stream), never wrong.
    """
    t0_unix = None
    for r in records:
        if r.get("kind") == "serve_clock" and \
                isinstance(r.get("t_unix"), (int, float)):
            t0_unix = float(r["t_unix"])
            break
    if t0_unix is None:
        return []
    events: list[dict] = []
    seen = False
    for r in records:
        if r.get("kind") != "request" or not \
                isinstance(r.get("e2e_ms"), (int, float)):
            continue
        seen = True
        rid = r.get("id", "?")
        attr = attribution_of(r)
        t_arr = t0_unix + float(r.get("arrival_s", 0.0))
        t_admit = t_arr + attr["queue_wait"] / 1e3
        t_first = t_admit + attr["prefill"] / 1e3
        t_done = t_arr + float(r["e2e_ms"]) / 1e3

        def _slice(name, t0, t1, **args):
            ev = {"name": name, "ph": "X", "ts_unix": t0,
                  "dur": round(max(0.0, t1 - t0) * 1e6, 1),
                  "pid": REQUEST_LANE_PID, "tid": rid}
            if args:
                ev["args"] = args
            events.append(ev)

        _slice("queue_wait", t_arr, t_admit, rid=rid,
               prompt_len=r.get("prompt_len"))
        _slice("prefill", t_admit, t_first, rid=rid)
        if t_done > t_first:
            _slice("decode", t_first, t_done, rid=rid,
                   active_ms=attr["decode_active"],
                   stall_ms=attr["decode_stall"],
                   retire_ms=attr["retire_overhead"],
                   output_len=r.get("output_len"))
    if seen:
        events.append({"name": "process_name", "ph": "M",
                       "pid": REQUEST_LANE_PID,
                       "args": {"name": "requests"}})
    return events
