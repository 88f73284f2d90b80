"""KV-pool utilization ledger: allocation honesty for the serving lane
(the port's copy of the JAX package's ``obs/kv.py``).

Admission is conservative by design (``serve/engine.py`` reserves every
request's worst-case page count, so mid-generation eviction never
happens) — which means the pool underutilizes whenever outputs run
short, and before this ledger the waste was a guess, not a number.
This module is the seventh obs pillar: it folds the engine's KV-pool
bookkeeping into the one figure the on-demand-paging ROADMAP item must
be judged against,

    ``kv_pool_util`` = written-page-seconds / reserved-page-seconds,

plus the per-request **honesty gap** (``pages_reserved`` vs
``pages_final`` at retirement) and the **admission-cause split**: the
r20 ``queue_wait`` component broken into ``pool_starved`` vs
``batch_full`` time, so the tail-attribution line names WHICH resource
gated the p99 (pool-starved ⇒ grow the pool / evict; batch-full ⇒
scale out — the disaggregated-serving scaling-policy input).

Record shapes (round 22, all host counters the engine already holds —
no device round-trips; see ``serve.engine.KVLedger``):

- ``kv_pool`` records: periodic pool snapshots with cumulative
  ``reserved_page_s``/``written_page_s`` integrals, free-list depth,
  pool high-water and recycled-page count;
- ``request`` records grow ``pages_reserved``/``pages_peak_used``/
  ``pages_final`` footprint fields and the ``queue_pool_starved_ms``/
  ``queue_batch_full_ms`` cause split.

Pure record processing, no torch.  Streams without ``kv_pool`` records
or footprint fields fold to ``None``/absent and render labeled, never
KeyError — the same seam discipline as ``attribution_of``.
"""

from __future__ import annotations

from tpu_hc_bench_torch.obs import requests as requests_mod

KV_POOL_KIND = "kv_pool"

#: the per-request footprint fields stamped at retirement.
#: ``pages_peak_used`` equals ``pages_final`` under worst-case
#: reservation (lengths only grow and pages free only at retirement);
#: they diverge once mid-flight page release / on-demand paging lands.
FOOTPRINT_KEYS = ("pages_reserved", "pages_peak_used", "pages_final")

#: round 25 footprint fields: pages grown on demand after admission
#: and page slots admitted pointing at shared prefix-cache pages.
#: Absent on pre-r25 records — normalized to 0 (the r20/r22 seam), so
#: old streams flow through fold_attribution / obs diff / obs regress
#: without KeyError.
GROWTH_KEYS = ("pages_grown", "prefix_pages_shared")

#: queue-wait causes, in render order (and the engine's charge order)
WAIT_CAUSES = ("pool_starved", "batch_full")

#: cause name -> the flat key on the ``request`` record
CAUSE_KEYS = (
    ("pool_starved", "queue_pool_starved_ms"),
    ("batch_full", "queue_batch_full_ms"),
)

#: shed causes, in render order (round 23): the deadline-aware
#: degradation stamps extending the r22 queue-wait split — every
#: rejected or expired request names the policy decision that shed it
SHED_CAUSES = ("deadline_expired", "deadline_predicted",
               "resident_expired")


def footprint_of(record: dict) -> dict | None:
    """One request record's KV footprint, or ``None`` when the record
    predates round 22 or belongs to a pool-free (classify) member —
    the back-compat seam every consumer reads through."""
    res = record.get("pages_reserved")
    peak = record.get("pages_peak_used")
    final = record.get("pages_final")
    if not all(isinstance(v, (int, float)) for v in (res, peak, final)):
        return None
    out = {"pages_reserved": int(res), "pages_peak_used": int(peak),
           "pages_final": int(final)}
    for key in GROWTH_KEYS:
        # round 25 fields: a pre-r25 record simply never grew or
        # shared a page — 0, labeled by key, never a KeyError
        v = record.get(key)
        out[key] = int(v) if isinstance(v, (int, float)) else 0
    return out


def has_footprints(request_records: list[dict]) -> bool:
    return any(footprint_of(r) is not None for r in request_records)


def wait_cause_of(record: dict) -> dict[str, float]:
    """One record's cause split in ms, absent fields normalized to 0.0
    (pre-r22 records carry only the undivided ``queue_ms``)."""
    out = {}
    for name, key in CAUSE_KEYS:
        v = record.get(key)
        out[name] = float(v) if isinstance(v, (int, float)) else 0.0
    return out


def has_causes(request_records: list[dict]) -> bool:
    keys = tuple(key for _, key in CAUSE_KEYS)
    return any(any(k in r for k in keys) for r in request_records)


def fold_wait_causes(request_records: list[dict],
                     tail_frac: float = requests_mod.TAIL_FRAC
                     ) -> dict | None:
    """The cause split aggregated over the slowest ``tail_frac`` of
    requests by e2e — the refinement of the r20 tail attribution that
    names WHICH resource the tail's queue_wait was spent on.

    ``tail_frac`` shares are of the tail's mean queue_wait (the r20
    ``queue_ms`` component), so "100% pool_starved" reads as "every
    waited millisecond in the tail was a full pool".  Returns ``None``
    when no request carries an e2e.
    """
    rows = [(float(r["e2e_ms"]), r) for r in request_records
            if isinstance(r.get("e2e_ms"), (int, float))]
    if not rows:
        return None
    rows.sort(key=lambda x: x[0])
    k = max(1, int(round(len(rows) * tail_frac)))
    tail = [r for _, r in rows[-k:]]
    tail_queue_ms = sum(
        requests_mod.attribution_of(r)["queue_wait"] for r in tail) / k
    tail_ms = {name: sum(wait_cause_of(r)[name] for r in tail) / k
               for name in WAIT_CAUSES}
    denom = tail_queue_ms if tail_queue_ms > 0 else 1.0
    return {
        "n": len(rows),
        "tail_n": k,
        "tail_queue_ms": round(tail_queue_ms, 3),
        "tail_ms": {n: round(v, 3) for n, v in tail_ms.items()},
        "tail_frac": {n: round(v / denom, 4) for n, v in tail_ms.items()},
        "total_ms": {
            name: round(sum(wait_cause_of(r)[name]
                            for _, r in rows), 3)
            for name in WAIT_CAUSES},
        "has_causes": has_causes(request_records),
    }


def fold_ledger(*, reserved_page_s: float, written_page_s: float,
                pages_peak: int | None = None,
                pages_recycled: int | None = None,
                pages_grown: int | None = None,
                cow_copies: int | None = None,
                prefix_hits: int | None = None,
                prefix_lookups: int | None = None,
                prefix_pages_shared: int | None = None,
                request_records: list[dict] = ()) -> dict:
    """The ONE ledger fold (engine-side and offline callers share it,
    so the engine's final print and ``obs summarize`` agree by
    construction): page-seconds integrals -> utilization, request
    footprints -> the mean honesty gap, cause fields -> the tail
    cause split, and (round 25) the growth/sharing counters ->
    ``prefix_hit_frac``.  The r25 kwargs default to ``None`` so a
    pre-r25 caller folds exactly as before."""
    rs = float(reserved_page_s or 0.0)
    ws = float(written_page_s or 0.0)
    out: dict = {
        "util": round(ws / rs, 4) if rs > 0 else None,
        "reserved_page_s": round(rs, 4),
        "written_page_s": round(ws, 4),
        "pages_peak": int(pages_peak) if pages_peak is not None else None,
        "pages_recycled": (int(pages_recycled)
                           if pages_recycled is not None else None),
    }
    if pages_grown is not None:
        out["pages_grown"] = int(pages_grown)
    if cow_copies is not None:
        out["cow_copies"] = int(cow_copies)
    if prefix_pages_shared is not None:
        out["prefix_pages_shared"] = int(prefix_pages_shared)
    if prefix_lookups is not None:
        out["prefix_lookups"] = int(prefix_lookups)
        out["prefix_hits"] = int(prefix_hits or 0)
        # None (not 0.0) when the cache never looked anything up —
        # regress must skip structurally, not gate on a fake zero
        out["prefix_hit_frac"] = (
            round(int(prefix_hits or 0) / int(prefix_lookups), 4)
            if int(prefix_lookups) > 0 else None)
    fps = [f for f in (footprint_of(r) for r in request_records) if f]
    if fps:
        res = sum(f["pages_reserved"] for f in fps)
        fin = sum(f["pages_final"] for f in fps)
        out.update({
            "req_n": len(fps),
            "req_pages_reserved_mean": round(res / len(fps), 3),
            "req_pages_final_mean": round(fin / len(fps), 3),
            "req_gap_frac": round(1.0 - fin / res, 4) if res else None,
        })
    wc = fold_wait_causes(list(request_records))
    if wc is not None:
        out["wait_causes"] = wc
    return out


def fold_kv(records: list[dict]) -> dict | None:
    """The offline ledger fold over one metrics stream: the LAST
    ``kv_pool`` record's cumulative integrals (a truncated stream
    reports the run so far) + the request footprints.  ``None`` when
    the stream carries neither (pre-round-22 serve stream, classify
    member, or a training run) — absent, never a KeyError."""
    pools = [r for r in records if r.get("kind") == KV_POOL_KIND]
    reqs = [r for r in records if r.get("kind") == "request"]
    if not pools and not has_footprints(reqs):
        return None
    last = pools[-1] if pools else {}

    def _num(v):
        return float(v) if isinstance(v, (int, float)) else 0.0

    def _int(key):
        v = last.get(key)
        return int(v) if isinstance(v, (int, float)) else None

    return fold_ledger(
        reserved_page_s=_num(last.get("reserved_page_s")),
        written_page_s=_num(last.get("written_page_s")),
        pages_peak=_int("pages_peak"),
        pages_recycled=_int("pages_recycled"),
        # round 25 counters: absent on pre-r25 kv_pool records, and
        # fold_ledger omits the fields entirely then (no fake zeros)
        pages_grown=_int("pages_grown"),
        cow_copies=_int("pages_cow"),
        prefix_hits=_int("prefix_hits"),
        prefix_lookups=_int("prefix_lookups"),
        prefix_pages_shared=_int("prefix_pages_shared"),
        request_records=reqs)


def flatten_kv(kv_fold: dict | None) -> dict:
    """The regress/BENCH-extra projection: utilization (gated
    direction-aware, down = regression) and the mean per-request
    reservation gap."""
    if not kv_fold:
        return {}
    out = {}
    u = kv_fold.get("util")
    if isinstance(u, (int, float)):
        out["kv_pool_util"] = u
    g = kv_fold.get("req_gap_frac")
    if isinstance(g, (int, float)):
        out["kv_req_gap_frac"] = g
    # round 25: the sharing hit rate (gated: a drop = regression) and
    # the growth count — absent when the run predates round 25 or the
    # cache never looked anything up (regress skips structurally)
    h = kv_fold.get("prefix_hit_frac")
    if isinstance(h, (int, float)):
        out["prefix_hit_frac"] = h
    pg = kv_fold.get("pages_grown")
    if isinstance(pg, (int, float)):
        out["pages_grown_total"] = pg
    return out


def kv_lines(fold: dict) -> list[str]:
    """The summarize KV-pool section: the ``kv_pool_util`` headline,
    the honesty-gap line, the tail cause split, and the configured
    pool geometry (satellite: pool size appeared in no rendered output
    before round 22).  ``fold`` is the whole serve fold — geometry
    keys ride the summary, the ledger rides ``fold["kv_pool"]``."""
    lines: list[str] = []
    kvf = fold.get("kv_pool")
    if kvf:
        util = kvf.get("util")
        if isinstance(util, (int, float)):
            head = (f"  kv_pool_util {util:.1%}  (written-page-s "
                    f"{kvf.get('written_page_s', 0.0):.4g} / "
                    f"reserved-page-s "
                    f"{kvf.get('reserved_page_s', 0.0):.4g})")
            peak = kvf.get("pages_peak")
            if peak is not None:
                head += f"  peak {peak}"
                if fold.get("kv_pages"):
                    # pool high-water against the allocatable pool
                    # (page 0 is the reserved trash page)
                    head += f"/{int(fold['kv_pages']) - 1}"
                head += " pages"
            if kvf.get("pages_recycled") is not None:
                head += f"  recycled {kvf['pages_recycled']}"
            if kvf.get("pages_grown") is not None:
                # round 25 on-demand growth (recycled and COW copies
                # are tracked apart — a copy is not a recycle)
                head += f"  grown {kvf['pages_grown']}"
            lines.append(head)
        if kvf.get("prefix_lookups") is not None:
            hf = kvf.get("prefix_hit_frac")
            cow = kvf.get("cow_copies") or 0
            lines.append(
                "  prefix cache: "
                + (f"{hf:.1%} hit rate"
                   if isinstance(hf, (int, float)) else "no lookups")
                + f" ({kvf.get('prefix_hits', 0)}/"
                  f"{kvf.get('prefix_lookups', 0)}), "
                  f"{kvf.get('prefix_pages_shared', 0)} shared "
                  f"page-slot(s), {cow} COW cop"
                  f"{'y' if cow == 1 else 'ies'}")
        if isinstance(kvf.get("req_gap_frac"), (int, float)):
            lines.append(
                f"  reservation honesty: "
                f"{kvf.get('req_pages_reserved_mean', 0.0):.1f} pages "
                f"reserved vs {kvf.get('req_pages_final_mean', 0.0):.1f} "
                f"written per request — gap "
                f"{kvf['req_gap_frac']:.0%}")
        wc = kvf.get("wait_causes")
        if wc and wc.get("has_causes"):
            fr = wc.get("tail_frac", {})
            lines.append(
                f"  queue_wait cause (slowest decile): "
                + " / ".join(f"{fr.get(name, 0.0):.0%} {name}"
                             for name in WAIT_CAUSES)
                + f"  [of {wc.get('tail_queue_ms', 0.0):.0f}ms tail "
                  f"queue_wait]")
    if fold.get("kv_pool_bytes") is not None:
        geom = (f"  kv pool geometry: {fold.get('kv_pages', '?')} pages "
                f"x {fold.get('kv_page_size', '?')} tokens x "
                f"{fold.get('kv_layers', '?')} layers = "
                f"{fold['kv_pool_bytes'] / 2**20:.2f} MiB")
        sb = fold.get("kv_scale_bytes")
        if sb:
            geom += f" (incl. {sb / 2**10:.1f} KiB int8_kv scales)"
        lines.append(geom)
    return lines


def kv_diff_lines(fold_a: dict | None, fold_b: dict | None) -> list[str]:
    """``obs diff`` rows: utilization / honesty-gap / tail-cause
    deltas in percentage points.  A side without the ledger (a stream
    that predates it) reads as 0 and is labeled, never a KeyError."""
    ka = (fold_a or {}).get("kv_pool")
    kb = (fold_b or {}).get("kv_pool")
    if not ka and not kb:
        return []
    lines = ["  kv pool (written/reserved page-seconds):"]
    rows = [("kv_pool_util", "util"), ("kv req gap", "req_gap_frac"),
            # sides without a prefix cache read 0
            ("prefix hits", "prefix_hit_frac")]
    for label, key in rows:
        va = (ka or {}).get(key)
        vb = (kb or {}).get(key)
        va = float(va) if isinstance(va, (int, float)) else 0.0
        vb = float(vb) if isinstance(vb, (int, float)) else 0.0
        if va == 0.0 and vb == 0.0:
            continue
        lines.append(f"  {label:>14s} {va:11.1%} {vb:11.1%} "
                     f"{100.0 * (vb - va):+7.1f}pp")
    for name in WAIT_CAUSES:
        va = float(((ka or {}).get("wait_causes") or {})
                   .get("tail_frac", {}).get(name, 0.0))
        vb = float(((kb or {}).get("wait_causes") or {})
                   .get("tail_frac", {}).get(name, 0.0))
        if va == 0.0 and vb == 0.0:
            continue
        lines.append(f"  {'tail ' + name:>14s} {va:11.1%} {vb:11.1%} "
                     f"{100.0 * (vb - va):+7.1f}pp")
    for side, k in (("a", ka), ("b", kb)):
        if k is None:
            lines.append(f"  note: run {side} predates the KV-pool "
                         "ledger (round 22) — no kv_pool records")
    return lines if len(lines) > 1 else []


# ---------------------------------------------------------------------
# timeline export: pool occupancy as a Chrome-trace counter track


#: synthetic Chrome-trace pid for the pool counter track (beside the
#: per-request lanes at ``requests_mod.REQUEST_LANE_PID``)
KV_COUNTER_PID = (1 << 20) + 1


def kv_counter_events(records: list[dict]) -> list[dict]:
    """Chrome-trace "C"-phase counter samples of pool occupancy
    (written / reserved-but-unwritten / free pages, stacked), one per
    ``kv_pool`` record, merged by ``obs.timeline.merge_chrome_trace``
    beside the per-request lanes — a pool-full stall is visually
    attributable to the admission gap above it.

    Anchored by the run's ``serve_clock`` record exactly like the
    request lanes; without one (pre-r20 stream) or without ``kv_pool``
    records (pre-r22 stream) the track is skipped, never wrong.
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
    for r in records:
        if r.get("kind") != KV_POOL_KIND:
            continue
        reserved = int(r.get("pages_reserved") or 0)
        written = int(r.get("pages_written") or 0)
        events.append({
            "name": "kv pool pages", "ph": "C",
            "ts_unix": t0_unix + float(r.get("t") or 0.0),
            "pid": KV_COUNTER_PID, "tid": 0,
            "args": {"written": written,
                     "reserved_unwritten": max(0, reserved - written),
                     "free": int(r.get("free_pages") or 0)}})
    if events:
        events.append({"name": "process_name", "ph": "M",
                       "pid": KV_COUNTER_PID,
                       "args": {"name": "kv pool"}})
    return events
