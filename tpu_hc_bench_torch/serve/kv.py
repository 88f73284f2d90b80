"""The KV pool's summary record, copied from the JAX package's
``obs/kv.py`` (``fold_ledger``, ``flatten_kv`` and the footprint reader
they use).

The engine's ledger integrates pages reserved and pages written over
step wall (page-seconds); ``fold_ledger`` turns them, the allocator's
counters and the per-request footprints into the ``kv_pool`` record,
and ``flatten_kv`` projects its headline keys into the flat summary:
``kv_pool_util`` (written over reserved page-seconds),
``kv_req_gap_frac`` (the mean share of a request's reservation never
written), ``prefix_hit_frac`` and ``pages_grown_total``.  The JAX
fold's queue-wait cause split is left out: the port's engine does not
split queue wait by cause.
"""

from __future__ import annotations

#: pages grown on demand after admission, and slots admitted pointing
#: at shared prefix-cache pages
GROWTH_KEYS = ("pages_grown", "prefix_pages_shared")
#: shed causes, in render order
SHED_CAUSES = ("deadline_expired", "deadline_predicted",
               "resident_expired")


def footprint_of(record: dict) -> dict | None:
    """One request record's KV footprint, or None without one."""
    res = record.get("pages_reserved")
    peak = record.get("pages_peak_used")
    final = record.get("pages_final")
    if not all(isinstance(v, (int, float)) for v in (res, peak, final)):
        return None
    out = {"pages_reserved": int(res), "pages_peak_used": int(peak),
           "pages_final": int(final)}
    for key in GROWTH_KEYS:
        v = record.get(key)
        out[key] = int(v) if isinstance(v, (int, float)) else 0
    return out


def fold_ledger(*, reserved_page_s: float, written_page_s: float,
                pages_peak: int | None = None,
                pages_recycled: int | None = None,
                pages_grown: int | None = None,
                cow_copies: int | None = None,
                prefix_hits: int | None = None,
                prefix_lookups: int | None = None,
                prefix_pages_shared: int | None = None,
                request_records: list[dict] = ()) -> dict:
    """Page-seconds -> utilization, request footprints -> the mean
    reservation gap, and the growth and sharing counters ->
    ``prefix_hit_frac`` (None when the cache never looked anything up)."""
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
    return out


def flatten_kv(kv_fold: dict | None) -> dict:
    """The flat summary keys of a ``fold_ledger`` record."""
    if not kv_fold:
        return {}
    out = {}
    u = kv_fold.get("util")
    if isinstance(u, (int, float)):
        out["kv_pool_util"] = u
    g = kv_fold.get("req_gap_frac")
    if isinstance(g, (int, float)):
        out["kv_req_gap_frac"] = g
    h = kv_fold.get("prefix_hit_frac")
    if isinstance(h, (int, float)):
        out["prefix_hit_frac"] = h
    pg = kv_fold.get("pages_grown")
    if isinstance(pg, (int, float)):
        out["pages_grown_total"] = pg
    return out
