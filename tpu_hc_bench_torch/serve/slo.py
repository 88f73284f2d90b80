"""SLO report: fold ``request``/``serve`` records into latency/goodput
lines (the port's copy of the JAX package's ``serve/slo.py``).

Pure record processing, no torch: ``obs summarize`` and ``obs signals``
call into this module on machines with no GPU.  The engine uses the
same fold on its in-memory records, so the engine's final print and
the offline summarize agree by construction, and the lines equal the
JAX package's on the same records.

Report fields (the serving analog of the training lane's
goodput/MFU/p50 account):

- **TTFT** p50/p95/p99 — arrival to first generated token (queueing +
  prefill; the interactivity number).
- **End-to-end** p50/p95/p99 — arrival to retirement.
- **tokens/s** — generated tokens over wall (the serving throughput
  headline).
- **goodput-under-load** — the fraction of wall spent on *useful*
  compute: each step's wall is credited at ``active_rows /
  bucket_rows`` (padding slots waste it) and idle waits credit
  nothing.  Static batching loses goodput twice — idling while a
  batch fills, and padding while stragglers finish — which is exactly
  the delta continuous batching exists to close.
- **queue depth** mean/max — the backpressure signal.
"""

from __future__ import annotations

from tpu_hc_bench_torch.obs import kv as kv_mod
from tpu_hc_bench_torch.obs import requests as requests_mod
from tpu_hc_bench_torch.obs import sketch as sketch_mod

SERVE_SUMMARY_KIND = "serve_summary"
REQUEST_KIND = "request"
# per-window mergeable quantile sketches (round 24): the engine lands
# one per serve-record window; summarize merges them into
# fleet-wide percentiles next to the run's own figures
SKETCH_KIND = "latency_sketch"
LATENCY_FIELDS = ("ttft_ms", "e2e_ms", "queue_ms")


# (label, key) rows of the diff table
DIFF_METRICS = (
    ("p99 ttft ms", "p99_ttft_ms"),
    ("p99 e2e ms", "p99_e2e_ms"),
    ("p50 e2e ms", "p50_e2e_ms"),
    # queue wait: the cheapest leading overload indicator
    ("p99 queue ms", "p99_queue_ms"),
    # the merged-sketch fleet-wide tail (absent on older streams; the
    # row simply skips there)
    ("p99 e2e merged", "p99_e2e_ms_merged"),
    ("tokens/s", "tokens_per_s"),
    ("serve goodput", "goodput"),
    ("queue max", "queue_depth_max"),
    # the worst decode bucket's temp bytes (JAX's AOT account; absent
    # on the port's streams, where the row skips)
    ("aot dec temp B", "aot_decode_temp_bytes"),
)


def request_sketches(request_records) -> dict:
    """One streaming sketch per latency field — O(buckets) memory over
    any stream length, and the same multiset of samples the engine's
    live sketches saw, so offline and engine-side folds agree."""
    sks = {f: sketch_mod.QuantileSketch() for f in LATENCY_FIELDS}
    for r in request_records:
        for field, sk in sks.items():
            v = r.get(field)
            if isinstance(v, (int, float)):
                sk.add(float(v))
    return sks


def fold_requests(request_records: list[dict]) -> dict:
    """Percentile block from per-request records (engine-side and
    offline callers share it).  Round 24: folded through the mergeable
    sketch (within its relative-error bound of the old stored-sample
    fold) so memory stays bounded over unbounded streams."""
    return fold_sketches(request_sketches(request_records))


def fold_sketches(sks: dict) -> dict:
    out: dict = {}
    for field in LATENCY_FIELDS:
        sk = sks.get(field)
        for q in (50, 95, 99):
            out[f"p{q}_{field}"] = round(sk.quantile(q), 3) if sk \
                else 0.0
    return out


def fold_serve_records(records: list[dict]) -> dict | None:
    """Fold one metrics stream's serving records, or None when the run
    has no serving lane (training runs cost one list scan).

    The last ``serve_summary`` record wins (engine-computed goodput and
    wall); percentiles are recomputed from the ``request`` records so a
    stream truncated before its summary still reports latencies.
    """
    reqs = [r for r in records if r.get("kind") == REQUEST_KIND]
    summaries = [r for r in records if r.get("kind") == SERVE_SUMMARY_KIND]
    compiles = [r for r in records if r.get("kind") == "serve_compile"]
    if not reqs and not summaries:
        return None
    fold: dict = {"completed": len(reqs)}
    if summaries:
        fold.update(summaries[-1])
        fold.pop("kind", None)
    if reqs:
        fold.update(fold_requests(reqs))
        fold["completed"] = len(reqs)
        # tail attribution recomputed from the request records, so a
        # stream truncated before its summary still attributes its p99
        # (pre-r20 records normalize to zero components, labeled)
        attr = requests_mod.fold_attribution(reqs)
        if attr is not None:
            fold["attribution"] = attr
        slo_t = (fold.get("slo") or {}).get("slo_e2e_ms") \
            if isinstance(fold.get("slo"), dict) else None
        if slo_t:
            fold["slo"] = fold_burn_rate(reqs, slo_t)
    # round 22 (obs.kv): the pool ledger recomputed from the stream so
    # a run truncated before its summary still reports utilization — a
    # pre-r22 stream folds to None and the keys stay absent, labeled
    kvf = kv_mod.fold_kv(records)
    if kvf is not None:
        fold["kv_pool"] = kvf
        fold.update(kv_mod.flatten_kv(kvf))
    fold.update(fold_window_sketches(records))
    if compiles:
        c = compiles[-1]
        fold["compile_buckets"] = c.get("buckets")
        fold["compile_warm"] = c.get("warm")
    return fold


def fold_window_sketches(records: list[dict]) -> dict:
    """Merge every ``latency_sketch`` window record in one stream (or
    several streams concatenated — merge is bucket-wise add, so the
    result IS the fleet-wide percentile, not an average of per-host
    ones).  A pre-r24 stream has no sketch records and folds to an
    empty dict — the keys stay absent, labeled, never a KeyError."""
    merged: dict[str, sketch_mod.QuantileSketch] = {}
    n_win = 0
    for r in records:
        if r.get("kind") != "latency_sketch":
            continue
        n_win += 1
        for f, srec in (r.get("fields") or {}).items():
            if not isinstance(srec, dict):
                continue
            sk = sketch_mod.QuantileSketch.from_record(srec)
            if f in merged:
                merged[f].merge(sk)
            else:
                merged[f] = sk
    if not merged:
        return {}
    out: dict = {"sketch_windows": n_win, "latency_source": "sketch"}
    for f, sk in merged.items():
        for q in (50, 95, 99):
            out[f"p{q}_{f}_merged"] = round(sk.quantile(q), 3)
    if "e2e_ms" in merged:
        out["p99_merged_ms"] = out["p99_e2e_ms_merged"]
    return out


DEFAULT_BURN_WINDOWS = 8


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


def burn_lines(burn: dict | None) -> list[str]:
    """The one summarize/engine line for the SLO burn account."""
    if not burn:
        return []
    n_win = len(burn.get("windows", ()))
    return [
        f"  slo: e2e <= {burn['slo_e2e_ms']:g}ms — "
        f"{burn['violations']}/{burn['completed']} violated "
        f"({burn['violation_rate']:.1%}); worst window "
        f"{burn['peak_window_rate']:.0%} @ t={burn['peak_window_t']:.1f}s; "
        f"longest streak {burn['max_violation_streak']}/{n_win} "
        f"window(s)"
        + (" — SUSTAINED overload" if n_win
           and burn["max_violation_streak"] >= max(2, n_win // 2)
           else "")
    ]


def slo_lines(fold: dict) -> list[str]:
    """Render the serving section (summarize / the engine's final
    print; two-space indent matches the other summarize sections)."""
    lines = [
        f"  serve: {fold.get('completed', 0)}"
        + (f"/{fold['requests']}" if fold.get("requests") else "")
        + f" requests  batching={fold.get('batching', '?')}"
        + f"  arrival={fold.get('arrival', '?')}"
        + (f"@{fold.get('arrival_rate')}/s"
           if fold.get("arrival_rate") else ""),
    ]
    if "p50_ttft_ms" in fold:
        lines.append(
            f"  ttft ms p50 {fold['p50_ttft_ms']:.1f}  "
            f"p95 {fold['p95_ttft_ms']:.1f}  "
            f"p99 {fold['p99_ttft_ms']:.1f}   e2e ms "
            f"p50 {fold['p50_e2e_ms']:.1f}  "
            f"p95 {fold['p95_e2e_ms']:.1f}  "
            f"p99 {fold['p99_e2e_ms']:.1f}")
    if "p99_e2e_ms_merged" in fold:
        # round 24: the fleet-wide merged-sketch tail, source-labeled
        # next to the per-host stored-sample figures above
        lines.append(
            f"  e2e ms [sketch, {fold.get('sketch_windows', '?')} "
            f"window(s) merged] p50 {fold['p50_e2e_ms_merged']:.1f}  "
            f"p95 {fold['p95_e2e_ms_merged']:.1f}  "
            f"p99 {fold['p99_e2e_ms_merged']:.1f}")
    if "p50_queue_ms" in fold:
        # queue wait: the cheapest leading indicator of overload —
        # folded since round 16, rendered since round 20
        lines.append(
            f"  queue ms p50 {fold['p50_queue_ms']:.1f}  "
            f"p99 {fold['p99_queue_ms']:.1f}")
    # round 20 (obs.requests): where the p99 lives
    lines.extend(requests_mod.attribution_lines(
        fold.get("attribution"), p99_e2e_ms=fold.get("p99_e2e_ms")))
    # round 22 (obs.kv): utilization headline + honesty gap + the
    # tail-cause split + configured pool geometry
    lines.extend(kv_mod.kv_lines(fold))
    lines.extend(burn_lines(fold.get("slo")))
    # round 23: the degradation account — sheds by cause, preemption/
    # requeue traffic, quarantined poison requests.  Rendered only when
    # the engine actually degraded; a clean run stays a clean report.
    deg = fold.get("degrade")
    if deg and (deg.get("shed") or deg.get("preempts")
                or deg.get("quarantined")):
        shed = deg.get("shed") or {}
        parts = [f"shed {sum(shed.values())}"
                 + (" (" + ", ".join(
                     f"{c}x{shed[c]}" for c in kv_mod.SHED_CAUSES
                     if c in shed) + ")" if shed else "")]
        if deg.get("preempts"):
            parts.append(f"preempts {deg['preempts']} "
                         f"(requeued {deg.get('requeues', 0)})")
        if deg.get("quarantined"):
            parts.append(f"quarantined {deg['quarantined']}")
        lines.append(
            f"  degrade: {'  '.join(parts)}   "
            f"shed_frac {deg.get('shed_frac', 0.0):.1%}")
    if fold.get("wall_s") is not None:
        lines.append(
            f"  {fold.get('tokens', 0)} tokens in "
            f"{fold['wall_s']:.2f}s wall = "
            f"{fold.get('tokens_per_s', 0.0):.1f} tok/s   "
            f"goodput-under-load {fold.get('goodput', 0.0):.1%}   "
            f"queue depth mean {fold.get('queue_depth_mean', 0.0):.1f} "
            f"max {fold.get('queue_depth_max', 0)}")
    if fold.get("buckets"):
        lines.append(
            f"  buckets {','.join(str(b) for b in fold['buckets'])} "
            f"max_in_flight {fold.get('max_in_flight', '?')}  "
            f"kv {fold.get('kv_pages', '?')} pages x "
            f"{fold.get('kv_page_size', '?')} tokens  steps "
            f"prefill {fold.get('prefill_steps', 0)} / decode "
            f"{fold.get('decode_steps', 0)} / classify "
            f"{fold.get('classify_steps', 0)}")
    if fold.get("decode_attention"):
        # the port's counterpart of the JAX lane's AOT temp bytes: the
        # peak allocated over the warmed decode buckets (none on the CPU)
        tb = fold.get("decode_peak_bytes")
        lines.append(
            f"  decode arm: attention={fold['decode_attention']} "
            f"quant={fold.get('quant', 'off')}"
            + (f" block_pages={fold['decode_block_pages']}"
               if fold.get("decode_block_pages") else "")
            + (f"  warmed decode ladder peak {tb / 2**20:.1f} MiB"
               if tb is not None else ""))
    # round 20: per-bucket occupancy heatmap (padding waste and ladder
    # sizing read directly off it)
    lines.extend(requests_mod.bucket_util_lines(fold.get("bucket_util")))
    return lines


def _pct(a: float, b: float) -> str:
    if a:
        return f"{(b - a) / a:+.1%}"
    return "new" if b else "-"


def serve_diff_lines(fold_a: dict | None, fold_b: dict | None) -> list[str]:
    """The ``obs diff`` serving rows (empty unless both runs serve)."""
    if not fold_a or not fold_b:
        return []
    lines = ["  serve metrics:"]
    for label, key in DIFF_METRICS:
        if key not in fold_a and key not in fold_b:
            continue
        va = float(fold_a.get(key) or 0.0)
        vb = float(fold_b.get(key) or 0.0)
        lines.append(f"  {label:>14s} {va:12.4g} {vb:12.4g} "
                     f"{_pct(va, vb):>8s}")
    if fold_a.get("batching") != fold_b.get("batching"):
        lines.append(f"  note: batching arm differs: "
                     f"{fold_a.get('batching')} -> "
                     f"{fold_b.get('batching')}")
    for key, label in (("decode_attention", "decode-attention arm"),
                       ("quant", "quant arm")):
        if fold_a.get(key) != fold_b.get(key):
            lines.append(f"  note: {label} differs: "
                         f"{fold_a.get(key)} -> {fold_b.get(key)}")
    # component deltas over the slowest decile — a side without them
    # normalizes to zero components, labeled, never a KeyError
    lines.extend(requests_mod.attribution_diff_lines(
        fold_a.get("attribution"), fold_b.get("attribution")))
    # utilization / honesty-gap / tail-cause deltas — the same
    # absent-not-error seam
    lines.extend(kv_mod.kv_diff_lines(fold_a, fold_b))
    return lines


def watch_lines(records: list[dict]) -> list[str]:
    """The live ``obs watch`` serving panel lines: last serve window +
    latest percentiles over the requests completed so far."""
    serves = [r for r in records if r.get("kind") == "serve"]
    fold = fold_serve_records(records)
    lines: list[str] = []
    if serves:
        s = serves[-1]
        lines.append(
            f"  serving t={s.get('t', 0.0):.1f}s  queue "
            f"{s.get('queue_depth', 0)}  in-flight "
            f"{s.get('in_flight', 0)}  free pages "
            f"{s.get('free_pages', '?')}  tokens {s.get('tokens', 0)}")
        occ = s.get("bucket_occ")
        if occ:
            # live per-bucket occupancy column (round 20)
            lines.append("  bucket occ: " + "  ".join(
                f"{k} {v:.0%}" for k, v in sorted(occ.items())))
    pools = [r for r in records if r.get("kind") == kv_mod.KV_POOL_KIND]
    if pools:
        # live pool-occupancy column (round 22): reserved vs actually
        # written right now, plus the running high-water
        p = pools[-1]
        res = int(p.get("pages_reserved") or 0)
        wrt = int(p.get("pages_written") or 0)
        lines.append(
            f"  kv pool: {res} reserved / {wrt} written / "
            f"{p.get('free_pages', '?')} free pages  "
            f"peak {p.get('pages_peak', '?')}  "
            f"recycled {p.get('pages_recycled', '?')}")
    if fold and "p99_e2e_ms" in fold and fold.get("completed"):
        lines.append(
            f"  {fold['completed']} done  p99 ttft "
            f"{fold['p99_ttft_ms']:.1f}ms  p99 e2e "
            f"{fold['p99_e2e_ms']:.1f}ms"
            + (f"  merged[sketch] p99 {fold['p99_merged_ms']:.1f}ms"
               if fold.get("p99_merged_ms") is not None else ""))
    return lines
