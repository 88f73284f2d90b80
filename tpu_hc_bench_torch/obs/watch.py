"""``python -m tpu_hc_bench_torch.obs watch <dir>`` — live run tail (the
port's copy of the JAX package's ``obs/watch.py``).

The reference's live view is ``tail -f`` on a teed log; this renders
the structured stream instead: step progress + rate + loss (last
``window`` record), the goodput account so far (ledger fold over the
records read to this point), the MFU line once the summary lands, the
last resilience event, and fleet skew when heartbeat files exist.

The panel refreshes in place on a TTY (cursor-up redraw); on a pipe it
prints one compact status line per change, so ``watch`` stays usable
under ``nohup``/CI.  Exits 0 as soon as the run is complete (a
``summary`` record is present — including when it already was at
startup), 1 on ``--timeout`` expiry, and the stream keeps being
re-read from disk each poll, so a watcher started mid-run or attached
to an NFS mirror behaves identically.
"""

from __future__ import annotations

import sys
import time

from tpu_hc_bench_torch.obs import fleet as fleet_mod
from tpu_hc_bench_torch.obs import goodput as goodput_mod
from tpu_hc_bench_torch.obs import metrics as metrics_mod


# the reversed-scan "newest record of kind" helper lives in obs.metrics
_last = metrics_mod._last


def render(path: str, manifest: dict, records: list[dict],
           problems: list[str] | None = None) -> list[str]:
    """The watch panel for one snapshot of the stream."""
    import os

    run_dir = os.path.dirname(metrics_mod.resolve_run(path)[1])
    lines = [f"watch {path} — model={manifest.get('model', '?')} "
             f"world={manifest.get('process_count', '?')}proc/"
             f"{manifest.get('device_count', '?')}dev"]
    w = _last(records, "window")
    beats = fleet_mod.read_heartbeats(run_dir)
    total = (manifest.get("config") or {}).get("num_batches")
    if w:
        lines.append(
            f"  step {w.get('step', '?')}"
            + (f"/{total}" if total else "")
            + f"   {w.get('rate', 0.0):.1f} ex/s   "
            f"step {w.get('step_ms', 0.0):.1f}ms   "
            f"loss {w.get('loss', float('nan')):.3f}")
    elif beats:
        # mid-run: window records only land at the end of the timed
        # loop, but every host's heartbeat file advances per sync
        # window — the live progress signal
        last = max((recs[-1] for recs in beats.values() if recs),
                   key=lambda r: r.get("step", 0), default=None)
        if last is not None:
            mem = fleet_mod.heartbeat_mem_peak(last)
            lines.append(
                f"  step {last.get('step', '?')}"
                + (f"/{total}" if total else "")
                + f" (heartbeat)   step ~"
                f"{last.get('step_ewma_ms', 0.0):.1f}ms ewma"
                + (f"   mem peak {mem / 2**20:.1f} MiB" if mem else ""))
    elif not any(r.get("kind") in ("serve", "serve_summary", "request")
                 for r in records):
        lines.append("  (no progress records yet)")
    # fleet memory: the heartbeat mem_peak_bytes field, max across the
    # hosts' freshest beats (previously received and dropped)
    mem_peaks = [p for p in (
        fleet_mod.heartbeat_mem_peak(recs[-1])
        for recs in beats.values() if recs) if p]
    if len(mem_peaks) > 1:
        lines.append(f"  fleet mem peak: {max(mem_peaks) / 2**20:.1f} MiB "
                     f"max across {len(mem_peaks)} host(s)")
    # fleet KV pressure: the serve lane's pool high-water off each
    # host's freshest beat
    kv_peaks = [(h, p) for h, p in (
        (h, fleet_mod.heartbeat_kv_peak(recs[-1]))
        for h, recs in sorted(beats.items()) if recs) if p]
    if kv_peaks:
        lines.append("  kv peak pages: " + "  ".join(
            f"rank{h} {p}" for h, p in kv_peaks[:8]))
    # per-rank current phase: the newest flight-recorder span
    # each rank stamped into its heartbeat — a hung fleet shows WHERE
    # each rank is stuck, not just that its step counter stopped
    last_beats = {h: recs[-1] for h, recs in sorted(beats.items()) if recs}
    if any(r.get("phase") for r in last_beats.values()):
        # liveness column: ALIVE/STALE/DEAD from the newest
        # beat's wall age — a wedged rank says so instead of silently
        # showing its last good numbers forever
        for h, r in list(last_beats.items())[:8]:
            live = fleet_mod.classify_liveness([r])
            age = live["age_s"] or 0.0
            lines.append(
                f"  rank{h}: {live['status']:<5}  "
                f"step {r.get('step', '?')}  "
                f"phase {r.get('phase') or '?'}  "
                f"beat {age:.0f}s ago"
                + (f"  (incarnation {r['incarnation']})"
                   if r.get("incarnation") else ""))
        if len(last_beats) > 8:
            lines.append(f"  ... {len(last_beats) - 8} more rank(s)")
    ledger = goodput_mod.build_ledger(records)
    if ledger is not None:
        lines.extend("  " + ln for ln in ledger.format_lines())
    from tpu_hc_bench_torch.obs import memory as memory_mod

    lines.extend(memory_mod.memory_lines(
        memory_mod.fold_memory_records(records))[:1])
    summary = _last(records, "summary")
    if summary:
        from tpu_hc_bench_torch.obs import efficiency as eff_mod

        lines.append(
            f"  DONE: total {summary.get('total_images_per_sec', 0.0):.2f} "
            f"ex/s  mean step {summary.get('mean_step_ms', 0.0):.2f}ms")
        lines.extend(eff_mod.mfu_lines(summary))
    # serving lane: live queue/in-flight panel + completed-request
    # percentiles (serve/request records; training runs skip this in
    # one list scan)
    from tpu_hc_bench_torch.serve import slo as slo_mod

    lines.extend(slo_mod.watch_lines(records))
    # live health signals: currently-active signals off the
    # append-only signals.jsonl beside the stream
    from tpu_hc_bench_torch.obs import signals as signals_mod

    lines.extend(signals_mod.watch_lines(run_dir))
    res = [r for r in records
           if r.get("kind") in metrics_mod.RESILIENCE_KINDS]
    if res:
        r = res[-1]
        detail = " ".join(f"{k}={v}" for k, v in r.items() if k != "kind")
        lines.append(f"  last resilience event: {r['kind']} {detail}")
    lines.extend(fleet_mod.straggler_lines(run_dir, records))
    for p in problems or ():
        lines.append(f"  WARNING: {p}")
    return lines


def watch(path: str, out=None, interval: float = 1.0,
          timeout_s: float | None = None, follow: bool = True) -> int:
    """Tail a metrics run until it completes.  Returns 0 once a
    ``summary`` record is seen (completed run), 1 on timeout."""
    out = out or sys.stdout
    tty = bool(getattr(out, "isatty", lambda: False)())
    deadline = (time.monotonic() + timeout_s) if timeout_s else None
    prev_height = 0
    prev_panel: list[str] | None = None
    while True:
        # degradations render inside the panel (a live stream's partial
        # final line is NORMAL here) — stderr stays quiet, so the
        # in-place TTY redraw never gets interleaved warnings
        problems: list[str] = []
        manifest, records = metrics_mod.read_run(path, problems=problems)
        panel = render(path, manifest, records, problems=problems)
        # a serving run's terminal record is serve_summary (the lane
        # never emits step-keyed summaries) — either one ends the watch
        done = any(r.get("kind") in ("summary", "serve_summary")
                   for r in records)
        if tty:
            if prev_height:
                out.write(f"\x1b[{prev_height}A")
            out.write("".join(f"\x1b[2K{ln}\n" for ln in panel))
            # a shrinking panel (a warning cleared, a laggard caught
            # up) must not leave its stale bottom lines on screen
            extra = prev_height - len(panel)
            if extra > 0:
                out.write("\x1b[2K\n" * extra + f"\x1b[{extra}A")
            prev_height = len(panel)
        elif panel != prev_panel or done or not follow:
            out.write("\n".join(panel) + "\n")
            prev_panel = panel
        out.flush()
        if done:
            return 0
        if not follow:
            return 0
        if deadline is not None and time.monotonic() >= deadline:
            out.write("watch: timeout waiting for run to complete\n")
            return 1
        time.sleep(interval)
