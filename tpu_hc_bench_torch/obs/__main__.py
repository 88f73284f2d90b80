"""CLI: ``python -m tpu_hc_bench_torch.obs`` — summarize / diff / watch /
timeline / signals / regress over a training or serving run's
``--metrics_dir`` (and BENCH-style JSON records for ``regress``).

Examples::

    # render a metrics run (dir with metrics.jsonl + manifest.json):
    # a training run's goodput, MFU (source labelled), memory, trace
    # buckets and resilience events, or a serving run's SLO section
    python -m tpu_hc_bench_torch.obs summarize /runs/resnet50
    python -m tpu_hc_bench_torch.obs summarize /runs/resnet50 \
        --fabric_ceiling sweep.json

    # render a raw torch.profiler trace (--trace_dir) by step buckets
    python -m tpu_hc_bench_torch.obs summarize /runs/resnet50_trace

    # merge the flight recorder's spans into ONE aligned Chrome-trace
    # file (open in chrome://tracing or Perfetto)
    python -m tpu_hc_bench_torch.obs timeline /runs/llama_serve

    # health signals: recorded signals.jsonl + an offline hysteresis
    # re-evaluation of the stream (exit 1 when anything fired)
    python -m tpu_hc_bench_torch.obs signals /runs/llama_serve

    # per-metric, per-phase and per-bucket deltas between two runs
    # (resolved-flag drift first: a config change is not a regression)
    python -m tpu_hc_bench_torch.obs diff /runs/before /runs/after

    # live tail of a running (or finished) run; exits when it does
    python -m tpu_hc_bench_torch.obs watch /runs/resnet50

    # noise-aware regression gate: a fresh BENCH json vs the history's
    # median/MAD per config fingerprint (exit 1 on a real regression)
    python -m tpu_hc_bench_torch.obs regress BENCH_fresh.json \
        --history 'BENCH_*.json'

All subcommands are pure file operations (no GPU needed), and they read
the JAX package's run directories as well as the port's.

Exit codes: 0 clean; 1 degraded run dir (rendered what survived, each
problem one WARNING line on stderr), a signal fired (``signals``),
``watch --timeout`` expiry or a regression (``regress``); 2 unusable
input (no metrics stream or trace at the path, or no parseable BENCH
record — one-line error).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from tpu_hc_bench_torch.obs import metrics as metrics_mod
from tpu_hc_bench_torch.obs import trace as trace_mod


def _kind(path: str) -> str:
    """Autodetect an artifact path: a 'metrics' run or a 'trace'."""
    if os.path.isfile(path):
        name = os.path.basename(path)
        return "trace" if (name.endswith(".gz")
                           or ".trace.json" in name) else "metrics"
    if os.path.isfile(os.path.join(path, metrics_mod.METRICS_NAME)):
        return "metrics"
    if any(glob.glob(f"{path}/**/{pat}", recursive=True)
           for pat in ("*.trace.json", "*.trace.json.gz")):
        return "trace"
    raise FileNotFoundError(
        f"{path}: neither a metrics run (no {metrics_mod.METRICS_NAME}) "
        "nor a trace dir (no *.trace.json[.gz])")


def _summarize(path: str, out, fabric_ceiling: str | None = None) -> int:
    if _kind(path) == "metrics":
        problems: list[str] = []
        lines = metrics_mod.summarize_run(
            path, fabric_ceiling=fabric_ceiling, problems=problems)
        print("\n".join(lines), file=out)
        return _report_problems(problems)
    lines = trace_mod.format_summary(trace_mod.summarize_trace_dir(path),
                                     title=f"trace {path}")
    if fabric_ceiling:
        lines.append(
            "fabric ceiling: --fabric_ceiling applies to metrics runs "
            "(needs wall step times + allreduce bytes); pass the "
            "--metrics_dir artifact instead of the raw trace dir")
    print("\n".join(lines), file=out)
    return 0


def _report_problems(problems: list[str]) -> int:
    for p in problems:
        print(f"WARNING: {p}", file=sys.stderr)
    return 1 if problems else 0


def _diff(path_a: str, path_b: str, out) -> int:
    kind_a, kind_b = _kind(path_a), _kind(path_b)
    if kind_a != kind_b:
        print(f"cannot diff a {kind_a} run against a {kind_b} run",
              file=sys.stderr)
        return 2
    if kind_a == "metrics":
        problems: list[str] = []
        lines = metrics_mod.diff_runs(path_a, path_b, problems=problems)
        print("\n".join(lines), file=out)
        return _report_problems(problems)
    a = trace_mod.summarize_trace_dir(path_a)
    b = trace_mod.summarize_trace_dir(path_b)
    lines = [f"trace diff: {path_a} -> {path_b}"]
    lines.extend(trace_mod.diff_buckets(a.totals, b.totals))
    print("\n".join(lines), file=out)
    return 0


def _timeline(run_dir: str, out_path: str | None, out) -> int:
    from tpu_hc_bench_torch.obs import timeline as timeline_mod

    trace = timeline_mod.merge_chrome_trace(run_dir)
    path = timeline_mod.write_trace_json(
        trace, out_path or os.path.join(run_dir, "timeline.trace.json"))
    # clock-fallback ranks merge with identity offset but must be LOUD
    warnings = trace["metadata"].get("warnings", [])
    for w in warnings:
        print(f"WARNING: {w}", file=sys.stderr)
    for ln in timeline_mod.timeline_lines(run_dir):
        print(ln.strip(), file=out)
    lanes = trace["metadata"].get("request_lanes", 0)
    if lanes:
        print(f"request lanes: {lanes} request(s) rendered as their own "
              f"timeline rows (pid 'requests')", file=out)
    kv_samples = trace["metadata"].get("kv_counter_samples", 0)
    if kv_samples:
        print(f"kv pool track: {kv_samples} occupancy sample(s) rendered "
              f"as a counter track (pid 'kv pool')", file=out)
    print(f"chrome trace written: {path} (open in chrome://tracing or "
          f"https://ui.perfetto.dev)", file=out)
    return 1 if warnings else 0


def main(argv: list[str] | None = None, out=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_hc_bench_torch.obs",
        description="summarize/diff/watch/timeline/signals/regress over "
                    "training- and serving-run artifacts (--metrics_dir, "
                    "--trace_dir, BENCH records)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("summarize", help="render one run (metrics dir, "
                                         "its metrics.jsonl, or a trace)")
    s.add_argument("path")
    s.add_argument("--fabric_ceiling", default=None, metavar="SWEEP_JSON",
                   help="an OSU sweep export (microbench.osu --json): "
                        "judge the gradient all-reduce against it")
    d = sub.add_parser("diff",
                       help="per-bucket/per-metric deltas between two runs")
    d.add_argument("run_a")
    d.add_argument("run_b")
    w = sub.add_parser("watch",
                       help="live tail: step rate, goodput, MFU, last "
                            "resilience event; exits when the run does")
    w.add_argument("path")
    w.add_argument("--interval", type=float, default=1.0,
                   help="poll/refresh period, seconds (default 1)")
    w.add_argument("--timeout", type=float, default=None,
                   help="give up (exit 1) after this many seconds")
    w.add_argument("--no-follow", dest="follow", action="store_false",
                   help="render one snapshot and exit")
    t = sub.add_parser("timeline",
                       help="merge every rank's flight-recorder spans "
                            "(spans.<k>.jsonl) into one clock-aligned "
                            "Chrome-trace JSON")
    t.add_argument("run_dir")
    t.add_argument("-o", "--out", default=None, metavar="TRACE_JSON",
                   help="output path (default <run_dir>/"
                        "timeline.trace.json)")
    g = sub.add_parser("signals",
                       help="health signals: the run's recorded "
                            "signals.jsonl plus an offline hysteresis "
                            "re-evaluation of the stream; exit 1 when "
                            "anything fired")
    g.add_argument("path")
    g.add_argument("--window_s", type=float, default=None,
                   help="evaluation window seconds (default: completion "
                        "span / 8, the burn-rate convention)")
    g.add_argument("--json", action="store_true",
                   help="emit the raw event list as JSON instead of "
                        "the rendered report")
    r = sub.add_parser("regress",
                       help="noise-aware regression gate: a fresh BENCH "
                            "json vs the history's median/MAD per config "
                            "fingerprint; exit 1 on regression")
    r.add_argument("fresh", help="fresh BENCH json (bare record or the "
                                 "harness {'parsed': ...} wrapper)")
    r.add_argument("--history", nargs="+", default=None,
                   metavar="FILE|DIR|GLOB",
                   help="history sources (default: BENCH_*.json + "
                        "artifacts/ in the cwd)")
    r.add_argument("--mad_k", type=float, default=None,
                   help="noise multiplier on the MAD-sigma (default 4)")
    r.add_argument("--rel_floor", type=float, default=None,
                   help="relative noise floor vs the median (default "
                        "0.03: a quiet history never flags <3%% jitter)")
    args = ap.parse_args(argv)
    out = out or sys.stdout
    try:
        if args.cmd == "summarize":
            return _summarize(args.path, out, args.fabric_ceiling)
        if args.cmd == "diff":
            return _diff(args.run_a, args.run_b, out)
        if args.cmd == "timeline":
            return _timeline(args.run_dir, args.out, out)
        if args.cmd == "signals":
            from tpu_hc_bench_torch.obs import signals as signals_mod

            rep = signals_mod.evaluate_run(args.path,
                                           window_s=args.window_s)
            if args.json:
                print(json.dumps({"recorded": rep["recorded"],
                                  "evaluated": rep["evaluated"],
                                  "fired": rep["fired"]}), file=out)
            else:
                print("\n".join(rep["lines"]), file=out)
            return _report_problems(rep["problems"]) \
                or (1 if rep["fired"] else 0)
        if args.cmd == "regress":
            from tpu_hc_bench_torch.obs import regress as regress_mod

            kwargs = {}
            if args.mad_k is not None:
                kwargs["mad_k"] = args.mad_k
            if args.rel_floor is not None:
                kwargs["rel_floor"] = args.rel_floor
            return regress_mod.run_regress(args.fresh, args.history,
                                           out=out, **kwargs)
        from tpu_hc_bench_torch.obs import watch as watch_mod

        return watch_mod.watch(args.path, out=out, interval=args.interval,
                               timeout_s=args.timeout, follow=args.follow)
    except (FileNotFoundError, json.JSONDecodeError, ValueError,
            RuntimeError) as e:
        # a missing/garbage artifact gets ONE clear line and a distinct
        # exit code, not a traceback
        print(f"error: {e}", file=sys.stderr)
        return 2
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    raise SystemExit(main())
