"""CLI: ``python -m tpu_hc_bench_torch.obs`` — summarize / timeline /
signals over a serving run's ``--metrics_dir``.

Examples::

    # render a metrics run (dir with metrics.jsonl + manifest.json)
    python -m tpu_hc_bench_torch.obs summarize /runs/llama_serve

    # merge the flight recorder's spans into ONE aligned Chrome-trace
    # file (open in chrome://tracing or Perfetto)
    python -m tpu_hc_bench_torch.obs timeline /runs/llama_serve

    # health signals: recorded signals.jsonl + an offline hysteresis
    # re-evaluation of the stream (exit 1 when anything fired)
    python -m tpu_hc_bench_torch.obs signals /runs/llama_serve

All subcommands are pure file operations (no GPU needed), and they read
the JAX package's run directories as well as the port's.

Exit codes: 0 clean; 1 degraded run dir (rendered what survived, each
problem one WARNING line on stderr) or a signal fired (``signals``); 2
unusable input (no metrics stream at the path — one-line error).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from tpu_hc_bench_torch.obs import metrics as metrics_mod


def _report_problems(problems: list[str]) -> int:
    for p in problems:
        print(f"WARNING: {p}", file=sys.stderr)
    return 1 if problems else 0


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
        description="summarize/timeline/signals over serving-run "
                    "artifacts (--metrics_dir)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("summarize", help="render one run (metrics dir or "
                                         "its metrics.jsonl)")
    s.add_argument("path")
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
    args = ap.parse_args(argv)
    out = out or sys.stdout
    try:
        if args.cmd == "summarize":
            problems: list[str] = []
            lines = metrics_mod.summarize_run(args.path, problems=problems)
            print("\n".join(lines), file=out)
            return _report_problems(problems)
        if args.cmd == "timeline":
            return _timeline(args.run_dir, args.out, out)
        from tpu_hc_bench_torch.obs import signals as signals_mod

        rep = signals_mod.evaluate_run(args.path, window_s=args.window_s)
        if args.json:
            print(json.dumps({"recorded": rep["recorded"],
                              "evaluated": rep["evaluated"],
                              "fired": rep["fired"]}), file=out)
        else:
            print("\n".join(rep["lines"]), file=out)
        return _report_problems(rep["problems"]) \
            or (1 if rep["fired"] else 0)
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
