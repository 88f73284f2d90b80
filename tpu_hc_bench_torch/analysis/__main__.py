"""CLI: ``python -m tpu_hc_bench_torch.analysis``.

Runs the lint passes (and, per model, the op census of a world=N
training step) and compares the findings against the checked-in
baseline; exits non-zero on any finding the baseline does not accept —
the lint gate.

Examples::

    # one member: lints + the census of its step on the card (kernel
    # launches, host syncs, the card's sync warnings) + the world=2
    # collective counts
    python -m tpu_hc_bench_torch.analysis --model resnet50

    # the whole zoo's lints + the repo source passes, JSON to a file
    python -m tpu_hc_bench_torch.analysis --all --device=cpu --json out.json

    # per-file passes restricted to sources `git diff` names (repo-scope
    # passes still see the whole tree) — the cheap pre-push loop
    python -m tpu_hc_bench_torch.analysis --all --changed-only --device=cpu

    # show what accepting the current tree WOULD change (exit 1 if
    # anything), then actually rewrite it (atomic tmp->fsync->rename)
    python -m tpu_hc_bench_torch.analysis baseline --device=cpu
    python -m tpu_hc_bench_torch.analysis baseline --update --device=cpu

``--all`` and the lint passes need no card: the model passes build each
member on the meta device.  ``--model`` also takes one real step of the
member on ``--device`` (the card unless ``--device=cpu``) for its census,
and, with ``--collectives`` (its default), the world=N step over an
in-process ``fake`` process group for the collective counts.
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_hc_bench_torch.analysis",
        description="static analysis + lint gate over the port and its "
                    "model zoo")
    ap.add_argument("command", nargs="?", choices=["baseline"],
                    help="subcommand: `baseline` diffs this run's "
                         "findings against the committed baseline "
                         "(exit 1 on any change); `baseline --update` "
                         "rewrites it atomically")
    ap.add_argument("--update", action="store_true",
                    help="(baseline) actually rewrite the baseline "
                         "file instead of dry-running the diff")
    ap.add_argument("--changed-only", action="store_true",
                    help="restrict per-file passes to python sources "
                         "changed vs HEAD (plus untracked); repo-scope "
                         "passes still see the whole tree")
    ap.add_argument("--model", action="append", default=[],
                    help="zoo member to analyze (repeatable)")
    ap.add_argument("--all", action="store_true",
                    help="analyze every zoo member + repo sources")
    ap.add_argument("--batch", type=int, default=2,
                    help="per-worker batch of the census's step "
                         "(collective counts are batch-invariant)")
    ap.add_argument("--world", type=int, default=2,
                    help="ranks of the step the collectives are counted "
                         "in")
    ap.add_argument("--collectives", dest="collectives",
                    action="store_true", default=None,
                    help="count the collectives of the world=N step "
                         "(default: on for --model, off for --all)")
    ap.add_argument("--no-collectives", dest="collectives",
                    action="store_false")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where --model's census takes its step (the "
                         "card unless asked)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full JSON report here ('-' = stdout)")
    ap.add_argument("--baseline", metavar="PATH",
                    help="baseline findings file (default: checked-in)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from this run's findings")
    args = ap.parse_args(argv)

    from tpu_hc_bench_torch.models import list_models

    models = list(args.model)
    if args.all:
        models = list_models()
    if not models and not args.all and args.command != "baseline":
        ap.error("pass --model NAME (repeatable), --all, or the "
                 "`baseline` subcommand")
    if args.update and args.command != "baseline":
        ap.error("--update belongs to the `baseline` subcommand")
    count_collectives = args.collectives
    if count_collectives is None:
        count_collectives = bool(args.model) and not args.all
    # the real step's census is --model's (JAX's --model lowers a step)
    take_step = bool(args.model) and not args.all

    import collections
    import time

    from tpu_hc_bench_torch import resolve_device
    from tpu_hc_bench_torch.analysis import census, lints, registry, report

    if take_step:
        resolve_device(args.device)      # no card: raise before the work
    t0 = time.monotonic()
    files = None
    if args.changed_only:
        root = __import__("pathlib").Path(__file__).resolve().parents[2]
        files = registry.changed_python_files(root)
        if files is None:
            print("--changed-only: git unavailable, falling back to "
                  "the full tree", file=sys.stderr)
        else:
            print(f"--changed-only: {len(files)} changed python "
                  f"source(s)", file=sys.stderr)

    findings = []
    collectives: dict[str, dict[str, int]] = {}
    steps: dict[str, dict] = {}
    suppressed: collections.Counter = collections.Counter()
    findings.extend(lints.lint_repo_sources(files=files,
                                            counters=suppressed))
    for name in models:
        print(f"-- {name}", file=sys.stderr)
        findings.extend(lints.lint_model(name))
        if take_step:
            steps[name] = census.census_train_step(
                name, batch=args.batch, device=args.device,
                card_syncs=args.device == "cuda").summary()
        if count_collectives:
            collectives[name] = census.collective_counts(
                census.census_train_step(name, batch=args.batch,
                                         world=args.world,
                                         device=args.device))
    wall_s = time.monotonic() - t0

    rep = report.Report(findings=findings, collectives=collectives,
                        suppressed=dict(suppressed), wall_s=wall_s,
                        census=steps)
    if args.json == "-":
        sys.stdout.write(rep.to_json())
    elif args.json:
        with open(args.json, "w") as f:
            f.write(rep.to_json())

    # human summary: stderr when stdout is the JSON stream
    out = sys.stderr if args.json == "-" else sys.stdout
    for name, counts in sorted(collectives.items()):
        total = sum(counts.values())
        print(f"{name} world={args.world} step collectives (op census, "
              f"dispatcher ops): {total}  {counts}", file=out)
    for name, rec in sorted(steps.items()):
        print(f"{name} world=1 step on {args.device}: {rec['ops']} ops, "
              f"host syncs {rec['host_syncs']}, card sync warnings "
              f"{rec['card_syncs']}, kernel launches "
              f"{rec['kernel_launches']}", file=out)

    if args.command == "baseline":
        path = args.baseline or report.BASELINE_PATH
        # a partial (--model) run only ADDS keys; erasing other models'
        # accepted findings requires the full --all picture
        merge = set() if args.all else report.load_baseline(path)
        gating = {f.key for f in findings
                  if f.severity in ("error", "warning")} | merge
        before = report.load_baseline(path)
        added, removed = sorted(gating - before), sorted(before - gating)
        for k in added:
            print(f"+ {k}", file=out)
        for k in removed:
            print(f"- {k}", file=out)
        if not args.update:
            if added or removed:
                print(f"baseline DIFF: +{len(added)} -{len(removed)} "
                      f"key(s); rerun with `baseline --update` to "
                      f"accept", file=out)
                return 1
            print(f"baseline up to date: {path} "
                  f"({len(before)} accepted keys)", file=out)
            return 0
        gating_findings = [f for f in findings
                           if f.severity in ("error", "warning")]
        report.save_baseline(gating_findings, path, merge=merge)
        print(f"baseline updated: {path} (+{len(added)} "
              f"-{len(removed)}, {len(gating)} accepted keys)", file=out)
        return 0

    if args.update_baseline:
        path = args.baseline or report.BASELINE_PATH
        merge = set() if args.all else report.load_baseline(path)
        added, removed = report.save_baseline(findings, path, merge=merge)
        for k in added:
            print(f"+ {k}", file=out)
        for k in removed:
            print(f"- {k}", file=out)
        print(f"baseline updated: {path} "
              f"({len({f.key for f in findings} | merge)} accepted keys)",
              file=out)
        return 0

    baseline = report.load_baseline(args.baseline or report.BASELINE_PATH)
    regressions = report.compare_to_baseline(findings, baseline)
    for f in regressions:
        print(f.render(), file=sys.stderr)
    if regressions:
        print(f"{len(regressions)} finding(s) not in baseline "
              f"(accept with `baseline --update` or suppress with "
              f"`# tpu-hc: disable=<lint>`)", file=sys.stderr)
        return 1
    n_info = sum(1 for f in findings if f.severity == "info")
    n_sup = sum(suppressed.values())
    print(f"analysis clean: {len(findings)} finding(s), all accepted "
          f"({n_info} info, {n_sup} suppressed) in {wall_s:.1f}s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
