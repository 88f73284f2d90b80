"""CLI: ``python -m tpu_hc_bench_torch.tune`` — search | show | promote.

Examples::

    # budgeted search over gpt2's lever space (axes mode) on the card,
    # every candidate a launcher subprocess sharing one kernel build
    # directory, journaled + resumable under --out
    python -m tpu_hc_bench_torch.tune search \\
        --model gpt2 --budget_s 600 --out artifacts/tune/gpt2

    # re-enter the same --out after a preemption: completed
    # measurements are never re-run
    python -m tpu_hc_bench_torch.tune search \\
        --model gpt2 --budget_s 600 --out artifacts/tune/gpt2

    # promote the journal's best config into the registry row the
    # launcher's --config=auto resolves
    python -m tpu_hc_bench_torch.tune promote \\
        --journal artifacts/tune/gpt2/tune_state.json

    # what is tuned for this hardware?  (the prune ledger of one search:
    # show --journal PATH)
    python -m tpu_hc_bench_torch.tune show

The hardware key comes from the card (``registry.hardware_key``); with
no card, ``--hardware`` or ``TPU_HC_TUNE_HW`` names it, else the
command raises.  A search prunes each member whose ``analysis`` lints
find what the port's baseline does not accept
(``prune.baseline_lint_classes``, on the meta device) unless
``--no-lints``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _cmd_search(args) -> int:
    from tpu_hc_bench_torch.tune import prune as prune_mod
    from tpu_hc_bench_torch.tune import registry as registry_mod
    from tpu_hc_bench_torch.tune import search as search_mod

    hardware = args.hardware or registry_mod.hardware_key()
    models = []
    for m in args.model or []:
        models.extend(m.split(","))
    if not models:
        print("pass --model NAME (repeatable or comma-separated)",
              file=sys.stderr)
        return 2
    settings = search_mod.SearchSettings(
        budget_s=args.budget_s,
        rung0_batches=args.rung_batches,
        warmup=args.warmup,
        max_rungs=args.max_rungs,
        timeout_s=args.timeout_s,
        mode=args.mode,
        max_candidates=args.max_candidates,
    )
    lint_fn = (None if args.no_lints
               else prune_mod.baseline_lint_classes)
    rc = 0
    for model in models:
        out_dir = args.out or f"artifacts/tune/{model}-{hardware}"
        if args.out and len(models) > 1:
            # one journal per (model, out dir): a shared --out across
            # members would trip the journal's model guard
            out_dir = os.path.join(args.out, model)
        journal = search_mod.run_search(
            model, out_dir, hardware, settings=settings, lint_fn=lint_fn)
        if journal.get("best") is None:
            rc = 1
            continue
        if args.promote:
            path, row = registry_mod.promote(
                journal, registry_dir=args.registry)
            print(f"promoted: {model} -> {path}")
    return rc


def _render_journal(journal: dict) -> None:
    """One search journal's prune ledger: what the pruner skipped, why,
    and — for the hbm-oom class — which anchor provenance decided it
    (``measured`` journal rows vs the ``seeded`` best-known-config
    guess), plus the memory each landed measurement recorded."""
    print(f"search journal: {journal.get('model')} @ "
          f"{journal.get('hardware')} (status {journal.get('status')}, "
          f"{journal.get('spent_s', 0):.0f}s/"
          f"{journal.get('budget_s', 0):.0f}s budget)")
    skipped = journal.get("skipped") or []
    by_class: dict[str, int] = {}
    for s in skipped:
        by_class[s.get("class", "?")] = by_class.get(
            s.get("class", "?"), 0) + 1
    pruned = ", ".join(f"{k} x{v}" for k, v in sorted(by_class.items()))
    print(f"  pruned without a run: {len(skipped)}"
          + (f" ({pruned})" if pruned else ""))
    for s in skipped:
        if s.get("class") != "hbm-oom":
            continue
        print(f"    [hbm-oom/{s.get('hbm_source', '?')}] "
              f"{s.get('key')}: {s.get('reason')}")
    for key, meas in sorted((journal.get("measurements") or {}).items()):
        for rung, rec in sorted((meas or {}).items()):
            if not isinstance(rec, dict):
                continue
            # the key IS the lever assignment (kernel/block-size levers
            # like decode_attention=paged,decode_block_pages=2 render
            # here verbatim), so every measured row names its config
            parts = []
            if rec.get("score") is not None:
                parts.append(f"score {rec['score']:.4g}")
            peak = rec.get("peak_hbm_bytes")
            if peak:
                limit = rec.get("hbm_bytes_limit")
                parts.append(
                    f"peak {peak / 2**20:.1f} MiB"
                    + (f" of {limit / 2**30:.1f} GiB "
                       f"({peak / limit:.0%})" if limit else "")
                    + (f" [{rec['mem_source']}]"
                       if rec.get("mem_source") else ""))
            print(f"  measured: {key} rung {rung}"
                  + (": " + "; ".join(parts) if parts else ""))


def _cmd_show(args) -> int:
    import json as json_mod

    from tpu_hc_bench_torch.tune import registry as registry_mod

    if getattr(args, "journal", None):
        with open(args.journal) as f:
            journal = json_mod.load(f)
        _render_journal(journal)
        return 0
    hardware = args.hardware or registry_mod.hardware_key()
    rows = registry_mod.load_rows(hardware, args.registry)
    path = registry_mod.registry_path(hardware, args.registry)
    if not rows:
        print(f"no tuned rows for hardware {hardware!r} ({path})")
        return 1
    print(f"tuned configs @ {hardware} ({path}):")
    for model in sorted(rows):
        row = rows[model]
        levers = ", ".join(f"{k}={v}"
                           for k, v in sorted(row["overrides"].items()))
        print(f"  {model:>16s}  score {row.get('score')}  "
              f"goodput {row.get('goodput')}  {levers}")
    return 0


def _cmd_promote(args) -> int:
    from tpu_hc_bench_torch.tune import registry as registry_mod

    with open(args.journal) as f:
        journal = json.load(f)
    path, row = registry_mod.promote(
        journal, registry_dir=args.registry, hardware=args.hardware)
    print(f"promoted: {journal['model']} @ "
          f"{args.hardware or journal['hardware']} -> {path}")
    print(json.dumps(row, indent=2, sort_keys=True))
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_hc_bench_torch.tune",
        description="budgeted per-member config search over the zoo")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("search", help="run/resume a budgeted search")
    s.add_argument("--model", action="append",
                   help="zoo member (repeatable / comma-separated)")
    s.add_argument("--out", default=None,
                   help="journal + artifacts dir (default: "
                        "artifacts/tune/<model>-<hardware>); reuse the "
                        "same dir to resume")
    s.add_argument("--budget_s", type=float, default=3600.0,
                   help="wall-clock budget (journaled across resumes)")
    s.add_argument("--rung_batches", type=int, default=8,
                   help="timed steps at rung 0 (doubles per rung)")
    s.add_argument("--warmup", type=int, default=4)
    s.add_argument("--max_rungs", type=int, default=3)
    s.add_argument("--timeout_s", type=float, default=900.0,
                   help="per-measurement subprocess timeout")
    s.add_argument("--mode", choices=["axes", "grid"], default="axes")
    s.add_argument("--max_candidates", type=int, default=None,
                   help="cap the post-prune candidate count "
                        "(truncation is journaled)")
    s.add_argument("--hardware", default=None,
                   help="override the live hardware key")
    s.add_argument("--registry", default=None,
                   help="registry dir for --promote "
                        "(default artifacts/tuned)")
    s.add_argument("--promote", action="store_true",
                   help="promote the best config on completion")
    s.add_argument("--no-lints", action="store_true",
                   help="skip the per-member analysis-lint prune pass")
    s.set_defaults(fn=_cmd_search)

    s = sub.add_parser("show", help="render the registry rows, or a "
                                    "search journal's prune ledger")
    s.add_argument("--hardware", default=None)
    s.add_argument("--registry", default=None)
    s.add_argument("--journal", default=None,
                   help="path to a search's tune_state.json: print what "
                        "the pruner skipped and why (hbm-oom skips carry "
                        "their anchor provenance, measured|seeded) plus "
                        "each measurement's recorded HBM peak")
    s.set_defaults(fn=_cmd_show)

    s = sub.add_parser("promote",
                       help="journal best -> registry row")
    s.add_argument("--journal", required=True,
                   help="path to a search's tune_state.json")
    s.add_argument("--hardware", default=None)
    s.add_argument("--registry", default=None)
    s.set_defaults(fn=_cmd_promote)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
