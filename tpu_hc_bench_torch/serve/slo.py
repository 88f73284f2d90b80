"""Serve-lane latency fold and its short report.

The port keeps the JAX package's summary key names
(``p{50,95,99}_{ttft,e2e,queue}_ms``) but folds them as exact numpy
percentiles (linear interpolation) over every completed request; the
mergeable sketch of the JAX lane comes in a later slice.
"""

from __future__ import annotations

import numpy as np

LATENCY_FIELDS = ("ttft_ms", "e2e_ms", "queue_ms")


def fold_requests(request_records: list[dict]) -> dict:
    """Percentile block from per-request records."""
    out: dict = {}
    for field in LATENCY_FIELDS:
        vals = [float(r[field]) for r in request_records if field in r]
        for q in (50, 95, 99):
            out[f"p{q}_{field}"] = (round(float(np.percentile(vals, q)), 3)
                                    if vals else 0.0)
    return out


def slo_lines(fold: dict) -> list[str]:
    """Render the serve summary (the engine's final print)."""
    lines = [
        f"  serve: {fold.get('completed', 0)}/{fold.get('requests', 0)} "
        f"requests  batching={fold.get('batching', '?')}  "
        f"arrival={fold.get('arrival', '?')}@{fold.get('arrival_rate')}/s"
        f"  device={fold.get('device', '?')}",
        f"  ttft ms p50 {fold['p50_ttft_ms']:.1f}  "
        f"p95 {fold['p95_ttft_ms']:.1f}  p99 {fold['p99_ttft_ms']:.1f}   "
        f"e2e ms p50 {fold['p50_e2e_ms']:.1f}  "
        f"p95 {fold['p95_e2e_ms']:.1f}  p99 {fold['p99_e2e_ms']:.1f}",
        f"  queue ms p50 {fold['p50_queue_ms']:.1f}  "
        f"p99 {fold['p99_queue_ms']:.1f}",
        f"  tokens {fold.get('tokens', 0)} in {fold.get('wall_s', 0)}s = "
        f"{fold.get('tokens_per_s', 0)} tokens/s  "
        f"(decode steps {fold.get('decode_steps', 0)}, "
        f"prefills {fold.get('prefill_steps', 0)})",
        f"  decode arm: attention={fold.get('decode_attention')} "
        f"quant={fold.get('quant')}"
        + (f" block_pages={fold['decode_block_pages']}"
           if fold.get("decode_block_pages") else "")
        + f"  kv pages {fold.get('kv_pages')} x {fold.get('kv_page_size')}"
          f" tokens",
    ]
    return lines
