#!/usr/bin/env python3
"""Where a pipeline run's loss parts from the one-batch step, on one
NVIDIA GPU: llama_1b, bf16, flash attention, batch 4 x seq 2048, 13
momentum-SGD steps from seed 0, four ways on the same rows:

- ``plain``: the launcher's world-1 run (``1 1 4 ib``);
- ``accum4``: the same with ``--gradient_accumulation_steps=4``;
- ``one_stage_m4`` and ``one_stage_m1``: ``parallel.pipeline``'s GPipe
  schedule at one stage (no hops) with 4 and 1 microbatches.

Prints each arm's 13 losses as one JSON line an arm.  A pipeline of any
depth runs the one-stage schedule's arithmetic, so ``--pipeline_parallel``
at M = 4 is to be read against ``one_stage_m4`` (and ``accum4``), not
against ``plain``.

Usage: ``python3 scripts/pp_microbatch_losses.py`` from the repo root.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

STEPS = 13
BATCH, SEQ, VOCAB = 4, 2048, 32000


def _launch(extra: list[str]) -> list[float]:
    from tpu_hc_bench_torch import launcher

    lines: list[str] = []
    launcher.main(["1", "1", str(BATCH), "ib", "--model=llama_1b",
                   "--use_fp16=true", "--attention_impl=flash",
                   "--num_warmup_batches=0", f"--num_batches={STEPS}",
                   "--display_every=1", *extra], print_fn=lines.append)
    return [float(ln.split()[-1]) for ln in lines
            if ln[:1].isdigit() and "loss:" in ln]


def _one_stage(microbatches: int) -> list[float]:
    import torch

    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.data.synthetic import (SyntheticTokens,
                                                   tokens_to_device)
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.parallel import pipeline
    from tpu_hc_bench_torch.parallel.fabric import Fabric
    from tpu_hc_bench_torch.train import step as step_mod

    cfg = flags.BenchmarkConfig(model="llama_1b", batch_size=BATCH,
                                use_fp16=True, attention_impl="flash"
                                ).resolve()
    model, _ = create_model("llama_1b", torch.bfloat16, "flash",
                            device="cuda", seed=cfg.seed, train=True)
    pipe = pipeline.make_pipeline(None, model.num_layers, microbatches)
    state = step_mod.make_train_state(model, cfg, Fabric.ICI, None, None,
                                      pipe)
    batch = tokens_to_device(SyntheticTokens(
        BATCH, SEQ, seed=cfg.seed, vocab_size=VOCAB, causal_lm=True).batch(),
        torch.device("cuda"))
    losses = []
    try:
        for _ in range(STEPS):
            state, m = step_mod.train_step(state, batch)
            losses.append(float(m["loss"]))
    finally:
        state.dp.grads.close()
    return losses


def main() -> int:
    import torch
    import torch.distributed as dist

    from tpu_hc_bench_torch.parallel import distributed

    out = {"plain": _launch([]),
           "accum4": _launch(["--gradient_accumulation_steps=4"])}
    torch.cuda.empty_cache()
    distributed.init_single("nccl")
    try:
        for m in (4, 1):
            out[f"one_stage_m{m}"] = _one_stage(m)
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    for arm, losses in out.items():
        print(json.dumps({"arm": arm, "losses": losses}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main())
