"""The training benchmark driver: tf_cnn_benchmarks' measurement protocol.

The counterpart of the JAX package's ``train/driver.py`` for one worker:
``num_warmup_batches`` untimed steps (cuDNN's algorithm search and the
allocator's warm-up fall there, as XLA's compile does in the JAX lane),
then ``num_batches`` timed steps on one fixed synthetic batch, a line
``{step}\\timages/sec: {rate}\\tloss: {loss}`` every ``display_every``
steps, and a final ``total images/sec`` line.  Image models train on
``SyntheticImages``; text models (gpt2 and gpt2_medium next-token,
bert_base, bert_large and bert_tiny masked-LM) on one ``SyntheticTokens``
batch, whose "images" are sequences, as in the JAX lane.  The result
states the text arm's routes, ``attention_impl`` and ``fused_xent``.

Timing: the total is the host clock from the end of warmup to the
device's end of the last step.  Each timed step also records a CUDA
event after it, so the per-step median comes from device timestamps
without a host sync per step; the host waits for the device only at
display steps, where it reads the loss.  On the CPU (on request only)
the host clock marks the steps.  MFU is ``3 x flops_per_example x
images/s per card / peak``, with the card's published peak
(``utils.hw``); a card without one reports MFU as NaN.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import Callable

import torch

from tpu_hc_bench_torch import resolve_device
from tpu_hc_bench_torch.data.synthetic import (
    SyntheticImages, SyntheticTokens, to_device, tokens_to_device)
from tpu_hc_bench_torch.flags import BenchmarkConfig
from tpu_hc_bench_torch.models import create_model, get_model_spec
from tpu_hc_bench_torch.train import step as step_mod
from tpu_hc_bench_torch.utils import hw


@dataclasses.dataclass
class BenchmarkResult:
    """The JAX ``BenchmarkResult`` fields this lane fills."""

    model: str
    total_workers: int
    global_batch: int
    total_images_per_sec: float      # "total images/sec" (tf_cnn final line)
    images_per_sec_per_chip: float
    mean_step_ms: float              # timed wall / num_batches
    p50_step_ms: float               # median of per-step device times
    p50_step_granularity: int        # 1: a true per-step median
    mfu: float                       # NaN where the card has no peak
    final_loss: float
    fabric: str
    device_kind: str
    mfu_source: str = "analytic"     # 3 x spec.flops_per_example
    attention_impl: str = "dense"    # text models: dense | flash
    fused_xent: bool = False         # text models: the blocked xent kernels

    def json_line(self) -> dict:
        """The fields as a dict for strict JSON: NaN (no MFU) is None."""
        return {k: None if isinstance(v, float) and math.isnan(v) else v
                for k, v in dataclasses.asdict(self).items()}


class _StepClock:
    """End-of-step marks: CUDA events on the card, the host clock on the
    CPU (where every op has finished when it returns)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> list[float]:
        """Per-interval milliseconds (after the device has synced)."""
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [1e3 * (b - a) for a, b in pairs]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_benchmark(cfg: BenchmarkConfig, *, total_workers: int = 1,
                  fabric: str = "sock",
                  print_fn: Callable[[str], None] = print,
                  ) -> BenchmarkResult:
    """Train ``cfg.model`` on synthetic data and measure it."""
    if total_workers != 1:
        raise ValueError(f"a world of {total_workers} workers is not ported "
                         "yet (one worker only)")
    dev = resolve_device(cfg.device)
    spec = get_model_spec(cfg.model)
    if spec.serve_only:
        raise ValueError(f"--model={cfg.model}: the port's training lane "
                         "runs resnet50/101/152, gpt2/gpt2_medium and "
                         "bert_base/bert_large/bert_tiny")
    if cfg.fused_conv and not spec.fused_conv:
        raise ValueError(f"--fused_conv applies to the v1 bottleneck "
                         f"resnets, not {cfg.model}")
    if dev.type == "cuda":
        # the analog of XLA's autotuning: cuDNN picks its conv algorithms
        # for these fixed shapes during warmup
        torch.backends.cudnn.benchmark = True
    dtype = torch.bfloat16 if cfg.use_fp16 else torch.float32
    global_batch = cfg.batch_size * total_workers
    # a text model's spec comes back rescaled to --seq_len
    model, spec = create_model(
        cfg.model, dtype, cfg.attention_impl, device=dev, seed=cfg.seed,
        fused_conv=cfg.fused_conv, train=True, num_classes=cfg.num_classes,
        space_to_depth=cfg.use_space_to_depth, seq_len=cfg.seq_len)
    if spec.is_text:
        batch = tokens_to_device(SyntheticTokens(
            global_batch, spec.input_shape[0], seed=cfg.seed,
            vocab_size=spec.vocab_size, causal_lm=spec.causal_lm).batch(),
            dev)
    else:
        batch = to_device(SyntheticImages(
            global_batch, spec.input_shape, cfg.num_classes,
            cfg.seed).batch(), dev)
    state = step_mod.make_train_state(model, cfg)
    kind = hw.device_name(dev)
    for line in cfg.summary_lines():
        print_fn(line)
    print_fn(f"device_kind={kind} global_batch={global_batch}")

    for _ in range(cfg.num_warmup_batches):
        state, metrics = step_mod.train_step(state, batch)
    _sync(dev)
    clock = _StepClock(dev)
    clock.mark()
    t0 = t_window = time.perf_counter()
    for i in range(1, cfg.num_batches + 1):
        state, metrics = step_mod.train_step(state, batch)
        clock.mark()
        if i % cfg.display_every == 0:
            loss = float(metrics["loss"])           # waits for the device
            now = time.perf_counter()
            rate = cfg.display_every * global_batch / (now - t_window)
            t_window = now
            print_fn(f"{i}\timages/sec: {rate:.1f}\tloss: {loss:.3f}")
    final_loss = float(metrics["loss"])
    _sync(dev)
    total_s = time.perf_counter() - t0

    total_rate = cfg.num_batches * global_batch / total_s
    per_chip = total_rate / total_workers
    mean_ms = 1e3 * total_s / cfg.num_batches
    p50_ms = statistics.median(clock.step_ms())
    peak = hw.peak_flops(cfg.compute_dtype, dev)
    mfu = (3.0 * spec.flops_per_example * per_chip / peak if peak
           else float("nan"))
    result = BenchmarkResult(
        model=cfg.model, total_workers=total_workers,
        global_batch=global_batch, total_images_per_sec=total_rate,
        images_per_sec_per_chip=per_chip, mean_step_ms=mean_ms,
        p50_step_ms=p50_ms, p50_step_granularity=1, mfu=mfu,
        final_loss=final_loss, fabric=fabric, device_kind=kind,
        mfu_source="analytic" if peak else "no peak for this device",
        attention_impl=cfg.attention_impl, fused_xent=cfg.fused_xent)
    print_fn("-" * 40)
    print_fn(f"total images/sec: {total_rate:.2f}")
    mfu_txt = (f"{100 * mfu:.1f}% (analytic)" if peak
               else f"unknown (no peak for {kind})")
    print_fn(f"images/sec/chip: {per_chip:.2f}  step: {mean_ms:.2f}ms "
             f"(p50/step {p50_ms:.2f}ms)  MFU: {mfu_txt}")
    return result
