"""The training benchmark driver: tf_cnn_benchmarks' measurement protocol.

The counterpart of the JAX package's ``train/driver.py``:
``num_warmup_batches`` untimed steps (cuDNN's algorithm search and the
allocator's warm-up fall there, as XLA's compile does in the JAX lane),
then ``num_batches`` timed steps on one fixed synthetic batch, a line
``{step}\\timages/sec: {rate}\\tloss: {loss}`` every ``display_every``
steps, and a final ``total images/sec`` line.  Image models train on
``SyntheticImages``; text models (gpt2 and gpt2_medium next-token,
bert_base, bert_large and bert_tiny masked-LM) on one ``SyntheticTokens``
batch, whose "images" are sequences, as in the JAX lane.  The result
states the text arm's routes, ``attention_impl`` and ``fused_xent``.

Data parallel: where a process group is up (the launcher starts one at a
world above one worker, and a one-rank group on the fast fabric at
world 1), ``total_workers`` is its world size and ``global_batch`` the
per-worker batch times that.  Every rank builds the one global batch
from ``--seed`` and trains on its own rows, draws its own dropout masks
(``models.dropout_seed``), and steps through the data-parallel arm of
``train/step.py``; only rank 0 prints.  Barriers bracket the timed
window, so "total images/sec" is the global batch over the slowest
rank's time, and ``images_per_sec_per_chip`` the total over the world.
Without a group the step is the one-worker step (``sock`` at world 1).

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
import torch.distributed as dist

from tpu_hc_bench_torch import resolve_device
from tpu_hc_bench_torch.data.synthetic import (
    SyntheticImages, SyntheticTokens, rank_rows, to_device,
    tokens_to_device)
from tpu_hc_bench_torch.flags import BenchmarkConfig
from tpu_hc_bench_torch.models import create_model, get_model_spec
from tpu_hc_bench_torch.parallel import distributed
from tpu_hc_bench_torch.parallel.fabric import resolve_fabric
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
    variable_update: str = "psum"    # psum | replicated
    overlap_grad_comm: str = "on"
    gradient_accumulation_steps: int = 1
    grad_buckets: int = 0            # the fast fabric's gradient buckets
    allreduce_per_step: int = 0      # all-reduce calls a step (0: one
                                     # worker; 1: the host round trip)

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


def run_benchmark(cfg: BenchmarkConfig, *, fabric: str = "sock",
                  print_fn: Callable[[str], None] = print,
                  ) -> BenchmarkResult:
    """Train ``cfg.model`` on synthetic data and measure it: data
    parallel over the default process group where one is up, else on
    one worker.  Every rank returns the result; only rank 0 prints."""
    fab = resolve_fabric(fabric)
    step_mod.check_arm(cfg, fab)
    grouped = dist.is_initialized()
    total_workers = dist.get_world_size() if grouped else 1
    rank = distributed.rank()
    if not distributed.is_coordinator():
        print_fn = lambda _m: None                           # noqa: E731
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
        space_to_depth=cfg.use_space_to_depth, seq_len=cfg.seq_len,
        rank=rank)
    if spec.is_text:
        batch = tokens_to_device(rank_rows(SyntheticTokens(
            global_batch, spec.input_shape[0], seed=cfg.seed,
            vocab_size=spec.vocab_size, causal_lm=spec.causal_lm).batch(),
            rank, cfg.batch_size), dev)
    else:
        batch = to_device(rank_rows(SyntheticImages(
            global_batch, spec.input_shape, cfg.num_classes,
            cfg.seed).batch(), rank, cfg.batch_size), dev)
    state = step_mod.make_train_state(model, cfg, fab if grouped else None)
    grads = state.dp.grads if state.dp else None
    kind = hw.device_name(dev)
    for line in cfg.summary_lines():
        print_fn(line)
    print_fn(f"device_kind={kind} global_batch={global_batch}")
    if grouped:
        print_fn(f"data parallel: total_workers={total_workers} "
                 f"fabric={fab.value} backend={dist.get_backend()} "
                 f"grad_buckets={len(grads.buckets) if grads else 0}")

    for _ in range(cfg.num_warmup_batches):
        state, metrics = step_mod.train_step(state, batch)
    _sync(dev)
    if grouped:
        distributed.barrier()
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
    if grouped:
        distributed.barrier()
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
        attention_impl=cfg.attention_impl, fused_xent=cfg.fused_xent,
        variable_update=cfg.variable_update,
        overlap_grad_comm=cfg.overlap_grad_comm,
        gradient_accumulation_steps=cfg.gradient_accumulation_steps,
        grad_buckets=len(grads.buckets) if grads else 0,
        allreduce_per_step=state.dp.allreduce_calls if state.dp else 0)
    if grads:
        grads.close()
    print_fn("-" * 40)
    print_fn(f"total images/sec: {total_rate:.2f}")
    mfu_txt = (f"{100 * mfu:.1f}% (analytic)" if peak
               else f"unknown (no peak for {kind})")
    print_fn(f"images/sec/chip: {per_chip:.2f}  step: {mean_ms:.2f}ms "
             f"(p50/step {p50_ms:.2f}ms)  MFU: {mfu_txt}")
    return result
