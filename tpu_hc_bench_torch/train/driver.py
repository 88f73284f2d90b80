"""The training benchmark driver: tf_cnn_benchmarks' measurement protocol.

The counterpart of the JAX package's ``train/driver.py``:
``num_warmup_batches`` untimed steps (cuDNN's algorithm search and the
allocator's warm-up fall there, as XLA's compile does in the JAX lane),
then ``num_batches`` timed steps, a line
``{step}\\t{units}/sec: {rate}\\tloss: {loss}`` every ``display_every``
steps, and a final ``total {units}/sec`` line, where ``units`` is
"examples" for the text, CTC and integer-input members and "images"
for the image members, as JAX's ``_example_units`` has it (the result's
keys keep JAX's names, ``total_images_per_sec`` and
``images_per_sec_per_chip``, for every member).  The step is the train
step, or with ``--forward_only`` the loss with no update; ``--eval``
runs ``_run_eval`` instead (at most 5 warmup batches, ``top_1`` display
lines, ``eval top_1 accuracy``).

Inputs (as JAX's driver wires them):

- **synthetic** (no ``--data_dir``): one fixed batch made once from
  ``--seed`` and fed every step, ``SyntheticImages`` for the image
  models, ``SyntheticTokens`` for the text models, ``SyntheticSpeech``
  for the CTC member and ``SyntheticIds`` for the id member (these two
  take no ``--data_dir``, and the CTC member no ``--eval``, as in JAX).
- **ImageNet TFRecords** (``--data_dir``, image models):
  ``data.imagenet.ImageNetDataset`` on this rank's shards (``worker =
  rank``), the train split with augmentation, or under ``--eval`` the
  validation split (when present) with the central crop; uint8 crops on
  the wire (``--wire_dtype``), normalized on the card
  (``step.prep_inputs``).  At world > 1 each rank decodes only its rows
  of the global batch (``decode_rows``); ``--full_batch_identity``
  decodes the whole batch and keeps the rank's rows, the control arm
  (the same pixels).  ``--datasets_repeat_cached_sample`` decodes 8
  batches, keeps them on the card, stops the decode pool and cycles
  them: the real-data step with the host taken out.
- **a token corpus** (``--data_dir``, text models):
  ``data.tokens.TokenDataset`` on ``<split>.bin``, this rank's stripe.
- **the host's input service** (``--input_service``; ``auto`` engages
  where several workers share one host, as JAX's ``_input_service_on``):
  rank 0 starts the host's decode pool in processes of its own, one a
  worker's stream (``data.service.ServiceProcess``), and each rank
  reads its own shared-memory ring (its rows only when sliced), every
  rank deriving the ring's name from a nonce rank 0 broadcasts; the
  stream is the per-process pipeline's, bit for bit.  The result's
  ``data`` says ``input_service`` and carries the ring's
  counters (on rank 0 the whole service's under ``service``).

Real batches reach the card through ``data.feed.DeviceFeeder`` (pinned
buffers, a copy stream, ``--prefetch_depth`` in flight); the host time
the step loop waits for its next batch is the result's
``data["input_wait_ms_per_step"]``, beside the decode pool's counters.
``--num_epochs`` sets ``num_batches`` to ``ceil(num_epochs x examples /
global_batch)`` over the split's shards.

Checkpoints (``--train_dir``, ``utils.checkpoint``; JAX's flow): the
latest complete checkpoint is restored before the first step (``--resume
auto|never|must``; ``--eval`` restores and raises on a ``--train_dir``
with none); training saves every ``--save_model_steps`` timed steps and
the final state after the timed window, async at world 1 under
``--async_checkpoint``, with ``--keep_checkpoints`` retention after each
save.  The result carries ``resume`` and ``checkpoint`` (the saves'
blocking milliseconds, the final state's fingerprint).

Data parallel: where a process group is up (the launcher starts one at a
world above one worker, and a one-rank group on the fast fabric at
world 1), ``total_workers`` is its world size and ``global_batch`` the
per-worker batch times that.  Every rank trains on its own rows, draws
its own dropout masks (``models.dropout_seed``), and steps through the
data-parallel arm of ``train/step.py``; only rank 0 prints.  Barriers
bracket the timed window, so "total images/sec" is the global batch over
the slowest rank's time, and ``images_per_sec_per_chip`` the total over
the world.  Without a group the step is the one-worker step (``sock``
at world 1).

Timing: the total is the host clock from the end of warmup to the
device's end of the last step.  Each timed step also records a CUDA
event after it, so the per-step median comes from device timestamps
without a host sync per step; the host waits for the device only at
display steps, where it reads the loss.  On the CPU (on request only)
the host clock marks the steps.  MFU is ``3 x flops_per_example x
images/s per card / peak`` (1 x forward-only and under eval), with the
card's published peak (``utils.hw``); a card without one reports MFU as
NaN.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import os
import statistics
import time
from typing import Callable, Iterator

import torch
import torch.distributed as dist

from tpu_hc_bench_torch import resolve_device
from tpu_hc_bench_torch.data.feed import DeviceFeeder
from tpu_hc_bench_torch.data.synthetic import (
    SyntheticIds, SyntheticImages, SyntheticSpeech, SyntheticTokens,
    ids_to_device, rank_rows, speech_to_device, to_device, tokens_to_device)
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
    forward_only: bool = False       # the loss with no update
    eval_top_1: float | None = None  # --eval: top-1 accuracy
    data: dict | None = None         # real data: the split, the decode
                                     # pool's counters (reader, decoder),
                                     # the input service's, the input
                                     # wait a step
    resume: dict | None = None       # --train_dir: the step restored
    checkpoint: dict | None = None   # --train_dir: the saves, the final
                                     # state's fingerprint
    extra: dict | None = None        # MoE members: the dispatch, the
                                     # last step's aux loss and
                                     # dropped-pair fraction

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


def _example_units(spec) -> str:
    """What the rate lines count (JAX ``_example_units``): "examples"
    for the text, CTC and integer-input members, else "images"."""
    if spec.is_text or spec.ctc or spec.integer_input:
        return "examples"
    return "images"


RANDOM_INIT_EVAL_WARNING = (
    "WARNING: --eval without --train_dir measures RANDOMLY INITIALIZED "
    "params — the accuracy line is meaningless; train with --train_dir "
    "first and pass it here")
REPEAT_CACHED_BATCHES = 8        # --datasets_repeat_cached_sample


def _maybe_restore(state, cfg: BenchmarkConfig, topo: dict | None,
                   rank: int, print_fn) -> dict | None:
    """--train_dir's resume (JAX ``_maybe_restore``): the latest complete
    checkpoint into ``state``, per ``--resume`` (auto: if there is one;
    never: a fresh start; must: raise if there is none), every rank from
    the same files; returns the resume record, None where nothing was
    restored.  Step directories without a sentinel are never restored,
    and never started over silently either: a warning names them."""
    if not cfg.train_dir or cfg.resume == "never":
        return None
    from pathlib import Path

    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    if ckpt.latest_step(cfg.train_dir) is None:
        orphans = [p.name for p in Path(cfg.train_dir).glob("step_*")
                   if p.is_dir() and not p.name.endswith(".tmp")]
        if orphans:
            print_fn(
                f"WARNING: {cfg.train_dir} has step dir(s) without a "
                f"commit sentinel ({', '.join(sorted(orphans)[:4])}"
                f"{'...' if len(orphans) > 4 else ''}): crashed saves — "
                f"verify and `touch <dir>/step_NNNNNNNN.complete` to "
                f"adopt; starting fresh")
        if cfg.resume == "must":
            raise FileNotFoundError(
                f"--resume=must: no complete checkpoint under "
                f"{cfg.train_dir}")
        return None
    saved = ckpt.read_topology(cfg.train_dir)
    if saved is not None:
        _, plan = ckpt.check_topology(saved, topo, cfg.train_dir)
        if plan:
            print_fn(f"resume: {plan}")
    ckpt.restore(state, cfg.train_dir, rank=rank)
    fp = ckpt.fingerprint(state.model.state_dict())
    print_fn(f"restored checkpoint step {state.step} from {cfg.train_dir}")
    print_fn(f"state fingerprint: {fp}")
    return {"restored_step": state.step,
            "saved_world": (saved or {}).get("world"),
            "live_world": topo["world"],
            "arm": (saved or {}).get("variable_update"),
            "fingerprint": fp}


def _require_checkpoint_for_eval(cfg: BenchmarkConfig, restored: bool,
                                 print_fn) -> None:
    """--eval's restore policy (JAX ``_require_checkpoint_for_eval``): a
    named --train_dir with no checkpoint raises; no --train_dir warns
    that random weights are measured."""
    if restored:
        return
    if cfg.train_dir:
        raise FileNotFoundError(
            f"--eval: no checkpoint found under {cfg.train_dir}")
    print_fn(RANDOM_INIT_EVAL_WARNING)


class _Saver:
    """--train_dir's saves during training (JAX ``save_now``): every
    --save_model_steps timed steps and at the end.  At world 1 with
    --async_checkpoint the write runs on the writer's thread and only
    the snapshot holds the loop; otherwise rank 0 snapshots and writes
    (every rank gathers the dropout states), and a barrier holds the ranks until the files are there.
    The retention pass follows each save."""

    def __init__(self, cfg: BenchmarkConfig, topo: dict, rank: int,
                 world: int, grouped: bool, print_fn):
        from tpu_hc_bench_torch.utils import checkpoint as ckpt

        self.ckpt, self.cfg, self.topo = ckpt, cfg, topo
        self.rank, self.grouped, self.print = rank, grouped, print_fn
        self.writer = (ckpt.AsyncCheckpointWriter(cfg.train_dir, print_fn)
                       if cfg.async_checkpoint and world == 1 else None)
        self.saves: list[dict] = []
        print_fn("checkpointing: "
                 + ("async (snapshot blocks, write overlapped, one in "
                    "flight)" if self.writer else
                    "sync (rank 0 snapshots and writes)"))

    def save(self, state) -> None:
        cfg, t0 = self.cfg, time.perf_counter()
        if self.writer is not None:
            self.writer.submit(state, gc_keep=cfg.keep_checkpoints,
                               topology=self.topo)
            self.print(f"checkpoint snapshot: step {state.step} "
                       f"({time.perf_counter() - t0:.3f}s blocking; write "
                       f"overlapped)")
        else:
            path = self.ckpt.save(state, cfg.train_dir, self.topo,
                                  write=self.rank == 0)
            if self.rank == 0:
                self.ckpt.gc_checkpoints(cfg.train_dir,
                                         cfg.keep_checkpoints,
                                         print_fn=self.print)
            if self.grouped:
                distributed.barrier()
            self.print(f"checkpoint saved: {path}")
        self.saves.append({"step": state.step, "async": bool(self.writer),
                           "blocking_ms":
                               1e3 * (time.perf_counter() - t0)})

    def finish(self, state) -> dict:
        """Land the write in flight; the result's ``checkpoint``
        record."""
        if self.writer is not None:
            self.writer.wait()
        return {"train_dir": self.cfg.train_dir, "saves": self.saves,
                "final_step": state.step,
                "fingerprint": self.ckpt.fingerprint(
                    state.model.state_dict())}


@dataclasses.dataclass
class _Input:
    """What feeds the step loop: ``batches`` (device batches, endless),
    the dataset behind them (None for synthetic input), ``data`` (the
    result's record, None for synthetic input) and ``close``."""

    batches: Iterator
    dataset: object = None
    data: dict | None = None
    close: Callable[[], None] = lambda: None


def _split(cfg: BenchmarkConfig, spec) -> str | None:
    """The real-data split, resolved once: train, or under --eval the
    validation split where the data has one; None for synthetic input."""
    if cfg.data_dir is None:
        return None
    if not cfg.eval:
        return "train"
    try:
        if spec.is_text:
            from tpu_hc_bench_torch.data.tokens import _resolve

            _resolve(cfg.data_dir, "validation")
        else:
            from tpu_hc_bench_torch.data.imagenet import find_shards

            find_shards(cfg.data_dir, "validation")
        return "validation"
    except FileNotFoundError:
        return "train"


def _resolve_epochs(cfg: BenchmarkConfig, spec, split: str | None,
                    global_batch: int, print_fn) -> None:
    """--num_epochs: ``num_batches = ceil(num_epochs x examples /
    global_batch)`` over every shard of the split; cleared afterwards,
    so ``cfg`` stays re-resolvable (as JAX's driver)."""
    if not cfg.num_epochs:
        return
    if split is None or spec.is_text:
        raise ValueError(
            "--num_epochs needs a real image dataset (--data_dir): "
            "synthetic and text inputs are endless streams with no "
            "epoch size; use --num_batches")
    from tpu_hc_bench_torch.data.imagenet import count_examples

    examples = count_examples(cfg.data_dir, split)
    cfg.num_batches = math.ceil(cfg.num_epochs * examples / global_batch)
    print_fn(f"num_epochs={cfg.num_epochs} ({examples} examples) -> "
             f"num_batches={cfg.num_batches} (global_batch={global_batch})")
    cfg.num_epochs = 0.0


def _check_synthetic_only(cfg: BenchmarkConfig, spec) -> None:
    """JAX's refusals for the members with synthetic input only: the CTC
    member's and the id member's ``--data_dir``, the CTC member's
    ``--eval``."""
    if spec.ctc or spec.integer_input:
        if cfg.data_dir is not None:
            what = ("synthetic spectrograms" if spec.ctc
                    else "synthetic implicit-feedback pairs")
            raise ValueError(f"--data_dir is not supported for {cfg.model} "
                             f"({what} only)")
    if spec.ctc and cfg.eval:
        raise ValueError("--eval is not supported for the CTC member "
                         "(decode/CER is outside the benchmark protocol)")


def _synthetic_input(cfg, spec, dev, rank: int, global_batch: int,
                     model) -> _Input:
    """One fixed batch on the card: tokens, spectrograms with CTC
    transcripts (labels bounded by the frames after the conv strides),
    (user, item) ids over ``model``'s tables, or images."""
    rows = functools.partial(rank_rows, rank=rank, rows=cfg.batch_size)
    if spec.is_text:
        batch = tokens_to_device(rows(SyntheticTokens(
            global_batch, spec.input_shape[0], seed=cfg.seed,
            vocab_size=spec.vocab_size, causal_lm=spec.causal_lm).batch()),
            dev)
    elif spec.ctc:
        from tpu_hc_bench_torch.models.deepspeech import max_label_for

        frames, freq = spec.input_shape
        batch = speech_to_device(rows(SyntheticSpeech(
            global_batch, frames, freq, max_label_for(frames),
            seed=cfg.seed).batch()), dev)
    elif spec.integer_input:
        batch = ids_to_device(rows(SyntheticIds(
            global_batch, model.num_users, model.num_items,
            seed=cfg.seed).batch()), dev)
    else:
        batch = to_device(rows(SyntheticImages(
            global_batch, spec.input_shape, cfg.num_classes,
            cfg.seed).batch()), dev)
    return _Input(itertools.repeat(batch))


def _input_service_on(cfg: BenchmarkConfig, world: int,
                      local_workers: int) -> bool:
    """``--input_service`` against the world's shape (JAX
    ``_input_service_on``): ``auto`` engages where more than one worker
    shares one host; ``on`` with workers on several hosts raises (one
    ring set a host); never under --datasets_repeat_cached_sample or
    --eval (``resolve`` turned an explicit ``on`` off for those)."""
    if cfg.input_service == "off":
        return False
    if cfg.datasets_repeat_cached_sample or cfg.eval:
        return False
    one_host = local_workers >= world
    if cfg.input_service == "on":
        if world > 1 and not one_host:
            raise ValueError(
                "--input_service=on requires all workers on one host "
                "(one shared-memory ring set per host); multi-host runs "
                "start one service per host via their own local launch")
        return True
    return world > 1 and one_host


def _service_nonce(world: int) -> int:
    """A name part every rank shares: rank 0's pid and clock, broadcast
    over the process group, so a relaunch never attaches to a crashed
    run's segments and two runs on one host stay apart."""
    nonce = [os.getpid() * 1000 + (time.monotonic_ns() // 1000) % 1000]
    if world > 1:
        dist.broadcast_object_list(nonce, src=0)
    return int(nonce[0])


def _service_input(cfg, spec, dev, rank: int, world: int,
                   global_batch: int, split: str, sliced: bool,
                   rows: tuple[int, int], print_fn) -> _Input:
    """The host's shared input service (``data.service``): rank 0 starts
    the owner, one process a worker's stream with the host's decode
    budget split over them; each rank reads its own ring (its rows only
    when ``sliced``) through the feeder.  JAX's driver runs the owner's
    threads in rank 0's process; here they run in processes of their
    own: eager PyTorch's step loop needs the GIL for each kernel launch,
    and on four cards the pool in rank 0's process held every rank to
    0.38 of the per-process pipelines' images/s, one owner process to
    0.45 (``PERF.md`` §6)."""
    from tpu_hc_bench_torch import native
    from tpu_hc_bench_torch.data import service as service_mod

    image_size = spec.input_shape[0]
    depth = max(2, cfg.prefetch_depth)
    name = service_mod.service_name(
        cfg.data_dir, split, cfg.seed, global_batch, image_size,
        cfg.wire_dtype, cfg.model, cfg.train_dir or "",
        "sliced" if sliced else "full", _service_nonce(world))
    svc = None
    if rank == 0:
        svc = service_mod.ServiceProcess(dict(
            data_dirs=[cfg.data_dir], num_workers=world,
            global_batch=global_batch, image_size=image_size, split=split,
            train=not cfg.eval, seed=cfg.seed, wire_dtype=cfg.wire_dtype,
            decode_workers=cfg.service_decode_workers, depth=depth,
            name=name, slice_per_worker=sliced))
        print_fn(f"decode pool: input service {name}: host decode pool "
                 f"{svc.decode_workers} thread(s) in {world} process(es) "
                 f"of its own serving {world} worker(s) over shared-memory "
                 f"rings (depth {depth}; "
                 f"decoder={native.jpeg_decoder().name}"
                 + (f"; sliced rings: each worker's ring carries only its "
                    f"{global_batch // world} rows" if sliced else "")
                 + ")")
    try:
        # copy=True: the feeder thread copies each batch on while the
        # next is read; a stall of 10 minutes means a dead service
        client = service_mod.ServiceClient(
            name, service_mod.image_batch_layout(
                global_batch // world if sliced else global_batch,
                image_size, cfg.wire_dtype),
            worker=rank, depth=depth, copy=True, stall_timeout_s=600.0)
    except BaseException:
        if svc is not None:
            svc.stop()
        raise

    def my_rows():
        for b in client:
            yield b if sliced else tuple(a[rows[0]:rows[1]] for a in b)

    feeder = DeviceFeeder(my_rows(), dev, cfg.prefetch_depth)

    def close():
        feeder.close()
        client.close()
        if svc is not None:
            svc.stop()

    data = {"split": split, "wire_dtype": cfg.wire_dtype,
            "sliced_rows": list(rows) if sliced else None,
            "repeat_cached_sample": False, "input_service": True,
            "reader": "native",
            "decoder": native.jpeg_decoder().name if svc else None}
    return _Input(iter(feeder), _ServiceStats(client, svc), data, close)


class _ServiceStats:
    """The result's counters under the service: this rank's ring, and on
    rank 0 the whole service's under ``service``."""

    def __init__(self, client, svc):
        self.client, self.svc = client, svc

    def stats(self) -> dict:
        rec = self.client.stats()
        if self.svc is not None:
            rec["service"] = self.svc.stats()
        return rec


def _image_input(cfg, spec, dev, rank: int, world: int, global_batch: int,
                 split: str, local_workers: int, print_fn) -> _Input:
    """ImageNet TFRecords: this rank's shards, its rows of each global
    batch (decoded alone unless --full_batch_identity), through the
    feeder, from this process's decode pool or the host's input service;
    or --datasets_repeat_cached_sample's 8 batches on the card."""
    from tpu_hc_bench_torch.data.imagenet import ImageNetDataset

    rows = (rank * cfg.batch_size, (rank + 1) * cfg.batch_size)
    sliced = world > 1 and not cfg.full_batch_identity
    if _input_service_on(cfg, world, local_workers):
        return _service_input(cfg, spec, dev, rank, world, global_batch,
                              split, sliced, rows, print_fn)
    ds = ImageNetDataset(
        cfg.data_dir, global_batch=global_batch,
        image_size=spec.input_shape[0], split=split, train=not cfg.eval,
        worker=rank, num_workers=world, seed=cfg.seed,
        prefetch=cfg.prefetch_depth, wire_dtype=cfg.wire_dtype,
        decode_workers=cfg.datasets_num_private_threads,
        local_workers=local_workers, decode_rows=rows if sliced else None)
    print_fn(f"decode pool: {ds.decode_workers} thread(s)/worker "
             f"({local_workers} local worker(s) share {os.cpu_count()} host "
             f"CPUs; per-process pipeline, input_service="
             f"{cfg.input_service}; reader={ds.reader} "
             f"decoder={ds.decoder}"
             + (f"; sliced: decoding rows [{rows[0]}, {rows[1]})"
                if sliced else "")
             + (f"; full batch, keeping rows [{rows[0]}, {rows[1]})"
                if world > 1 and not sliced else "") + ")")
    host = iter(ds)

    def my_rows():
        try:
            for b in host:
                yield tuple(a[rows[0]:rows[1]] for a in b)
        finally:
            host.close()

    feeder = DeviceFeeder(my_rows(), dev, cfg.prefetch_depth)
    data = {"split": split, "wire_dtype": cfg.wire_dtype,
            "sliced_rows": list(rows) if sliced else None,
            "repeat_cached_sample": cfg.datasets_repeat_cached_sample,
            "input_service": False}
    if not cfg.datasets_repeat_cached_sample:
        return _Input(iter(feeder), ds, data, feeder.close)
    stream = iter(feeder)
    cached = list(itertools.islice(stream, REPEAT_CACHED_BATCHES))
    stream.close()
    feeder.close()                 # the decode pool stops here
    print_fn(f"repeat_cached_sample: {len(cached)} real batches decoded "
             "once, on the card, cycled per step")
    return _Input(itertools.cycle(cached), ds, data)


def _token_input(cfg, spec, dev, rank: int, world: int, global_batch: int,
                 split: str) -> _Input:
    """A token corpus: this rank's stripe; as JAX's multi-process arm,
    each rank draws a global batch from its stripe and keeps its rows."""
    from tpu_hc_bench_torch.data.tokens import TokenDataset

    ds = TokenDataset(cfg.data_dir, global_batch, spec.input_shape[0],
                      split=split, causal_lm=spec.causal_lm, worker=rank,
                      num_workers=world, seed=cfg.seed,
                      vocab_size=spec.vocab_size)
    feeder = DeviceFeeder((rank_rows(b, rank, cfg.batch_size) for b in ds),
                          dev, cfg.prefetch_depth)
    return _Input(iter(feeder), ds, {"split": split, "reader": "memmap"},
                  feeder.close)


def _run_eval(cfg, spec, state, inp: _Input, global_batch: int,
              total_workers: int, dev, kind: str, fabric: str,
              grouped: bool, print_fn) -> BenchmarkResult:
    """tf_cnn_benchmarks --eval (JAX ``_run_eval``): at most 5 warmup
    batches, then ``num_batches`` timed forward passes with running
    statistics; top-1 over every timed example."""
    state.model.eval()
    for _ in range(max(1, min(cfg.num_warmup_batches, 5))):
        loss, _ = step_mod.eval_step(state, next(inp.batches))
    _sync(dev)
    if grouped:
        distributed.barrier()
    clock = _StepClock(dev)
    clock.mark()
    corrects = []
    wait_s = 0.0
    t0 = time.perf_counter()
    for i in range(1, cfg.num_batches + 1):
        t_in = time.perf_counter()
        batch = next(inp.batches)
        wait_s += time.perf_counter() - t_in
        loss, correct = step_mod.eval_step(state, batch)
        corrects.append(correct)
        clock.mark()
        if i % cfg.display_every == 0:
            top1 = float(torch.stack(corrects).sum()) / (i * global_batch)
            print_fn(f"{i}\ttop_1: {top1:.4f}\tloss: {float(loss):.3f}")
    final_loss = float(loss)
    _sync(dev)
    if grouped:
        distributed.barrier()
    total_s = time.perf_counter() - t0
    top1 = float(torch.stack(corrects).sum()) / (cfg.num_batches
                                                 * global_batch)
    total_rate = cfg.num_batches * global_batch / total_s
    per_chip = total_rate / total_workers
    peak = hw.peak_flops(cfg.compute_dtype, dev)
    result = BenchmarkResult(
        model=cfg.model, total_workers=total_workers,
        global_batch=global_batch, total_images_per_sec=total_rate,
        images_per_sec_per_chip=per_chip,
        mean_step_ms=1e3 * total_s / cfg.num_batches,
        p50_step_ms=statistics.median(clock.step_ms()),
        p50_step_granularity=1,
        mfu=(spec.flops_per_example * per_chip / peak if peak
             else float("nan")),
        final_loss=final_loss, fabric=fabric, device_kind=kind,
        mfu_source="analytic" if peak else "no peak for this device",
        attention_impl=cfg.attention_impl, fused_xent=cfg.fused_xent,
        variable_update=cfg.variable_update,
        overlap_grad_comm=cfg.overlap_grad_comm, eval_top_1=top1,
        data=_data_record(inp, wait_s, cfg.num_batches))
    print_fn("-" * 40)
    print_fn(f"eval top_1 accuracy: {top1:.4f}")
    print_fn(f"total {_example_units(spec)}/sec: {total_rate:.2f}")
    return result


def _extra(cfg: BenchmarkConfig, model) -> dict | None:
    """An MoE model's dispatch, last aux loss and dropped fraction (read
    once, after the timed window); None for the other models."""
    if not getattr(model, "num_experts", 0):
        return None
    rec = {"moe_impl": cfg.moe_impl}
    for key, attr in (("moe_aux_loss", "aux_loss"),
                      ("moe_drop_fraction", "moe_dropped")):
        t = getattr(model, attr, None)
        rec[key] = None if t is None else float(t)
    return rec


def _data_record(inp: _Input, wait_s: float, steps: int) -> dict | None:
    if inp.data is None:
        return None
    rec = dict(inp.data)
    if hasattr(inp.dataset, "stats"):
        rec.update(inp.dataset.stats())
    rec["input_wait_s"] = wait_s
    rec["input_wait_ms_per_step"] = 1e3 * wait_s / steps
    return rec


def run_benchmark(cfg: BenchmarkConfig, *, fabric: str = "sock",
                  print_fn: Callable[[str], None] = print,
                  local_workers: int = 1) -> BenchmarkResult:
    """Train ``cfg.model`` (or run it forward-only, or evaluate it) on
    synthetic or real data and measure it: data parallel over the default
    process group where one is up, else on one worker.  Every rank
    returns the result; only rank 0 prints.  ``local_workers``: the
    workers on this host, who share its decode budget."""
    fab = resolve_fabric(fabric)
    step_mod.check_arm(cfg, fab)
    grouped = dist.is_initialized()
    total_workers = dist.get_world_size() if grouped else 1
    rank = distributed.rank()
    if not distributed.is_coordinator():
        print_fn = lambda _m: None                           # noqa: E731
    dev = resolve_device(cfg.device)
    spec = get_model_spec(cfg.model)
    _check_synthetic_only(cfg, spec)
    if cfg.fused_conv and not spec.fused_conv:
        raise ValueError(f"--fused_conv applies to the v1 bottleneck "
                         f"resnets, not {cfg.model}")
    if cfg.datasets_repeat_cached_sample and (cfg.data_dir is None
                                              or spec.is_text):
        raise ValueError(
            "--datasets_repeat_cached_sample needs a real image dataset "
            "(--data_dir with TFRecord shards); it is meaningless for "
            "synthetic input and unsupported for text corpora")
    if dev.type == "cuda":
        # the analog of XLA's autotuning: cuDNN picks its conv algorithms
        # for these fixed shapes during warmup
        torch.backends.cudnn.benchmark = True
    dtype = torch.bfloat16 if cfg.use_fp16 else torch.float32
    global_batch = cfg.batch_size * total_workers
    split = _split(cfg, spec)
    _resolve_epochs(cfg, spec, split, global_batch, print_fn)
    # a text model's spec comes back rescaled to --seq_len
    model, spec = create_model(
        cfg.model, dtype, cfg.attention_impl, device=dev, seed=cfg.seed,
        fused_conv=cfg.fused_conv, train=True, num_classes=cfg.num_classes,
        space_to_depth=cfg.use_space_to_depth, seq_len=cfg.seq_len,
        rank=rank, gradient_checkpointing=cfg.gradient_checkpointing,
        scan_layers=cfg.scan_layers, moe_impl=cfg.moe_impl,
        moe_capacity_factor=cfg.moe_capacity_factor,
        moe_f_chunk=cfg.moe_f_chunk, rnn_impl=cfg.rnn_impl)
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
    topo = None
    if cfg.train_dir:
        from tpu_hc_bench_torch.utils import checkpoint as ckpt

        topo = ckpt.topology_record(total_workers, cfg)
    try:
        resume = _maybe_restore(state, cfg, topo, rank, print_fn)
        if cfg.eval:
            _require_checkpoint_for_eval(cfg, resume is not None, print_fn)
    except BaseException:
        if grads:
            grads.close()
        raise
    if split is None:
        inp = _synthetic_input(cfg, spec, dev, rank, global_batch, model)
    elif spec.is_text:
        inp = _token_input(cfg, spec, dev, rank, total_workers,
                           global_batch, split)
    else:
        inp = _image_input(cfg, spec, dev, rank, total_workers,
                           global_batch, split, local_workers, print_fn)
    try:
        if cfg.eval:
            result = _run_eval(cfg, spec, state, inp, global_batch,
                               total_workers, dev, kind, fabric, grouped,
                               print_fn)
        else:
            saver = (_Saver(cfg, topo, rank, total_workers, grouped,
                            print_fn) if cfg.train_dir else None)
            result = _run_train(cfg, spec, state, inp, global_batch,
                                total_workers, dev, kind, fabric, grouped,
                                print_fn, saver)
        result.resume = resume
        return result
    finally:
        inp.close()
        if grads:
            grads.close()


def _run_train(cfg, spec, state, inp: _Input, global_batch: int,
               total_workers: int, dev, kind: str, fabric: str,
               grouped: bool, print_fn,
               saver: _Saver | None = None) -> BenchmarkResult:
    """The warmup and the timed steps of the train (or forward-only)
    step; with a ``saver`` (--train_dir) a save every --save_model_steps
    timed steps (inside the timed window: it holds the loop) and one of
    the final state after it."""
    step_fn = (step_mod.forward_step if cfg.forward_only
               else step_mod.train_step)
    units = _example_units(spec)
    for _ in range(cfg.num_warmup_batches):
        state, metrics = step_fn(state, next(inp.batches))
    _sync(dev)
    if grouped:
        distributed.barrier()
    clock = _StepClock(dev)
    clock.mark()
    wait_s = 0.0
    t0 = t_window = time.perf_counter()
    for i in range(1, cfg.num_batches + 1):
        t_in = time.perf_counter()
        batch = next(inp.batches)
        wait_s += time.perf_counter() - t_in
        state, metrics = step_fn(state, batch)
        clock.mark()
        if i % cfg.display_every == 0:
            loss = float(metrics["loss"])           # waits for the device
            now = time.perf_counter()
            rate = cfg.display_every * global_batch / (now - t_window)
            t_window = now
            print_fn(f"{i}\t{units}/sec: {rate:.1f}\tloss: {loss:.3f}")
        if (saver is not None and cfg.save_model_steps
                and i % cfg.save_model_steps == 0 and i < cfg.num_batches):
            saver.save(state)
    final_loss = float(metrics["loss"])
    _sync(dev)
    if grouped:
        distributed.barrier()
    total_s = time.perf_counter() - t0
    checkpoint = None
    if saver is not None:
        saver.save(state)               # the final state
        checkpoint = saver.finish(state)

    total_rate = cfg.num_batches * global_batch / total_s
    per_chip = total_rate / total_workers
    mean_ms = 1e3 * total_s / cfg.num_batches
    p50_ms = statistics.median(clock.step_ms())
    peak = hw.peak_flops(cfg.compute_dtype, dev)
    flops_mult = 1.0 if cfg.forward_only else 3.0
    mfu = (flops_mult * spec.flops_per_example * per_chip / peak if peak
           else float("nan"))
    grads = state.dp.grads if state.dp else None
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
        allreduce_per_step=state.dp.allreduce_calls if state.dp else 0,
        forward_only=cfg.forward_only,
        data=_data_record(inp, wait_s, cfg.num_batches),
        checkpoint=checkpoint, extra=_extra(cfg, state.model))
    print_fn("-" * 40)
    print_fn(f"total {units}/sec: {total_rate:.2f}")
    mfu_txt = (f"{100 * mfu:.1f}% (analytic)" if peak
               else f"unknown (no peak for {kind})")
    print_fn(f"{units}/sec/chip: {per_chip:.2f}  step: {mean_ms:.2f}ms "
             f"(p50/step {p50_ms:.2f}ms)  MFU: {mfu_txt}")
    if result.data is not None:
        print_fn(f"input wait: {result.data['input_wait_ms_per_step']:.3f}"
                 " ms/step")
    return result
