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

Sequence parallelism (``--sequence_parallel``, or a sequence-sharded
impl on the degenerate seq axis; JAX's ``sp_active``): the world is a
(data, seq) mesh of process groups (``distributed.build_mesh``), the
text model shards its sequence over its seq group, and each rank feeds
its data group's rows and its seq group's slice of each sequence
(``data.synthetic.seq_slice``).  The global batch counts sequences:
the per-worker batch times the world over ``sp``, so the
``examples/sec`` line counts sequences, not shards.  The gradients,
the loss and the statistics are averaged over the whole world (both
axes), as JAX's ``(data, seq)`` step.  The host fabric is refused under
any sharded impl, the degenerate one included, as in JAX.

Tensor and expert parallelism (``--model_parallel``, ``--expert_parallel``;
JAX's GSPMD arm): the world is a (data, model) mesh, a model group of
consecutive ranks; the model is built whole from the seed on every rank
and cut (``parallel.tensor.shard_model_``); the ranks of a model group
read their data group's rows and draw one dropout stream (seeded by the
group's first rank, ``_dropout_rank``), and the global batch counts the
data groups' rows (``world x batch / max(tp, ep)``).  A checkpoint holds
the full tree (gathered on save, cut on restore), so it resumes under
another tp or none.  JAX's refusals: a host fabric, ``--scan_layers``, a
degree that does not divide the world, a model with no split parameter.

Pipeline parallelism (``--pipeline_parallel``, ``--num_microbatches``;
JAX's PP arm): the world is a (data, pipe) mesh, or (data, pipe, model)
under DP x PP x TP; a rank builds only its stage's layers
(``create_model(pipeline=)``) with the whole embedding and head, trains
through ``parallel.pipeline``'s GPipe schedule of M microbatches
(default ``2 x pp`` where the batch divides, else ``pp``), reads its
data group's rows (every stage of a pipe group the same rows) and draws
its own dropout stream (the first rank of its model group's).  The
banner reads ``pipeline: {pp} stages x {M} microbatches ({L/pp}
layers/stage)``, under TP ``tensor parallel: {tp}-way (hybrid with
PP)``.  On one host a checkpoint is DP's host layout (the stages
gathered on save, cut on restore), so PP and DP resume each other's;
on several, the pp-native layout (``checkpoint.save_pp``).  JAX's
refusals: a model with no PP interface, layers or a per-worker batch
the stages or microbatches do not divide, ``--scan_layers``.  DP x SP x
TP (``--sequence_parallel`` with ``--model_parallel``): the (data, seq,
model) mesh, the model cut over its model group, the sequence over its
seq group (``heads / tp`` heads a rank; Ulysses needs ``heads / tp`` and
``kv_heads / tp`` divisible by ``sp``, checked before the first step),
the banner ``tensor parallel: {tp}-way (hybrid with SP)``.

Multislice (``dcn``; JAX's round 3): ``--num_slices`` (default one a
host) splits the data axis into ``(dcn, data)``, every sum over it is
hierarchical, and the banner reads ``multislice: N slices x ... — data
axis = dcn(N) x data(M)``; ``--num_slices`` on another fabric and a
model axis under multislice are refused, as in JAX.

Elastic resume (``--resume=elastic``; JAX's ``_maybe_restore``): a
checkpoint whose topology sidecar differs from the live world is placed
by ``checkpoint.elastic_plan``; the plan is printed as ``elastic
resume: <plan>``, a zero1 state saved at another world is resplit for
this one (``restore_elastic``), and the result's ``resume`` says
``elastic``.  Without the flag such a resume raises, naming both sides.

Guards and observability (JAX's driver; ``_run_train``): the
``--inject_fault`` plan fires before each timed step; SIGTERM/SIGINT is a
flag honored at a step boundary (the ranks agree at sync-window
boundaries), then one synchronous emergency save to ``--train_dir``, its
``state fingerprint:`` line and ``PreemptedError`` (exit 75); the
``--step_timeout_s`` watchdog reads the step clock's CUDA events from its
thread and ends a run with no step done within it (exit 70); the
non-finite guard's counters (``--on_nonfinite``) are read once a sync
window, one window late, and settled before every save and at the end
(``skip``: the step dropped the update; ``rewind``: the last complete
checkpoint is restored and a window of batches skipped; ``abort``: a
non-finite display loss fails the run); ``--max_bad_steps`` ends a
poisoned run.  Under ``--metrics_dir`` rank 0 writes the stream (the
goodput ledger's phases, windows, memory samples, stragglers, the
resilience events, the summary) and every rank its heartbeats and spans
once a sync window; ``--trace_dir``/``--profile_steps`` profile a window
of timed steps; ``--hbm_budget`` is checked against the first warmup
step's allocator peak, and the MFU probe counts that step's operations
(``obs.efficiency.probe_step_flops``), both outside the timed window.

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

import contextlib
import dataclasses
import functools
import itertools
import math
import os
import statistics
import threading
import time
from typing import Callable, Iterator

import torch
import torch.distributed as dist

from tpu_hc_bench_torch import resolve_device
from tpu_hc_bench_torch.data.feed import DeviceFeeder
from tpu_hc_bench_torch.data.synthetic import (
    SyntheticIds, SyntheticImages, SyntheticSpeech, SyntheticTokens,
    ids_to_device, rank_rows, seq_slice, speech_to_device, to_device,
    tokens_to_device)
from tpu_hc_bench_torch.flags import BenchmarkConfig
from tpu_hc_bench_torch.models import create_model, get_model_spec
from tpu_hc_bench_torch.parallel import distributed, tensor
from tpu_hc_bench_torch.parallel.fabric import Fabric, resolve_fabric
from tpu_hc_bench_torch.train import step as step_mod
from tpu_hc_bench_torch.utils import hw
from tpu_hc_bench_torch.utils.sync import drain


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
    variable_update: str = "psum"    # psum | replicated | zero1
    sequence_parallel: int = 1       # seq shards a seq group
    model_parallel: int = 1          # TP: ranks a model group
    pipeline_parallel: int = 1       # PP: stages a pipe group
    num_microbatches: int = 0        # PP: GPipe microbatches a step
    expert_parallel: int = 1         # EP: ranks a model group
    num_slices: int = 1              # multislice: slices of the data axis
    overlap_grad_comm: str = "on"
    gradient_accumulation_steps: int = 1
    grad_buckets: int = 0            # the fast fabric's gradient buckets
    allreduce_per_step: int = 0      # all-reduce calls a step (0: one
                                     # worker; 1: the host round trip)
    forward_only: bool = False       # the loss with no update
    optimizer_state_bytes: int = 0   # this rank's optimizer state (zero1:
                                     # its shards' only)
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
    goodput: float = float("nan")    # the ledger (obs.goodput): productive
                                     # step seconds / wall seconds
    goodput_phases: dict | None = None   # phase -> wall seconds (zero
                                         # phases omitted)
    peak_hbm_bytes: int | None = None    # the memory ledger's high water
    hbm_bytes_limit: int | None = None
    mem_source: str | None = None

    def json_line(self) -> dict:
        """The fields as a dict for strict JSON: NaN (no MFU) is None."""
        return {k: None if isinstance(v, float) and math.isnan(v) else v
                for k, v in dataclasses.asdict(self).items()}


class _StepClock:
    """End-of-step marks: CUDA events on the card, the host clock on the
    CPU (where every op has finished when it returns).

    ``done()`` is the progress oracle of the watchdog, the trace window
    and the heartbeats: the newest mark the device has reached and the
    host time it was first seen reached, found by querying the events
    (``cudaEventQuery``, no sync) from the newest known-done mark on; it
    may run on another thread than the loop's."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []
        self._done = -1                 # index of the newest done mark
        self._done_t: float | None = None
        self._lock = threading.Lock()

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def done(self) -> tuple[int, float | None]:
        """``(marks done, host time the newest was seen done)``: the
        count includes the window's opening mark."""
        with self._lock:
            n = len(self.marks)
            j = self._done
            if not self.cuda:
                j = n - 1
            else:
                while j + 1 < n and self.marks[j + 1].query():
                    j += 1
            if j > self._done:
                self._done = j
                self._done_t = (self.marks[j] if not self.cuda
                                else time.perf_counter())
            return self._done + 1, self._done_t

    def wait(self, k: int) -> None:
        """Block until mark ``k`` (0: the window's start) is done."""
        if self.cuda and 0 <= k < len(self.marks):
            self.marks[k].synchronize()

    def step_ms(self) -> list[float]:
        """Per-interval milliseconds (after the device has synced)."""
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [1e3 * (b - a) for a, b in pairs]


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
    never: a fresh start; must: raise if there is none; elastic: as must,
    and a zero1 state saved at another world is resplit for this one),
    every rank from the same files, its topology sidecar checked against
    the live one first (``elastic_plan``, whose line is printed); returns
    the resume record, None where nothing was restored.  Step
    directories without a sentinel are never restored,
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
        if cfg.resume in ("must", "elastic"):
            raise FileNotFoundError(
                f"--resume={cfg.resume}: no complete checkpoint under "
                f"{cfg.train_dir}")
        return None
    saved = ckpt.read_topology(cfg.train_dir)
    action, plan = "ok", ""
    if saved is not None:
        action, plan = ckpt.check_topology(saved, topo, cfg.train_dir,
                                           elastic=cfg.resume == "elastic")
        if plan:
            print_fn(f"elastic resume: {plan}")
    elif cfg.resume == "elastic":
        print_fn("elastic resume: checkpoint has no topology sidecar "
                 "(pre-elastic save); assuming the saved topology "
                 "matches the live one")
    if action == "reshard":
        ckpt.restore_elastic(state, cfg.train_dir, saved, topo["world"],
                             rank=rank)
    else:
        ckpt.restore(state, cfg.train_dir, rank=rank)
    fp = ckpt.model_fingerprint(state)
    print_fn(f"restored checkpoint step {state.step} from {cfg.train_dir}")
    print_fn(f"state fingerprint: {fp}")
    return {"restored_step": state.step,
            "saved_world": (saved or {}).get("world"),
            "live_world": topo["world"],
            "arm": (saved or {}).get("variable_update"),
            "elastic": action == "reshard", "fingerprint": fp}


def _dropout_rank(mesh, rank: int) -> int:
    """The rank whose dropout stream this rank draws (``create_model``'s
    seed, a restored generator state): its own, but under a model axis
    its model group's first rank's, so the ranks of a model group, whose
    activations are replicated, draw the same masks; distinct by data,
    seq and pipe index."""
    return rank if mesh is None else rank - mesh.model_index


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


@dataclasses.dataclass
class _Obs:
    """The run's observability (JAX's driver wiring): the metrics stream
    (rank 0; a no-op without --metrics_dir), this rank's heartbeats,
    the goodput ledger's phase tracker and the memory ledger."""

    writer: object
    fleet: object
    phases: object
    memory: object
    on: bool = False                 # --metrics_dir: the per-window work

    def close(self) -> None:
        self.writer.close()
        self.fleet.close()


def _make_obs(cfg: BenchmarkConfig, dev, rank: int, world: int,
              fabric: str, topo: dict | None, print_fn) -> _Obs:
    """The metrics stream and manifest (rank 0), the flight recorder
    (every rank persists ``spans.<rank>.jsonl`` under --metrics_dir),
    the heartbeats, and the phase tracker, which enters ``init``."""
    from tpu_hc_bench_torch.obs import fleet, goodput, memory, metrics
    from tpu_hc_bench_torch.obs import timeline

    manifest = None
    if cfg.metrics_dir and rank == 0:
        manifest = metrics.run_manifest(
            cfg=cfg, device=dev, world=world,
            extra={"workload": "train", "fabric": fabric,
                   "process_count": world, "device_count": world,
                   "topology": topo})
        print_fn(f"metrics: {cfg.metrics_dir}/{metrics.METRICS_NAME} "
                 f"(+ {metrics.MANIFEST_NAME})")
    writer = metrics.MetricsWriter(cfg.metrics_dir, manifest,
                                   primary=rank == 0)
    timeline.configure(enabled=cfg.flight_recorder != "off",
                       run_dir=cfg.metrics_dir, rank=rank)
    return _Obs(writer, fleet.FleetWriter(cfg.metrics_dir, rank),
                goodput.PhaseTracker(writer), memory.MemoryLedger(dev),
                on=bool(cfg.metrics_dir))


class _Saver:
    """--train_dir's saves during training (JAX ``save_now``): every
    --save_model_steps timed steps and at the end.  At world 1 with
    --async_checkpoint the write runs on the writer's thread and only
    the snapshot holds the loop; otherwise rank 0 snapshots and writes
    (every rank gathers the dropout states), and a barrier holds the
    ranks until the files are there.  The retention pass follows each
    save.  A synchronous save retries an ``OSError`` (at world 1;
    ``io_error@ckpt`` injects one), pauses the watchdog and is the
    goodput ledger's ``checkpoint`` phase (the async snapshot its
    ``checkpoint_async``); the emergency save is always synchronous."""

    def __init__(self, cfg: BenchmarkConfig, topo: dict, rank: int,
                 world: int, grouped: bool, print_fn, obs: _Obs,
                 plan=None):
        from tpu_hc_bench_torch.utils import checkpoint as ckpt

        self.ckpt, self.cfg, self.topo = ckpt, cfg, topo
        self.rank, self.grouped, self.print = rank, grouped, print_fn
        self.world, self.obs, self.plan = world, obs, plan
        self.dog = None                 # the watchdog, once armed
        self.writer = (ckpt.AsyncCheckpointWriter(cfg.train_dir, print_fn)
                       if cfg.async_checkpoint and world == 1
                       and not (plan is not None and plan.io_error)
                       else None)
        self.saves: list[dict] = []
        print_fn("checkpointing: "
                 + ("async (snapshot blocks, write overlapped, one in "
                    "flight; emergency saves stay synchronous)"
                    if self.writer else
                    "sync (rank 0 snapshots and writes)"))

    def drain_commits(self) -> None:
        """Landed async saves into the metrics stream (main thread)."""
        while self.writer is not None and self.writer.commits:
            self.obs.writer.event("checkpoint_commit",
                                  **self.writer.commits.popleft())

    def land(self) -> None:
        """Wait for the write in flight (its error surfaces here)."""
        if self.writer is not None:
            self.writer.wait()
            self.drain_commits()

    def save(self, state, i: int, phase: str = "checkpoint") -> None:
        from tpu_hc_bench_torch.resilience.retry import retry_io

        cfg, t0 = self.cfg, time.perf_counter()
        overlapped = self.writer is not None and phase == "checkpoint"
        if self.dog is not None:
            self.dog.pause()
        self.obs.phases.enter("checkpoint_async" if overlapped else phase,
                              step=i)
        try:
            if overlapped:
                self.writer.submit(state, gc_keep=cfg.keep_checkpoints,
                                   topology=self.topo)
                self.print(f"checkpoint snapshot: step {state.step} "
                           f"({time.perf_counter() - t0:.3f}s blocking; "
                           f"write overlapped)")
            else:
                self.land()

                def write():
                    if self.plan is not None:
                        self.plan.maybe_io_error("ckpt")
                    return self.ckpt.save(state, cfg.train_dir, self.topo,
                                          write=self.rank == 0)

                path = retry_io(write, what="checkpoint save",
                                print_fn=self.print,
                                obs_writer=self.obs.writer,
                                attempts=1 if self.world > 1 else 3)
                if self.rank == 0:
                    self.ckpt.gc_checkpoints(cfg.train_dir,
                                             cfg.keep_checkpoints,
                                             print_fn=self.print)
                if self.grouped:
                    distributed.barrier()
                self.print(f"checkpoint saved: {path}")
        finally:
            if self.obs.on:
                self.obs.writer.event("memory", **self.obs.memory.sample(
                    "checkpoint_async" if overlapped else phase, step=i))
            self.obs.phases.enter("step", step=i)
            if self.dog is not None:
                self.dog.resume()
        self.saves.append({"step": state.step, "async": overlapped,
                           "blocking_ms":
                               1e3 * (time.perf_counter() - t0)})

    def finish(self, state) -> dict:
        """Land the write in flight; the result's ``checkpoint``
        record."""
        self.land()
        return {"train_dir": self.cfg.train_dir, "saves": self.saves,
                "final_step": state.step,
                "fingerprint": self.ckpt.model_fingerprint(state)}


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
                     model, mesh=None) -> _Input:
    """One fixed batch on the card: tokens, spectrograms with CTC
    transcripts (labels bounded by the frames after the conv strides),
    (user, item) ids over ``model``'s tables, or images.  Under sequence
    parallelism (``mesh``) a rank's data group's rows, then its slice
    of the sequence."""
    rows = functools.partial(
        rank_rows, rank=mesh.data_index if mesh else rank,
        rows=cfg.batch_size)
    if spec.is_text:
        batch = rows(SyntheticTokens(
            global_batch, spec.input_shape[0], seed=cfg.seed,
            vocab_size=spec.vocab_size, causal_lm=spec.causal_lm).batch())
        if mesh is not None:
            batch = seq_slice(batch, mesh.seq_index, mesh.sp)
        batch = tokens_to_device(batch, dev)
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
                 split: str, local_workers: int, print_fn,
                 model_axis: bool = False) -> _Input:
    """ImageNet TFRecords: this rank's shards, its rows of each global
    batch (decoded alone unless --full_batch_identity), through the
    feeder, from this process's decode pool or the host's input service;
    or --datasets_repeat_cached_sample's 8 batches on the card.  Under a
    model axis ``rank`` and ``world`` are the data index and degree, and
    each rank decodes in its own pool (the service's streams are one a
    rank)."""
    from tpu_hc_bench_torch.data.imagenet import ImageNetDataset

    rows = (rank * cfg.batch_size, (rank + 1) * cfg.batch_size)
    sliced = world > 1 and not cfg.full_batch_identity
    if model_axis and cfg.input_service == "on":
        raise ValueError(
            "--input_service=on serves one stream a rank; under a model "
            "axis the ranks of a model group read the same rows: use "
            "--input_service=off")
    if not model_axis and _input_service_on(cfg, world, local_workers):
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
                 split: str, mesh=None) -> _Input:
    """A token corpus: this rank's stripe; as JAX's multi-process arm,
    each rank draws a global batch from its stripe and keeps its rows.
    Under sequence parallelism (``mesh``) the stripe and the rows are
    the data group's, and the rank keeps its slice of the sequence."""
    from tpu_hc_bench_torch.data.tokens import TokenDataset

    if mesh is not None:
        rank, world = mesh.data_index, mesh.dp
    ds = TokenDataset(cfg.data_dir, global_batch, spec.input_shape[0],
                      split=split, causal_lm=spec.causal_lm, worker=rank,
                      num_workers=world, seed=cfg.seed,
                      vocab_size=spec.vocab_size)

    def mine(b):
        b = rank_rows(b, rank, cfg.batch_size)
        return seq_slice(b, mesh.seq_index, mesh.sp) if mesh else b

    feeder = DeviceFeeder((mine(b) for b in ds), dev, cfg.prefetch_depth)
    return _Input(iter(feeder), ds, {"split": split, "reader": "memmap"},
                  feeder.close)


def _run_eval(cfg, spec, state, inp: _Input, global_batch: int,
              total_workers: int, dev, kind: str, fabric: str,
              grouped: bool, print_fn, num_slices: int = 1
              ) -> BenchmarkResult:
    """tf_cnn_benchmarks --eval (JAX ``_run_eval``): at most 5 warmup
    batches, then ``num_batches`` timed forward passes with running
    statistics; top-1 over every timed example."""
    state.model.eval()
    for _ in range(max(1, min(cfg.num_warmup_batches, 5))):
        loss, _ = step_mod.eval_step(state, next(inp.batches))
    drain(dev)
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
    drain(dev)
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
        sequence_parallel=cfg.sequence_parallel,
        model_parallel=cfg.model_parallel,
        pipeline_parallel=cfg.pipeline_parallel,
        num_microbatches=cfg.num_microbatches,
        expert_parallel=cfg.expert_parallel, num_slices=num_slices,
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


def _mesh(cfg: BenchmarkConfig, fab, grouped: bool, world: int,
          num_hosts: int):
    """The mesh of process groups (JAX's ``run_benchmark`` checks and
    ``build_mesh``): (data, seq) under sequence parallelism, (data,
    model) under TP/EP, (data, pipe) under PP, the hybrids (data, pipe,
    model) and (data, seq, model), (dcn, data) under multislice; None
    for plain data parallelism and one worker."""
    tp, ep, sp = cfg.model_parallel, cfg.expert_parallel, \
        cfg.sequence_parallel
    pp = cfg.pipeline_parallel
    if cfg.scan_layers and (pp > 1 or tp > 1 or ep > 1):
        raise ValueError(
            "--scan_layers stacks the trunk params [L, ...] (one compiled "
            "layer body), which the layer_i-based PP interface and the "
            "per-tensor TP/EP sharding rules do not address yet; drop "
            "--scan_layers or the model/pipe axes")
    mp = max(tp, ep) * pp * sp
    if world % mp:
        raise ValueError(
            f"--model_parallel/--expert_parallel/--pipeline_parallel/"
            f"--sequence_parallel product {mp} does not divide {world} "
            f"workers")
    if (mp > 1 or cfg.sp_active) and not fab.is_fast:
        raise ValueError(
            "--model_parallel/--expert_parallel/--pipeline_parallel/"
            "--sequence_parallel (incl. the degenerate seq axis of the "
            "seq-sharded attention impls) requires a device fabric "
            "(ici/dcn): the host path's shard_map binds no seq axis and "
            "would silently re-replicate the shards")
    num_slices = 1
    if fab is Fabric.DCN:
        num_slices = cfg.num_slices or num_hosts
        if num_slices > 1 and mp > 1:
            raise ValueError(
                "fabric=dcn multislice currently composes with data "
                "parallelism only")
    elif cfg.num_slices > 1:
        raise ValueError("--num_slices requires fabric=dcn")
    if num_slices > 1 and cfg.variable_update == "zero1":
        raise ValueError(
            "--variable_update=zero1 composes with single-slice data "
            "parallelism only (the multislice (dcn, data) hierarchical "
            "reduce has no reduce-scatter layout yet)")
    if not (cfg.sp_active or mp > 1 or num_slices > 1):
        return None
    if not grouped:
        raise ValueError("a mesh axis needs a process group (the "
                         "launcher starts one on a fast fabric)")
    return distributed.build_mesh(
        sp, max(tp, ep), num_slices, num_hosts,
        force_seq_axis=cfg.sp_active, pipeline_parallel=pp)


def run_benchmark(cfg: BenchmarkConfig, *, fabric: str = "sock",
                  print_fn: Callable[[str], None] = print,
                  local_workers: int = 1) -> BenchmarkResult:
    """Train ``cfg.model`` (or run it forward-only, or evaluate it) on
    synthetic or real data and measure it: data parallel over the default
    process group where one is up, else on one worker.  Every rank
    returns the result; only rank 0 prints.  ``local_workers``: the
    workers on this host, who share its decode budget."""
    from tpu_hc_bench_torch.obs import efficiency, memory
    from tpu_hc_bench_torch.ops import _build
    from tpu_hc_bench_torch.resilience import inject

    fab = resolve_fabric(fabric)
    step_mod.check_arm(cfg, fab)
    # read the artifacts and specs now, loudly: a typo'd path must die
    # before warmup, not after the run when the summary needs it
    fabric_ceiling = (efficiency.load_fabric_ceiling(cfg.fabric_ceiling)
                      if cfg.fabric_ceiling else None)
    budget = memory.parse_hbm_budget(cfg.hbm_budget)
    plan = inject.parse_plan(cfg.inject_fault)
    if cfg.compile_cache:
        _build.configure(cfg.compile_cache)
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
    if dev.type == "cuda" and not torch.backends.cudnn.deterministic:
        # the analog of XLA's autotuning: cuDNN picks its conv algorithms
        # for these fixed shapes during warmup (not where the caller
        # asked cuDNN for reproducible runs)
        torch.backends.cudnn.benchmark = True
    dtype = torch.bfloat16 if cfg.use_fp16 else torch.float32
    num_hosts = max(1, total_workers // max(1, local_workers))
    mesh = _mesh(cfg, fab, grouped, total_workers, num_hosts)
    model_axis = mesh is not None and mesh.tp > 1
    num_slices = mesh.num_slices if mesh is not None else 1
    dropout_rank = _dropout_rank(mesh, rank)
    # the minor axes divide the data-parallel degree: the global batch
    # counts the data groups' rows (sequences, not shards)
    pp = cfg.pipeline_parallel
    global_batch = cfg.batch_size * total_workers // (
        max(cfg.model_parallel, cfg.expert_parallel) * pp
        * cfg.sequence_parallel)
    split = _split(cfg, spec)
    _resolve_epochs(cfg, spec, split, global_batch, print_fn)
    if pp > 1 and not spec.causal_lm:
        raise ValueError(
            "--pipeline_parallel requires a decoder implementing the "
            "PP interface (pp_embed/pp_layer_module/pp_head: the GPT "
            f"and llama families), not {cfg.model}")
    # a text model's spec comes back rescaled to --seq_len
    model, spec = create_model(
        cfg.model, dtype, cfg.attention_impl, device=dev, seed=cfg.seed,
        fused_conv=cfg.fused_conv, train=True, num_classes=cfg.num_classes,
        space_to_depth=cfg.use_space_to_depth, seq_len=cfg.seq_len,
        rank=dropout_rank, gradient_checkpointing=cfg.gradient_checkpointing,
        scan_layers=cfg.scan_layers, moe_impl=cfg.moe_impl,
        moe_capacity_factor=cfg.moe_capacity_factor,
        moe_f_chunk=cfg.moe_f_chunk, rnn_impl=cfg.rnn_impl,
        seq_axis=mesh.seq_group if mesh else None,
        pipeline=(pp, mesh.pipe_index) if pp > 1 else None)
    if mesh is not None and spec.input_shape[0] % cfg.sequence_parallel:
        raise ValueError(
            f"sequence length {spec.input_shape[0]} not divisible by "
            f"sequence_parallel={cfg.sequence_parallel}")
    pipe = None
    if pp > 1:
        from tpu_hc_bench_torch.parallel import pipeline

        cfg.num_microbatches = (cfg.num_microbatches
                                or pipeline.default_microbatches(
                                    cfg.batch_size, pp))
        if cfg.batch_size % cfg.num_microbatches:
            raise ValueError(
                f"per-worker batch {cfg.batch_size} not divisible by "
                f"num_microbatches={cfg.num_microbatches}")
        pipe = pipeline.make_pipeline(mesh, model.num_layers,
                                      cfg.num_microbatches)
    hybrid = "PP" if pp > 1 else "SP" if cfg.sequence_parallel > 1 else None
    if hybrid == "SP" and model_axis and cfg.attention_impl in (
            "ulysses", "ulysses_flash"):
        heads, kv = model.heads, getattr(model, "num_kv_heads", model.heads)
        tp_ = cfg.model_parallel
        if (heads // tp_) % cfg.sequence_parallel or (
                kv // tp_) % cfg.sequence_parallel:
            raise ValueError(
                f"--attention_impl={cfg.attention_impl} under DPxSPxTP "
                f"splits a rank's heads / model_parallel over the seq "
                f"axis: heads={heads} (kv_heads={kv}) / model_parallel="
                f"{tp_} not divisible by sequence_parallel="
                f"{cfg.sequence_parallel}")
    tp = None
    if model_axis:
        # the hybrids keep their own losses (local means, as JAX's manual
        # data axis); plain TP/EP takes the global batch's
        tp = tensor.shard_model_(
            model, mesh.model_group,
            "ep" if cfg.expert_parallel > 1 else "tp",
            None if hybrid else mesh.data_group)
    state = step_mod.make_train_state(model, cfg, fab if grouped else None,
                                      mesh, tp, pipe)
    grads = state.dp.grads if state.dp else None
    kind = hw.device_name(dev)
    for line in cfg.summary_lines():
        print_fn(line)
    print_fn(f"device_kind={kind} global_batch={global_batch}")
    if grouped:
        print_fn(f"data parallel: total_workers={total_workers} "
                 f"fabric={fab.value} backend={dist.get_backend()} "
                 f"grad_buckets={len(grads.buckets) if grads else 0}")
    if mesh is not None and cfg.sp_active:
        print_fn(f"sequence parallel: mesh data={mesh.dp} x seq={mesh.sp} "
                 f"attention_impl={cfg.attention_impl} (a rank holds "
                 f"{cfg.batch_size} x {spec.input_shape[0] // mesh.sp} "
                 f"tokens of a {global_batch}-sequence global batch)")
    if pipe is not None:
        print_fn(f"pipeline: {pp} stages x {cfg.num_microbatches} "
                 f"microbatches ({model.num_layers // pp} layers/stage)")
    if hybrid and model_axis:
        print_fn(f"tensor parallel: {cfg.model_parallel}-way (hybrid with "
                 f"{hybrid})")
    elif model_axis:
        print_fn(f"{'expert' if tp.mode == 'ep' else 'tensor'} parallel: "
                 f"mesh data={mesh.dp} x model={mesh.tp} "
                 f"({len(tp.rules)} of "
                 f"{sum(1 for _ in model.parameters())} parameters split; "
                 f"the ranks of a model group read the same "
                 f"{cfg.batch_size} rows of a {global_batch}-row global "
                 f"batch)")
    if mesh is not None and mesh.num_slices > 1:
        per_slice = (f"{num_hosts // mesh.num_slices} host(s)/slice"
                     if mesh.num_slices <= num_hosts
                     else f"virtual slices on {num_hosts} host(s)")
        print_fn(f"multislice: {mesh.num_slices} slices x {per_slice} — "
                 f"data axis = dcn({mesh.num_slices}) x "
                 f"data({total_workers // mesh.num_slices})")
    topo = None
    if cfg.train_dir:
        from tpu_hc_bench_torch.utils import checkpoint as ckpt

        pp_native = pp > 1 and num_hosts > 1
        if pp_native:
            print_fn(
                "--train_dir multi-process PP: PP-native layout "
                "(stacked [L,...] trunk, a file a stage; not "
                "interchangeable with DP-layout checkpoints); restore "
                "requires a filesystem shared by all hosts")
        topo = ckpt.topology_record(
            total_workers, cfg,
            layout="pp-native" if pp_native else "host",
            mesh=mesh.shape if mesh is not None
            else distributed.mesh_shape(total_workers))
    try:
        resume = _maybe_restore(state, cfg, topo, dropout_rank, print_fn)
        if cfg.eval:
            _require_checkpoint_for_eval(cfg, resume is not None, print_fn)
    except BaseException:
        if grads:
            grads.close()
        raise
    obs = _make_obs(cfg, dev, rank, total_workers, fabric, topo, print_fn)
    if resume is not None:
        obs.writer.event("resume", **resume)
    try:
        data_rank, data_world = ((mesh.data_index, mesh.dp)
                                 if mesh is not None
                                 else (rank, total_workers))
        if split is None:
            inp = _synthetic_input(cfg, spec, dev, rank, global_batch,
                                   model, mesh)
        elif spec.is_text:
            inp = _token_input(cfg, spec, dev, rank, total_workers,
                               global_batch, split, mesh)
        else:
            inp = _image_input(cfg, spec, dev, data_rank, data_world,
                               global_batch, split, local_workers, print_fn,
                               model_axis)
    except BaseException:
        obs.close()
        if grads:
            grads.close()
        raise
    try:
        if cfg.eval:
            result = _run_eval(cfg, spec, state, inp, global_batch,
                               total_workers, dev, kind, fabric, grouped,
                               print_fn, num_slices)
            obs.writer.event("summary", **dataclasses.asdict(result))
        else:
            saver = (_Saver(cfg, topo, rank, total_workers, grouped,
                            print_fn, obs, plan)
                     if cfg.train_dir else None)
            result = _run_train(cfg, spec, state, inp, global_batch,
                                total_workers, dev, kind, fabric, grouped,
                                print_fn, obs, rank, saver, plan,
                                fabric_ceiling, budget, num_slices,
                                dropout_rank)
        result.resume = resume
        return result
    finally:
        obs.close()
        from tpu_hc_bench_torch.obs import timeline

        timeline.detach()
        inp.close()
        if grads:
            grads.close()


class _TraceWindow:
    """``--trace_dir``/``--profile_steps=a:b`` (JAX's ``_TraceWindow``):
    a ``torch.profiler`` (Kineto) trace of timed steps a..b, with ONE
    stop path.  Without ``--profile_steps`` the window is the first sync
    window.  The trace starts once step a-1 has completed on the device
    (a quiesced window), each step in it is annotated
    ``ProfilerStep#<step>``, and it stops once step b has completed;
    ``stop()`` is idempotent, and the post-loop call stops a window
    still open at the run's end.  The trace is written to
    ``<trace_dir>/rank<k>.pt.trace.json`` after the timed window
    (``post_summary``): Kineto's export of a few steps takes seconds.
    Inside the window the profiler records every host op too, which
    slows the host's dispatch: the window's idle share is larger than
    the unprofiled step's."""

    def __init__(self, cfg: BenchmarkConfig, print_fn, sync_every: int,
                 dev, rank: int):
        from tpu_hc_bench_torch.flags import parse_profile_steps

        self.trace_dir, self.print_fn = cfg.trace_dir, print_fn
        self.dev, self.rank = dev, rank
        self.prof = self._done = None
        self.started = False
        if cfg.profile_steps:
            self.start_step, self.stop_after = parse_profile_steps(
                cfg.profile_steps)
        else:
            self.start_step, self.stop_after = 1, sync_every

    @property
    def active(self) -> bool:
        return self.prof is not None

    def maybe_start(self, next_step: int, clock: _StepClock) -> None:
        if (self.trace_dir is None or self.started
                or next_step < self.start_step):
            return
        if self.start_step > 1:
            clock.wait(self.start_step - 1)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.started = True

    def annotate(self, i: int):
        if self.prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"ProfilerStep#{i}")

    def poll(self, i: int, clock: _StepClock) -> None:
        if self.prof is not None and i >= self.stop_after:
            clock.wait(self.stop_after)
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        drain(self.dev)
        self._done, self.prof = self.prof, None
        self._done.stop()

    def _export(self) -> None:
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir, f"rank{self.rank}.pt.trace.json")
        self._done.export_chrome_trace(path)
        self._done = None
        self.print_fn(f"profiler trace written to {path}")

    def post_summary(self):
        """Print the bucket summary of the trace just written and return
        it; None without a usable trace (on the CPU the profiler writes
        no device track: one line says so)."""
        if self.trace_dir is not None and not self.started:
            self.print_fn(
                f"WARNING: profile window {self.start_step}:"
                f"{self.stop_after} never started (run ended first); "
                f"no trace written to {self.trace_dir}")
        if not self.started:
            return None
        self.stop()
        if self._done is not None:
            self._export()
        from tpu_hc_bench_torch.obs import trace as obs_trace

        try:
            summary = obs_trace.summarize_trace_dir(self.trace_dir)
        except Exception as e:      # a degraded summary must not kill a run
            self.print_fn(f"trace summary unavailable: {e}")
            return None
        for line in obs_trace.format_summary(summary):
            self.print_fn(line)
        return summary


def _trace_record(cfg: BenchmarkConfig, tsum, print_fn) -> dict | None:
    """The ``trace_buckets`` record: the buckets, the per-kind collective
    split and the collective overlap (JAX's driver)."""
    if tsum is None:
        return None
    from tpu_hc_bench_torch.obs import efficiency
    from tpu_hc_bench_torch.obs import trace as obs_trace

    rec = {"buckets": tsum.totals, "steps": len(tsum.steps),
           "collective_ops": {}}
    try:
        intervals = obs_trace.leaf_intervals(
            obs_trace.load_events(cfg.trace_dir))
        ops: dict[str, float] = {}
        for name, a, b in intervals:
            ops[name] = ops.get(name, 0.0) + (b - a)
        rec["collective_ops"] = efficiency.collective_kind_times(ops)
        overlap = efficiency.collective_overlap(intervals)
    except Exception:
        overlap = None
    if overlap is not None:
        rec["overlap"] = overlap
        for ln in efficiency.overlap_lines(overlap):
            print_fn(ln.strip())
    return rec


def _warmup(cfg: BenchmarkConfig, step_fn, state, inp: _Input, dev, obs,
            budget, print_fn, probe: bool):
    """The warmup steps (the goodput ledger's ``compile`` phase).  The
    first is measured where asked: its allocator peak from a reset (the
    ``--hbm_budget`` verdict, printed before the timed loop; JAX checks
    the compiled step's AOT report instead) and its operations (the MFU
    probe, ``obs.efficiency.probe_step_flops``).  Returns ``(state,
    metrics, seconds, first-step memory report, probe record)``."""
    from tpu_hc_bench_torch.obs import efficiency, memory

    t0 = time.perf_counter()
    metrics = mem_an = flops = None
    box = [state]

    def first():
        batch = next(inp.batches)
        box[0], out = step_fn(box[0], batch)
        box.append(out)
        warm_batch.append(batch)

    warm_batch: list = []

    for w in range(cfg.num_warmup_batches):
        if w:
            state, metrics = step_fn(state, next(inp.batches))
            continue
        run = first
        if probe:
            def run():
                nonlocal flops
                flops = efficiency.probe_step_flops(first)
                if len(box) < 2:        # the counter failed mid-step
                    first()
        if budget is not None:
            mem_an = memory.first_step_report(dev, run)
        else:
            run()
        state, metrics = box[0], box[-1]
    if budget is not None:
        budget_bytes, note = memory.resolve_hbm_budget_bytes(budget, dev)
        for ln in memory.budget_lines(
                mem_an, budget_bytes, note, where="in the first warmup "
                "step", advice="shrink --batch_size or raise "
                "--gradient_accumulation_steps"):
            print_fn(ln)
        if budget_bytes is not None and mem_an:
            obs.writer.event(
                "hbm_budget", budget_bytes=budget_bytes,
                total_bytes=mem_an["total_bytes"],
                exceeded=mem_an["total_bytes"] > budget_bytes)
    drain(dev)
    return (state, metrics, time.perf_counter() - t0, mem_an, flops,
            warm_batch[0] if warm_batch else None)


def _run_train(cfg, spec, state, inp: _Input, global_batch: int,
               total_workers: int, dev, kind: str, fabric: str,
               grouped: bool, print_fn, obs: _Obs, rank: int = 0,
               saver: _Saver | None = None, plan=None,
               fabric_ceiling: dict | None = None,
               budget=None, num_slices: int = 1,
               dropout_rank: int | None = None) -> BenchmarkResult:
    """The warmup and the timed steps of the train (or forward-only)
    step, with JAX's resilience runtime and observability around them:
    the fault plan, the preemption flag (an emergency save, then
    ``PreemptedError``), the watchdog, the non-finite guard's policy
    (``--on_nonfinite``), the goodput ledger, memory samples, heartbeats
    and the straggler gather once a sync window, and the profiler
    window.  With a ``saver`` (--train_dir) a save every
    --save_model_steps timed steps (inside the timed window: it holds
    the loop) and one of the final state after it; a rewind restores
    the dropout state of ``dropout_rank`` (``_dropout_rank``)."""
    from tpu_hc_bench_torch.obs import efficiency, fleet, goodput
    from tpu_hc_bench_torch.obs import memory, timeline
    from tpu_hc_bench_torch.resilience import guards, preempt, watchdog
    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    step_fn = (step_mod.forward_step if cfg.forward_only
               else step_mod.train_step)
    if dropout_rank is None:
        dropout_rank = rank
    units = _example_units(spec)
    world = total_workers if grouped else 1
    probe = bool(cfg.metrics_dir or cfg.fabric_ceiling or budget is not None)
    obs.phases.enter("compile")
    try:
        state, metrics, warm_s, mem_an, flops, warm_batch = _warmup(
            cfg, step_fn, state, inp, dev, obs, budget, print_fn, probe)
    except BaseException as e:
        if memory.is_oom_error(e) and cfg.metrics_dir:
            path = memory.dump_forensics(cfg.metrics_dir, reason="oom",
                                         device=dev, print_fn=print_fn)
            if path:
                obs.writer.event("memory_dump",
                                 path=os.path.basename(path), reason="oom")
        raise
    warmup_steps = max(1, cfg.num_warmup_batches)
    print_fn(f"warmup done: {cfg.num_warmup_batches} steps in "
             f"{warm_s:.1f}s (includes cuDNN's algorithm search and the "
             f"kernel library's load)")
    analytic_mem = memory.analytic_memory_table(state.model,
                                                state.optimizer, warm_batch)
    warm_batch = None
    if mem_an:
        # what the step's inputs hold once the optimizer's state exists
        # (JAX's AOT argument bytes: the state and the batch); the next
        # step drops the gradients first anyway
        state.optimizer.zero_grad(set_to_none=True)
        mem_an["argument_bytes"] = memory.device_memory_sample(dev)[
            "bytes_in_use"]
    if obs.on:
        obs.writer.event("memory", **obs.memory.sample("compile"))
    if grouped:
        distributed.barrier()

    sync_every = max(1, min(cfg.display_every, 16))
    policy = cfg.on_nonfinite
    tracker = (guards.GuardTracker(dev) if policy in ("skip", "rewind")
               and not cfg.forward_only else None)
    rewind_base_step = state.step - warmup_steps
    preempt_h = preempt.PreemptionHandler(
        print_fn=print_fn, action="checkpoint and exit at the next step "
                                  "boundary").install()
    timeout_s = watchdog.resolve_timeout(
        cfg.step_timeout_s, warm_s / warmup_steps)
    trace_window = _TraceWindow(cfg, print_fn, sync_every, dev, rank)
    ewma = fleet.StepEwma()
    clock = _StepClock(dev)
    dog = None
    nonfinite_display: list[int] = []
    g = {"seen_total": 0, "last_poll_i": 0, "rewind_streak": 0,
         "wiped_until": -1, "pending": []}

    def fatal(exc: BaseException, i: int) -> BaseException:
        if saver is not None:
            try:
                saver.land()
            except Exception as e:
                print_fn(f"WARNING: async checkpoint write failed during "
                         f"abort: {e}")
                obs.writer.event("async_ckpt_error", error=str(e))
        obs.phases.end(step=i)
        obs.close()
        timeline.detach()
        return exc

    def apply_guard(j: int, streak: int, total: int, peak: int,
                    now_i: int) -> None:
        """JAX's ``_apply_guard``: the budget, and rewind's restore, on
        counters observed through step ``j``."""
        steps_since = j - g["last_poll_i"]
        g["last_poll_i"] = j
        new_bad = total - g["seen_total"]
        if new_bad <= 0:
            if steps_since > 0 and j > g["wiped_until"]:
                g["rewind_streak"] = 0
            return
        g["seen_total"] = total
        if policy == "skip":
            print_fn(f"nonfinite: dropped {new_bad} update(s) in window "
                     f"ending step {j} (consecutive {streak}, "
                     f"total {total})")
            obs.writer.event("nonfinite_skip", step=j, new_bad=new_bad,
                             streak=streak, total=total)
            obs.phases.note_skipped_updates(new_bad)
            if peak >= cfg.max_bad_steps:
                raise fatal(guards.GuardBudgetError(
                    f"{peak} consecutive non-finite steps "
                    f"(--max_bad_steps={cfg.max_bad_steps})"), j)
            return
        g["rewind_streak"] += 1
        if g["rewind_streak"] >= cfg.max_bad_steps:
            raise fatal(guards.GuardBudgetError(
                f"{g['rewind_streak']} consecutive rewinds without a clean "
                f"window (--max_bad_steps={cfg.max_bad_steps})"), j)
        obs.phases.enter("rewind_replay", step=now_i)
        if dog is not None:
            dog.pause()
        try:
            saver.land()
            ckpt.restore(state, cfg.train_dir, rank=dropout_rank)
        finally:
            if dog is not None:
                dog.resume()
        restored_step = state.step
        for _ in range(sync_every):
            next(inp.batches)
        tracker.reset()
        g["pending"].clear()
        g["wiped_until"] = now_i
        g["seen_total"] = 0
        lost = goodput.rewind_lost_steps(now_i, restored_step,
                                         rewind_base_step, warmup_steps)
        obs.phases.note_lost_steps(lost)
        obs.phases.enter("step", step=now_i)
        print_fn(f"rewind: non-finite step(s) in window ending step {j}; "
                 f"restored checkpoint step {restored_step}, skipping "
                 f"{sync_every} batches")
        obs.writer.event("rewind", step=now_i, restored_step=restored_step,
                         skipped_batches=sync_every, streak=streak,
                         lost_steps=lost)

    def settle_guard(i: int) -> None:
        """Flush the deferred guard windows, then poll the live
        counters: the one deliberate sync of the guard, before a save,
        at preemption and at the run's end."""
        while g["pending"]:
            j, handles = g["pending"].pop(0)
            apply_guard(j, *tracker.fetch(handles), now_i=i)
        apply_guard(i, *tracker.poll(), now_i=i)

    def emergency(completed: int) -> None:
        """JAX's ``_emergency``: settle the guard, one synchronous save,
        the fingerprint line, the forensics, then ``PreemptedError``."""
        print_fn(f"preemption: stopping after timed step {completed} "
                 f"(signal {preempt_h.signum})")
        obs.phases.enter("emergency_save", step=completed)
        saved = saver is not None
        if saved:
            saver.land()
        if saved and tracker is not None:
            try:
                settle_guard(completed)
            except guards.GuardBudgetError:
                saved = False
        if saved:
            saver.save(state, completed, phase="emergency_save")
            print_fn(f"state fingerprint: {ckpt.model_fingerprint(state)}")
            obs.writer.event("emergency_ckpt", step=completed)
        if cfg.metrics_dir:
            obs.writer.event("memory", **obs.memory.sample(
                "emergency_save", step=completed))
            path = memory.dump_forensics(
                cfg.metrics_dir, reason="emergency_save", device=dev,
                step=completed, print_fn=print_fn)
            if path:
                obs.writer.event("memory_dump", path=os.path.basename(path),
                                 reason="emergency_save", step=completed)
            tpath = timeline.dump_timeline(
                cfg.metrics_dir, reason="emergency_save", step=completed)
            if tpath:
                obs.writer.event("timeline_dump",
                                 path=os.path.basename(tpath),
                                 reason="emergency_save", step=completed)
        topo = saver.topo if saver is not None else {}
        obs.writer.event("preempt", step=completed,
                         signal=preempt_h.signum, checkpoint_saved=saved,
                         world=(topo or {}).get("world"),
                         arm=(topo or {}).get("variable_update"))
        raise fatal(preempt.PreemptedError(
            completed, saved, preempt_h.signum, topology=topo), completed)

    obs.phases.enter("step")
    clock.mark()
    wait_s = 0.0
    t0 = t_window = time.perf_counter()
    try:
        if timeout_s is not None:
            forensics = ((lambda: (
                memory.dump_forensics(cfg.metrics_dir, reason="watchdog",
                                      device=dev, print_fn=print_fn),
                timeline.dump_timeline(cfg.metrics_dir,
                                       reason="watchdog")))
                if cfg.metrics_dir else None)
            dog = watchdog.Watchdog(
                timeout_s, lambda: clock.done()[1],
                last_record_fn=lambda: obs.writer.last_record,
                obs_writer=obs.writer, forensics_fn=forensics,
                what="step").start()
            if saver is not None:
                saver.dog = dog
            print_fn(f"watchdog armed: step timeout {timeout_s:.1f}s")
        if policy == "rewind" and ckpt.latest_step(cfg.train_dir) is None:
            saver.save(state, 0)        # the rewind baseline
        for i in range(1, cfg.num_batches + 1):
            # step boundary: honor preemption (several ranks agree at
            # sync-window boundaries: a collective, the same step on all)
            if world == 1:
                if preempt_h.requested():
                    emergency(i - 1)
            elif (i - 1) % sync_every == 0 and preempt_h.agreed(world):
                emergency(i - 1)
            trace_window.maybe_start(i, clock)
            t_in = time.monotonic()
            batch = next(inp.batches)
            t_go = time.monotonic()
            wait_s += t_go - t_in
            obs.phases.note_data_wait(t_go - t_in)
            timeline.record_span("input_wait", t_in, t_go, step=i)
            if plan is not None:
                plan.fire_step_faults(i, print_fn, obs.writer)
                batch = plan.poison_batch(i, batch, print_fn, obs.writer)
            with trace_window.annotate(i):
                state, metrics = step_fn(state, batch)
            timeline.record_span("step_dispatch", t_go, time.monotonic(),
                                 step=i)
            clock.mark()
            if tracker is not None:
                tracker.update(metrics["nonfinite"])
                if i == cfg.num_batches:
                    settle_guard(i)
                elif i % sync_every == 0:
                    if g["pending"]:
                        j, handles = g["pending"].pop(0)
                        apply_guard(j, *tracker.fetch(handles), now_i=i)
                    g["pending"].append((i, tracker.handles()))
            if i % cfg.display_every == 0 or i == cfg.num_batches:
                loss = float(metrics["loss"])       # waits for the device
                if not math.isfinite(loss):
                    nonfinite_display.append(i)
                if i % cfg.display_every == 0:
                    now = time.perf_counter()
                    rate = cfg.display_every * global_batch / (now - t_window)
                    t_window = now
                    print_fn(f"{i}\t{units}/sec: {rate:.1f}\tloss: "
                             f"{loss:.3f}")
                    obs.writer.event("window", step=i, rate=rate,
                                     step_ms=1e3 * global_batch / rate,
                                     loss=loss)
            if i % sync_every == 0 or i == cfg.num_batches:
                obs.phases.flush(i)
                if saver is not None:
                    saver.drain_commits()
                if obs.on:
                    done = clock.done()[0] - 1
                    ewma_ms = ewma.update(done)
                    obs.writer.event("memory",
                                     **obs.memory.sample("step", step=i))
                    timeline.flush()
                    obs.fleet.heartbeat(
                        step=done, step_ewma_ms=ewma_ms,
                        mem_peak_bytes=obs.memory.peak_bytes or None,
                        phase=timeline.current_phase())
                    if world > 1:
                        skew = fleet.straggler_gather(done, ewma_ms)
                        if skew is not None:
                            obs.writer.event("straggler", step=i, **skew)
            if (saver is not None and cfg.save_model_steps
                    and i % cfg.save_model_steps == 0
                    and i < cfg.num_batches):
                if tracker is not None:
                    settle_guard(i)
                saver.save(state, i)
            trace_window.poll(i, clock)
        final_loss = float(metrics["loss"])
        drain(dev)
        if grouped:
            distributed.barrier()
    finally:
        if dog is not None:
            dog.stop()
        preempt_h.uninstall()
    total_s = time.perf_counter() - t0
    trace_window.stop()
    if policy == "abort" and nonfinite_display:
        obs.writer.event("nonfinite_abort", steps=nonfinite_display[:16])
        raise fatal(guards.NonFiniteError(
            f"non-finite loss at display step(s) "
            f"{nonfinite_display[:16]} (--on_nonfinite=abort; use skip "
            f"or rewind to survive, or inspect the data/lr)"),
            cfg.num_batches)
    checkpoint = None
    if saver is not None:
        saver.save(state, cfg.num_batches)      # the final state
        checkpoint = saver.finish(state)
    obs.phases.end(step=cfg.num_batches)
    ledger = obs.phases.ledger()

    total_rate = cfg.num_batches * global_batch / total_s
    per_chip = total_rate / total_workers
    mean_ms = 1e3 * total_s / cfg.num_batches
    p50_ms = statistics.median(clock.step_ms())
    peak = hw.peak_flops(cfg.compute_dtype, dev)
    flops_mult = 1.0 if cfg.forward_only else 3.0
    analytic_flops = (flops_mult * spec.flops_per_example * global_batch
                      / total_workers)
    if peak:
        mfu_rep = efficiency.mfu_report(
            flops["flops"] if flops else None, analytic_flops,
            mean_ms / 1e3, peak)
        if flops:
            mfu_rep["aten_flops_per_step"] = flops["aten_flops"]
            mfu_rep["kernel_flops_per_step"] = flops["kernel_flops"]
    else:
        mfu_rep = {"mfu": float("nan"),
                   "mfu_source": "no peak for this device",
                   "analytic_flops_per_step": analytic_flops}
        if flops:
            mfu_rep["measured_flops_per_step"] = flops["flops"]
    grads = state.dp.grads if state.dp else None
    result = BenchmarkResult(
        model=cfg.model, total_workers=total_workers,
        global_batch=global_batch, total_images_per_sec=total_rate,
        images_per_sec_per_chip=per_chip, mean_step_ms=mean_ms,
        p50_step_ms=p50_ms, p50_step_granularity=1, mfu=mfu_rep["mfu"],
        final_loss=final_loss, fabric=fabric, device_kind=kind,
        mfu_source=mfu_rep["mfu_source"],
        attention_impl=cfg.attention_impl, fused_xent=cfg.fused_xent,
        variable_update=cfg.variable_update,
        sequence_parallel=cfg.sequence_parallel,
        model_parallel=cfg.model_parallel,
        pipeline_parallel=cfg.pipeline_parallel,
        num_microbatches=cfg.num_microbatches,
        expert_parallel=cfg.expert_parallel, num_slices=num_slices,
        overlap_grad_comm=cfg.overlap_grad_comm,
        gradient_accumulation_steps=cfg.gradient_accumulation_steps,
        grad_buckets=len(grads.buckets) if grads else 0,
        allreduce_per_step=state.dp.allreduce_calls if state.dp else 0,
        forward_only=cfg.forward_only,
        optimizer_state_bytes=step_mod.optimizer_state_bytes(
            state.optimizer),
        data=_data_record(inp, wait_s, cfg.num_batches),
        checkpoint=checkpoint, extra=_extra(cfg, state.model),
        goodput=ledger.goodput if ledger is not None else float("nan"),
        goodput_phases=({k: round(v, 3) for k, v in ledger.seconds.items()
                         if v > 0.0} if ledger is not None else None))
    trace_rec = _trace_record(cfg, trace_window.post_summary(), print_fn)
    if trace_rec is not None:
        obs.writer.event("trace_buckets", **trace_rec)
    if inp.dataset is not None and hasattr(inp.dataset, "stats"):
        obs.writer.event("data", **inp.dataset.stats())
    obs.writer.event("memory", **obs.memory.sample("step",
                                                   step=cfg.num_batches))
    mem_rep = memory.memory_report(mem_an, analytic_mem)
    obs.writer.event("memory_report", **mem_rep)
    result.peak_hbm_bytes = obs.memory.peak_bytes or None
    result.hbm_bytes_limit = obs.memory.bytes_limit
    result.mem_source = obs.memory.source
    # JAX's record: the result's fields as they are (NaN stays NaN)
    summary = dataclasses.asdict(result)
    summary.update({k: v for k, v in mfu_rep.items() if k != "mfu"})
    if not cfg.forward_only and grouped and grads is not None:
        summary["allreduce_bytes_per_step"] = \
            efficiency.grad_allreduce_bytes(
                [p for p in state.model.parameters() if p.requires_grad],
                cfg.accum_dtype if cfg.gradient_accumulation_steps > 1
                else "f32")
    obs.writer.event("summary", **summary)
    obs.close()
    timeline.detach()

    print_fn("-" * 40)
    print_fn(f"total {units}/sec: {total_rate:.2f}")
    mfu_txt = (f"{100 * mfu_rep['mfu']:.1f}% ({mfu_rep['mfu_source']})"
               if peak else f"unknown (no peak for {kind})")
    print_fn(f"{units}/sec/chip: {per_chip:.2f}  step: {mean_ms:.2f}ms "
             f"(p50/step {p50_ms:.2f}ms)  MFU: {mfu_txt}")
    if probe and peak:
        for ln in efficiency.mfu_lines(summary)[1:]:
            print_fn(ln.strip())
        print_fn(f"MFU: measured {100 * summary.get('mfu_measured', 0):.1f}%"
                 f" vs analytic {100 * summary['mfu_analytic']:.1f}%")
    if ledger is not None and obs.on:
        for ln in ledger.format_lines():
            print_fn(ln)
    for ln in memory.memory_lines(obs.memory.fold()):
        print_fn(ln.strip())
    if probe or mem_an:
        for ln in memory.memory_report_lines(mem_rep):
            print_fn(ln.strip())
    if fabric_ceiling is not None:
        for ln in efficiency.ceiling_utilization_lines(
                summary, trace_rec, fabric_ceiling):
            print_fn(ln.strip())
    if result.data is not None:
        print_fn(f"input wait: {result.data['input_wait_ms_per_step']:.3f}"
                 " ms/step")
    return result
