"""The op census of one step: the port's counterpart of the JAX package's
``analysis/hlo.py``.

JAX counts what a step issues in the compiled HLO text (definition
sites, async pairs folded).  Eager PyTorch has no HLO: what one step
issues is read at the dispatcher instead.  ``OpCensus`` is a
``TorchDispatchMode`` that counts every op the step dispatches, under
the ATen and c10d names the dispatcher gives them
(``aten::addmm``, ``c10d::allreduce_``, ``c10d::_reduce_scatter_base_``,
``aten::_local_scalar_dense`` for an ``.item()``).  From one census:

- ``collective_counts`` returns JAX's opcode keys (``all-reduce``,
  ``reduce-scatter``, ``all-gather``, ``all-to-all``,
  ``collective-broadcast``, ``collective-permute``), so the zero1 shape
  check (``lints.zero1_shape_findings``) is shared word for word.  A
  point-to-point hop is this rank's view of a ``collective-permute``: a
  ring shift sends one buffer and receives one (one permute, as JAX's
  ``ppermute`` lowers); the count is the larger of the sends and the
  receives.  ``barrier`` is no HLO op and is counted in ``ops`` only.
- ``host_syncs`` counts the ops that make the host wait for the device:
  ``_local_scalar_dense`` (``.item()``, ``bool(t)``, ``float(t)``),
  ``nonzero`` and the other ops whose output shape depends on the data,
  ``equal``, and copies from the card to host memory.
- ``kernel_launches`` reads the ``.launches`` counters the ``ops/``
  wrappers keep: the hand-written kernels are ctypes entries
  (``ops/_build.py``), which the dispatcher never sees.
- ``op_attribution`` names the module of each matmul and convolution
  through a stack kept by forward hooks (JAX reads the metadata
  ``op_name`` paths); ops of the backward, which runs outside any
  module's forward, are attributed to ``<backward>``.

The step is a training step (``census_train_step``) or one prefill
plus one decode step of the serving engine (``census_serve_step``).  On
the card ``card_syncs=True`` also runs the step under
``torch.cuda.set_sync_debug_mode("warn")`` and counts the warnings: the
card's own count of the syncs, beside the dispatcher's.

``abstract=True`` runs the census over tensors that hold no data (the
meta device, JAX's ``make_jaxpr`` over ``eval_shape``): an op whose
answer depends on the data cannot run there, so the census records it
as a host sync, with its op and module path, and answers it with a
placeholder (a scalar 0, or an empty result) so the forward runs on and
every sync is found.

The world-2 count runs in one process over torch's ``fake`` process
group (every collective dispatches and returns at once) or, as the
twin that shows the two agree, in ``world`` gloo (or NCCL) processes:
``python -m tpu_hc_bench_torch.analysis.census --model trivial --world 2
--variable_update zero1 --spawn``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import warnings

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "Census", "OpCensus", "COLLECTIVE_OPS", "HOST_SYNC_OPS",
    "ATTRIBUTED_OPS", "collective_counts", "host_syncs", "kernel_launches",
    "zero_launches", "op_attribution", "take", "census_train_step",
    "census_serve_step", "census_forward", "KERNEL_ROWS",
]

#: c10d (and functional collective) ops -> JAX's HLO opcode
COLLECTIVE_OPS = {
    "c10d::allreduce_": "all-reduce",
    "c10d::allreduce_coalesced_": "all-reduce",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_": "all-gather",
    "c10d::allgather_coalesced_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::alltoall_": "all-to-all",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "c10d::broadcast_": "collective-broadcast",
    "_c10d_functional::broadcast": "collective-broadcast",
}
_SENDS = frozenset({"c10d::send"})
_RECVS = frozenset({"c10d::recv_", "c10d::recv_any_source_"})

#: ops whose answer the host must wait for: a scalar read, or an output
#: whose shape depends on the data
HOST_SYNC_OPS = frozenset({
    "aten::_local_scalar_dense", "aten::nonzero", "aten::is_nonzero",
    "aten::equal", "aten::masked_select", "aten::_unique2",
    "aten::unique_consecutive", "aten::unique_dim",
    "aten::repeat_interleave",
})
_COPIES = frozenset({"aten::_to_copy", "aten::copy_"})

#: the ops ``op_attribution`` names a module for (JAX's ``dot``)
ATTRIBUTED_OPS = frozenset({
    "aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
    "aten::convolution", "aten::convolution_backward",
    "aten::_scaled_dot_product_flash_attention",
    "aten::_scaled_dot_product_efficient_attention",
    "aten::_scaled_dot_product_cudnn_attention",
})

BACKWARD = "<backward>"

#: the kernel table's rows, each ``(module, counter, key)``: the wrapper
#: whose ``launches`` counts the row (``key`` indexes a dict counter)
KERNEL_ROWS = {
    "paged_decode_attention": ("paged_attention", "paged_decode_attention",
                               None),
    "fused_residual_norm": ("fused_residual_ln", "fused_residual_norm",
                            None),
    "fused_bn_relu_conv": ("fused_conv", "fused_bn_relu_conv", None),
    "flash_attention_fwd": ("flash_attention", "flash_attention", "fwd"),
    "flash_attention_dq": ("flash_attention", "flash_attention", "dq"),
    "flash_attention_dkv": ("flash_attention", "flash_attention", "dkv"),
    "softmax_xent_fwd": ("xent", "softmax_xent", "fwd"),
    "softmax_xent_bwd": ("xent", "softmax_xent", "bwd"),
    "max_pool_bwd": ("pool_bwd", "max_pool", None),
}


def _counter(row: str):
    import importlib

    mod, fn, key = KERNEL_ROWS[row]
    return getattr(importlib.import_module(f"tpu_hc_bench_torch.ops.{mod}"),
                   fn), key


def kernel_launches() -> dict[str, int]:
    """Every kernel row's launch count in this process."""
    out = {}
    for row in KERNEL_ROWS:
        fn, key = _counter(row)
        out[row] = fn.launches[key] if key else fn.launches
    return out


def zero_launches() -> None:
    """Every kernel row's launch count to 0."""
    for row in KERNEL_ROWS:
        fn, key = _counter(row)
        if key:
            fn.launches[key] = 0
        else:
            fn.launches = 0


@dataclasses.dataclass
class Census:
    """What one step dispatched: ``ops`` by dispatcher name, the host
    syncs as ``(op, module path)``, the attributed products by module
    path, the kernels' launches, and the card's sync warnings (None where
    not taken), each with the op being dispatched when it was raised and
    the Python line it came from."""

    ops: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    syncs: list[tuple[str, str]] = dataclasses.field(default_factory=list)
    attributed: dict[str, list[str]] = dataclasses.field(
        default_factory=dict)
    launches: dict[str, int] = dataclasses.field(default_factory=dict)
    card_syncs: int | None = None
    card_sync_sites: list[str] = dataclasses.field(default_factory=list)
    current: tuple[str, str] | None = None   # the op being dispatched

    def summary(self) -> dict:
        """The report's per-member record (JSON-ready)."""
        return {"ops": sum(self.ops.values()),
                "collectives": collective_counts(self),
                "host_syncs": host_syncs(self),
                "kernel_launches": {k: n for k, n in
                                    sorted(self.launches.items()) if n},
                "card_syncs": self.card_syncs,
                "card_sync_sites": sorted(set(self.card_sync_sites))}


def _device_of(x) -> torch.device | None:
    return x.device if isinstance(x, torch.Tensor) else None


def _is_device_to_host(name: str, args, kwargs) -> bool:
    """A copy from an accelerator tensor into host memory."""
    if name == "aten::copy_":
        dst, src = (args + (None, None))[:2]
        d, s = _device_of(dst), _device_of(src)
        return (d is not None and s is not None and d.type == "cpu"
                and s.type not in ("cpu", "meta"))
    src = _device_of(args[0]) if args else None
    dev = kwargs.get("device")
    return (src is not None and src.type not in ("cpu", "meta")
            and dev is not None and torch.device(dev).type == "cpu")


class OpCensus(TorchDispatchMode):
    """Counts every dispatched op into ``census``; ``stack`` (a list of
    module paths, pushed and popped by ``module_stack``) names where each
    sync and product ran, ``outside`` those outside every module's
    forward.  With ``abstract``, a data-dependent op is recorded and
    answered with a placeholder instead of being run."""

    def __init__(self, census: Census, stack: list[str] | None = None,
                 abstract: bool = False, outside: str = BACKWARD):
        super().__init__()
        self.census = census
        self.stack = stack if stack is not None else []
        self.abstract = abstract
        self.outside = outside

    def _where(self) -> str:
        return self.stack[-1] if self.stack else self.outside

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        c = self.census
        c.ops[name] += 1
        if name in ATTRIBUTED_OPS:
            c.attributed.setdefault(self._where(), []).append(name)
        if name in HOST_SYNC_OPS or (
                name in _COPIES and _is_device_to_host(name, args, kwargs)):
            c.syncs.append((name, self._where()))
            if self.abstract:
                return _placeholder(name, args)
        outer, c.current = c.current, (name, self._where())
        try:
            return func(*args, **kwargs)
        finally:
            c.current = outer


def _placeholder(name: str, args):
    """The answer a data-dependent op gives over data-less tensors: 0 for
    a scalar read, an empty result for a data-shaped output.  (A copy
    from the meta device is no sync, so copies never get here.)"""
    x = args[0]
    if name == "aten::_local_scalar_dense":
        return False if x.dtype == torch.bool else (
            0.0 if x.is_floating_point() else 0)
    if name in ("aten::is_nonzero", "aten::equal"):
        return False
    if name == "aten::nonzero":
        return torch.empty((0, x.dim()), dtype=torch.long, device=x.device)
    return torch.empty((0,), dtype=x.dtype, device=x.device)


@contextlib.contextmanager
def module_stack(model: torch.nn.Module | None, stack: list[str]):
    """Push each module's path (``layers.3.attn``) on ``stack`` for the
    time of its forward."""
    if model is None:
        yield
        return
    handles = []
    for path, mod in model.named_modules():
        label = path or type(model).__name__

        def pre(_m, _a, label=label):
            stack.append(label)

        def post(_m, _a, _o):
            if stack:
                stack.pop()

        handles.append(mod.register_forward_pre_hook(pre))
        handles.append(mod.register_forward_hook(post))
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def take(fn, model: torch.nn.Module | None = None, abstract: bool = False,
         card_syncs: bool = False, outside: str = BACKWARD) -> Census:
    """The census of ``fn()``: every op it dispatches, the modules of
    ``model`` they ran in (``outside`` names where an op outside every
    module's forward ran), the kernels it launched (the counters zeroed
    first) and, with ``card_syncs``, the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    census = Census()
    stack: list[str] = []
    zero_launches()
    with (module_stack(model, stack),
          OpCensus(census, stack, abstract, outside)):
        if card_syncs:
            sites: list[str] = []
            armed = [False]

            def seen(message, category, filename, lineno, file=None,
                     line=None):
                # only ``fn``'s: the mode switch itself can warn (the
                # first switch in a process did, on the card)
                if armed[0] and "synchroniz" in str(message):
                    op = ("{} @ {}: ".format(*census.current)
                          if census.current else "")
                    sites.append(op + _caller_site(filename, lineno))

            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = seen
                torch.cuda.set_sync_debug_mode("warn")
                armed[0] = True
                try:
                    fn()
                finally:
                    armed[0] = False
                    torch.cuda.set_sync_debug_mode("default")
            census.card_syncs = len(sites)
            census.card_sync_sites = sites
        else:
            fn()
    census.launches = kernel_launches()
    return census


def _caller_site(filename: str, lineno: int) -> str:
    """Where a sync warning came from: the innermost frame of the port's
    package on the stack (outside this module), ``file:line`` relative
    to the repo, then the line that raised it; where no frame of the
    package is on the stack, the raising line, its thread and the
    stack's innermost frames."""
    import threading
    import traceback
    from pathlib import Path

    root = Path(__file__).resolve().parents[2]
    here = Path(__file__).resolve()
    raised = f"{filename}:{lineno}"
    stack = traceback.extract_stack()[:-2]     # less this and the hook
    for frame in reversed(stack):
        path = Path(frame.filename).resolve()
        if path == here or "tpu_hc_bench_torch" not in path.parts:
            continue
        try:
            rel = path.relative_to(root)
        except ValueError:
            rel = path
        return f"{rel}:{frame.lineno} ({raised})"
    inner = " < ".join(f"{Path(f.filename).name}:{f.lineno} {f.name}"
                       for f in reversed(stack[-6:]))
    return (f"{raised} (thread {threading.current_thread().name}: "
            f"{inner})")


def collective_counts(census: Census) -> dict[str, int]:
    """The step's collectives under JAX's HLO opcode keys."""
    counts: dict[str, int] = {}
    for name, n in census.ops.items():
        op = COLLECTIVE_OPS.get(name)
        if op is not None:
            counts[op] = counts.get(op, 0) + n
    sends = sum(census.ops.get(n, 0) for n in _SENDS)
    recvs = sum(census.ops.get(n, 0) for n in _RECVS)
    if sends or recvs:
        counts["collective-permute"] = max(sends, recvs)
    return counts


def host_syncs(census: Census) -> dict[str, int]:
    """The step's host syncs by op (``aten::`` dropped)."""
    out: dict[str, int] = {}
    for op, _ in census.syncs:
        key = op.split("::", 1)[-1]
        out[key] = out.get(key, 0) + 1
    return dict(sorted(out.items()))


def op_attribution(census: Census,
                   opcodes: frozenset[str] = ATTRIBUTED_OPS
                   ) -> dict[str, list[str]]:
    """Module path -> the products (``opcodes``) that ran in it."""
    return {path: [o for o in ops if o in opcodes]
            for path, ops in sorted(census.attributed.items())
            if any(o in opcodes for o in ops)}


# ---------------------------------------------------------------------
# one step of a member


def _batch(spec, cfg, model, dev: torch.device, rows: int):
    from tpu_hc_bench_torch.data import synthetic
    from tpu_hc_bench_torch.train import driver

    if spec.is_text:
        return driver.tokens_to_device(synthetic.SyntheticTokens(
            rows, spec.input_shape[0], seed=cfg.seed,
            vocab_size=spec.vocab_size,
            causal_lm=spec.causal_lm).batch(), dev)
    if spec.ctc:
        from tpu_hc_bench_torch.models.deepspeech import max_label_for

        frames, freq = spec.input_shape
        return driver.speech_to_device(synthetic.SyntheticSpeech(
            rows, frames, freq, max_label_for(frames),
            seed=cfg.seed).batch(), dev)
    if spec.integer_input:
        return driver.ids_to_device(synthetic.SyntheticIds(
            rows, model.num_users, model.num_items,
            seed=cfg.seed).batch(), dev)
    return driver.to_device(synthetic.SyntheticImages(
        rows, spec.input_shape, cfg.num_classes, cfg.seed).batch(), dev)


@contextlib.contextmanager
def _world(world: int):
    """A process group of ``world`` ranks for the step: the caller's
    where one is up, else torch's in-process ``fake`` group (this
    process is rank 0; every collective dispatches and returns at
    once), torn down after."""
    import torch.distributed as dist

    if world <= 1 or dist.is_initialized():
        yield
        return
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def census_train_step(name: str, *, batch: int = 2, world: int = 1,
                      device: str = "cpu", fabric: str = "ib",
                      warmup: int = 1, card_syncs: bool = False,
                      **config) -> Census:
    """The census of one training step of ``name`` after ``warmup``
    plain steps (the optimizer's state, cuDNN's search and the kernels'
    first launches happen there), through ``train.step.train_step`` as
    the driver calls it.  ``world`` 1: the one-worker step (no process
    group); above 1, data parallel over ``fabric`` in the caller's
    process group, or in an in-process ``fake`` one.  ``config``: more
    ``BenchmarkConfig`` fields (``variable_update``, ``use_fp16``,
    ``attention_impl``, ``fused_xent``, ``fused_conv``, ``seq_len``...)."""
    import torch.distributed as dist

    from tpu_hc_bench_torch import flags, resolve_device
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.parallel.fabric import resolve_fabric
    from tpu_hc_bench_torch.train import step as step_mod

    dev = resolve_device(device)
    cfg = flags.BenchmarkConfig(model=name, batch_size=batch, device=device,
                                **config).resolve()
    with _world(world):
        grouped = dist.is_initialized() and dist.get_world_size() > 1
        dtype = torch.bfloat16 if cfg.use_fp16 else torch.float32
        if dev.type == "cuda":
            torch.backends.cudnn.benchmark = True
        model, spec = create_model(
            name, dtype, cfg.attention_impl, device=dev, seed=cfg.seed,
            fused_conv=cfg.fused_conv, train=True,
            num_classes=cfg.num_classes, seq_len=cfg.seq_len,
            moe_impl=cfg.moe_impl, rnn_impl=cfg.rnn_impl)
        state = step_mod.make_train_state(
            model, cfg, resolve_fabric(fabric) if grouped else None)
        data = _batch(spec, cfg, model, dev, batch)
        for _ in range(warmup):
            step_mod.train_step(state, data)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        census = take(lambda: step_mod.train_step(state, data), model,
                      card_syncs=card_syncs)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    return census


SERVE = "<serve>"


def census_serve_step(name: str, *, batch: int = 4, prompt_len: int = 16,
                      device: str = "cpu", warmup: int = 1,
                      card_syncs: bool = False, **config) -> Census:
    """The census of one prefill and one decode step of ``name``'s
    serving engine, as ``ServeEngine.run`` issues them: the inputs copied
    to the device, a ``prompt_len``-token prefill, the engine's sync and
    its first token read back (``int(next_tok[0])``), then a decode step
    of ``batch`` active rows at depth ``prompt_len``, the engine's sync
    and the rows' tokens read back (``.cpu()``).  Before it every row's
    prompt is prefilled and ``warmup`` such steps run (the engine's own
    warmup has run every bucket once).  Ops outside every module's
    forward are attributed to ``<serve>``.  ``config``: more
    ``ServeConfig`` fields (``decode_attention``, ``quant``...);
    ``max_in_flight`` and ``max_prompt_len`` default to ``batch`` and
    ``prompt_len``."""
    import numpy as np

    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.serve.engine import ServeEngine, pick_bucket

    config.setdefault("max_in_flight", batch)
    config.setdefault("max_prompt_len", prompt_len)
    cfg = flags.ServeConfig(model=name, device=device, **config).resolve()
    engine = ServeEngine(cfg, print_fn=lambda _m: None)
    if not engine.decode_mode:
        raise ValueError(f"{name}: a classify member has no prefill or "
                         "decode step")
    kv, t, w = engine._kv, engine._tensor, engine.table_width
    rng = np.random.default_rng(cfg.seed)
    prompt = np.zeros((1, pick_bucket(engine.prefill_buckets, prompt_len)),
                      np.int32)
    prompt[0, :prompt_len] = rng.integers(1, engine.spec.vocab_size,
                                          prompt_len)
    # the engine's padded decode bucket: row i holds pages 1 + i w ...;
    # padded rows read the trash page 0 at length 0, inactive
    b = pick_bucket(engine.batch_buckets, batch)
    tables = np.zeros((b, w), np.int32)
    tables[:batch] = (1 + np.arange(batch * w, dtype=np.int32)).reshape(
        batch, w)
    lengths = np.where(np.arange(b) < batch, prompt_len, 0).astype(np.int32)
    active = np.arange(b) < batch
    toks = np.zeros((b,), np.int32)

    def prefill(row: int) -> int:
        next_tok, _, _ = engine.prefill_fn(kv, t(prompt), prompt_len,
                                           t(tables[row]))
        engine._sync()
        return int(next_tok[0])

    def decode():
        next_toks, _, _ = engine.decode_fn(kv, t(toks), t(tables),
                                           t(lengths), t(active))
        engine._sync()
        return next_toks.cpu().numpy()

    for row in range(batch):
        toks[row] = prefill(row)

    def step():
        prefill(0)
        decode()

    for _ in range(warmup):
        step()
    return take(step, engine.model, card_syncs=card_syncs, outside=SERVE)


def abstract_input(spec, rows: int = 1, device="meta"):
    """A data-less example input of ``spec``'s shape (JAX's
    ``ShapeDtypeStruct`` example of ``lints._abstract_model``)."""
    shape = (rows,) + tuple(spec.input_shape)
    if spec.is_text or spec.integer_input:
        return torch.zeros(shape, dtype=torch.int32, device=device)
    if spec.ctc:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    # an image batch is an NCHW view of NHWC memory (``prep_inputs``)
    h, w, c = spec.input_shape
    return torch.zeros((rows, h, w, c), dtype=torch.float32,
                       device=device).permute(0, 3, 1, 2)


def census_forward(name: str, rows: int = 1) -> Census:
    """The census of one eval-mode forward of ``name`` built on the meta
    device (no memory, no compute: JAX's ``make_jaxpr`` over
    ``eval_shape``); every data-dependent op is a recorded sync."""
    from tpu_hc_bench_torch.models import create_model

    model, spec = create_model(name, device="meta")
    x = abstract_input(spec, rows)
    with torch.no_grad():
        return take(lambda: model(x), model, abstract=True)


# ---------------------------------------------------------------------
# the world-N twin in N processes


def _worker(args) -> int:
    from tpu_hc_bench_torch import resolve_device
    from tpu_hc_bench_torch.parallel import distributed

    worker = distributed.worker_from_env()
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(worker.local_rank)
    distributed.init_group("nccl" if dev.type == "cuda" else "gloo",
                           worker)
    try:
        census = census_train_step(
            args.model, batch=args.batch, world=worker.world_size,
            device=args.device, warmup=args.warmup,
            variable_update=args.variable_update,
            num_classes=args.num_classes,
            fusion_threshold_bytes=args.fusion_threshold_bytes)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    if worker.rank == 0:
        print(json.dumps(census.summary()), flush=True)
    return 0


def census_world(name: str, world: int, *, device: str = "cpu",
                 batch: int = 2, warmup: int = 1,
                 variable_update: str = "psum", num_classes: int = 10,
                 fusion_threshold_bytes: int = 256) -> dict:
    """Rank 0's census summary of one step of ``name`` in ``world``
    processes of this host (gloo on the CPU, NCCL on the cards, a card a
    rank), the twin of ``census_train_step(world=world)``'s in-process
    ``fake`` group."""
    import os
    import sys
    import tempfile

    from tpu_hc_bench_torch.parallel import distributed

    with tempfile.TemporaryDirectory() as tmp:
        store = f"file://{os.path.join(tmp, 'store')}"
        workers = [distributed.Worker(r, r, world, store)
                   for r in range(world)]
        lines: list[str] = []
        rc = distributed.spawn_local(
            [sys.executable, "-m", "tpu_hc_bench_torch.analysis.census",
             "--worker", "--model", name, "--device", device, "--batch",
             str(batch), "--warmup", str(warmup), "--variable_update",
             variable_update, "--num_classes", str(num_classes),
             "--fusion_threshold_bytes", str(fusion_threshold_bytes)],
            workers, lines.append)
    if rc != 0:
        raise RuntimeError(f"the {world}-process census of {name} exited "
                           f"{rc}: {lines[-5:]}")
    return json.loads(lines[-1])


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m tpu_hc_bench_torch.analysis.census",
        description="the op census of one training step")
    ap.add_argument("--model", default="trivial")
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--variable_update", default="psum")
    ap.add_argument("--num_classes", type=int, default=10)
    ap.add_argument("--fusion_threshold_bytes", type=int, default=256)
    ap.add_argument("--spawn", action="store_true",
                    help="run the world in processes, not in one")
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return _worker(args)
    if args.spawn:
        out = census_world(args.model, args.world, device=args.device,
                           batch=args.batch, warmup=args.warmup,
                           variable_update=args.variable_update,
                           num_classes=args.num_classes,
                           fusion_threshold_bytes=args.fusion_threshold_bytes)
    else:
        out = census_train_step(
            args.model, batch=args.batch, world=args.world,
            device=args.device, warmup=args.warmup,
            variable_update=args.variable_update,
            num_classes=args.num_classes,
            fusion_threshold_bytes=args.fusion_threshold_bytes).summary()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
