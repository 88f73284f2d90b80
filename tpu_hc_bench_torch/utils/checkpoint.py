"""Checkpoints of the training lane: save, resume, retain, restore.

The counterpart of the JAX package's ``utils/checkpoint.py``, with the
port's own on-disk form: one directory ``<dir>/step_<n>`` a step, holding
``state.pt``, a ``torch.save`` of

- ``model``: the model's ``state_dict`` (parameters and BatchNorm running
  statistics), on the host;
- ``optimizer``: the optimizer's ``state_dict`` (momentum traces, Adam's
  moments and counts, RMSprop's ``nu``), on the host; under zero1
  ``{"zero1_shards": [...]}``, every rank's ``state_dict`` of its own
  shards, by rank (gathered to the writer);
- ``step``: the optimizer steps taken (warmup included);
- ``rng``: what the step's randomness depends on, each rank's dropout
  generator state (``dropout``; a text model's masks continue where the
  run stopped), None for a model that draws none.

The data stream's position is not saved (as in JAX): a resumed run starts
its input stream anew.

Crash-safe commit, as JAX's: a save writes ``step_<n>.tmp/state.pt``,
fsyncs it, renames the directory to ``step_<n>``, writes the topology
sidecar ``step_<n>.topology.json`` and then the ``step_<n>.complete``
sentinel.  Discovery (``complete_steps``, ``latest_step``) believes only
sentinelled steps, so a crash leaves an ignored ``.tmp`` or an ignored
sentinel-less directory and ``restore`` falls back to the newest complete
step.  ``gc_checkpoints`` (``--keep_checkpoints=N``) keeps the newest N
complete steps and reaps ``.tmp`` debris, after waiting on an in-flight
writer.  ``AsyncCheckpointWriter`` (``--async_checkpoint``, world 1)
snapshots to the host on the step loop's thread and writes on its own,
one save in flight.

The topology sidecar (``topology_record``: world, process count, the
mesh ``{"data": ..., "model": ...}`` with ``dcn`` under multislice and
``pipe`` under pipeline parallelism, variable-update arm, pipeline
degree, layout ``"host"`` or ``"pp-native"``, dtype; JAX's
``topology.topology_record``) is checked at restore by JAX's
``elastic_plan``: ``ok`` (the same topology), ``noop`` (a host-layout
``psum``/``replicated`` state at another world or mesh: every rank holds
all of it, so it restores as it is, a TP or PP checkpoint at another
degree or under plain data parallelism too), ``reshard`` (a zero1 state
at another world) or ``refuse`` (zero1 against a replicated arm,
pp-native against the host layout, sharded saves).  ``check_topology`` raises one
``TopologyMismatchError`` naming both sides where the plan refuses, or
where it reshards and the run did not ask for ``--resume=elastic``
(``elastic=``).  ``restore_elastic`` reads a zero1 checkpoint saved by N
ranks and resplits every rank's optimizer shards for the live world
(``collectives.resplit_zero1_opt``; bit for bit on the real elements).
The stacked (``--scan_layers``) and unrolled layouts are not
interchangeable (as in JAX): a restore across them is refused by the
saved parameter names (``check_layers_layout``), before anything is
loaded.

Under data parallel every rank takes part in gathering the dropout
states (and zero1's optimizer shards), rank 0 alone copies the state to
the host and writes it, and every rank restores the same state (under
zero1 the same model, and its own optimizer shards).  Under tensor or
expert parallelism (``state.tp``) every split parameter and its
optimizer state are gathered over the model group first, so the file
holds the full tree (JAX's host layout on one host); a restore cuts it
for the live model group, whatever tp saved it.  Under pipeline
parallelism (``state.pipe``) the stages' layers and their optimizer
rows are gathered over the pipe group too (``parallel.pipeline``), so
a PP checkpoint on one host is DP's host layout, and a restore cuts
the live stage's layers from it: PP resumes under another pipe degree
or plain data parallelism, and DP under PP (JAX's DP<->PP interchange).

Several hosts under PP write the **pp-native** layout (``save_pp``,
``restore_pp``; JAX's): ``pp_shared.pt`` (rank 0: the step, the
replicated embedding and head with their optimizer state, the dropout
states) and one ``pp_trunk_<lo>_<hi>.pt`` a stage, written by the
stage's first data rank: its layers' parameters and optimizer state
stacked ``[hi - lo, ...]`` (``trunk.<name>``, the stacked trunk as it is
sharded).  It restores under any pipe degree; ``elastic_plan`` refuses
it against the host layout.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import re
import shutil
import threading
import time
from pathlib import Path

import torch
import torch.distributed as dist

__all__ = ["AsyncCheckpointWriter", "TopologyMismatchError", "check_topology",
           "check_layers_layout", "complete_steps", "describe_topology",
           "elastic_plan", "fingerprint", "gc_checkpoints", "latest_step",
           "model_fingerprint", "read_topology", "restore",
           "restore_elastic", "restore_pp", "save", "save_pp",
           "snapshot_to_host",
           "topology_record", "write_host_payload"]

_STEP_RE = re.compile(r"step_(\d+)")
STATE_FILE = "state.pt"
# the arms whose saved state is the same tree (replicated parameters and
# a parameter-shaped optimizer state): moving between them is free
REPLICATED_ARMS = ("psum", "replicated")
# what on-disk form a checkpoint took (JAX's names; the port writes
# "host" only: the full tree, gathered on save)
CKPT_LAYOUTS = ("host", "sharded", "pp-native")


class TopologyMismatchError(ValueError):
    """A checkpoint's recorded topology does not fit the live one."""


def _step_dir(base: Path, step: int) -> Path:
    return base / f"step_{step:08d}"


def _marker(base: Path, step: int) -> Path:
    """The commit sentinel, next to the step directory."""
    return base / f"step_{step:08d}.complete"


def _topology_sidecar(base: Path, step: int) -> Path:
    return base / f"step_{step:08d}.topology.json"


def _fsync_path(path: Path) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass    # not every filesystem fsyncs a directory


def _commit_step_dir(base: Path, step: int, tmp: Path,
                     topology: dict | None = None) -> Path:
    """``tmp`` -> ``step_<n>`` -> sidecar -> sentinel, each durable
    before the next.  An earlier save of the same step loses its
    sentinel only here, once the new write has landed in ``tmp``."""
    final = _step_dir(base, step)
    marker = _marker(base, step)
    _fsync_path(tmp)
    marker.unlink(missing_ok=True)
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    side = _topology_sidecar(base, step)
    if topology is not None:
        with open(side, "w") as f:
            json.dump(topology, f, indent=2, sort_keys=True)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
    else:
        side.unlink(missing_ok=True)
    with open(marker, "w") as f:
        f.write("ok\n")
        f.flush()
        os.fsync(f.fileno())
    _fsync_path(base)
    return final


# --- the topology sidecar ---------------------------------------------------


def topology_record(world: int, cfg, process_count: int | None = None,
                    layout: str = "host", mesh: dict | None = None) -> dict:
    """What ``restore`` must know of the world that wrote a checkpoint
    (JAX ``topology.topology_record``): ``mesh`` the mesh's shape
    (``distributed.mesh_shape``; default plain data parallelism)."""
    if layout not in CKPT_LAYOUTS:
        raise ValueError(f"layout_kind must be one of {CKPT_LAYOUTS}: "
                         f"{layout!r}")
    return {"schema": 1, "world": int(world),
            "process_count": int(world if process_count is None
                                 else process_count),
            "mesh": {str(k): int(v) for k, v in
                     (mesh or {"data": int(world), "model": 1}).items()},
            "variable_update": cfg.variable_update,
            "pipeline_parallel": int(getattr(cfg, "pipeline_parallel", 1)
                                     or 1),
            "layout": layout, "dtype": cfg.compute_dtype}


def _mesh_str(rec: dict | None) -> str:
    """A record's mesh as ``data:8xmodel:1`` (``?`` where absent)."""
    mesh = "x".join(f"{k}:{v}"
                    for k, v in ((rec or {}).get("mesh") or {}).items())
    return mesh or "?"


def describe_topology(rec: dict | None) -> str:
    """One line of a topology record (JAX's)."""
    if not rec:
        return "unknown (no topology sidecar)"
    return (f"world={rec.get('world')} mesh=[{_mesh_str(rec)}] "
            f"arm={rec.get('variable_update')} "
            f"pp={rec.get('pipeline_parallel', 1)} "
            f"layout={rec.get('layout')} dtype={rec.get('dtype')}")


def elastic_plan(saved: dict, live: dict) -> tuple[str, str]:
    """``(action, line)``, JAX's ``topology.elastic_plan``: ``ok`` (the
    same topology), ``noop`` (another world or mesh, but a host-layout
    replicated state restores as it is), ``reshard`` (zero1 shards at
    another world: ``--resume=elastic`` resplits them) or ``refuse``
    (different trees: zero1 against a replicated arm, pp-native against
    a data-parallel layout, sharded saves)."""
    same = all(saved.get(k) == live.get(k)
               for k in ("world", "mesh", "variable_update",
                         "pipeline_parallel", "layout"))
    if same:
        return "ok", ""
    s_arm, l_arm = saved.get("variable_update"), live.get("variable_update")
    s_lay, l_lay = saved.get("layout", "host"), live.get("layout", "host")
    sw, lw = saved.get("world"), live.get("world")
    if (s_arm == "zero1") != (l_arm == "zero1"):
        return ("refuse",
                f"arm {s_arm}->{l_arm}: the zero1 optimizer-state tree "
                f"(stacked [N, k] shards) and the replicated one are "
                f"different structures — resume on --variable_update="
                f"{s_arm}, or restart fresh")
    if ("pp-native" in (s_lay, l_lay)) and s_lay != l_lay:
        return ("refuse",
                f"layout {s_lay}->{l_lay}: pp-native stacked-trunk "
                f"checkpoints and DP-layout ones are different trees — "
                f"resume under the saved layout")
    if "sharded" in (s_lay, l_lay):
        return ("refuse",
                f"layout {s_lay}->{l_lay} with world {sw}->{lw}: "
                f"multi-host model-sharded checkpoints resume on the "
                f"saved topology only (per-shard Orbax I/O is not "
                f"host-reassemblable here)")
    extra = ("" if saved.get("dtype") == live.get("dtype")
             else f"; note: dtype policy {saved.get('dtype')}->"
                  f"{live.get('dtype')} (params restore bitwise, compute "
                  f"dtype changes)")
    if s_arm == "zero1":
        return ("reshard",
                f"zero1 optimizer shards resplit [{sw}, k]->[{lw}, k'] "
                f"over the data axis (world {sw}->{lw}){extra}")
    return ("noop",
            f"replicated {s_arm} state re-placed onto the live mesh "
            f"(world {sw}->{lw}, mesh [{_mesh_str(saved)}]->"
            f"[{_mesh_str(live)}]){extra}")


_UNROLLED_KEY = re.compile(r"layers\.\d+\.")


def check_layers_layout(model_sd: dict, saved_sd: dict,
                        directory=None) -> None:
    """Raise ``TopologyMismatchError`` where one ``state_dict`` holds the
    stacked trunk and the other the unrolled one."""
    def stacked(sd):
        keys = [k for k in sd if k.startswith("layers.")]
        return bool(keys) and not any(_UNROLLED_KEY.match(k) for k in keys)

    s, l = stacked(saved_sd), stacked(model_sd)
    if s != l:
        name = {True: "stacked (--scan_layers)", False: "unrolled"}
        where = f" under {directory}" if directory is not None else ""
        raise TopologyMismatchError(
            f"checkpoint layout mismatch{where}: trunk {name[s]} -> "
            f"{name[l]}: the stacked layers.<name> [L, ...] and the "
            f"unrolled layers.<i>.<name> parameters are not "
            f"interchangeable; resume with the --scan_layers the "
            f"checkpoint was written with")


def check_topology(saved: dict, live: dict, directory=None,
                   step: int | None = None,
                   elastic: bool = False) -> tuple[str, str]:
    """``elastic_plan``'s verdict (JAX's ``check_topology``); raises one
    ``TopologyMismatchError``, naming the saved and the live topology,
    where it refuses, or where it reshards without ``elastic``
    (``--resume=elastic``)."""
    action, plan = elastic_plan(saved, live)
    if action in ("ok", "noop"):
        return action, plan
    where = ""
    if directory is not None:
        where = f" under {directory}" + (
            f" (step {step})" if step is not None else "")
    head = (f"checkpoint topology mismatch{where}: saved "
            f"{describe_topology(saved)} vs live "
            f"{describe_topology(live)}")
    if action == "reshard" and not elastic:
        raise TopologyMismatchError(
            f"{head}; relaunch with --resume=elastic to reshape "
            f"({plan})")
    if action == "refuse":
        raise TopologyMismatchError(f"{head} — {plan}")
    return action, plan


def read_topology(directory: str | Path,
                  step: int | None = None) -> dict | None:
    """A checkpoint's topology sidecar (the latest complete step's by
    default); None where there is none."""
    base = Path(directory)
    if step is None:
        step = latest_step(base)
        if step is None:
            return None
    try:
        return json.loads(_topology_sidecar(base, step).read_text())
    except (OSError, json.JSONDecodeError):
        return None


# --- save -------------------------------------------------------------------


def _host(obj):
    """``obj`` with every tensor copied to the host (a snapshot: the
    live tensors change under the next step)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def _dropout_states(model) -> list | None:
    """Every rank's dropout generator state, by rank (a collective under
    data parallel); None for a model with no dropout generator."""
    gen = getattr(model, "dropout_generator", None)
    if gen is None:
        return None
    mine = gen.get_state()
    if dist.is_initialized() and dist.get_world_size() > 1:
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, mine)
        return out
    return [mine]


def _zero1(state) -> bool:
    dp = getattr(state, "dp", None)
    return dp is not None and dp.zero1


def _model_state(state) -> dict:
    """The model's full ``state_dict`` (under TP/EP gathered over the
    model group, under PP over the pipe group: collectives)."""
    from tpu_hc_bench_torch.parallel import pipeline

    return pipeline.full_state_dict(state.model, getattr(state, "tp", None),
                                    getattr(state, "pipe", None))


def model_fingerprint(state) -> str:
    """``fingerprint`` of the full model (a collective under TP/EP)."""
    return fingerprint(_model_state(state))


def _optimizer_state(state):
    """The optimizer's ``state_dict`` on the host, every split
    parameter's state gathered under TP/EP; under zero1 every rank's, by
    rank (collectives)."""
    from tpu_hc_bench_torch.parallel import pipeline

    mine = _host(pipeline.full_optimizer_state(
        state.optimizer, state.model, getattr(state, "tp", None),
        getattr(state, "pipe", None)))
    if not _zero1(state):
        return mine
    out = [mine]
    if dist.get_world_size() > 1:
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, mine)
    return {"zero1_shards": out}


def snapshot_to_host(state) -> tuple[int, dict]:
    """``(step, payload)``: the train state copied to the host, the only
    part of a save that must hold the step loop.  Under data parallel
    every rank takes part in its dropout states' gather (and zero1's
    optimizer shards')."""
    payload = {"step": int(state.step),
               "model": _host(_model_state(state)),
               "optimizer": _optimizer_state(state),
               "rng": {"dropout": _dropout_states(state.model)}}
    return payload["step"], payload


def write_host_payload(payload: dict, directory: str | Path, step: int,
                       topology: dict | None = None) -> Path:
    """``payload`` written under the commit protocol; returns the step
    directory."""
    base = Path(directory)
    base.mkdir(parents=True, exist_ok=True)
    tmp = base / (_step_dir(base, step).name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    path = tmp / STATE_FILE
    with open(path, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    return _commit_step_dir(base, step, tmp, topology)


def save(state, directory: str | Path, topology: dict | None = None,
         write: bool = True) -> Path | None:
    """Save ``state`` at its step where ``write`` (rank 0 under data
    parallel); a rank that does not write only takes its part in the
    dropout states' gather.  A ``pp-native`` ``topology`` takes
    ``save_pp`` (every rank calls it)."""
    if (topology or {}).get("layout") == "pp-native":
        return save_pp(state, directory, topology)
    if not write:
        _model_state(state)
        _optimizer_state(state)
        _dropout_states(state.model)
        return None
    step, payload = snapshot_to_host(state)
    return write_host_payload(payload, directory, step, topology)


class AsyncCheckpointWriter:
    """A background writer with at most one save in flight (world 1).

    ``submit`` waits on the previous save, snapshots the state to the
    host (the blocking part), and hands the payload to a thread that
    writes it under the commit protocol and then runs the retention pass.
    ``wait()`` joins that thread and re-raises its error here; the driver
    calls it before every save, GC and exit.  ``commits`` holds a record
    ``{"step", "write_s", "path"}`` for each landed save."""

    def __init__(self, directory: str | Path, print_fn=None):
        self._dir = Path(directory)
        self._print = print_fn or (lambda s: None)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.commits: collections.deque = collections.deque()

    @property
    def in_flight(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def submit(self, state, gc_keep: int = 0,
               topology: dict | None = None) -> int:
        """Wait on the previous save, snapshot, hand off; returns the
        step snapshotted."""
        self.wait()
        step, payload = snapshot_to_host(state)
        self._thread = threading.Thread(
            target=self._write, args=(step, payload, gc_keep, topology),
            name=f"checkpoint-writer-{step}", daemon=True)
        self._thread.start()
        return step

    def _write(self, step: int, payload: dict, gc_keep: int,
               topology: dict | None) -> None:
        t0 = time.monotonic()
        try:
            path = write_host_payload(payload, self._dir, step, topology)
            if gc_keep:
                # on this thread, after its own commit: no writer to wait
                gc_checkpoints(self._dir, gc_keep, print_fn=self._print)
            dt = time.monotonic() - t0
            self.commits.append({"step": step, "write_s": dt,
                                 "path": str(path)})
            self._print(f"checkpoint saved: {path} (async write "
                        f"{dt:.2f}s, overlapped)")
        except BaseException as e:
            self._error = e

    def wait(self) -> None:
        """Join the write in flight; re-raise its error here."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._error is not None:
            exc, self._error = self._error, None
            exc.add_note("raised in the async checkpoint writer thread, "
                         "re-raised at its next wait()")
            raise exc


# --- discovery, retention, restore -------------------------------------------


def complete_steps(directory: str | Path) -> list[int]:
    """The steps with a commit sentinel, ascending: the only checkpoints
    discovery believes (``.tmp`` and sentinel-less directories are
    crashed saves)."""
    base = Path(directory)
    if not base.exists():
        return []
    return sorted(
        int(m.group(1)) for p in base.iterdir()
        if p.is_dir() and (m := _STEP_RE.fullmatch(p.name))
        and _marker(base, int(m.group(1))).exists())


def latest_step(directory: str | Path) -> int | None:
    steps = complete_steps(directory)
    return steps[-1] if steps else None


def gc_checkpoints(directory: str | Path, keep: int, print_fn=None,
                   writer: AsyncCheckpointWriter | None = None) -> list[int]:
    """``--keep_checkpoints``: keep the newest ``keep`` complete steps,
    delete the older ones and every ``.tmp``; returns the steps deleted.
    Waits on ``writer`` first, whose ``.tmp`` it would otherwise reap
    mid-write.  Sentinel-less ``step_<n>`` directories are left alone:
    they may be checkpoints to adopt by hand."""
    if keep <= 0:
        return []
    if writer is not None:
        writer.wait()
    base = Path(directory)
    doomed = complete_steps(base)[:-keep]
    for step in doomed:
        # the sentinel first: a crash mid-delete leaves no sentinel on
        # a half-deleted directory
        _marker(base, step).unlink(missing_ok=True)
        _topology_sidecar(base, step).unlink(missing_ok=True)
        shutil.rmtree(_step_dir(base, step), ignore_errors=True)
    for p in base.glob("step_*.tmp"):
        shutil.rmtree(p, ignore_errors=True)
    if doomed and print_fn is not None:
        print_fn(f"checkpoint GC: removed step(s) "
                 f"{', '.join(str(s) for s in doomed)} "
                 f"(--keep_checkpoints={keep})")
    return doomed


def _tensors(obj):
    """Every tensor of a nested payload, in a fixed order."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            yield from _tensors(obj[k])
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def fingerprint(tree) -> str:
    """A digest of every tensor's dtype, shape and bytes, in a fixed
    order (a ``state_dict`` or a whole payload)."""
    h = hashlib.blake2b(digest_size=10)
    for t in _tensors(tree):
        t = t.detach().to("cpu")
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        # logical order, whatever the memory format
        h.update(t.contiguous().reshape(-1).view(torch.uint8).numpy()
                 .tobytes() if t.numel() else b"")
    return h.hexdigest()


def load_payload(directory: str | Path, step: int | None = None
                 ) -> tuple[int, dict]:
    """``(step, payload)`` of ``step``, by default the newest complete
    one; raises ``FileNotFoundError`` where there is none, or where
    ``step`` has no sentinel."""
    base = Path(directory)
    if step is None:
        step = latest_step(base)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoints under {base}")
    elif not _marker(base, step).exists():
        raise FileNotFoundError(
            f"checkpoint step {step} under {base} is incomplete (no "
            f"{_marker(base, step).name} sentinel: a crashed save?); "
            f"complete steps: {complete_steps(base) or 'none'}")
    return step, torch.load(_step_dir(base, step) / STATE_FILE,
                            map_location="cpu", weights_only=True)


def restore(state, directory: str | Path, step: int | None = None,
            expect_topology: dict | None = None, rank: int = 0,
            resplit: bool = False) -> dict:
    """Load a checkpoint into ``state`` in place (its model, cut for the
    live model group under TP/EP, optimizer, step and ``rank``'s dropout
    generator); returns the payload.  ``expect_topology``: the live
    record, checked against the sidecar first (``check_topology``).
    ``resplit``: a zero1 state saved at another world is resplit for the
    live one (``restore_elastic``)."""
    from tpu_hc_bench_torch.parallel import collectives, pipeline, tensor

    base = Path(directory)
    if step is None:
        step = latest_step(base)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoints under {base}")
    if expect_topology is not None:
        saved = read_topology(base, step)
        if saved is not None:
            check_topology(saved, expect_topology, base, step)
    if (_step_dir(base, step) / PP_SHARED_FILE).exists():
        return restore_pp(state, base, step, rank=rank)
    step, payload = load_payload(base, step)
    tp = getattr(state, "tp", None)
    pipe = getattr(state, "pipe", None)
    check_layers_layout(state.model.state_dict(), payload["model"], base)
    state.model.load_state_dict(tensor.cut_state_dict(
        pipeline.cut_state_dict(payload["model"], state.model, pipe), tp))
    opt = payload["optimizer"]
    if _zero1(state) != ("zero1_shards" in opt):
        raise TopologyMismatchError(
            f"checkpoint under {base} (step {step}): its optimizer state "
            f"is {'zero1 shards' if 'zero1_shards' in opt else 'whole'}, "
            f"the live arm's is not")
    if _zero1(state):
        shards, world = opt["zero1_shards"], dist.get_world_size()
        if resplit and len(shards) != world:
            shards = collectives.resplit_zero1_opt(
                shards, [p.numel() for p in state.dp.grads.params], world)
        if len(shards) != world:
            raise TopologyMismatchError(
                f"checkpoint under {base} (step {step}): zero1 shards of "
                f"{len(shards)} ranks, live world {world}; relaunch with "
                f"--resume=elastic to reshape")
        opt = shards[dist.get_rank()]
    state.optimizer.load_state_dict(tensor.cut_optimizer_state(
        pipeline.cut_optimizer_state(opt, state.model, pipe), state.model,
        tp))
    state.step = int(payload["step"])
    dropout = (payload.get("rng") or {}).get("dropout")
    gen = getattr(state.model, "dropout_generator", None)
    if gen is not None and dropout and rank < len(dropout):
        gen.set_state(dropout[rank])
    return payload


def restore_elastic(state, directory: str | Path,
                    saved_topology: dict | None, live_world: int,
                    step: int | None = None, rank: int = 0) -> dict:
    """Restore a host-layout checkpoint saved at another world onto the
    live one (``--resume=elastic``; JAX's ``restore_elastic``).  A
    replicated tree is world-neutral and restores as it is; a zero1
    checkpoint holds every one of its N ranks' optimizer shards, which
    are read whole and resplit for ``live_world`` ranks
    (``collectives.resplit_zero1_opt``: the old padding stripped,
    re-padded, restacked), each rank keeping its own."""
    if (saved_topology or {}).get("variable_update") == "zero1" and \
            dist.get_world_size() != int(live_world):
        raise ValueError(f"restore_elastic: live world {live_world}, "
                         f"process group of {dist.get_world_size()}")
    return restore(state, directory, step, rank=rank,
                   resplit=(saved_topology or {}).get("variable_update")
                   == "zero1")


# --- the pp-native layout (several hosts) ------------------------------------

PP_SHARED_FILE = "pp_shared.pt"


def _pp_trunk_file(lo: int, hi: int) -> str:
    return f"pp_trunk_{lo:05d}_{hi:05d}.pt"


def save_pp(state, directory: str | Path,
            topology: dict | None = None) -> Path | None:
    """The pp-native save (JAX's ``save_pp``): every rank calls it.  The
    stages' first data ranks each write their layers' rows stacked (a
    stage's layers gathered over its model group first), rank 0 the
    shared file, then rank 0 commits the step; returns its directory on
    rank 0, None elsewhere."""
    from tpu_hc_bench_torch.parallel import pipeline, tensor

    pipe, model = state.pipe, state.model
    tp = getattr(state, "tp", None)
    sd = _host(tensor.full_state_dict(model, tp))
    names = [n for n, _ in model.named_parameters()]
    opt = _host(tensor.full_optimizer_state(state.optimizer, model, tp))
    per = pipeline.named_optimizer_state(opt, names)
    rng = _dropout_states(model)
    rank, step = dist.get_rank(), int(state.step)
    base = Path(directory)
    tmp = base / (_step_dir(base, step).name + ".tmp")
    if rank == 0:
        base.mkdir(parents=True, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
    dist.barrier()
    lo, hi = pipe.layers
    n = hi - lo

    def layer(d: dict) -> dict:
        return {k: v for k, v in d.items() if k.startswith("layers.")}

    if pipe.writes_rows:
        params, opt_rows = pipeline.pp_state_from_train_state(
            layer(sd), layer(per), n)
        rows = {"params": params, "optimizer": opt_rows}
        with open(tmp / _pp_trunk_file(lo, hi), "wb") as f:
            torch.save(rows, f)
            f.flush()
            os.fsync(f.fileno())
    if rank == 0:
        shared = {"step": step, "num_layers": model.num_layers,
                  "model": {k: v for k, v in sd.items()
                            if not k.startswith("layers.")},
                  "optimizer": {k: v for k, v in per.items()
                                if not k.startswith("layers.")},
                  "param_groups": [{k: v for k, v in g.items()
                                    if k != "params"}
                                   for g in opt["param_groups"]],
                  "rng": {"dropout": rng}}
        with open(tmp / PP_SHARED_FILE, "wb") as f:
            torch.save(shared, f)
            f.flush()
            os.fsync(f.fileno())
    dist.barrier()
    path = _commit_step_dir(base, step, tmp, topology) if rank == 0 else None
    dist.barrier()
    return path


def restore_pp(state, directory: str | Path, step: int | None = None,
               rank: int = 0) -> dict:
    """The pp-native restore (JAX's ``restore_pp``) under any pipe degree:
    the live stage's layers from the trunk files that hold them (cut for
    the live model group), the shared entries from rank 0's file, the
    step and ``rank``'s dropout state; returns the shared payload."""
    from tpu_hc_bench_torch.parallel import pipeline, tensor

    base = Path(directory)
    if step is None:
        step = latest_step(base)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoints under {base}")
    path = _step_dir(base, step)
    load = lambda p: torch.load(p, map_location="cpu",  # noqa: E731
                                weights_only=True)
    shared = load(path / PP_SHARED_FILE)
    model, pipe = state.model, getattr(state, "pipe", None)
    lo = pipe.layers[0] if pipe is not None else 0
    hi = pipe.layers[1] if pipe is not None else model.num_layers
    trunks = []
    for f in sorted(path.glob("pp_trunk_*.pt")):
        a, b = (int(x) for x in f.stem.split("_")[2:4])
        if a < hi and b > lo:
            trunks.append((a, b, load(f)))

    def row(i: int, kind: str, name: str):
        for a, b, t in trunks:
            if a <= i < b:
                v = t[kind][pipeline.TRUNK + name]
                return ({k: x[i - a] for k, x in v.items()}
                        if kind == "optimizer" else v[i - a])
        raise FileNotFoundError(f"checkpoint under {path}: no trunk file "
                                f"holds layer {i}")

    def split(name: str):
        m = pipeline._LAYER.fullmatch(name)
        return None if m is None else (lo + int(m.group(1)), m.group(2))

    sd = {}
    for k in model.state_dict():
        at = split(k)
        sd[k] = (shared["model"][k] if at is None
                 else row(at[0], "params", at[1]))
    tp = getattr(state, "tp", None)
    model.load_state_dict(tensor.cut_state_dict(sd, tp))
    names = [n for n, _ in model.named_parameters()]
    opt_state = {}
    for i, n in enumerate(names):
        at = split(n)
        st = (shared["optimizer"].get(n) if at is None
              else row(at[0], "optimizer", at[1]))
        if st:
            opt_state[i] = st
    groups = [{**g, "params": list(range(len(names)))}
              for g in shared["param_groups"]]
    state.optimizer.load_state_dict(tensor.cut_optimizer_state(
        {"state": opt_state, "param_groups": groups}, model, tp))
    state.step = int(shared["step"])
    dropout = (shared.get("rng") or {}).get("dropout")
    gen = getattr(model, "dropout_generator", None)
    if gen is not None and dropout and rank < len(dropout):
        gen.set_state(dropout[rank])
    return shared
