"""AST lint passes over the port's sources, and the model passes over
the port's zoo (the JAX package's ``analysis/lints.py``).

Every pass keeps JAX's name, severity, scope and idiom, so JAX's own
fixtures fire the same here, and each also learns the port's idiom:
tracing callees ``torch.compile``, ``torch.cuda.graph`` (a ``with``
body), ``make_graphed_callables``, ``torch.func.*``; host syncs
``.cpu()``, ``.item()``, ``.tolist()``, ``torch.cuda.synchronize``;
memory probes ``torch.cuda.memory_allocated``, ``max_memory_allocated``,
``mem_get_info``; the dequantize shape ``q.float() * scale``; the serve
package's mid-traffic build (``ops._build.load_library``/
``build_stamped``, ``cudnn.benchmark``) outside the warmup namespace;
the port's ``KNOWN_SPANS``, ``KNOWN_SIGNALS``, ``PageAllocator`` and
``ServeEngine`` terminal calls.  The model passes read a meta-device
build of a member (``sharding-consistency``) and the op census of
``analysis.census`` (the forward's host syncs, the zero1 step's
collectives) where JAX reads the jaxpr and the compiled HLO.

The families of defects checked statically:

- **host-sync-in-jit** (error): a host round-trip inside traced code —
  ``.item()``, ``jax.device_get``, ``block_until_ready``,
  ``np.array``/``np.asarray`` on a traced value.  At best these bake a
  constant at trace time; at worst (under real jit) they throw a
  ``ConcretizationTypeError`` only on the first hardware run.  Checked
  two ways: over the AST of functions that are traced (passed to
  ``jax.jit``/``jax.shard_map``/``pallas_call``/``lax`` control flow,
  flax ``nn.Module`` methods, and anything nested in those), and over
  the model's jaxpr (``pure_callback``/``io_callback``/host callbacks).
- **recompile-hazard**: Python-scalar closure leaks — a traced function
  reading a free variable its enclosing scope *mutates* (for-loop
  target / augmented assignment), which bakes a different constant per
  call and recompiles every step (warning) — and shape-dependent
  branching against numeric literals, which silently forks compilations
  per shape class (info; shape-vs-shape residual branches are the
  normal static idiom and do not flag).
- **donated-buffer-misuse** (warning): a buffer passed in a
  ``donate_argnums`` position of a jitted call and then read again
  later in the same scope — donation invalidates it, and XLA's runtime
  error surfaces far from the offending read.
- **checkpoint-topology** (warning): a checkpoint-writing call site
  (``ckpt.save``/``save_pp``/``write_host_payload``/an async writer's
  ``submit``) that does not pass a ``topology=`` sidecar record.  The
  elastic-resume path can only re-place a checkpoint whose
  save recorded the world/mesh/arm it was written under; a save path
  added without the sidecar silently produces checkpoints that resume
  on the identical mesh only.
- **input-pool-width** (warning): an ImageNet/TFRecord pipeline
  constructed with an explicit decode pool wider than the host budget
  cap (``max(32, cpu_count())`` — machine-stable up to 32 cores), or a
  full-host-width *private* pool — at workers-per-host > 1 the
  per-process pools oversubscribe the CPUs and bypass the shared input
  service's one-pool-per-host budget (``data/service.py``).
- **memory-probe-in-hot-loop** (warning): a device-memory probe
  (``jax.live_arrays``, ``jax.profiler.device_memory_profile``,
  ``obs.memory.device_memory_sample``/``device_memory_stats``, a
  memory ledger's ``.sample``) called in the body of a loop without a
  sync-window boundary guard.  Every one of these walks the backend's
  live-buffer table (or serializes a pprof blob) on the host — inside
  the timed step loop that is a per-step host stall the async-dispatch
  design exists to avoid.  The accepted idiom is the driver's: one poll
  per sync window, under an ``i % sync_every == 0``-shaped guard (any
  modulo test, or a condition spelling ``sync``/``window``).  The check
  is lexical — a probe wrapped in a helper called from the loop is on
  the reviewer — and loop headers (``for a in jax.live_arrays():``,
  the probes' own implementation) are exempt.
- **span-in-compiled-fn** (error): an ``obs.timeline`` flight-recorder
  call (``span``/``record_span``/``instant``/``transition``) inside
  traced code.  The recorder reads the host monotonic clock and stores
  into a host-side ring; traced, the clock read bakes ONE constant
  timestamp into the compiled program and the span lies in every
  execution after the first.  Recorder calls wrap the *dispatch* of
  compiled work (the driver/serve-engine idiom), never live inside it.
- **span-name-registry** (warning): a literal span name at a
  ``timeline.span``/``record_span``/``instant`` call site that is not
  registered in ``obs.timeline.KNOWN_SPANS``.  Folds key on span names,
  so a typo'd name records fine and silently vanishes from every
  timeline consumer; the registry makes the typo a CI finding.
- **fleet-blocking-wait** (error): a no-timeout ``.wait()``/``.join()``
  inside a loop body under ``fleet/`` — the fleet control
  loop is one thread supervising N jobs, and an unbounded block on any
  single process/thread freezes scheduling (reaps, liveness, churn)
  for the whole pool.  Bounded forms (``wait(5)``,
  ``join(timeout=...)``) and poll+sleep loops pass.
- **sharding-consistency** (warning): per model, the Megatron
  annotation table (``train.step.tp_param_spec``) is replayed against
  the abstractly-initialized param tree: a rule whose *name* matches a
  param but whose *rank* doesn't (annotation drift after a model
  refactor), a model-axis-sharded dimension not divisible by the
  minimum TP degree, and column/row rule pairs where one direction of a
  block matched but its partner did not (the asymmetry that makes GSPMD
  insert per-layer reshards at the pjit boundary).

Suppression: append ``# tpu-hc: disable=<lint>`` (or the legacy
``# thb:lint-ok[<lint>]``) to the offending line — suppression hits are
counted into the findings JSON so they stay auditable — or accept the
finding into the checked-in baseline (see ``report.py``).

The passes register themselves in ``analysis.registry`` (one
``@register_pass`` per check carrying name/severity/scope/docs), and
``run()`` iterates the registry instead of a hand-coded sequence — the
distributed-correctness passes in ``analysis.dataflow`` plug in without
touching this file.
"""

from __future__ import annotations

import ast
import collections
import functools
import os
import re
import symtable
from pathlib import Path

from tpu_hc_bench_torch.analysis import registry
from tpu_hc_bench_torch.analysis.registry import register_pass
from tpu_hc_bench_torch.analysis.report import Finding

__all__ = [
    "lint_source_text", "lint_file", "lint_repo_sources", "lint_model",
    "check_zero1_collectives", "check_tuned_registry",
    "check_sharding_consistency", "check_forward_host_syncs",
    "zero1_shape_findings", "ALL_SOURCE_LINTS",
]

HOST_SYNC = "host-sync-in-jit"
RECOMPILE = "recompile-hazard"
DONATION = "donated-buffer-misuse"
SHARDING = "sharding-consistency"
COLLECTIVE_SHAPE = "collective-shape"
CKPT_TOPOLOGY = "checkpoint-topology"
INPUT_POOL = "input-pool-width"
TUNED_STALENESS = "tuned-config-staleness"
HOT_MEMORY = "memory-probe-in-hot-loop"
SERVE_RECOMPILE = "serve-bucket-recompile"
SPAN_IN_JIT = "span-in-compiled-fn"
DEQUANT_HOT = "dequantize-in-hot-loop"
FLEET_WAIT = "fleet-blocking-wait"
SPAN_REGISTRY = "span-name-registry"
RETIRE_STATUS = "retire-without-status"
SIGNAL_REGISTRY = "signal-name-registry"
PAGE_REFCOUNT = "page-refcount-discipline"
ALL_SOURCE_LINTS = (HOST_SYNC, RECOMPILE, DONATION, CKPT_TOPOLOGY,
                    INPUT_POOL, HOT_MEMORY, SERVE_RECOMPILE, SPAN_IN_JIT,
                    DEQUANT_HOT, FLEET_WAIT, SPAN_REGISTRY, RETIRE_STATUS,
                    SIGNAL_REGISTRY, PAGE_REFCOUNT)

# callables whose function-valued arguments are traced (jit contexts)
_TRACING_CALLEES = {
    "jit", "pjit", "shard_map", "pallas_call", "checkpoint", "remat",
    "scan", "while_loop", "fori_loop", "cond", "switch", "vmap", "pmap",
    "grad", "value_and_grad", "custom_vjp", "custom_jvp",
    # the port's: torch.compile, CUDA graph capture, torch.func
    "compile", "make_graphed_callables", "functional_call", "jacrev",
    "jacfwd", "jvp", "vjp", "hessian",
}
# `with torch.cuda.graph(g):` captures its body: a traced context
_CAPTURE_CONTEXTS = {"graph"}
# attribute/function calls that force a host round-trip on traced values
# (`.cpu()`/`.numpy()` are the port's device->host copies)
_HOST_SYNC_METHODS = {"item", "block_until_ready", "tolist", "cpu",
                      "numpy"}
_HOST_SYNC_FUNCS = {"device_get", "block_until_ready"}
# torch.cuda.synchronize / torch.cuda.current_stream().synchronize
_TORCH_SYNC_FUNCS = {"synchronize"}
_NUMPY_ALIASES = {"np", "numpy", "onp"}
_NUMPY_MATERIALIZERS = {"array", "asarray"}

_SUPPRESS_TOKEN = "thb:lint-ok["
_DISABLE_RE = re.compile(r"tpu-hc:\s*disable=([A-Za-z0-9_,-]+)")


def _suppressed_lines(source: str) -> dict[int, set[str]]:
    """Per-line suppressions, by 1-based line number: the
    ``# tpu-hc: disable=<name>[,<name>…]`` spelling plus the legacy
    ``# thb:lint-ok[name]``."""
    out: dict[int, set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        pos = line.find(_SUPPRESS_TOKEN)
        while pos != -1:
            end = line.find("]", pos)
            if end == -1:
                break
            out.setdefault(i, set()).add(
                line[pos + len(_SUPPRESS_TOKEN):end].strip())
            pos = line.find(_SUPPRESS_TOKEN, end)
        for m in _DISABLE_RE.finditer(line):
            out.setdefault(i, set()).update(
                name.strip() for name in m.group(1).split(",")
                if name.strip())
    return out


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of a call target ('jax.jit', 'np.array')."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _callee_basename(call: ast.Call) -> str:
    name = _dotted(call.func)
    base = name.rsplit(".", 1)[-1]
    if base == "partial":  # functools.partial(jax.jit, ...) etc.
        if call.args:
            return _callee_basename(
                call.args[0]) if isinstance(call.args[0], ast.Call) \
                else _dotted(call.args[0]).rsplit(".", 1)[-1]
    return base


class _FileLinter:
    """All AST passes over one Python source file."""

    def __init__(self, source: str, filename: str, model: str = "repo",
                 cpu_count: int | None = None):
        self.source = source
        self.filename = filename
        self.model = model
        self.cpu_count = cpu_count or (os.cpu_count() or 1)
        self.tree = ast.parse(source, filename=filename)
        self.suppressed = _suppressed_lines(source)
        try:
            self.symtab = symtable.symtable(source, filename, "exec")
        except Exception:
            self.symtab = None
        # parent links + enclosing-function chains
        self._parents: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self._parents[child] = node
        self.findings: list[Finding] = []
        self.suppression_hits: collections.Counter = collections.Counter()

    # -- shared helpers ------------------------------------------------

    def _emit(self, lint: str, node: ast.AST, message: str,
              severity: str | None = None):
        """Record a finding.  ``severity`` defaults to the pass's
        registered severity; pass it explicitly only for a site that
        deliberately deviates (the recompile pass's info-grade
        shape-vs-literal branch)."""
        line = getattr(node, "lineno", 0)
        if lint in self.suppressed.get(line, ()):
            self.suppression_hits[lint] += 1
            return
        if severity is None:
            severity = registry.default_severity(lint)
        self.findings.append(Finding(
            lint=lint, severity=severity, model=self.model,
            location=f"{self.filename}:{line}", message=message))

    def _enclosing_functions(self, node: ast.AST) -> list[ast.AST]:
        chain = []
        cur = self._parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                chain.append(cur)
            cur = self._parents.get(cur)
        return chain

    def _is_flax_module_class(self, cls: ast.ClassDef) -> bool:
        for base in cls.bases:
            name = _dotted(base)
            if name.endswith("Module") or name in ("nn.Module",):
                return True
        return False

    # -- jit-context discovery ----------------------------------------

    def _jit_contexts(self) -> list[ast.AST]:
        """FunctionDefs whose bodies run under trace.

        A function is a jit context if it is (a) decorated with a tracing
        transform or ``nn.compact``, (b) referenced by name as an
        argument to a tracing callee (``jax.jit(f)``,
        ``jax.shard_map(step, ...)``, ``lax.scan(body, ...)``,
        ``pl.pallas_call(kernel, ...)`` — including through
        ``functools.partial(kernel, ...)``), (c) a method of a flax
        ``nn.Module`` subclass named ``__call__``/``setup``, or (d)
        nested inside any of those.
        """
        traced_names: set[str] = set()   # function names used as traced args
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            base = _callee_basename(node)
            args = list(node.args)
            if base == "checkpoint" and self._eager_checkpoint(node):
                continue
            if base in _TRACING_CALLEES:
                for a in args:
                    if isinstance(a, ast.Name):
                        traced_names.add(a.id)
                    elif isinstance(a, ast.Call) and \
                            _callee_basename(a) == "partial":
                        for pa in a.args:
                            if isinstance(pa, ast.Name):
                                traced_names.add(pa.id)

        contexts: list[ast.AST] = []
        for node in ast.walk(self.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            is_ctx = node.name in traced_names
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                base = _dotted(target).rsplit(".", 1)[-1]
                if base in _TRACING_CALLEES or base == "compact":
                    is_ctx = True
                if base == "partial" and isinstance(dec, ast.Call) \
                        and dec.args:
                    if _dotted(dec.args[0]).rsplit(".", 1)[-1] \
                            in _TRACING_CALLEES:
                        is_ctx = True
            parent = self._parents.get(node)
            if isinstance(parent, ast.ClassDef) \
                    and self._is_flax_module_class(parent) \
                    and node.name in ("__call__", "setup"):
                is_ctx = True
            if is_ctx:
                contexts.append(node)
        # close over nesting: functions defined inside a context trace too
        closed: list[ast.AST] = []
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node in contexts or any(
                        f in contexts for f in
                        self._enclosing_functions(node)):
                    closed.append(node)
        # the port's capture blocks (`with torch.cuda.graph(g):`), unless
        # a traced function already holds them
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    isinstance(it.context_expr, ast.Call)
                    and _callee_basename(it.context_expr)
                    in _CAPTURE_CONTEXTS
                    and "cuda" in _dotted(it.context_expr.func)
                    for it in node.items) and not any(
                    f in closed for f in self._enclosing_functions(node)):
                closed.append(node)
        return closed

    @functools.cached_property
    def _eager_checkpoint_names(self) -> set[str]:
        """Local names bound by ``from torch.utils.checkpoint import X
        [as Y]``."""
        out: set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ImportFrom) \
                    and node.module == "torch.utils.checkpoint":
                out.update(a.asname or a.name for a in node.names)
        return out

    def _eager_checkpoint(self, call: ast.Call) -> bool:
        """``torch.utils.checkpoint.checkpoint(fn, ...)`` recomputes
        ``fn`` eagerly in the backward: unlike ``jax.checkpoint`` it
        traces nothing."""
        name = _dotted(call.func)
        return ("utils.checkpoint" in name
                or (isinstance(call.func, ast.Name)
                    and call.func.id in self._eager_checkpoint_names))

    # -- pass: host sync inside traced code ---------------------------

    @register_pass(
        HOST_SYNC, "error", "jit",
        doc="host round-trip (.item(), .cpu(), device_get, "
            "torch.cuda.synchronize, np.array on traced values) inside "
            "traced code — bakes a constant or throws on first hardware "
            "run",
        example="`.item()` inside a shard_map'd step fn")
    def _check_host_sync(self, ctx: ast.AST):
        for node in ast.walk(ctx):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            base = name.rsplit(".", 1)[-1]
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _HOST_SYNC_METHODS \
                    and not node.args:
                self._emit(
                    HOST_SYNC, node,
                    f".{node.func.attr}() forces a device->host sync at "
                    f"trace time inside `{getattr(ctx, 'name', '?')}`; "
                    "return the array and sync outside the jitted region")
            elif base in _HOST_SYNC_FUNCS and name.startswith(
                    ("jax.", "device_get", "block_until_ready")):
                self._emit(
                    HOST_SYNC, node,
                    f"{name}() inside traced `{getattr(ctx, 'name', '?')}` "
                    "is a host round-trip; hoist it out of the jit")
            elif base in _TORCH_SYNC_FUNCS and "cuda" in name:
                self._emit(
                    HOST_SYNC, node,
                    f"{name}() inside traced `{getattr(ctx, 'name', '?')}` "
                    "waits for the card on the host; hoist it out of the "
                    "compiled or captured region")
            elif "." in name and name.split(".", 1)[0] in _NUMPY_ALIASES \
                    and base in _NUMPY_MATERIALIZERS:
                self._emit(
                    HOST_SYNC, node,
                    f"{name}() materializes a traced value on host inside "
                    f"`{getattr(ctx, 'name', '?')}`; use jnp instead")

    # -- pass: recompilation hazards ----------------------------------

    def _locals_of(self, func: ast.AST) -> set[str]:
        """Parameter + locally-bound names of a FunctionDef (via symtable,
        matched by name and line)."""
        if self.symtab is None:
            return set()

        def find(table):
            if table.get_type() == "function" \
                    and table.get_name() == getattr(func, "name", None) \
                    and table.get_lineno() == func.lineno:
                return table
            for child in table.get_children():
                got = find(child)
                if got is not None:
                    return got
            return None

        table = find(self.symtab)
        if table is None:
            return set()
        return {s.get_name() for s in table.get_symbols()
                if s.is_local() or s.is_parameter()}

    def _free_vars_of(self, func: ast.AST) -> set[str]:
        if self.symtab is None:
            return set()

        def find(table):
            if table.get_type() == "function" \
                    and table.get_name() == getattr(func, "name", None) \
                    and table.get_lineno() == func.lineno:
                return table
            for child in table.get_children():
                got = find(child)
                if got is not None:
                    return got
            return None

        table = find(self.symtab)
        if table is None:
            return set()
        return {s.get_name() for s in table.get_symbols() if s.is_free()}

    @register_pass(
        RECOMPILE, "warning", "jit",
        doc="recompilation hazards: traced fn closing over a mutated "
            "Python scalar (warning), shape-vs-numeric-literal branching "
            "(info)",
        example="`for step in range(n): jitted_fn()` where the traced fn "
                "reads `step` as a free variable")
    def _check_recompile(self, ctx: ast.AST):
        # (a) closure leaks: free vars the enclosing scope mutates
        free = self._free_vars_of(ctx)
        if free:
            for enclosing in self._enclosing_functions(ctx):
                mutated: dict[str, ast.AST] = {}
                for node in ast.walk(enclosing):
                    if isinstance(node, ast.AugAssign) \
                            and isinstance(node.target, ast.Name):
                        mutated.setdefault(node.target.id, node)
                    elif isinstance(node, ast.For) \
                            and isinstance(node.target, ast.Name):
                        mutated.setdefault(node.target.id, node)
                for name in sorted(free & set(mutated)):
                    self._emit(
                        RECOMPILE, mutated[name],
                        f"traced `{getattr(ctx, 'name', '?')}` closes over "
                        f"`{name}`, which this scope mutates — each new "
                        "value bakes a fresh constant and recompiles; pass "
                        "it as a traced argument instead")
        # (b) shape-vs-literal branching (shape-vs-shape is the normal
        # static residual-path idiom and stays silent)
        for node in ast.walk(ctx):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            for cmp in ast.walk(node.test):
                if not isinstance(cmp, ast.Compare):
                    continue
                sides = [cmp.left, *cmp.comparators]
                shapeish = [s for s in sides if self._mentions_shape(s)]
                literal = [s for s in sides
                           if isinstance(s, ast.Constant)
                           and isinstance(s.value, (int, float))]
                if shapeish and literal:
                    self._emit(
                        RECOMPILE, cmp,
                        "branching on a shape vs a numeric literal forks "
                        "one compilation per shape class; make sure every "
                        "class is intended (use static_argnums/config if "
                        "it encodes a mode)", severity="info")

    @staticmethod
    def _mentions_shape(node: ast.AST) -> bool:
        for n in ast.walk(node):
            if isinstance(n, ast.Attribute) and n.attr == "shape":
                return True
            if isinstance(n, ast.Call) and _dotted(n.func) == "len":
                return True
        return False

    # -- pass: donated-buffer misuse ----------------------------------

    @staticmethod
    def _own_nodes(scope: ast.AST):
        """Walk a scope WITHOUT descending into nested scopes, so a
        nested function's parameters never alias this scope's names."""
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            node = stack.pop(0)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    @register_pass(
        DONATION, "warning", "file",
        doc="a buffer passed in a donate_argnums position of a jitted "
            "call and read again afterwards — donation invalidated it",
        example="`loss = step(state, batch); print(state)` with "
                "donate_argnums=(0,)")
    def _check_donation(self):
        """Within each function scope: a name passed in a donated
        position of a jitted callable, then *read* again afterwards.

        Only the scope's OWN statements participate — a nested function
        calling the jitted callable with its own parameters is a fresh
        binding per call and is fine by construction.
        """
        scopes = [self.tree] + [
            n for n in ast.walk(self.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for scope in scopes:
            jitted: dict[str, tuple[int, ...]] = {}
            for node in self._own_nodes(scope):
                if isinstance(node, ast.Assign) \
                        and isinstance(node.value, ast.Call) \
                        and _callee_basename(node.value) in ("jit", "pjit"):
                    donate = self._donated_positions(node.value)
                    if donate and len(node.targets) == 1 \
                            and isinstance(node.targets[0], ast.Name):
                        jitted[node.targets[0].id] = donate
            if not jitted:
                continue
            self._scan_donation_scope(scope, jitted)

    @staticmethod
    def _donated_positions(call: ast.Call) -> tuple[int, ...]:
        for kw in call.keywords:
            if kw.arg == "donate_argnums":
                v = kw.value
                if isinstance(v, ast.Constant) and isinstance(v.value, int):
                    return (v.value,)
                if isinstance(v, (ast.Tuple, ast.List)):
                    return tuple(e.value for e in v.elts
                                 if isinstance(e, ast.Constant)
                                 and isinstance(e.value, int))
        return ()

    def _scan_donation_scope(self, scope: ast.AST,
                             jitted: dict[str, tuple[int, ...]]):
        # document-order scan of the scope's OWN statements; per stmt:
        # flag reads of donated names, then record new donations, then
        # clear rebound targets (so `state = jitted(state, ...)` — the
        # idiomatic donate-and-rebind — never flags)
        stmts: list[ast.stmt] = [n for n in self._own_nodes(scope)
                                 if isinstance(n, ast.stmt)]
        stmts.sort(key=lambda n: (n.lineno, n.col_offset))
        donated_at: dict[str, ast.AST] = {}
        for stmt in stmts:
            sub = [stmt] + [n for n in self._own_nodes(stmt)]
            for node in sub:
                if isinstance(node, ast.Name) \
                        and isinstance(node.ctx, ast.Load) \
                        and node.id in donated_at:
                    call = donated_at.pop(node.id)
                    self._emit(
                        DONATION, node,
                        f"`{node.id}` was donated to a jitted call "
                        f"(line {call.lineno}) and is read again here "
                        "— the buffer is invalidated by donation; "
                        "rebind the result or drop donate_argnums")
            for node in sub:
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Name) \
                        and node.func.id in jitted:
                    for pos in jitted[node.func.id]:
                        if pos < len(node.args) and isinstance(
                                node.args[pos], ast.Name):
                            donated_at[node.args[pos].id] = node
            for tgt in self._assigned_names(stmt):
                donated_at.pop(tgt, None)

    @staticmethod
    def _assigned_names(stmt: ast.stmt) -> set[str]:
        out: set[str] = set()
        if isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                for n in ast.walk(tgt):
                    if isinstance(n, ast.Name):
                        out.add(n.id)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)) \
                and isinstance(stmt.target, ast.Name):
            out.add(stmt.target.id)
        return out

    # -- pass: checkpoint writes without a topology sidecar ------------

    # module aliases under which this repo's checkpoint API is called
    # (`ckptr`, the orbax PyTreeCheckpointer convention, deliberately
    # does NOT match: its .save is the raw writer the protocol wraps)
    _CKPT_MODULE_ALIASES = {"ckpt", "ckpt_mod", "checkpoint"}

    @register_pass(
        CKPT_TOPOLOGY, "warning", "file",
        doc="a checkpoint-writing call site without a topology= sidecar "
            "— the save resumes on the identical mesh only",
        example="`ckpt.save(path, state)` with no topology record")
    def _check_checkpoint_topology(self):
        """Checkpoint-writing call sites must pass ``topology=``: the
        elastic-resume sidecar is only as complete as the save paths
        that record it, and a new call site that forgets it produces
        checkpoints that resume on the identical mesh only."""
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            base = name.rsplit(".", 1)[-1]
            prefix = name.rsplit(".", 2)[-2] if "." in name else ""
            hit = (base in ("save_pp", "write_host_payload")
                   or (base == "save"
                       and prefix in self._CKPT_MODULE_ALIASES)
                   or (base == "submit" and "ckpt" in prefix.lower()))
            if not hit:
                continue
            if any(kw.arg == "topology" for kw in node.keywords):
                continue
            if any(kw.arg is None for kw in node.keywords):
                continue    # **kwargs splat: can't see inside
            self._emit(
                CKPT_TOPOLOGY, node,
                f"checkpoint write `{name}(...)` without a `topology=` "
                "sidecar record — the checkpoint will refuse/skip "
                "elastic resume; pass topology.topology_record(...) "
                "(or None deliberately, with a thb:lint-ok note)")

    # -- pass: input decode-pool width ---------------------------------

    # call sites that construct a per-worker input pipeline with its
    # own decode pool (the service factories own the HOST budget and
    # are deliberately exempt)
    _INPUT_PIPELINE_CALLEES = {"ImageNetDataset"}

    @register_pass(
        INPUT_POOL, "warning", "file",
        doc="a private input decode pool wider than the host budget cap "
            "(or full-host-width) — oversubscribes CPUs at "
            "workers-per-host > 1",
        example="`ImageNetDataset(decode_workers=cpu_count())` in a "
                "per-worker pipeline")
    def _check_input_pool(self):
        """An ImageNet/TFRecord pipeline constructed with an explicit
        decode pool wider than the host, or a full-host-width private
        pool — at workers-per-host > 1 either oversubscribes the CPUs
        the input service exists to budget (``--input_service=on``
        routes every worker through ONE host pool).

        The explicit-constant threshold is ``max(32, cpu_count)`` — 32
        is the data layer's own pool cap (``imagenet
        .host_decode_budget``), so the verdict on a literal width is
        stable across dev/CI machines up to 32 cores instead of
        flapping with whatever host happens to run the gate.
        """
        limit = max(32, self.cpu_count)
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            if _callee_basename(node) not in self._INPUT_PIPELINE_CALLEES:
                continue
            for kw in node.keywords:
                if kw.arg != "decode_workers":
                    continue
                v = kw.value
                if isinstance(v, ast.Constant) \
                        and isinstance(v.value, int) \
                        and v.value > limit:
                    self._emit(
                        INPUT_POOL, node,
                        f"explicit decode pool width {v.value} exceeds "
                        f"the host budget cap max(32, cpu_count)="
                        f"{limit} — the pool oversubscribes the host; "
                        "size the host budget via "
                        "--service_decode_workers (input service) or "
                        "divide by the local worker count")
                elif self._full_width_expr(v):
                    self._emit(
                        INPUT_POOL, node,
                        "private decode pool sized to the FULL host "
                        "(cpu_count()) — at workers-per-host > 1 the "
                        "per-process pools oversubscribe the CPUs and "
                        "bypass the shared input service's one-pool-per-"
                        "host budget; route input through data.service "
                        "or divide the width by the local worker count")

    @staticmethod
    def _full_width_expr(node: ast.AST) -> bool:
        has_cpu = any(
            isinstance(n, ast.Call)
            and _dotted(n.func).rsplit(".", 1)[-1] == "cpu_count"
            for n in ast.walk(node))
        divided = any(
            isinstance(n, ast.BinOp)
            and isinstance(n.op, (ast.FloorDiv, ast.Div))
            for n in ast.walk(node))
        return has_cpu and not divided

    # -- pass: memory probes inside the hot loop -----------------------

    # host-stalling device-memory probe callees (obs.memory + the raw
    # jax surfaces they wrap)
    _MEMORY_PROBE_CALLEES = {"live_arrays", "device_memory_profile",
                             "device_memory_sample", "device_memory_stats",
                             "live_buffer_breakdown",
                             # the port's torch.cuda probes and its
                             # obs.memory walk of the live tensors
                             "memory_allocated", "max_memory_allocated",
                             "mem_get_info", "memory_stats",
                             "live_tensor_breakdown"}

    @register_pass(
        HOT_MEMORY, "warning", "file",
        doc="a device-memory probe (jax.live_arrays, "
            "torch.cuda.memory_allocated, mem_get_info) in a loop body "
            "without a sync-window boundary guard — a per-iteration host "
            "stall",
        example="`jax.live_arrays()` called every step of the timed loop")
    def _check_memory_probe_hot_loop(self):
        """A device-memory probe in a loop body must sit behind a
        sync-window boundary guard (a modulo test, or a condition
        spelling ``sync``/``window``) — the driver's one-poll-per-window
        contract.  Loop headers and probes inside nested function defs
        (executed on call, not per iteration) are exempt."""
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            base = name.rsplit(".", 1)[-1]
            probe = (base in self._MEMORY_PROBE_CALLEES
                     or (base == "sample" and "mem" in name.lower()))
            if not probe:
                continue
            loop = self._enclosing_loop_body(node)
            if loop is None or self._window_guarded(node, loop):
                continue
            self._emit(
                HOT_MEMORY, node,
                f"device-memory probe `{name}(...)` inside a loop body "
                "without a sync-window boundary guard — each call walks "
                "the live-buffer table on the host, a per-iteration "
                "stall in what may be the timed step loop; poll once "
                "per sync window (`i % sync_every == 0`) like the "
                "driver's HBM ledger, or move the probe out of the loop")

    def _enclosing_loop_body(self, node: ast.AST) -> ast.AST | None:
        """The nearest For/While whose BODY contains ``node`` — None
        when the walk first crosses a function boundary (a nested def's
        body runs on call, not per iteration) or when ``node`` only
        appears in a loop's header (`for a in probe():`)."""
        cur = self._parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return None
            if isinstance(cur, (ast.For, ast.AsyncFor, ast.While)):
                header = (cur.test if isinstance(cur, ast.While)
                          else cur.iter)
                if not any(n is node for n in ast.walk(header)):
                    return cur
            cur = self._parents.get(cur)
        return None

    def _window_guarded(self, node: ast.AST, loop: ast.AST) -> bool:
        cur = self._parents.get(node)
        while cur is not None and cur is not loop:
            if isinstance(cur, ast.If) and self._boundary_test(cur.test):
                return True
            cur = self._parents.get(cur)
        return False

    @staticmethod
    def _boundary_test(test: ast.AST) -> bool:
        for n in ast.walk(test):
            if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mod):
                return True
            spelled = None
            if isinstance(n, ast.Name):
                spelled = n.id
            elif isinstance(n, ast.Attribute):
                spelled = n.attr
            if spelled and ("sync" in spelled or "window" in spelled):
                return True
        return False

    # -- pass: dequantize in a hot loop --------------------------------

    # identifiers that mark a value as a quantized/cached int8 buffer
    # (lexical, like the memory-probe pass — a quantized buffer hidden
    # behind an innocent name is on the reviewer).  A bare `q` is NOT
    # quantish: it is the attention convention for the query
    _QUANTISH = re.compile(r"int8|quant|_q8?($|_)|(^|_)q8($|_)")
    _LOOP_TRACERS = {"scan", "fori_loop", "while_loop"}
    # the casts of a dequantize: JAX's `.astype(dt)`, the port's
    # `.float()`, `.to(dt)`, `.half()`, `.bfloat16()`
    _DEQUANT_CASTS = {"astype", "float", "to", "half", "bfloat16"}

    @functools.cached_property
    def _loop_traced_funcs(self) -> set[ast.AST]:
        """FunctionDefs passed (by name, incl. through partial) to
        ``lax.scan``/``fori_loop``/``while_loop`` — their bodies run
        once per iteration, same as a Python loop body."""
        names: set[str] = set()
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            if _callee_basename(node) not in self._LOOP_TRACERS:
                continue
            for a in node.args:
                if isinstance(a, ast.Name):
                    names.add(a.id)
                elif isinstance(a, ast.Call) \
                        and _callee_basename(a) == "partial":
                    for pa in a.args:
                        if isinstance(pa, ast.Name):
                            names.add(pa.id)
        return {n for n in ast.walk(self.tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                and n.name in names}

    @register_pass(
        DEQUANT_HOT, "error", "file",
        doc="elementwise dequantize (`q.astype(f32) * scale`, "
            "`q.float() * scale`) of a cached int8 buffer inside a "
            "scan/loop body — a full-width f32 copy per iteration",
        example="`w_q8.astype(jnp.float32) * w_scale` inside the decode "
                "scan body instead of the scale-fused matmul form")
    def _check_dequant_hot_loop(self):
        """**dequantize-in-hot-loop** (error): ``X.astype(...)`` of a
        quantized/cached int8 buffer used as a bare operand of an
        elementwise ``*`` inside a scan/loop body.  That shape is the
        dense-dequant anti-pattern: a full-width f32 copy of the
        cached buffer materializes on every iteration of the hot loop
        (every decode layer / scan step).  The accepted forms keep the
        dequantize *scale-fused*: the int8 operand feeds the matmul
        and the per-channel scale multiplies the matmul OUTPUT
        (``einsum(spec, x, q.astype(dt)) * scale`` —
        ``serve.decode._qeinsum``), or the astype lives inside a
        Pallas kernel next to its matmul (``ops.paged_attention``).
        Detection is lexical (the buffer's identifiers must spell
        int8/quant/_q, like the memory-probe pass); loop headers and
        nested defs are exempt through the same loop-body walk.
        """
        for node in ast.walk(self.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self._DEQUANT_CASTS):
                continue
            parent = self._parents.get(node)
            if not (isinstance(parent, ast.BinOp)
                    and isinstance(parent.op, ast.Mult)):
                continue
            idents = set()
            for n in ast.walk(node.func.value):
                if isinstance(n, ast.Name):
                    idents.add(n.id)
                elif isinstance(n, ast.Attribute):
                    idents.add(n.attr)
            if not any(self._QUANTISH.search(i) for i in idents):
                continue
            in_loop = self._enclosing_loop_body(node) is not None
            if not in_loop:
                in_loop = any(f in self._loop_traced_funcs
                              for f in self._enclosing_functions(node))
            if not in_loop:
                continue
            src = _dotted(node.func.value) or "<expr>"
            self._emit(
                DEQUANT_HOT, node,
                f"`{src}.{node.func.attr}(...) * scale` dequantizes a "
                "cached "
                "int8 buffer elementwise inside a scan/loop body — a "
                "full-width f32 copy materializes every iteration; "
                "use the scale-fused matmul form instead (int8 feeds "
                "the einsum/dot, the per-channel scale multiplies the "
                "matmul OUTPUT — serve.decode._qeinsum), or dequantize "
                "inside the kernel next to its matmul "
                "(ops.paged_attention)")

    # -- pass: flight-recorder calls inside traced code ----------------

    # obs.timeline's recorder surface: host-clock reads + ring stores —
    # traced into a jit/AOT program they bake ONE constant timestamp at
    # trace time (and the span never measures anything again), exactly
    # the silent-lie class the recorder's host-side contract forbids
    _SPAN_CALLEES = {"record_span", "instant", "transition",
                     "dump_timeline"}
    _SPAN_MODULE_HINTS = ("timeline", "recorder", "flight")

    @functools.cached_property
    def _timeline_imported_names(self) -> set[str]:
        """Local names bound by ``from ...obs.timeline import X [as Y]``
        — a bare ``transition(...)`` call through such a binding is the
        recorder's even when no dotted prefix betrays it."""
        out: set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.rsplit(".", 1)[-1] == "timeline":
                out.update(a.asname or a.name for a in node.names)
        return out

    @register_pass(
        SPAN_IN_JIT, "error", "jit",
        doc="an obs.timeline flight-recorder call inside traced code — "
            "the host-clock read traces to one frozen timestamp",
        example="`timeline.span(\"decode\")` inside the AOT'd decode fn")
    def _check_span_in_jit(self, ctx: ast.AST):
        """**span-in-compiled-fn** (error): an ``obs.timeline`` recorder
        call (``span``/``record_span``/``instant``/``transition``)
        inside a traced function.  The recorder reads the HOST monotonic
        clock; under trace that read happens once, at trace time, so the
        compiled program carries a frozen timestamp — the span lies
        forever and recompile-guards can't save it.  Record around the
        dispatch (the driver's idiom), never inside it."""
        for node in ast.walk(ctx):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            base = name.rsplit(".", 1)[-1]
            timeline_owned = (
                any(h in name.lower() for h in self._SPAN_MODULE_HINTS)
                # a BARE call through `from ...timeline import X [as Y]`
                # is the recorder's even with no dotted prefix
                or (isinstance(node.func, ast.Name)
                    and node.func.id in self._timeline_imported_names))
            if not (base in self._SPAN_CALLEES
                    or (base == "span" and timeline_owned)):
                continue
            if base not in ("record_span", "dump_timeline") \
                    and not timeline_owned:
                continue    # a generic .instant()/.transition() that is
                            # not the flight recorder's
            self._emit(
                SPAN_IN_JIT, node,
                f"flight-recorder call `{name}(...)` inside traced "
                f"`{getattr(ctx, 'name', '?')}` — the host-clock read "
                "traces to ONE constant timestamp and the span lies in "
                "every execution; record around the jitted call, not "
                "inside it (obs.timeline is host-side by contract)")

    # -- span-name-registry --------------------------------------------

    _SPAN_NAME_CALLEES = {"record_span", "instant", "span"}

    @register_pass(
        SPAN_REGISTRY, "warning", "file",
        doc="a literal span name at a recorder call site that is not in "
            "obs.timeline.KNOWN_SPANS — a typo'd name silently vanishes "
            "from every fold",
        example="`record_span(\"prefil\", ...)` — records fine, never "
                "appears in any timeline")
    def _check_span_name_registry(self):
        """**span-name-registry** (warning): a literal span name passed
        to ``timeline.span``/``record_span``/``instant`` that is not in
        ``obs.timeline.KNOWN_SPANS``.

        Every fold keys on span names (``timeline_lines`` totals, the
        heartbeat phase column, the Chrome-trace lanes) — a typo'd name
        records fine and then silently vanishes from every consumer,
        which is the worst failure mode telemetry can have.  The
        registry is one frozenset in ``obs.timeline``; adding a span is
        a one-line registration there.  Variable names (the engine's
        ``record_span(kind, ...)``) are skipped — the lint is for
        literals, where the typo class lives.
        """
        try:
            from tpu_hc_bench_torch.obs.timeline import KNOWN_SPANS
        except Exception:        # analysis must run without obs too
            return
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            base = name.rsplit(".", 1)[-1]
            if base not in self._SPAN_NAME_CALLEES:
                continue
            timeline_owned = (
                any(h in name.lower() for h in self._SPAN_MODULE_HINTS)
                or (isinstance(node.func, ast.Name)
                    and node.func.id in self._timeline_imported_names))
            if not timeline_owned and base != "record_span":
                continue    # a generic .instant()/.span() that is not
                            # the flight recorder's
            if not node.args:
                continue
            arg = node.args[0]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                continue    # variable span names are the caller's
                            # contract, not a typo class
            if arg.value in KNOWN_SPANS:
                continue
            self._emit(
                SPAN_REGISTRY, node,
                f"span name {arg.value!r} at `{name or base}(...)` is "
                f"not in obs.timeline.KNOWN_SPANS — an unregistered "
                f"(or typo'd) name records fine and then silently "
                f"vanishes from every timeline fold; register it in "
                f"KNOWN_SPANS or fix the spelling")

    # -- signal-name-registry ------------------------------------------

    # health-signal lookups keyed by a LITERAL name, mapped to the
    # positional index the name rides in: spec_of(name),
    # advice_for(name), fired_count(events, name)
    _SIGNAL_NAME_CALLEES = {"spec_of": 0, "advice_for": 0,
                            "fired_count": 1}
    _SIGNAL_MODULE_HINTS = ("signals",)

    @functools.cached_property
    def _signals_imported_names(self) -> set[str]:
        """Local names bound by ``from ...obs.signals import X [as Y]``
        — a bare ``spec_of(...)`` call through such a binding is the
        signal engine's even when no dotted prefix betrays it."""
        out: set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.rsplit(".", 1)[-1] == "signals":
                out.update(a.asname or a.name for a in node.names)
        return out

    @register_pass(
        SIGNAL_REGISTRY, "warning", "file",
        doc="a literal signal name at a signals-engine call site that "
            "is not in obs.signals.KNOWN_SIGNALS — a typo'd name never "
            "matches anything any engine emits",
        example="`fired_count(events, \"KV_PRESURE\")` — always 0, "
                "never an error")
    def _check_signal_name_registry(self):
        """**signal-name-registry** (warning): a literal signal name
        passed to ``signals.spec_of``/``advice_for``/``fired_count``
        that is not in ``obs.signals.KNOWN_SIGNALS``.

        Signal names are the join key between the engine's append-only
        ``signals.jsonl`` and every consumer (the watch column, the
        supervisor's advice journal, the bench verdict counts) — a
        typo'd literal compares clean against every event and the
        consumer silently reads "never fired", the same failure class
        the span-name registry exists for.  The registry is one tuple
        in ``obs.signals``; adding a signal is a one-line registration
        there.  Variable names (the engine's own ``spec_of(name)``
        loop) are skipped — the lint is for literals, where the typo
        class lives.
        """
        try:
            from tpu_hc_bench_torch.obs.signals import KNOWN_SIGNALS
        except Exception:        # analysis must run without obs too
            return
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            base = name.rsplit(".", 1)[-1]
            if base not in self._SIGNAL_NAME_CALLEES:
                continue
            signals_owned = (
                any(h in name.lower() for h in self._SIGNAL_MODULE_HINTS)
                or (isinstance(node.func, ast.Name)
                    and node.func.id in self._signals_imported_names))
            if not signals_owned:
                continue    # a generic .spec_of()/.fired_count() that
                            # is not the signal engine's
            idx = self._SIGNAL_NAME_CALLEES[base]
            if len(node.args) <= idx:
                continue
            arg = node.args[idx]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                continue    # variable signal names are the caller's
                            # contract, not a typo class
            if arg.value in KNOWN_SIGNALS:
                continue
            self._emit(
                SIGNAL_REGISTRY, node,
                f"signal name {arg.value!r} at `{name or base}(...)` "
                f"is not in obs.signals.KNOWN_SIGNALS — an "
                f"unregistered (or typo'd) name never matches any "
                f"emitted event and the consumer silently reads "
                f"\"never fired\"; register it in KNOWN_SIGNALS or "
                f"fix the spelling")

    # -- fleet-blocking-wait -------------------------------------------

    # no-arg blocking callees: `.wait()` (Popen, Event, Condition) and
    # `.join()` (Thread, Process) block FOREVER without a timeout
    _BLOCKING_CALLEES = {"wait", "join"}

    def _in_fleet_package(self) -> bool:
        parts = Path(self.filename).as_posix().split("/")
        return "fleet" in parts and "tests" not in parts

    @register_pass(
        FLEET_WAIT, "error", "file",
        doc="a no-timeout .wait()/.join() inside a fleet control-loop "
            "body — one wedged job freezes scheduling for the pool",
        example="`proc.wait()` in the supervisor reap loop")
    def _check_fleet_blocking_wait(self):
        """**fleet-blocking-wait** (error, fleet package only): a
        ``.wait()``/``.join()`` call with no timeout inside a loop body
        of the fleet scheduler/supervisor.

        The control loop is the one thread keeping N jobs alive: an
        unbounded wait on any single job (a Popen that never exits, a
        thread stuck in I/O) freezes scheduling for the WHOLE fleet —
        no reaps, no liveness checks, no admissions — which is exactly
        the hang class the per-job watchdog cannot see from inside the
        job.  The accepted idiom is poll + bounded sleep (the
        supervisor's ``reap``) or an explicit timeout argument; a
        ``wait(5)``/``join(timeout=...)`` call is bounded and passes.
        Loop headers and nested function definitions are exempt through
        the same loop-body walk as the hot-loop passes.
        """
        if not self._in_fleet_package():
            return
        for node in ast.walk(self.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self._BLOCKING_CALLEES):
                continue
            if node.args or node.keywords:
                continue        # any argument bounds (or re-purposes) it
            if self._enclosing_loop_body(node) is None:
                continue
            name = _dotted(node.func) or f"<expr>.{node.func.attr}"
            self._emit(
                FLEET_WAIT, node,
                f"unbounded `{name}()` inside a fleet control loop — "
                "one wedged job blocks scheduling for every other job; "
                "pass a timeout (`.wait(grace_s)` / "
                "`.join(timeout=...)`) or poll with a bounded sleep "
                "like supervisor.reap")

    # -- retire-without-status -----------------------------------------

    # terminal call sites in the serve engine: every request leaving
    # the ledger goes through one of these
    _TERMINAL_CALLEES = {"finish", "shed_queued"}

    @register_pass(
        RETIRE_STATUS, "error", "file",
        doc="a serve-engine terminal call site (finish/shed_queued) "
            "without a status/cause stamp — a request would leave the "
            "ledger uncaused",
        example="`finish(fl, t_done)` with no `status=` keyword")
    def _check_retire_status(self):
        """**retire-without-status** (error, serve package only): a
        ``finish(...)``/``shed_queued(...)`` call that stamps no
        terminal disposition.

        The degradation contract is that EVERY request leaving
        the engine's ledger carries a terminal ``status`` (ok / shed /
        quarantined) and, for degraded exits, a ``cause`` — `obs
        summarize` and the faults A/B both fold on those stamps, so an
        unstamped retire is a request that silently vanishes from the
        degradation account.  A call passes when it spells a
        ``status=``/``cause=`` keyword or passes the cause positionally
        (three or more positional arguments); relying on the ``"ok"``
        default is exactly the hazard — a later degraded caller copies
        the spelling and mislabels a shed as served.
        """
        if not self._in_serve_package():
            return
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            if _callee_basename(node) not in self._TERMINAL_CALLEES:
                continue
            if len(node.args) >= 3 or any(
                    kw.arg in ("status", "cause")
                    for kw in node.keywords):
                continue
            name = _dotted(node.func) or _callee_basename(node)
            self._emit(
                RETIRE_STATUS, node,
                f"`{name}(...)` retires a request with no terminal "
                "status — stamp `status=` (and `cause=` for degraded "
                "exits) so the ledger, `obs summarize`, and the faults "
                "A/B agree on every request's disposition")

    # -- page-refcount-discipline --------------------------------------

    # mutating methods on a free-list container
    _FREELIST_MUTATORS = {"append", "extend", "insert", "pop", "remove",
                          "clear"}

    def _inside_page_allocator(self, node: ast.AST) -> bool:
        """True when ``node`` sits lexically inside ``class
        PageAllocator`` — the one namespace sanctioned to touch the
        free list and write page tables."""
        cur: ast.AST | None = node
        while cur is not None:
            if isinstance(cur, ast.ClassDef) and \
                    cur.name == "PageAllocator":
                return True
            cur = self._parents.get(cur)
        return False

    @register_pass(
        PAGE_REFCOUNT, "error", "file",
        doc="a page-table store or free-list mutation outside "
            "PageAllocator — bypasses the refcount that keeps "
            "shared/COW pages alive",
        example="`fl.table[slot] = page` instead of "
                "`allocator.bind(fl.table, slot, page)`")
    def _check_page_refcount(self):
        """**page-refcount-discipline** (error, serve package only):
        a page-table slot store or a free-list mutation reached from
        outside ``class PageAllocator``.

        KV pages are reference-counted: the prefix cache
        and every in-flight request may hold refs on the same physical
        page, and a page returns to the free list only when its
        refcount hits zero inside ``PageAllocator.free``.  A direct
        ``table[slot] = page`` store skips the liveness assert in
        ``PageAllocator.bind`` (binding a freed page silently corrupts
        another request's KV), and an out-of-band
        ``free_list.append(...)`` double-frees a page someone still
        reads.  Flagged: (a) mutating-method calls
        (append/extend/insert/pop/remove/clear) on a name ending in
        ``_free`` or ``free_list``; (b) subscript assignment into a
        bare ``table`` variable or ``.table`` attribute.  Plural
        spellings (``tables[i] = ...``) and anything lexically inside
        ``PageAllocator`` are exempt.
        """
        if not self._in_serve_package():
            return
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in self._FREELIST_MUTATORS:
                owner = _dotted(node.func.value)
                base = owner.rsplit(".", 1)[-1]
                if not (base.endswith("_free") or base == "free_list"):
                    continue
                if self._inside_page_allocator(node):
                    continue
                self._emit(
                    PAGE_REFCOUNT, node,
                    f"`{owner}.{node.func.attr}(...)` mutates a KV "
                    "free list outside PageAllocator — pages return "
                    "to the pool only via `PageAllocator.free`, which "
                    "decrefs and recycles at refcount zero; an "
                    "out-of-band free double-frees a page a shared "
                    "prefix or another request still reads")
                continue
            if not isinstance(node, (ast.Assign, ast.AugAssign)):
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                if not isinstance(tgt, ast.Subscript):
                    continue
                val = tgt.value
                name = val.attr if isinstance(val, ast.Attribute) \
                    else val.id if isinstance(val, ast.Name) else ""
                if name != "table":
                    continue
                if self._inside_page_allocator(node):
                    continue
                self._emit(
                    PAGE_REFCOUNT, node,
                    f"`{_dotted(val) or name}[...] = ...` stores a "
                    "page id without the refcount-liveness check — "
                    "route table writes through "
                    "`PageAllocator.bind(table, slot, page)`, which "
                    "asserts the page is live before it becomes "
                    "readable by the decode kernel")

    # -- serve-bucket-recompile ----------------------------------------

    # calls that lower/trace a program (and so can compile a NEW shape):
    # the serve package's zero-recompile-after-warmup contract says
    # these may only appear in the engine's warmup namespace
    _LOWERING_CALLEES = {
        "jit", "pjit", "pmap", "shard_map", "aot_compile", "lower",
        "compile", "xla_computation", "make_jaxpr", "eval_shape",
        # the port's builds: the kernels' nvcc build and library load,
        # CUDA graph capture
        "load_library", "build_stamped", "make_graphed_callables",
    }
    _WARMUP_FUNCS = ("__init__", "_aot")

    def _in_serve_package(self) -> bool:
        parts = Path(self.filename).as_posix().split("/")
        return "serve" in parts and "tests" not in parts

    @register_pass(
        SERVE_RECOMPILE, "warning", "file",
        doc="a jit/lowering call site (the port's kernel build, "
            "load_library, cudnn.benchmark) in the serve package outside "
            "the warmup namespace — re-opens the mid-traffic-recompile "
            "hazard",
        example="`jax.jit(decode_fn)` reached from the admission path")
    def _check_serve_recompile(self):
        """**serve-bucket-recompile** (warning, serve package only): a
        call site that can reach jit/lowering outside the engine's
        warmup namespace (``__init__`` / ``_aot`` / ``_warm*``).

        The serving lane's latency contract is *zero lowering after
        warmup*: every (batch, seqlen) bucket is AOT-compiled at engine
        construction, and after that the traffic path only calls AOT
        executables — an off-ladder shape raises instead of silently
        recompiling.  A ``jax.jit``/``.lower()``/``aot_compile`` call
        that creeps into the admission/decode path re-opens the
        mid-traffic-recompile hazard this subsystem exists to close
        (measured as ``post_warmup_compiles`` via compile-cache entry
        deltas).  Warmup-only namespaces are exempt; so is anything
        outside the serve package.
        """
        if not self._in_serve_package():
            return
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                base = _callee_basename(node)
                if base not in self._LOWERING_CALLEES:
                    continue
                what = f"{_dotted(node.func) or base}()"
            elif isinstance(node, ast.Assign) and any(
                    _dotted(t).endswith("cudnn.benchmark")
                    for t in node.targets):
                # cuDNN's search picks new algorithms on the next conv
                what = "cudnn.benchmark ="
            else:
                continue
            names = [getattr(f, "name", "<lambda>")
                     for f in self._enclosing_functions(node)]
            if any(n in self._WARMUP_FUNCS or n.startswith("_warm")
                   for n in names):
                continue
            where = names[0] if names else "module level"
            self._emit(
                SERVE_RECOMPILE, node,
                f"{what} in {where} can lower/"
                f"compile after engine warmup — the serving lane's "
                f"zero-recompile contract keeps jit/lowering inside "
                f"the warmup namespace (__init__/_aot/_warm*); route "
                f"this through a warmed AOT bucket instead")

    # -- driver --------------------------------------------------------

    def run(self) -> list[Finding]:
        """Registry-driven pass sequence: every registered jit-scope
        pass over every traced context, then every file-scope pass
        (including the ``analysis.dataflow`` distributed-correctness
        passes, which register themselves on import)."""
        jit = registry.jit_passes()
        for ctx in self._jit_contexts():
            for info in jit:
                info.func(self, ctx)
        for info in registry.file_passes():
            info.func(self)
        return self.findings


def lint_source_text(source: str, filename: str = "<string>",
                     model: str = "repo",
                     cpu_count: int | None = None,
                     counters: collections.Counter | None = None
                     ) -> list[Finding]:
    """AST lint passes over a source string (the test-fixture entry).
    ``cpu_count`` pins the input-pool-width threshold for deterministic
    tests (default: this host's).  ``counters`` (optional) accumulates
    per-lint suppression hits so the findings JSON can audit them."""
    linter = _FileLinter(source, filename, model, cpu_count=cpu_count)
    findings = linter.run()
    if counters is not None:
        counters.update(linter.suppression_hits)
    return findings


def lint_file(path: str | Path, model: str = "repo") -> list[Finding]:
    path = Path(path)
    return lint_source_text(path.read_text(), str(path), model)


def source_files(root: Path) -> list[Path]:
    """The sources the per-file passes walk: the port's package and the
    port's scripts (``scripts/*torch*``; the JAX package's scripts are
    JAX's gate's)."""
    from tpu_hc_bench_torch.analysis.contracts import writer_sources

    return writer_sources(root)


def lint_repo_sources(root: str | Path | None = None,
                      files: list[str | Path] | None = None,
                      counters: collections.Counter | None = None
                      ) -> list[Finding]:
    """AST passes over every source of the port's package and scripts,
    plus the repo-scope passes: tuned-config registry staleness over
    ``artifacts/tuned/`` and the stream-schema contract check.

    ``files`` (relative paths under ``root``) restricts the PER-FILE
    passes to the given sources — the ``--changed-only`` mode; the
    repo-scope passes always see the whole tree (a contract break can
    live in an UNchanged file whose partner changed).  ``counters``
    accumulates suppression hits across files.
    """
    if root is None:
        root = Path(__file__).resolve().parents[2]
    root = Path(root)
    findings: list[Finding] = []
    if files is None:
        paths = source_files(root)
    else:
        own = set(source_files(root))
        paths = [root / f for f in files if (root / f) in own]
    for path in paths:
        if not path.is_file():
            continue
        try:
            rel = str(path.relative_to(root))
        except ValueError:
            rel = str(path)
        findings.extend(lint_source_text(path.read_text(), rel,
                                         counters=counters))
    findings.extend(check_tuned_registry(root / "artifacts" / "tuned"))
    from tpu_hc_bench_torch.analysis import contracts

    findings.extend(contracts.check_stream_contracts(root))
    return findings


@register_pass(
    TUNED_STALENESS, "warning", "repo",
    doc="a tuned-config registry row recording a flag that no longer "
        "exists on BenchmarkConfig (or the other lane's lever)",
    example="artifacts/tuned/v4-8.json records `fuse_steps`, renamed "
            "two rounds ago — --config=auto silently skips it")
def check_tuned_registry(
        registry_dir: str | Path | None = None) -> list[Finding]:
    """**tuned-config-staleness** (warning): a tuned-config registry row
    (``artifacts/tuned/<hardware_key>.json``, ``tpu_hc_bench_torch.tune``)
    whose recorded flag names are fields of neither of the port's config
    classes (``BenchmarkConfig``, ``ServeConfig``: JAX's one
    ``BenchmarkConfig`` holds both lanes' fields).

    ``--config=auto`` deliberately survives a stale row (it skips the
    unknown flag with a banner note rather than crash every run —
    ``tune.registry.resolve_auto``), so THIS is the loud gate that
    protects the registry across flag refactors.  An unreadable registry
    file flags too.  Serving rows are keyed ``<model>@serve``; a
    ``@serve`` row recording a training-lane lever (or a training row
    recording a serving knob) is flagged as JAX flags it.
    """
    import dataclasses
    import json

    from tpu_hc_bench_torch.flags import BenchmarkConfig, ServeConfig
    from tpu_hc_bench_torch.tune.space import LEVERS, SERVE_LEVERS

    if registry_dir is None:
        from tpu_hc_bench_torch.tune.registry import default_registry_dir

        registry_dir = default_registry_dir()
    base = Path(registry_dir)
    findings: list[Finding] = []
    if not base.is_dir():
        return findings
    fields = {f.name for cls in (BenchmarkConfig, ServeConfig)
              for f in dataclasses.fields(cls)}
    for path in sorted(base.glob("*.json")):
        try:
            data = json.loads(path.read_text())
        except (OSError, ValueError) as e:
            findings.append(Finding(
                TUNED_STALENESS, "warning", "repo",
                f"artifacts/tuned/{path.name}",
                f"unreadable registry file: {e}"))
            continue
        for model, row in sorted((data.get("members") or {}).items()):
            serving = model.endswith("@serve")
            member = model[:-len("@serve")] if serving else model
            lane_levers = SERVE_LEVERS if serving else LEVERS
            crossed = SERVE_LEVERS if not serving else LEVERS
            recorded = {**(row.get("base") or {}),
                        **(row.get("overrides") or {})}
            for k in sorted(recorded):
                if k not in fields:
                    findings.append(Finding(
                        TUNED_STALENESS, "warning", member,
                        f"artifacts/tuned/{path.name}:{model}/{k}",
                        f"tuned row records flag {k!r}, which is no "
                        f"longer a BenchmarkConfig field — re-run "
                        f"`python -m tpu_hc_bench_torch.tune search` or "
                        f"edit the row"))
                elif k in crossed and k not in lane_levers:
                    lane = "serving" if serving else "training"
                    findings.append(Finding(
                        TUNED_STALENESS, "warning", member,
                        f"artifacts/tuned/{path.name}:{model}/{k}",
                        f"{lane} row records the other lane's lever "
                        f"{k!r} — --config=auto skips it with a note; "
                        f"re-search the row or drop the key"))
    return findings


# -- per-model semantic passes (sharding rules, the op census) ---------

# column-parallel -> row-parallel partners on the port's parameter names
# (JAX's Flax pairs: qkv/out, Dense_0/Dense_1, fc/proj, wq-wk-wv/wo,
# gate-up/down): if one side of a transformer block matched a TP rule
# and the other did not, the block reshards at its boundary every layer
_TP_RULE_PARTNERS = [
    ({"attn.qkv.weight"}, {"attn.out.weight"}),
    ({"fc.weight"}, {"proj.weight"}),
    ({"attn.wq.weight", "attn.wk.weight", "attn.wv.weight"},
     {"attn.wo.weight"}),
    ({"gate.weight", "up.weight"}, {"down.weight"}),
]
_MIN_TP_DEGREE = 2


def _abstract_model(name: str):
    """(model, spec) built on the meta device: shapes and dtypes, no
    device memory (JAX's ``jax.eval_shape`` of ``model.init``)."""
    from tpu_hc_bench_torch.models import create_model

    return create_model(name, device="meta")


def _suffix_match(path: str, suffix: str) -> bool:
    return path == suffix or path.endswith("." + suffix)


@register_pass(
    SHARDING, "warning", "model",
    doc="Megatron TP annotation table replayed against the abstract "
        "param tree: rank drift, indivisible model-axis dims, "
        "half-annotated column/row blocks",
    example="`wq/kernel` matched a TP rule but partner `wo/kernel` did "
            "not — GSPMD reshards at every layer boundary")
def check_sharding_consistency(name: str, model=None,
                               is_transformer: bool | None = None
                               ) -> list[Finding]:
    """Replay the port's TP table (``parallel.tensor._TP_RULES``,
    ``tp_param_rule``) over the member's meta-device parameters: a rule
    whose name matches a parameter of another rank, a split dim whose
    pieces do not divide by the minimum TP degree, and a column/row
    pair where one direction matched and its partner did not.  ``model``
    (a module) replaces the member's build."""
    from tpu_hc_bench_torch.parallel import tensor

    findings: list[Finding] = []
    if model is None:
        model, spec = _abstract_model(name)
        is_transformer = spec.is_text or spec.attention
    params = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    rule_ranks: dict[str, set[int]] = {}
    for suffix, rank, _rule in tensor._TP_RULES:
        rule_ranks.setdefault(suffix, set()).add(rank)
    matched: set[str] = set()
    for path, shape in params:
        ndim = len(shape)
        hit = [s for s in rule_ranks if _suffix_match(path, s)]
        rule = tensor.tp_param_rule(path, ndim)
        if hit and rule is None:
            want = sorted(r for s in hit for r in rule_ranks[s])
            findings.append(Finding(
                lint=SHARDING, severity="warning", model=name,
                location=f"param:{path}",
                message=f"name matches TP rule {hit[0]!r} but rank "
                        f"{ndim} matches none of its specs (rank(s) "
                        f"{want}); the rule table has drifted from the "
                        "model definition and this param silently "
                        "replicates"))
            continue
        if hit:
            matched.update(hit)
            dim, blocks = rule
            if (shape[dim] // blocks) % _MIN_TP_DEGREE \
                    or shape[dim] % blocks:
                findings.append(Finding(
                    lint=SHARDING, severity="warning", model=name,
                    location=f"param:{path}",
                    message=f"dim {dim} (size {shape[dim]}, {blocks} "
                            f"block(s)) is model-axis-sharded but not "
                            f"divisible by the minimum TP degree "
                            f"{_MIN_TP_DEGREE}"))
    # column/row pairing only means something for the transformer
    # families the TP table targets (``shard_model_`` refuses the rest)
    if not is_transformer:
        return findings
    for cols, rows in _TP_RULE_PARTNERS:
        got_col = bool(cols & matched)
        got_row = bool(rows & matched)
        if got_col != got_row:
            have, miss = (cols, rows) if got_col else (rows, cols)
            findings.append(Finding(
                lint=SHARDING, severity="warning", model=name,
                location=f"param:{sorted(have)[0]}",
                message=f"TP rules matched {sorted(have)} but not the "
                        f"partner direction {sorted(miss)}: the block is "
                        "half-annotated, so the column-parallel output "
                        "is gathered (or the row-parallel input cut) "
                        "every layer"))
    return findings


def check_forward_host_syncs(name: str) -> list[Finding]:
    """The model-scope **host-sync-in-jit** check: the op census of one
    eval forward on the meta device (``census.census_forward``), JAX's
    ``check_jaxpr_host_callbacks`` over the jaxpr.  Each data-dependent
    op (``.item()``, ``nonzero``, a copy to the host) is a finding at
    ``census:<op>@<module path>``."""
    from tpu_hc_bench_torch.analysis import census as census_mod

    findings: list[Finding] = []
    seen: set[tuple[str, str]] = set()
    for op, where in census_mod.census_forward(name).syncs:
        if (op, where) in seen:
            continue
        seen.add((op, where))
        short = op.split("::", 1)[-1]
        findings.append(Finding(
            lint=HOST_SYNC, severity="warning", model=name,
            location=f"census:{short}@{where}",
            message=f"model forward dispatches `{op}` in `{where}` — a "
                    "device->host wait inside every step"))
    return findings


@register_pass(
    COLLECTIVE_SHAPE, "error", "model",
    doc="the zero1 arm's step missing its reduce-scatter/all-gather "
        "pair, or gradient buckets riding full all-reduces (the op "
        "census of a world=2 step)",
    example="world=2 zero1 step issues 0 reduce-scatters — the "
            "optimizer states are not actually sharded")
def check_zero1_collectives(name: str = "trivial", world: int = 2,
                            batch: int = 2,
                            **config_overrides) -> list[Finding]:
    """The zero1 arm's collective shape: the op census of the member's
    world=N ``--variable_update=zero1`` training step (an in-process
    ``fake`` group, ``census.census_train_step``) fed to
    ``zero1_shape_findings``, JAX's check on its compiled HLO."""
    from tpu_hc_bench_torch.analysis import census

    config_overrides.setdefault("num_classes", 10)
    counts = census.collective_counts(census.census_train_step(
        name, batch=batch, world=world, device="cpu",
        variable_update="zero1", **config_overrides))
    return zero1_shape_findings(
        name, counts, location=f"census:{name}:zero1:world{world}")


def zero1_shape_findings(name: str, counts: dict[str, int],
                         location: str = "hlo:") -> list[Finding]:
    """The pure half of ``check_zero1_collectives``: derive findings
    from the step's collective counts (JAX's word for word)."""
    rs = counts.get("reduce-scatter", 0)
    ag = counts.get("all-gather", 0)
    ar = counts.get("all-reduce", 0)
    findings: list[Finding] = []
    loc = location
    if rs < 1 or ag < 1:
        findings.append(Finding(
            lint=COLLECTIVE_SHAPE, severity="error", model=name,
            location=loc,
            message=f"zero1 step lowered without the reduce-scatter/"
                    f"all-gather pair (counts: {counts}) — the gradient "
                    "path is not optimizer-sharded"))
    # non-gradient all-reduces: the scalar loss pmean (1) plus the
    # BN-stat sync bucket(s) — a small fixed budget.  A gradient tree
    # falling back to all-reduce adds one per GRAD bucket and blows it.
    budget = 3
    if ar > budget:
        findings.append(Finding(
            lint=COLLECTIVE_SHAPE, severity="error", model=name,
            location=loc,
            message=f"zero1 step emits {ar} all-reduces (> budget "
                    f"{budget} for loss/BN-stat sync; counts: {counts}) "
                    "— gradient buckets are riding a full all-reduce"))
    return findings


@functools.lru_cache(maxsize=None)
def _module_findings(path: str) -> tuple[Finding, ...]:
    """A model module's file passes, once a process (the zoo shares its
    modules: eleven members build from ``models/resnet.py``)."""
    return tuple(lint_file(path))


def lint_model(name: str, source_lints: bool = True) -> list[Finding]:
    """Every per-model pass: module-source AST + the forward's census +
    sharding rules."""
    findings: list[Finding] = []
    if source_lints:
        import dataclasses
        import importlib

        from tpu_hc_bench_torch.models import get_model_spec

        spec = get_model_spec(name)
        mod = importlib.import_module(spec.create.__module__)
        findings.extend(dataclasses.replace(f, model=name)
                        for f in _module_findings(mod.__file__))
    findings.extend(check_forward_host_syncs(name))
    findings.extend(check_sharding_consistency(name))
    return findings
