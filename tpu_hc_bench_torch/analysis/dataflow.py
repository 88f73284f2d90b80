"""Distributed-correctness dataflow passes: rank taint -> collectives
(the JAX package's ``analysis/dataflow.py``, with the torch.distributed
vocabulary added to JAX's).

The costliest multi-node failure mode this harness has is the *silent
hang*: every rank must issue the same collectives in the same order, and
a collective guarded by rank-dependent control flow (or ordered by a
rank-divergent dict walk) deadlocks NCCL (or gloo) with no error on any
rank — the runtime watchdog (``resilience/watchdog.py``) catches it only
AFTER burning the cards.  These passes catch the two shapes at lint
time:

- **rank-divergent-collective** (error): an intraprocedural AST taint
  engine.  Values derived from ``jax.process_index()`` or
  ``dist.get_rank()``/``get_local_rank()``/``get_group_rank()`` (any
  dotted spelling), from ``RANK``/``LOCAL_RANK`` read out of the
  environment, from parameters/attributes named ``process_index`` /
  ``rank`` / ``local_rank`` / ``host_id``, from a pipeline stage's
  ``pipe.first``/``pipe.last``/``pipe.stage``, or transitively through
  assignments and comparisons, *taint* the expressions they flow into.
  A collective or cross-process sync call (``psum``/``all_gather``/
  ``reduce_scatter`` family, torch.distributed's ``all_reduce``,
  ``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``broadcast``,
  ``all_to_all_single``, barriers, the port's ``GradReducer`` and
  ``Zero1Reducer`` methods, ``all_processes_any``,
  ``process_allgather``, ``broadcast_one_to_all``) is flagged when it
  is reachable
  under a tainted branch **without a matching collective on the other
  side**: inside a tainted ``if`` whose other arm does not issue the
  same collectives, inside a tainted ``while`` (divergent trip counts),
  or after a tainted early-exit (``if rank != 0: return`` followed by a
  collective every rank must reach).  Rank-gated *host work* (worker-0
  logging, checkpoint commits) is the normal idiom and stays silent —
  only collectives under the divergence flag.

- **nondeterministic-collective-order** (error): a loop that issues
  collectives and draws its iteration order from a dict or set
  (``.items()``/``.keys()``/``.values()``, ``set(...)``, set
  literals/comprehensions).  Dict order is insertion order — per
  process — and set order is hash order; if any rank built the mapping
  differently (a racing arrival, a per-host file listing), the ranks
  issue the same collectives in different orders and the fabric
  deadlocks.  Wrapping the iterable in ``sorted(...)`` canonicalizes
  the order and passes.

Point-to-point hops (``dist.send``/``recv``/``isend``/``irecv``, the
pipeline's ``_send``/``_recv``) are NOT collectives here: a GPipe stage
receives unless it is the first and sends unless it is the last, by
design, and JAX's vocabulary has no point-to-point call either.

**Scope — what the taint model provably cannot see** (keep claims
honest; ARCHITECTURE repeats this): the engine is *intraprocedural* and
*lexical*.  It does not follow taint through function calls (a helper
returning ``process_index() == 0`` launders the taint), through
closures, containers, or object attributes assigned elsewhere; it
cannot know a variable holds a dict when the iteration spells a bare
name; and it cannot prove two ranks' dicts actually diverge — it flags
the *shape* that makes divergence possible.  A clean report is
necessary, not sufficient.  Suppress deliberate sites with
``# tpu-hc: disable=<lint-name>`` (counted in the findings JSON) or
accept them into the baseline.
"""

from __future__ import annotations

import ast

from tpu_hc_bench_torch.analysis.registry import register_pass

__all__ = [
    "RANK_DIVERGENT", "NONDET_ORDER", "COLLECTIVE_CALLEES",
    "REDUCER_METHODS", "TAINT_CALL_NAMES", "TAINT_NAMES", "TAINT_ENV",
    "PIPE_TAINT_ATTRS", "FunctionTaint",
    "check_rank_divergence", "check_collective_order",
]

RANK_DIVERGENT = "rank-divergent-collective"
NONDET_ORDER = "nondeterministic-collective-order"

#: call basenames that are collectives / cross-process sync points —
#: every rank must execute these the same number of times in the same
#: order (the ``parallel/collectives.py`` wrappers, the raw lax/
#: multihost primitives they wrap, and the repo's host-level sync)
COLLECTIVE_CALLEES = frozenset({
    # parallel/collectives.py wrappers + bucketed trees
    "psum", "pmean", "all_gather", "reduce_scatter", "ppermute_ring",
    "fused_psum_tree", "allreduce_gradients", "reduce_scatter_tree",
    "all_gather_tree",
    # raw lax primitives
    "psum_scatter", "ppermute", "all_to_all", "pmax", "pmin",
    # host-level cross-process sync (utils.sync, multihost_utils)
    "all_processes_any", "process_allgather", "broadcast_one_to_all",
    "sync_global_devices", "barrier",
    # torch.distributed (the port's raw calls and its collectives.py)
    "all_reduce", "all_reduce_", "allreduce_mean_",
    "all_gather_into_tensor", "all_gather_single", "reduce_scatter_tensor",
    "broadcast", "all_to_all_single", "monitored_barrier", "ring_shift",
})

#: methods of the port's gradient reducers (``collectives.GradReducer``,
#: ``Zero1Reducer``) and of ``train.step.DataParallel`` that issue
#: collectives; a call counts only on a receiver spelled like one
#: (``grads.finish()``, ``state.dp.reduce(...)``), since the bare
#: method names (``gather``, ``finish``) are common elsewhere
REDUCER_METHODS = frozenset({
    "finish", "reduce_tree", "gather", "grad_sq_sum", "reduce", "sum_",
})
_REDUCER_RECEIVERS = ("grads", "reducer", "dp")

#: calls whose RESULT is rank-dependent (any dotted spelling:
#: ``jax.process_index()``, ``dist.get_rank()``,
#: ``distributed.is_coordinator()``)
TAINT_CALL_NAMES = frozenset({
    "process_index", "get_rank", "get_local_rank", "get_group_rank",
    "is_coordinator",
})

#: parameter / attribute / variable names that carry per-host identity
TAINT_NAMES = frozenset({
    "process_index", "process_idx", "rank", "local_rank", "host_id",
    "host_index",
})

#: environment variables that carry the rank (``os.environ["RANK"]``,
#: ``os.environ.get("LOCAL_RANK")``, ``os.getenv("RANK")``)
TAINT_ENV = frozenset({"RANK", "LOCAL_RANK"})

#: a pipeline stage's rank-derived attributes, tainted on a receiver
#: spelled ``pipe`` (``pipe.first``, ``state.pipe.stage``)
PIPE_TAINT_ATTRS = frozenset({"first", "last", "stage"})

#: fixpoint bound for assignment propagation (chains longer than this
#: do not occur in honest code; the bound keeps the pass O(n))
_MAX_ROUNDS = 10


def _dotted(node: ast.AST) -> str:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _own_walk(node: ast.AST):
    """Walk ``node``'s subtree WITHOUT descending into nested function/
    class scopes (their bodies run on call, not here)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop(0)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _is_collective(call: ast.Call) -> bool:
    name = _dotted(call.func)
    head, _, base = name.rpartition(".")
    if base in COLLECTIVE_CALLEES:
        return True
    return base in REDUCER_METHODS and head.rsplit(".", 1)[-1] in \
        _REDUCER_RECEIVERS


def _collective_calls(stmts) -> list[ast.Call]:
    """Collective call sites among ``stmts``' own nodes (document
    order), nested scopes excluded."""
    out = []
    for stmt in stmts:
        nodes = [stmt] if isinstance(stmt, ast.Call) else []
        nodes += list(_own_walk(stmt))
        for n in nodes:
            if isinstance(n, ast.Call) and _is_collective(n):
                out.append(n)
    return out


def _names_of(calls: list[ast.Call]) -> list[str]:
    return sorted(_dotted(c.func).rsplit(".", 1)[-1] for c in calls)


class FunctionTaint:
    """Intraprocedural taint for ONE function scope (or the module
    top level): seed from rank-identity sources, propagate through the
    scope's own assignments to a fixpoint."""

    def __init__(self, scope: ast.AST):
        self.scope = scope
        self.tainted: set[str] = set()
        self._seed_params()
        self._propagate()

    def _seed_params(self) -> None:
        args = getattr(self.scope, "args", None)
        if args is None:
            return
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            if a.arg in TAINT_NAMES:
                self.tainted.add(a.arg)

    def expr_tainted(self, node: ast.AST) -> bool:
        """An expression is tainted when any part of it reads a rank
        source or a tainted local."""
        for n in ast.walk(node):
            if isinstance(n, ast.Name) and n.id in self.tainted:
                return True
            if isinstance(n, ast.Call):
                base = _dotted(n.func).rsplit(".", 1)[-1]
                if base in TAINT_CALL_NAMES:
                    return True
                if base in ("get", "getenv") and n.args and isinstance(
                        n.args[0], ast.Constant) \
                        and n.args[0].value in TAINT_ENV:
                    return True
            if isinstance(n, ast.Subscript) and isinstance(
                    n.slice, ast.Constant) and n.slice.value in TAINT_ENV:
                return True
            if isinstance(n, ast.Attribute) and n.attr in TAINT_NAMES:
                return True
            if isinstance(n, ast.Attribute) \
                    and n.attr in PIPE_TAINT_ATTRS \
                    and _dotted(n.value).rsplit(".", 1)[-1] == "pipe":
                return True
        return False

    @staticmethod
    def _target_names(target: ast.AST) -> set[str]:
        return {n.id for n in ast.walk(target) if isinstance(n, ast.Name)}

    def _propagate(self) -> None:
        stmts = list(_own_walk(self.scope))
        for _ in range(_MAX_ROUNDS):
            before = len(self.tainted)
            for n in stmts:
                if isinstance(n, ast.Assign) and self.expr_tainted(n.value):
                    for t in n.targets:
                        self.tainted |= self._target_names(t)
                elif isinstance(n, (ast.AugAssign, ast.AnnAssign)) \
                        and n.value is not None \
                        and self.expr_tainted(n.value):
                    self.tainted |= self._target_names(n.target)
                elif isinstance(n, ast.NamedExpr) \
                        and self.expr_tainted(n.value):
                    self.tainted |= self._target_names(n.target)
                elif isinstance(n, ast.For) \
                        and self.expr_tainted(n.iter):
                    self.tainted |= self._target_names(n.target)
            if len(self.tainted) == before:
                return


def _scopes(tree: ast.Module):
    """Every analysis scope: the module body + each function def."""
    yield tree
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield n


def _exits_control_flow(stmts) -> bool:
    """A branch arm diverges ranks' CONTROL FLOW when it returns/breaks/
    continues/raises — ranks taking it never reach the code after the
    branch."""
    for stmt in stmts:
        for n in [stmt] + list(_own_walk(stmt)):
            if isinstance(n, (ast.Return, ast.Break, ast.Continue,
                              ast.Raise)):
                return True
    return False


def _subtree_end(node: ast.AST) -> int:
    return max((getattr(n, "lineno", 0) for n in ast.walk(node)),
               default=getattr(node, "lineno", 0))


# ---------------------------------------------------------------------
# pass: rank-divergent collectives


@register_pass(
    RANK_DIVERGENT, "error", "file",
    doc="collective/cross-process sync reachable under rank-dependent "
        "control flow without a matching partner on the other arm — "
        "the silent multi-host deadlock",
    example="`all_processes_any(...)` at driver.py:412 executes only "
            "where `jax.process_index() == 0` holds; other ranks never "
            "enter the collective and the fabric hangs")
def check_rank_divergence(linter) -> None:
    """Per scope: seed+propagate taint, then audit every tainted branch
    for unbalanced collectives.  ``linter`` is the ``_FileLinter``
    running this file (duck-typed: ``.tree``, ``._emit``)."""
    for scope in _scopes(linter.tree):
        taint = FunctionTaint(scope)
        stmts = [n for n in _own_walk(scope) if isinstance(n, ast.stmt)]
        for node in stmts:
            if isinstance(node, ast.If) and taint.expr_tainted(node.test):
                _audit_tainted_if(linter, taint, node, stmts)
            elif isinstance(node, ast.While) \
                    and taint.expr_tainted(node.test):
                for call in _collective_calls(node.body):
                    _emit_divergent(
                        linter, call,
                        f"inside a while-loop whose condition "
                        f"(line {node.lineno}) is rank-dependent — "
                        f"ranks run different trip counts and issue "
                        f"different collective sequences")


def _audit_tainted_if(linter, taint: FunctionTaint, node: ast.If,
                      scope_stmts: list[ast.stmt]) -> None:
    body_calls = _collective_calls(node.body)
    else_calls = _collective_calls(node.orelse)
    body_names = _names_of(body_calls)
    else_names = _names_of(else_calls)
    if body_names != else_names:
        # flag the arm(s) whose collectives lack a partner opposite
        surplus = _unmatched(body_calls, else_names) \
            + _unmatched(else_calls, body_names)
        for call in surplus:
            _emit_divergent(
                linter, call,
                f"under a rank-dependent branch (line {node.lineno}) "
                f"with no matching collective on the other arm — only "
                f"some ranks enter it")
    # early-exit divergence: one arm leaves the scope (return/raise/
    # break/continue), so ranks taking it never reach collectives
    # issued after the branch
    body_exits = _exits_control_flow(node.body)
    else_exits = bool(node.orelse) and _exits_control_flow(node.orelse)
    if not (body_exits or else_exits):
        return
    if body_calls or else_calls:
        return      # already audited above; the arms' own collectives
                    # carry the verdict
    end = _subtree_end(node)
    after = [s for s in scope_stmts if s.lineno > end]
    for call in _collective_calls(after):
        _emit_divergent(
            linter, call,
            f"after a rank-dependent early exit (line {node.lineno}): "
            f"ranks taking the exit never reach this collective while "
            f"the rest block in it")


def _unmatched(calls: list[ast.Call], other_names: list[str]
               ) -> list[ast.Call]:
    """Calls whose basename has no remaining partner in the other arm's
    (multiset) name list."""
    remaining = list(other_names)
    out = []
    for c in calls:
        base = _dotted(c.func).rsplit(".", 1)[-1]
        if base in remaining:
            remaining.remove(base)
        else:
            out.append(c)
    return out


def _emit_divergent(linter, call: ast.Call, why: str) -> None:
    name = _dotted(call.func) or "<collective>"
    linter._emit(
        RANK_DIVERGENT, call,
        f"collective `{name}(...)` {why}; every rank must issue the "
        f"same collectives in the same order or the fabric deadlocks "
        f"silently — hoist the collective out of the branch, or make "
        f"both arms issue it")


# ---------------------------------------------------------------------
# pass: nondeterministic collective order


def _nondet_iter(iter_expr: ast.AST) -> str | None:
    """Why this loop's iteration order can diverge across ranks, or
    None when it cannot (lexically).  ``sorted(...)`` at the top
    canonicalizes everything under it."""
    if isinstance(iter_expr, ast.Call) \
            and _dotted(iter_expr.func).rsplit(".", 1)[-1] == "sorted":
        return None
    for n in ast.walk(iter_expr):
        if isinstance(n, ast.Call):
            base = _dotted(n.func).rsplit(".", 1)[-1]
            if isinstance(n.func, ast.Attribute) \
                    and n.func.attr in ("items", "keys", "values"):
                return (f"`.{n.func.attr}()` iterates in dict insertion "
                        f"order, which diverges when ranks built the "
                        f"dict differently")
            if base in ("set", "frozenset"):
                return "`set(...)` iterates in hash order"
        if isinstance(n, (ast.Set, ast.SetComp)):
            return "a set literal/comprehension iterates in hash order"
    return None


@register_pass(
    NONDET_ORDER, "error", "file",
    doc="a collective-issuing loop ordered by dict/set iteration — "
        "insertion/hash-order divergence across ranks reorders the "
        "collective sequence and deadlocks the fabric",
    example="`for name, g in grads.items(): psum(g)` at step.py:88 — "
            "two ranks that populated `grads` differently psum "
            "different tensors against each other")
def check_collective_order(linter) -> None:
    for node in ast.walk(linter.tree):
        if not isinstance(node, (ast.For, ast.AsyncFor)):
            continue
        why = _nondet_iter(node.iter)
        if why is None:
            continue
        calls = _collective_calls(node.body)
        if not calls:
            continue
        first = _dotted(calls[0].func) or "<collective>"
        linter._emit(
            NONDET_ORDER, node,
            f"loop order feeds collective `{first}(...)` but {why}; "
            f"ranks disagreeing on the order issue the same "
            f"collectives in different sequences — a silent deadlock; "
            f"iterate `sorted(...)` (or a list with one canonical "
            f"order) instead")
