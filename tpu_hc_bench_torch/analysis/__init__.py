"""Static analysis of the port's sources and of one step of its models:
the counterpart of the JAX package's ``analysis/``, with the same pass
names, severities, scopes, finding keys and JSON shape (one baseline key
means the same thing in both packages).

- :mod:`tpu_hc_bench_torch.analysis.census` — the op census of one step
  (in place of JAX's HLO parser): a ``TorchDispatchMode`` counts the
  ops a step dispatches; from it the collectives under JAX's opcode
  keys, the host syncs, the hand-written kernels' launches (the
  ``ops/`` counters), and the products attributed to module paths.
- :mod:`tpu_hc_bench_torch.analysis.lints` — the AST passes over the
  port's sources (host syncs in compiled or captured code, recompile
  hazards, memory probes in hot loops, the span and signal registries,
  the serve and fleet disciplines...) and the model passes (the TP
  table over a meta-device build, the forward's census, the zero1
  step's collective shape).
- :mod:`tpu_hc_bench_torch.analysis.registry` — the pass registry: every
  check registers name/severity/scope/docs once; the run order, the
  ``_emit`` default severity, and the README lint table all derive
  from it.
- :mod:`tpu_hc_bench_torch.analysis.dataflow` — distributed-correctness
  passes: an intraprocedural rank-taint engine flagging collectives
  under rank-divergent control flow (torch.distributed's vocabulary
  added to JAX's), and dict/set-ordered collective-issuing loops.
- :mod:`tpu_hc_bench_torch.analysis.contracts` — the stream-schema
  contract checker: keys the port's obs folds read vs keys the port's
  writers materialize, gated by a committed allowlist of seams.
- :mod:`tpu_hc_bench_torch.analysis.report` — findings, JSON reports,
  and the checked-in baseline the gate (``tests/test_torch_analysis.py``
  + ``python -m tpu_hc_bench_torch.analysis``) fails against.

CLI::

    python -m tpu_hc_bench_torch.analysis --model resnet50  # + the census
    python -m tpu_hc_bench_torch.analysis --all --json out.json --device=cpu
    python -m tpu_hc_bench_torch.analysis --all --changed-only --device=cpu
    python -m tpu_hc_bench_torch.analysis baseline           # dry-run diff
    python -m tpu_hc_bench_torch.analysis baseline --update  # atomic rewrite
"""

from tpu_hc_bench_torch.analysis.census import (  # noqa: F401
    COLLECTIVE_OPS,
    Census,
    OpCensus,
    collective_counts,
    host_syncs,
    kernel_launches,
    op_attribution,
)
from tpu_hc_bench_torch.analysis.registry import (  # noqa: F401
    PassInfo,
    all_passes,
    pass_index,
    register_pass,
)
from tpu_hc_bench_torch.analysis.report import (  # noqa: F401
    Finding,
    compare_to_baseline,
    load_baseline,
)
