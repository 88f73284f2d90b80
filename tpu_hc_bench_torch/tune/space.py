"""The tunable levers per zoo member, and the seeded starting configs
(the port's copy of the JAX package's ``tune/space.py``).

A *candidate* is one assignment of the levers a manual sweep moves:

- ``batch_size`` — power-of-two ladder around the seeded batch
- ``gradient_accumulation_steps`` — 1..64 (microbatching without
  remat's recompute)
- ``accum_dtype`` — f32 (exact mean) vs bf16 (the memory lever)
- ``gradient_checkpointing`` — remat: FLOPs for activation memory
- ``scan_layers`` — one layer body over stacked parameters (decoders)
- ``fusion_threshold_bytes`` — the all-reduce bucket threshold
- ``variable_update`` — psum vs the zero1 sharded-optimizer arm

Per-member validity rules are structural (accum must divide the batch,
the dtype lever needs accum > 1, remat needs a transformer, scan needs
a decoder); everything deeper — the zero1 composition matrix, the
eval/forward-only exclusions — is enforced by the config's
``resolve()`` and handled by the pruner as a free flag-time skip.

The port has two config classes where JAX has one: a training
candidate builds a ``flags.BenchmarkConfig``, a serving one
(``workload="serve"``) a ``flags.ServeConfig``.

``SEED_CONFIGS`` and ``SEED_SERVE_CONFIGS`` are the JAX package's seed
points, its best-known single-chip operating points on a TPU.  On the
card they are starting points of a search and nothing more: none of
them was measured on a GPU.
"""

from __future__ import annotations

import dataclasses

from tpu_hc_bench_torch.flags import (
    DEFAULT_FUSION_THRESHOLD_BYTES,
    BenchmarkConfig,
    ServeConfig,
)

__all__ = [
    "Candidate", "SEED_CONFIGS", "seed_candidate", "member_space",
    "seed_matrix", "seed_extra_flags", "LEVERS",
    "SERVE_LEVERS", "SEED_SERVE_CONFIGS", "serve_seed_candidate",
    "serve_member_space",
]

# The lever fields a candidate may override (everything else rides the
# member's base flags or the BenchmarkConfig defaults).
LEVERS = (
    "batch_size",
    "gradient_accumulation_steps",
    "accum_dtype",
    "gradient_checkpointing",
    "scan_layers",
    "fusion_threshold_bytes",
    "variable_update",
)

# The serving lane's levers: the decode bucket ladder, the
# continuous-batching admission cap, the paged-KV geometry, the
# decode-kernel arm (gather reference vs the CUDA paged decode kernel),
# its page-block size, and the quantization arm — kernels are tuned
# like any other lever.  All are ServeConfig fields, so the halving
# search, the journal, and ``--config=auto`` handle serve candidates
# with the same machinery — a serve candidate carries
# ``workload="serve"`` so the pruner's flag-time resolve() runs the
# serving validity matrix, and its registry row is keyed
# ``<model>@serve`` (one member can hold a tuned row per lane).
SERVE_LEVERS = (
    "serve_buckets",
    "max_in_flight",
    "kv_page_size",
    "kv_pages",
    "decode_attention",
    "quant",
    "decode_block_pages",
    # lazy reservation + prefix sharing — admission policy is a lever
    # like any kernel arm (resolve() enforces the prefix_cache->lazy
    # dependency at flag time, so the pruner never runs an invalid
    # pairing)
    "kv_reserve",
    "prefix_cache",
    "kv_growth_headroom",
)

# member -> the JAX package's seed config, its best-known single-chip
# TPU operating point (never measured on the card: a search's starting
# point).  "batch" is the per-chip batch; "accum"/"accum_dtype" the
# microbatch levers; "base" the member-fixed flags the search does not
# move (attention kernel choice).  The accumulation members' batches
# exceeded device memory on the TPU as one-shot batches and fit only
# as accum microbatches — that pairing seeds the pruner's memory model.
SEED_CONFIGS: dict[str, dict] = {
    "trivial":          {"batch": 512},
    "lenet":            {"batch": 2048},
    "alexnet":          {"batch": 2048, "accum": 4},
    "overfeat":         {"batch": 4096, "accum": 16},
    "googlenet":        {"batch": 256},
    "mobilenet":        {"batch": 256},
    "nasnet":           {"batch": 128},
    "nasnetlarge":      {"batch": 128, "accum": 8},
    "densenet40_k12":   {"batch": 512},
    "densenet100_k12":  {"batch": 256},
    "resnet18":         {"batch": 256},
    "resnet34":         {"batch": 256},
    "resnet50":         {"batch": 128},
    "resnet101":        {"batch": 512, "accum": 8},
    "resnet152":        {"batch": 512, "accum": 8},
    "resnet50_v2":      {"batch": 1024, "accum": 8},
    "resnet101_v2":     {"batch": 512, "accum": 8},
    "resnet152_v2":     {"batch": 512, "accum": 8},
    "resnet20_cifar":   {"batch": 1024},
    "resnet56_cifar":   {"batch": 512},
    "resnet110_cifar":  {"batch": 256},
    "vgg11":            {"batch": 1024, "accum": 8},
    "vgg16":            {"batch": 1024, "accum": 8},
    "vgg19":            {"batch": 1024, "accum": 8},
    "inception3":       {"batch": 128},
    "vit_b16":          {"batch": 256, "accum": 4},
    "vit_l16":          {"batch": 512, "accum": 8},
    "inception4":       {"batch": 512, "accum": 8},
    "bert_base":        {"batch": 1024, "accum": 8},
    "bert_large":       {"batch": 1024, "accum": 32},
    "gpt2":             {"batch": 128, "accum": 8,
                         "base": {"attention_impl": "flash"}},
    "gpt2_medium":      {"batch": 64, "accum": 16,
                         "base": {"attention_impl": "flash"}},
    # the bf16 accumulator let the TPU's batch grow past its bs=16
    # memory wall (microbatch 8)
    "gpt2_moe":         {"batch": 512, "accum": 64, "accum_dtype": "bf16",
                         "base": {"attention_impl": "flash"}},
    "llama_1b":         {"batch": 2,
                         "base": {"attention_impl": "flash"}},
    # both members' tf_cnn-default batches starved the TPU; these are
    # its operating points
    "ncf":              {"batch": 1048576},
    "deepspeech2":      {"batch": 256},
}

# member -> the JAX package's seed SERVING config (decoder members
# only — classify members serve single-forward requests whose only
# lever is the batch-bucket cap).  Values are starting points, not
# measurements.
SEED_SERVE_CONFIGS: dict[str, dict] = {
    "trivial":      {"max_in_flight": 8},
    "moe_tiny":     {"max_in_flight": 8},
    "llama_tiny":   {"max_in_flight": 8},
    "gpt2":         {"max_in_flight": 16},
    "gpt2_medium":  {"max_in_flight": 8},
    "gpt2_moe":     {"max_in_flight": 8},
    "llama_1b":     {"max_in_flight": 4},
}

_KV_PAGE_LADDER = (8, 16, 32)
_DECODE_BLOCK_PAGES_LADDER = (2, 4)

_ACCUM_LADDER = (1, 2, 4, 8, 16, 32, 64)
_FUSION_LADDER = (DEFAULT_FUSION_THRESHOLD_BYTES,
                  DEFAULT_FUSION_THRESHOLD_BYTES // 4)

_CONFIG_DEFAULTS = {f.name: f.default
                    for f in dataclasses.fields(BenchmarkConfig)}
_SERVE_DEFAULTS = {f.name: f.default
                   for f in dataclasses.fields(ServeConfig)}


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point in a member's search space.

    ``overrides`` maps config field names to lever values;
    ``base`` carries the member-fixed flags the search does not move
    (e.g. ``attention_impl=flash`` for the decoder families).
    ``workload`` selects the lane — a ``"serve"`` candidate draws from
    ``SERVE_LEVERS`` and resolves under the serving validity matrix.
    """

    model: str
    overrides: tuple[tuple[str, object], ...]   # sorted, hashable
    base: tuple[tuple[str, object], ...] = ()
    workload: str = "train"

    @staticmethod
    def make(model: str, overrides: dict, base: dict | None = None,
             workload: str = "train") -> "Candidate":
        levers = SERVE_LEVERS if workload == "serve" else LEVERS
        for k in overrides:
            if k not in levers:
                raise ValueError(
                    f"not a tunable lever ({workload} lane): {k!r}")
        return Candidate(
            model=model,
            overrides=tuple(sorted(overrides.items())),
            base=tuple(sorted((base or {}).items())),
            workload=workload,
        )

    @property
    def key(self) -> str:
        """Stable identity for journal/registry bookkeeping."""
        parts = [f"{k}={v}" for k, v in self.overrides]
        return ",".join(parts) or "defaults"

    @property
    def batch_size(self) -> int:
        d = dict(self.overrides)
        return int(d.get("batch_size", _CONFIG_DEFAULTS["batch_size"]))

    def all_overrides(self) -> dict:
        """base + lever overrides, one dict (base first: a lever that
        shadows a base flag wins)."""
        out = dict(self.base)
        out.update(dict(self.overrides))
        return out

    def to_config(self, **extra):
        """An UNresolved config of the candidate's lane with this
        candidate applied: a ``BenchmarkConfig``, or a ``ServeConfig``
        for a serve candidate (the pruner calls ``.resolve()`` on it to
        get flag-time rejections for free — serve candidates under the
        serving validity matrix)."""
        kwargs = dict(self.all_overrides())
        kwargs.update(extra)
        cls = ServeConfig if self.workload == "serve" else BenchmarkConfig
        return cls(model=self.model, **kwargs)

    def to_flags(self) -> list[str]:
        """The candidate as driver CLI flags (batch rides the
        positional contract, so it is excluded here)."""
        out = []
        for k, v in {**dict(self.base), **dict(self.overrides)}.items():
            if k == "batch_size":
                continue
            if isinstance(v, bool):
                v = "True" if v else "False"
            out.append(f"--{k}={v}")
        return sorted(out)


def seed_candidate(model: str) -> Candidate:
    """The member's seeded best-known config as a Candidate (identity
    point of the search space; also the HBM model's anchor)."""
    seed = SEED_CONFIGS.get(model)
    if seed is None:
        raise ValueError(
            f"no seeded config for {model!r} (not a sweep-matrix member); "
            f"pass an explicit space")
    overrides: dict = {"batch_size": seed["batch"]}
    if seed.get("accum", 1) > 1:
        overrides["gradient_accumulation_steps"] = seed["accum"]
    if seed.get("accum_dtype"):
        overrides["accum_dtype"] = seed["accum_dtype"]
    return Candidate.make(model, overrides, seed.get("base"))


def _pow2_ladder(center: int, down: int = 2, up: int = 2) -> list[int]:
    """Power-of-two ladder around ``center``: center/2^down ..
    center*2^up, floored at 1."""
    out = []
    for e in range(-down, up + 1):
        v = center * (2 ** e) if e >= 0 else center // (2 ** -e)
        if v >= 1 and v not in out:
            out.append(int(v))
    return out


def _member_decodes(model: str) -> bool:
    """True for causal-LM members (the serve lane's decode families);
    best-effort like ``_member_levers`` so the module stays importable
    without the models package."""
    try:
        from tpu_hc_bench_torch.models import get_model_spec

        return bool(get_model_spec(model).causal_lm)
    except Exception:
        return False


def _member_levers(model: str) -> dict[str, bool]:
    """Which structural levers this member supports (remat needs a
    transformer, scan a decoder family).  Spec lookup is best-effort so
    the space module stays importable without the models package."""
    try:
        from tpu_hc_bench_torch.models import get_model_spec

        spec = get_model_spec(model)
        return {"remat": bool(spec.attention or spec.is_text),
                "scan": bool(spec.causal_lm)}
    except Exception:
        return {"remat": False, "scan": False}


def member_space(model: str, mode: str = "axes",
                 seed: Candidate | None = None) -> list[Candidate]:
    """Enumerate the member's candidates, seed first.

    ``mode="axes"`` (default) is the manual-sweep shape automated: vary
    ONE lever at a time off the seeded best-known config — the batch
    ladder, the accum ladder, the dtype/remat/scan/fusion/arm toggles.
    ``mode="grid"`` crosses batch x accum x dtype for members where the
    interaction matters (the OOM-wall members), still toggling the
    remaining levers axis-wise.  Structurally invalid points (accum not
    dividing batch, dtype lever without accum) are never generated;
    deeper validity is the pruner's job.
    """
    if mode not in ("axes", "grid"):
        raise ValueError(f"mode must be axes|grid: {mode!r}")
    seed = seed or seed_candidate(model)
    levers = _member_levers(model)
    sd = dict(seed.overrides)
    base = dict(seed.base)
    seed_batch = int(sd.get("batch_size", _CONFIG_DEFAULTS["batch_size"]))
    seed_accum = int(sd.get("gradient_accumulation_steps", 1))

    out: list[Candidate] = [seed]
    seen = {seed.key}

    def add(overrides: dict):
        # structural validity: accum divides batch, microbatch >= 1,
        # the dtype lever only exists with accum > 1
        b = int(overrides.get("batch_size", seed_batch))
        a = int(overrides.get("gradient_accumulation_steps", 1))
        if a > 1 and (b % a or b // a < 1):
            return
        if overrides.get("accum_dtype", "f32") != "f32" and a <= 1:
            return
        c = Candidate.make(model, overrides, base)
        if c.key not in seen:
            seen.add(c.key)
            out.append(c)

    def vary(**delta):
        o = dict(sd)
        for k, v in delta.items():
            if v is None:
                o.pop(k, None)
            else:
                o[k] = v
        # normalize: accum==1 and f32 are the defaults, drop them so
        # equal configs get equal keys
        if o.get("gradient_accumulation_steps") == 1:
            o.pop("gradient_accumulation_steps", None)
            o.pop("accum_dtype", None)
        if o.get("accum_dtype") == "f32":
            o.pop("accum_dtype", None)
        add(o)

    batches = _pow2_ladder(seed_batch)
    accums = [a for a in _ACCUM_LADDER if a != seed_accum]

    if mode == "grid":
        dtypes = ("f32", "bf16")
        for b in batches:
            for a in _ACCUM_LADDER:
                for dt in dtypes:
                    vary(batch_size=b,
                         gradient_accumulation_steps=a if a > 1 else None,
                         accum_dtype=dt if a > 1 else None)
    else:
        for b in batches:
            vary(batch_size=b)
        for a in accums:
            vary(gradient_accumulation_steps=a if a > 1 else None)
        if seed_accum > 1:
            cur = sd.get("accum_dtype", "f32")
            vary(accum_dtype="bf16" if cur == "f32" else "f32")

    # the toggle levers are axis-wise in both modes
    if levers["remat"]:
        vary(gradient_checkpointing=True)
    if levers["scan"]:
        vary(scan_layers=True)
    for ft in _FUSION_LADDER:
        if ft != sd.get("fusion_threshold_bytes",
                        DEFAULT_FUSION_THRESHOLD_BYTES):
            vary(fusion_threshold_bytes=ft)
    vary(variable_update="zero1")
    return out


def serve_seed_candidate(model: str) -> Candidate:
    """The member's seeded serving config as a workload="serve"
    Candidate (identity point of the serve search space)."""
    seed = SEED_SERVE_CONFIGS.get(model)
    if seed is None:
        raise ValueError(
            f"no seeded serving config for {model!r} (decoder/classify "
            f"members only; see SEED_SERVE_CONFIGS)")
    overrides = {k: v for k, v in seed.items() if k != "base"}
    return Candidate.make(model, overrides, seed.get("base"),
                          workload="serve")


def serve_member_space(model: str,
                       seed: Candidate | None = None) -> list[Candidate]:
    """Enumerate the member's serving candidates, seed first (the
    axes-mode discipline of ``member_space``: one lever at a time off
    the seed).

    Levers: the admission cap (``max_in_flight`` power-of-two ladder —
    more rows per decode step vs deeper queues), the KV page size
    (coarser pages waste tail tokens, finer pages widen the gather
    tables), the pool size (auto vs a half pool — queueing for pages vs
    HBM held), the bucket ladder shape (the full power-of-two
    ladder vs one top-bucket — per-compile cost vs padding waste), and
    — decoder members only — the decode-kernel arms: the
    paged CUDA decode kernel vs the gather reference, its
    page-block size, and the int8 weight/KV quantization arms.
    Structurally-coupled levers are generated together (``int8_kv``
    and ``decode_block_pages`` only exist on the paged arm — the
    combinations ``resolve()`` would reject are never emitted);
    validity beyond this is ``resolve()``'s serving matrix, reached by
    the pruner's flag-time check.
    """
    seed = seed or serve_seed_candidate(model)
    if seed.workload != "serve":
        raise ValueError(f"serve_member_space needs a serve-lane seed: "
                         f"{seed.workload!r}")
    sd = dict(seed.overrides)
    base = dict(seed.base)
    cap = int(sd.get("max_in_flight", _SERVE_DEFAULTS["max_in_flight"]))
    page = int(sd.get("kv_page_size", _SERVE_DEFAULTS["kv_page_size"]))

    out: list[Candidate] = [seed]
    seen = {seed.key}

    def vary(**delta):
        o = dict(sd)
        for k, v in delta.items():
            if v is None:
                o.pop(k, None)
            else:
                o[k] = v
        c = Candidate.make(model, o, base, workload="serve")
        if c.key not in seen:
            seen.add(c.key)
            out.append(c)

    for m in _pow2_ladder(cap, down=1, up=2):
        vary(max_in_flight=m)
    for p in _KV_PAGE_LADDER:
        if p != page:
            vary(kv_page_size=p)
    # decode-kernel arms (decoder members only; classify members have
    # no decode step for these to shape)
    if _member_decodes(model):
        vary(decode_attention="paged")
        for ppb in _DECODE_BLOCK_PAGES_LADDER:
            vary(decode_attention="paged", decode_block_pages=ppb)
        vary(quant="int8_w")
        # int8_kv's per-page scales are consumed inside the paged
        # kernel, so the arm only exists there
        vary(decode_attention="paged", quant="int8_kv")
    # one top bucket: a single compiled decode shape, every step padded
    # to the cap (the compile-count-vs-padding tradeoff made explicit)
    vary(serve_buckets=str(cap))
    # half pool: enough pages for cap/2 worst-case requests + the trash
    # page — admission blocks on pages instead of slots (queueing-for-
    # memory, the vLLM regime), trading HBM held for queue delay
    max_ctx = (_SERVE_DEFAULTS["max_prompt_len"]
               + _SERVE_DEFAULTS["max_output_len"])
    width = -(-max_ctx // page)
    half = 1 + max(1, cap // 2) * width
    vary(kv_pages=half)
    return out


# --- the seed table in a sweep's shape ---------------------------------


def seed_matrix() -> list[tuple[str, int]]:
    """(model, per-chip batch) pairs of the seed table."""
    return [(m, cfg["batch"]) for m, cfg in SEED_CONFIGS.items()]


def seed_extra_flags(model: str) -> list[str]:
    """The member's seeded non-batch flags in CLI form."""
    return seed_candidate(model).to_flags()
