"""Configurations and flag parsers of the port's two lanes.

- ``ServeConfig`` / ``parse_flags``: the serving lane (``python -m
  tpu_hc_bench_torch serve``).
- ``BenchmarkConfig`` / ``parse_benchmark_flags``: the training lane
  (``python -m tpu_hc_bench_torch NUM_HOSTS WORKERS BATCH FABRIC``).

Flag spellings and defaults are the JAX package's (``flags.py``), for
each lane, plus ``--device=cuda|cpu``: every flag of the JAX lanes is
ported (the last, ``--virtual_devices``, a CPU host's worker count, with
slice 18); the other lane's flags are unknown.

``--config=manual|auto`` works in both lanes as in JAX: ``auto`` makes
``resolve()`` apply the member's tuned registry row
(``tune.registry.resolve_auto``) before any other check, to every lever
the operator did not type (``explicit_flags``, recorded by the
parsers; the launcher's positional batch counts as typed), and the
note lands in ``translations``.

The training lane takes the reference's whole flag line
(``run-tf-sing-ucx-openmpi.sh``'s tf_cnn_benchmarks command) and
translates its literal values as the JAX package does, each translation
recorded in ``translations`` and printed in the banner: ``--data_format=
NCHW`` (the port's tensors are NCHW views of NHWC memory), ``--mkl``,
``--horovod_device``/``--local_parameter_device`` (the fabric's own
device), the CPU thread knobs (no-ops) and ``--variable_update=horovod``.
The one exception is ``--device``: JAX translates the reference's
``cpu`` to its accelerator, while here ``--device=cpu`` is how a caller
asks for the CPU, so the port's form of the reference line leaves it
out.
"""

from __future__ import annotations

import argparse
import dataclasses

# serving knobs of the JAX lane that this port does not carry yet: none
# since --config came
LATER_SLICE_FLAGS: tuple[str, ...] = ()

# config fields that are not flags: where the resolved config came from
# (--config), what the operator typed, and the translation notes
DERIVED_FIELDS = ("config_source", "tuned_config", "explicit_flags",
                  "translations")


def _resolve_config(cfg, t: dict) -> None:
    """``--config`` first in either lane's ``resolve()``, as JAX's: an
    applied tuned row is then validated like a flag typed by hand."""
    if cfg.config not in ("manual", "auto"):
        raise ValueError(f"--config must be manual|auto: {cfg.config!r}")
    if cfg.config == "auto":
        # the one registry read at flag time (TPU_HC_TUNE_REGISTRY /
        # TPU_HC_TUNE_HW override its directory and hardware key)
        from tpu_hc_bench_torch.tune import registry as tune_registry

        t["config"] = tune_registry.resolve_auto(cfg)


def _typed(argv: list[str], fields: set) -> tuple:
    """The flag names the operator typed (JAX's ``explicit_flags``)."""
    return tuple(sorted(
        {a[2:].split("=", 1)[0] for a in argv if a.startswith("--")}
        & fields))


def parse_serve_buckets(spec: str, max_in_flight: int) -> tuple[int, ...]:
    """Resolve ``--serve_buckets`` into the decode batch-bucket ladder.

    ``auto`` = the power-of-two ladder 1, 2, 4, ... up to
    ``max_in_flight`` (``max_in_flight`` itself appended when it is not a
    power of two).  An explicit spec is comma-separated positive ints
    (``"1,4,8"``); loud on malformed input.
    """
    if max_in_flight < 1:
        raise ValueError(f"--max_in_flight must be >= 1: {max_in_flight}")
    if spec == "auto":
        ladder = []
        b = 1
        while b < max_in_flight:
            ladder.append(b)
            b *= 2
        ladder.append(max_in_flight)
        return tuple(ladder)
    try:
        vals = sorted({int(v) for v in spec.split(",") if v.strip()})
    except ValueError:
        raise ValueError(
            f"--serve_buckets must be 'auto' or comma-separated ints "
            f"(decode batch buckets): {spec!r}") from None
    if not vals or vals[0] < 1:
        raise ValueError(
            f"--serve_buckets needs at least one positive bucket: {spec!r}")
    return tuple(vals)


@dataclasses.dataclass
class ServeConfig:
    """The serve lane's resolved configuration (JAX defaults)."""

    model: str = "llama_1b"
    seed: int = 0
    device: str = "cuda"                      # cuda | cpu (on request)
    arrival: str = "poisson"                  # poisson | bursty | diurnal
    arrival_rate: float = 8.0                 # mean requests/second
    num_requests: int = 64
    serve_buckets: str = "auto"               # decode batch-bucket ladder
    max_in_flight: int = 8                    # continuous-batching cap
    kv_page_size: int = 16                    # tokens per KV page
    kv_pages: int = 0                         # 0 = auto: max_in_flight
                                              # worst-case tables + trash
    max_prompt_len: int = 64
    max_output_len: int = 32
    batching: str = "continuous"              # continuous | static
    decode_attention: str = "gather"          # gather | paged
    quant: str = "off"                        # off | int8_w (per-channel
                                              # int8 projections, scale
                                              # on the product) | int8_kv
                                              # (int8 pool + per-page
                                              # scales; paged arm only)
    decode_block_pages: int = 0               # paged kernel pages per step
                                              # (0 = auto: 1)
    slo_e2e_ms: float = 0.0                   # e2e SLO target: windowed
                                              # burn rate in the summary
    deadline_ms: float = 0.0                  # per-request deadline the
                                              # shed policies judge by
                                              # (0 = slo_e2e_ms)
    shed: str = "off"                         # off | admit | deadline
    kv_preempt: str = "off"                   # off | on: preempt the
                                              # resident with most pages
                                              # per token and requeue it
                                              # with its generated prefix
    serve_faults: str | None = None           # hang@STEP:S, nan_logits@RID,
                                              # sigterm@T, pool_squeeze@T:P
    serve_journal: str | None = None          # drain journal path
                                              # (default ./serve_journal.json)
    serve_resume: str | None = None           # replay a drain journal
    serve_step_timeout_s: str | None = None   # scheduler-iteration
                                              # watchdog (exit 70)
    kv_reserve: str = "worst"                 # worst | lazy (prompt pages
                                              # + headroom, grown on demand)
    prefix_cache: str = "off"                 # off | on: shared prompt
                                              # pages, copy-on-write;
                                              # needs kv_reserve=lazy
    kv_growth_headroom: int = 1               # pages past the prompt a
                                              # lazy admission reserves
    data_dir: str | None = None               # prompt corpus
                                              # (<data_dir>/train.bin);
                                              # None = synthetic prompts
    num_classes: int = 1000                   # classify members' labels
    metrics_dir: str | None = None            # manifest.json +
                                              # metrics.jsonl, heartbeats
                                              # metrics.0.jsonl, spans,
                                              # signals.jsonl, the drain
                                              # journal (obs.metrics)
    flight_recorder: str = "on"               # on|off: the span ring
                                              # (obs.timeline); with
                                              # --metrics_dir spans.0.jsonl
    hbm_budget: str | None = None             # bytes (KB/MB/GB/TB) or
                                              # auto (the card's memory):
                                              # the warmed ladder's
                                              # measured peak is checked
                                              # before traffic
    compile_cache: str | None = None          # the kernel build directory
                                              # (default build/
                                              # torch_kernels); off =
                                              # rebuild, stamp unread
    config: str = "manual"                    # manual | auto: the tuned
                                              # <model>@serve registry row
                                              # (tune.registry)
    # derived, not flags: manual | auto | baseline (auto found no row),
    # the applied row, the typed flags, the notes
    config_source: str = "manual"
    tuned_config: dict | None = None
    explicit_flags: tuple | None = None
    translations: dict = dataclasses.field(default_factory=dict)

    def resolve(self) -> "ServeConfig":
        """Validate (the JAX serving matrix, for the ported knobs)."""
        t: dict[str, str] = {}
        _resolve_config(self, t)
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"--device must be cuda|cpu: {self.device!r}")
        if self.arrival not in ("poisson", "bursty", "diurnal"):
            raise ValueError(
                f"--arrival must be poisson|bursty|diurnal: {self.arrival!r}")
        if self.arrival_rate <= 0:
            raise ValueError(
                f"--arrival_rate must be > 0 req/s: {self.arrival_rate}")
        if self.num_requests < 1:
            raise ValueError(
                f"--num_requests must be >= 1: {self.num_requests}")
        if self.kv_page_size < 1:
            raise ValueError(
                f"--kv_page_size must be >= 1 token: {self.kv_page_size}")
        if self.kv_pages < 0:
            raise ValueError(
                f"--kv_pages must be >= 0 (0 = auto): {self.kv_pages}")
        if self.max_prompt_len < 1:
            raise ValueError(
                f"--max_prompt_len must be >= 1: {self.max_prompt_len}")
        if self.max_output_len < 1:
            raise ValueError(
                f"--max_output_len must be >= 1: {self.max_output_len}")
        if self.batching not in ("continuous", "static"):
            raise ValueError(
                f"--batching must be continuous|static: {self.batching!r}")
        if self.decode_attention not in ("gather", "paged"):
            raise ValueError(
                f"--decode_attention must be gather|paged: "
                f"{self.decode_attention!r}")
        if self.quant not in ("off", "int8_w", "int8_kv"):
            raise ValueError(
                f"--quant must be off|int8_w|int8_kv: {self.quant!r}")
        if self.quant == "int8_kv" and self.decode_attention != "paged":
            raise ValueError(
                "--quant=int8_kv stores per-page scales that are "
                "consumed INSIDE the paged decode kernel; set "
                "--decode_attention=paged (the gather reference has no "
                "scale-fused read path)")
        if self.decode_block_pages < 0:
            raise ValueError(
                f"--decode_block_pages must be >= 0 (0 = auto): "
                f"{self.decode_block_pages}")
        if self.decode_block_pages and self.decode_attention != "paged":
            raise ValueError(
                "--decode_block_pages sizes the paged kernel's page "
                "blocks; it has no meaning under --decode_attention=gather")
        if self.slo_e2e_ms < 0:
            raise ValueError(
                f"--slo_e2e_ms must be >= 0 ms (0 = no SLO tracking): "
                f"{self.slo_e2e_ms}")
        if self.deadline_ms < 0:
            raise ValueError(
                f"--deadline_ms must be >= 0 ms (0 = use --slo_e2e_ms): "
                f"{self.deadline_ms}")
        if self.shed not in ("off", "admit", "deadline"):
            raise ValueError(
                f"--shed must be off|admit|deadline: {self.shed!r}")
        if self.shed != "off" and not (self.deadline_ms
                                       or self.slo_e2e_ms):
            raise ValueError(
                "--shed needs a deadline to shed against: set "
                "--deadline_ms (or --slo_e2e_ms, its fallback)")
        if self.kv_preempt not in ("off", "on"):
            raise ValueError(
                f"--kv_preempt must be off|on: {self.kv_preempt!r}")
        if self.kv_reserve not in ("worst", "lazy"):
            raise ValueError(
                f"--kv_reserve must be worst|lazy: {self.kv_reserve!r}")
        if self.prefix_cache not in ("off", "on"):
            raise ValueError(
                f"--prefix_cache must be off|on: {self.prefix_cache!r}")
        if self.prefix_cache == "on" and self.kv_reserve != "lazy":
            raise ValueError(
                "--prefix_cache=on shares pages a worst-case "
                "reservation would immediately duplicate; set "
                "--kv_reserve=lazy (sharing only saves pages when "
                "admission stops reserving the worst case)")
        if self.num_classes < 1:
            raise ValueError(f"--num_classes must be >= 1: {self.num_classes}")
        if self.kv_growth_headroom < 0:
            raise ValueError(
                f"--kv_growth_headroom must be >= 0 pages: "
                f"{self.kv_growth_headroom}")
        if self.serve_faults:
            from tpu_hc_bench_torch.serve.faults import parse_serve_plan

            parse_serve_plan(self.serve_faults)     # loud format check
        if self.serve_step_timeout_s is not None:
            from tpu_hc_bench_torch.resilience.watchdog import (
                resolve_timeout)

            resolve_timeout(self.serve_step_timeout_s)
        if self.flight_recorder not in ("on", "off"):
            raise ValueError(
                f"--flight_recorder must be on|off: "
                f"{self.flight_recorder!r}")
        parse_serve_buckets(self.serve_buckets, self.max_in_flight)
        if self.hbm_budget is not None:
            from tpu_hc_bench_torch.obs.memory import parse_hbm_budget

            parse_hbm_budget(self.hbm_budget)       # loud format check
        self.translations = t
        return self

    def summary_lines(self) -> list[str]:
        buckets = ",".join(str(b) for b in parse_serve_buckets(
            self.serve_buckets, self.max_in_flight))
        lines = [
            f"serve: model={self.model} device={self.device} "
            f"batching={self.batching} seed={self.seed}",
            f"arrival={self.arrival} rate={self.arrival_rate}/s "
            f"requests={self.num_requests} prompt<={self.max_prompt_len} "
            f"output<={self.max_output_len}",
            f"buckets={buckets} max_in_flight={self.max_in_flight} "
            f"kv_page_size={self.kv_page_size} "
            f"kv_pages={self.kv_pages or 'auto'}",
            f"decode_attention={self.decode_attention} quant={self.quant}"
            + (f" decode_block_pages={self.decode_block_pages}"
               if self.decode_block_pages else ""),
        ]
        if self.kv_reserve != "worst" or self.prefix_cache != "off":
            lines.append(
                f"kv_reserve={self.kv_reserve} "
                f"prefix_cache={self.prefix_cache} "
                f"growth_headroom={self.kv_growth_headroom}")
        if (self.shed != "off" or self.kv_preempt != "off"
                or self.serve_faults or self.serve_resume
                or self.serve_step_timeout_s):
            lines.append(
                f"shed={self.shed} kv_preempt={self.kv_preempt}"
                + (f" deadline_ms={self.deadline_ms:g}"
                   if self.deadline_ms else "")
                + (f" faults={self.serve_faults}"
                   if self.serve_faults else "")
                + (f" resume={self.serve_resume}"
                   if self.serve_resume else "")
                + (f" watchdog={self.serve_step_timeout_s}s"
                   if self.serve_step_timeout_s else ""))
        if self.data_dir is not None:
            lines.append(f"prompts from {self.data_dir}")
        if (self.metrics_dir or self.hbm_budget or self.compile_cache
                or self.flight_recorder != "on"):
            lines.append(
                f"metrics_dir={self.metrics_dir} "
                f"flight_recorder={self.flight_recorder}"
                + (f" hbm_budget={self.hbm_budget}"
                   if self.hbm_budget else "")
                + (f" compile_cache={self.compile_cache}"
                   if self.compile_cache else ""))
        for k, v in self.translations.items():
            lines.append(f"translated: {k}: {v}")
        return lines


def build_parser() -> argparse.ArgumentParser:
    d = ServeConfig()
    p = argparse.ArgumentParser(
        prog="python -m tpu_hc_bench_torch serve",
        description="Serve a decoder with continuous batching over a "
                    "paged KV pool (PyTorch/CUDA port).")
    choices = {"flight_recorder": ["on", "off"]}
    for f in dataclasses.fields(ServeConfig):
        if f.name in DERIVED_FIELDS:
            continue
        default = getattr(d, f.name)
        p.add_argument(f"--{f.name}",
                       type=str if default is None else type(default),
                       default=default, choices=choices.get(f.name))
    return p


def parse_flags(argv: list[str]) -> ServeConfig:
    args = build_parser().parse_args(argv)
    names = {f.name for f in dataclasses.fields(ServeConfig)
             if f.name not in DERIVED_FIELDS}
    cfg = ServeConfig(**{n: getattr(args, n) for n in names})
    # what the operator typed, before resolve(): --config=auto honours
    # an explicit flag even at its default value
    cfg.explicit_flags = _typed(argv, names)
    return cfg.resolve()


# --- training lane -------------------------------------------------------

# training knobs of the JAX lane that this port does not carry yet: none
# since slice 18 (--virtual_devices)
LATER_SLICE_TRAIN_FLAGS: tuple[str, ...] = ()

NONFINITE_POLICIES = ("abort", "skip", "rewind")


def parse_profile_steps(spec: str) -> tuple[int, int]:
    """``--profile_steps=a:b`` -> the inclusive timed-step window (JAX's
    rule and messages); ``b`` may pass the run's end."""
    parts = spec.split(":")
    try:
        if len(parts) != 2:
            raise ValueError
        a, b = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(
            f"--profile_steps must be 'a:b' (1-based timed-step bounds, "
            f"inclusive): {spec!r}") from None
    if a < 1 or b < a:
        raise ValueError(
            f"--profile_steps window must satisfy 1 <= a <= b: {spec!r}")
    return a, b

# Horovod's fusion buffer, 128 MiB (HOROVOD_FUSION_THRESHOLD=134217728),
# the JAX package's default
DEFAULT_FUSION_THRESHOLD_BYTES = 134217728

# the JAX lane's default timed steps, filled in by resolve() when neither
# --num_batches nor --num_epochs is set
DEFAULT_NUM_BATCHES = 100

# the fabric's own device: where --horovod_device and
# --local_parameter_device of the reference (cpu|gpu) land
FABRIC_DEVICE = ("fabric (NCCL on the card for ib|ici|dcn, gloo through "
                 "host memory for sock|host)")

# attention impls of the JAX lane: the single-device two, and the
# sequence-sharded ones, which attend across a seq group
# (``parallel.sequence``)
ATTENTION_IMPLS = ("dense", "flash")
SEQ_SHARDED_IMPLS = ("ring", "ulysses", "ulysses_flash")


OPTIMIZERS = ("momentum", "sgd", "adam", "adamw", "rmsprop")

# fields whose default is None: the type their flag parses to
_OPTIONAL_TYPES = {"seq_len": int, "num_batches": int, "data_dir": str,
                   "train_dir": str, "compile_cache": str,
                   "step_timeout_s": str, "inject_fault": str,
                   "trace_dir": str, "profile_steps": str,
                   "metrics_dir": str, "fabric_ceiling": str,
                   "hbm_budget": str, "virtual_devices": int}
RESUME_POLICIES = ("auto", "never", "must", "elastic")


def _parse_bool(v: str | bool) -> bool:
    """tf_cnn_benchmarks accepts TRUE/False/true/... for boolean flags."""
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("true", "t", "1", "yes"):
        return True
    if s in ("false", "f", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {v!r}")


@dataclasses.dataclass
class BenchmarkConfig:
    """The training lane's resolved configuration (JAX names and
    defaults: 50 warmup and 100 timed batches, resnet50, display every
    10 steps, momentum SGD at lr 0.01, float32 unless --use_fp16)."""

    model: str = "resnet50"
    batch_size: int = 64                      # per worker
    num_warmup_batches: int = 50
    # None = unset: resolve() fills DEFAULT_NUM_BATCHES, so an explicit
    # --num_batches still conflicts with --num_epochs
    num_batches: int | None = None
    num_epochs: float = 0.0                   # dataset passes: run_benchmark
                                              # derives num_batches from
                                              # the shards and the global
                                              # batch
    display_every: int = 10
    optimizer: str = "momentum"               # momentum | sgd | adam |
                                              # adamw | rmsprop (optax's)
    forward_only: bool = False                # the loss with no update
    eval: bool = False                        # forward + top-1 accuracy
                                              # on running statistics
    init_learning_rate: float = 0.01
    momentum: float = 0.9
    use_fp16: bool = False                    # bf16 compute, f32 params
    fused_conv: bool = False                  # fused BN-relu-conv3x3 kernel
    use_space_to_depth: bool = False          # 4x4/s1 stem on packed input
    num_classes: int = 1000
    seed: int = 0
    device: str = "cuda"                      # cuda | cpu (on request)
    variable_update: str = "psum"             # psum (fusion buckets) |
                                              # replicated (per tensor) |
                                              # zero1 (sharded optimizer
                                              # state); horovod -> psum
    gradient_accumulation_steps: int = 1      # microbatches a step
    overlap_grad_comm: str = "on"             # on: buckets launch during
                                              # the backward | off: after
    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES
    attention_impl: str = "dense"             # transformer attention:
                                              # dense (plain) | flash (the
                                              # CUDA flash kernels) | ring
                                              # | ulysses | ulysses_flash
                                              # (sequence-sharded)
    sequence_parallel: int = 1                # sequence shards: ranks a
                                              # seq group (text models)
    model_parallel: int = 1                   # tensor-parallel degree:
                                              # ranks a model group
                                              # (Megatron's split of the
                                              # transformer members)
    expert_parallel: int = 1                  # expert-parallel degree:
                                              # the MoE experts split
                                              # over a model group
    pipeline_parallel: int = 1                # pipeline stages: ranks a
                                              # pipe group (GPipe over
                                              # point-to-point hops)
    num_microbatches: int = 0                 # GPipe microbatches a step
                                              # (0: 2 x stages where the
                                              # batch divides, else
                                              # stages)
    num_slices: int = 0                       # fabric=dcn multislice:
                                              # slices of the data axis
                                              # (0: one per host)
    virtual_devices: int | None = None        # --device=cpu: N gloo
                                              # workers on this host (the
                                              # card count a host has;
                                              # WORKERS_PER_HOST 0 takes
                                              # all N)
    seq_len: int | None = None                # text models: override the
                                              # registry sequence length
    fused_xent: bool = False                  # text models: the CUDA
                                              # blocked cross-entropy
    accum_dtype: str = "f32"                  # the microbatch gradient
                                              # accumulator: f32 | bf16
                                              # (each microbatch's
                                              # gradient rounded, summed
                                              # and reduced in bf16)
    gradient_checkpointing: bool = False      # transformers: recompute
                                              # each layer in the backward
    scan_layers: bool = False                 # decoders: one layer body
                                              # over stacked [L, ...]
                                              # parameters
    moe_impl: str = "einsum"                  # MoE dispatch: einsum |
                                              # ragged | auto
    moe_capacity_factor: float = 1.25         # einsum slots an expert =
                                              # ceil(cf * k * S / E)
    moe_f_chunk: int = 0                      # ragged: the FFN-dim tile
                                              # (0: full width)
    rnn_impl: str = "hoisted"                 # RNN members' GRU: hoisted
                                              # (input products out of the
                                              # loop) | bidi (both
                                              # directions in one loop) |
                                              # flax (every product in it)

    # --- data (the reference's --data_dir/--data_name, JAX's pipeline
    # knobs) ---
    data_dir: str | None = None               # None: synthetic data
    data_name: str = "imagenet"
    data_format: str = "NHWC"                 # the reference passes NCHW:
                                              # translated, see resolve()
    wire_dtype: str = "uint8"                 # host->card image wire:
                                              # uint8 (normalized on the
                                              # card) | float32
    prefetch_depth: int = 2                   # batches in flight to the
                                              # card (and the decode
                                              # queue's depth)
    datasets_num_private_threads: int = 0     # decode pool width (0 auto)
    datasets_repeat_cached_sample: bool = False  # 8 real batches kept on
                                              # the card, cycled
    full_batch_identity: bool = False         # world > 1: decode the whole
                                              # global batch, keep my rows
                                              # (the sliced arm's control)
    input_service: str = "auto"               # on | off | auto (on when
                                              # several workers share one
                                              # host): one decode pool a
                                              # host, shared-memory rings
    service_decode_workers: int = 0           # the host pool's width
                                              # (0 auto: the host budget)

    # --- checkpoints (tf_cnn_benchmarks --train_dir) ---
    train_dir: str | None = None              # save here; --eval and a
                                              # resumed run restore from it
    save_model_steps: int = 0                 # save every N timed steps
                                              # (0: the final state only)
    async_checkpoint: bool = True             # world 1: the write on a
                                              # thread, one in flight
    resume: str = "auto"                      # auto (the latest complete
                                              # checkpoint, if any) | never
                                              # | must (raise if none)
                                              # | elastic (a zero1 state
                                              # resplit for the live
                                              # world)
    keep_checkpoints: int = 0                 # keep the newest N (0: all)

    # --- resilience (JAX's round 8 surface) ---
    on_nonfinite: str = "abort"               # abort (fail loudly) | skip
                                              # (drop the update in the
                                              # step) | rewind (restore
                                              # the last checkpoint, skip
                                              # a window of batches)
    max_bad_steps: int = 10                   # consecutive-failure budget
                                              # of skip/rewind
    step_timeout_s: str | None = None         # watchdog: seconds, auto
                                              # (10x the warmup's mean
                                              # step, >= 60 s), off
    inject_fault: str | None = None           # nan_loss@N, hang@N:S,
                                              # sigterm@N, io_error@ckpt

    # --- observability ---
    metrics_dir: str | None = None            # manifest.json +
                                              # metrics.jsonl (rank 0),
                                              # metrics.<k>.jsonl
                                              # heartbeats and
                                              # spans.<k>.jsonl (every
                                              # rank)
    flight_recorder: str = "on"               # on|off: the span ring
    trace_dir: str | None = None              # torch.profiler (Kineto)
                                              # trace of a timed window
    profile_steps: str | None = None          # "a:b": the window (unset:
                                              # the first sync window)
    hbm_budget: str | None = None             # bytes (KB/MB/GB/TB) or
                                              # auto: checked against the
                                              # first warmup step's peak
    fabric_ceiling: str | None = None         # an OSU sweep export: judge
                                              # the gradient all-reduce
    compile_cache: str | None = None          # the kernel build directory
                                              # (off: rebuild into the
                                              # default one)

    # --- the reference's engine and thread knobs: parsed, translated ---
    mkl: bool = False
    horovod_device: str = "fabric"
    local_parameter_device: str = "fabric"
    num_intra_threads: int = 0
    num_inter_threads: int = 2
    kmp_blocktime: int = 1
    kmp_affinity: str = "granularity=fine,noverbose,compact,1,0"

    # --- autotuner ---
    config: str = "manual"                    # manual: flags mean what
                                              # they say; auto: resolve()
                                              # applies this member's
                                              # tuned registry row
                                              # (tune.registry)
    # derived, not flags: manual | auto | baseline (auto found no row),
    # the applied row, the typed flags (the launcher's positional batch
    # included), the notes
    config_source: str = "manual"
    tuned_config: dict | None = None
    explicit_flags: tuple | None = None
    translations: dict = dataclasses.field(default_factory=dict)

    @property
    def compute_dtype(self) -> str:
        return "bfloat16" if self.use_fp16 else "float32"

    @property
    def sp_active(self) -> bool:
        """A seq group is bound: ``--sequence_parallel`` > 1, or a
        sequence-sharded impl on the degenerate seq axis (JAX's
        ``sp_active``)."""
        return (self.sequence_parallel > 1
                or self.attention_impl in SEQ_SHARDED_IMPLS)

    def resolve(self) -> "BenchmarkConfig":
        """Translate the reference's literal values and validate (the JAX
        training matrix, for the ported knobs)."""
        t: dict[str, str] = {}
        _resolve_config(self, t)
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"--device must be cuda|cpu: {self.device!r}")
        if self.virtual_devices is not None:
            if self.virtual_devices < 1:
                raise ValueError(f"--virtual_devices must be >= 1: "
                                 f"{self.virtual_devices}")
            if self.device != "cpu":
                raise ValueError(
                    "--virtual_devices is a CPU host's worker count "
                    "(--device=cpu): on the card the world comes from the "
                    "visible cards, and two NCCL ranks cannot share one")
        if self.data_format.upper() == "NCHW":
            t["data_format"] = ("NCHW->channels_last (NCHW tensors in NHWC "
                                "memory, the JAX lane's NHWC byte for byte)")
            self.data_format = "NHWC"
        if self.data_format != "NHWC":
            raise ValueError(
                f"--data_format must be NCHW|NHWC: {self.data_format!r}")
        if self.mkl:
            t["mkl"] = "TRUE->no-op (cuDNN and cuBLAS are the compute engine)"
            self.mkl = False
        for name in ("horovod_device", "local_parameter_device"):
            v = getattr(self, name)
            if v in ("cpu", "gpu"):
                t[name] = f"{v}->{FABRIC_DEVICE}"
                setattr(self, name, "fabric")
            elif v != "fabric":
                raise ValueError(f"--{name} must be cpu|gpu: {v!r}")
        if self.num_intra_threads or self.kmp_blocktime != 1:
            t["thread_tuning"] = (
                "num_intra/inter_threads,kmp_* parsed but no-op (PyTorch "
                "and the decode pool size their own threads)")
        if self.num_epochs and self.num_batches is not None:
            raise ValueError(
                "--num_batches and --num_epochs cannot both be set")
        if self.num_epochs < 0:
            raise ValueError(f"--num_epochs must be >= 0: {self.num_epochs}")
        if self.num_batches is None and not self.num_epochs:
            self.num_batches = DEFAULT_NUM_BATCHES
        if self.batch_size < 1:
            raise ValueError(f"--batch_size must be >= 1: {self.batch_size}")
        if self.num_warmup_batches < 0 or (self.num_batches is not None
                                           and self.num_batches < 1):
            raise ValueError(
                f"--num_warmup_batches must be >= 0 and --num_batches >= 1: "
                f"{self.num_warmup_batches}, {self.num_batches}")
        if self.display_every < 1:
            raise ValueError(
                f"--display_every must be >= 1: {self.display_every}")
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(f"--optimizer must be "
                             f"{'|'.join(OPTIMIZERS)}: {self.optimizer!r}")
        if self.variable_update == "horovod":
            t["variable_update"] = ("horovod->psum (the fusion-bucket "
                                    "all-reduce)")
            self.variable_update = "psum"
        if self.variable_update == "zero1":
            # ZeRO-1 shards the optimizer state over the data axis; every
            # unsupported composition dies at flag time
            if self.model_parallel > 1 or self.expert_parallel > 1:
                raise ValueError(
                    "--variable_update=zero1 composes with plain data "
                    "parallelism only (TP/EP run on the GSPMD arm)")
            if self.pipeline_parallel > 1:
                raise ValueError(
                    "--variable_update=zero1 is not supported with "
                    "--pipeline_parallel (the GPipe arm owns its own "
                    "gradient path; no sharded-optimizer layout)")
            if (self.sequence_parallel > 1
                    or self.attention_impl in SEQ_SHARDED_IMPLS):
                raise ValueError(
                    "--variable_update=zero1 composes with plain data "
                    "parallelism only: the SP step reduces over "
                    "(data, seq) and the zero1 reduce-scatter layout is "
                    "data-axis only")
            if self.forward_only:
                raise ValueError(
                    "--variable_update=zero1 shards the OPTIMIZER state; "
                    "forward-only runs have none (use psum)")
        if self.variable_update not in ("psum", "replicated", "zero1"):
            raise ValueError(f"--variable_update must be psum|horovod|"
                             f"replicated|zero1: {self.variable_update!r}")
        for name in ("model_parallel", "expert_parallel",
                     "pipeline_parallel"):
            if getattr(self, name) < 1:
                raise ValueError(f"--{name} must be >= 1: "
                                 f"{getattr(self, name)}")
        if self.num_slices < 0:
            raise ValueError(f"--num_slices must be >= 0 (0: one slice a "
                             f"host): {self.num_slices}")
        if self.model_parallel > 1 and self.expert_parallel > 1:
            raise ValueError(
                "--model_parallel and --expert_parallel are exclusive: both "
                "shard over the mesh 'model' axis")
        if self.gradient_accumulation_steps < 1:
            raise ValueError(f"--gradient_accumulation_steps must be >= 1: "
                             f"{self.gradient_accumulation_steps}")
        if (self.gradient_accumulation_steps > 1
                and self.pipeline_parallel > 1):
            raise ValueError(
                "--gradient_accumulation_steps: pipeline parallelism "
                "already microbatches (--num_microbatches)")
        if self.gradient_accumulation_steps > 1 and (
                self.model_parallel > 1 or self.expert_parallel > 1):
            raise ValueError(
                "--gradient_accumulation_steps is not supported on the "
                "GSPMD TP/EP arm (supported: DP and DP x SP)")
        if self.gradient_accumulation_steps > 1 and (self.forward_only
                                                     or self.eval):
            raise ValueError(
                "--gradient_accumulation_steps is a training-step "
                "knob; it has no meaning forward-only / under --eval")
        if self.batch_size % self.gradient_accumulation_steps:
            raise ValueError(
                f"--batch_size={self.batch_size} (per worker) is not "
                f"divisible by --gradient_accumulation_steps="
                f"{self.gradient_accumulation_steps}")
        if self.accum_dtype not in ("f32", "bf16"):
            raise ValueError(
                f"--accum_dtype must be f32 or bf16: {self.accum_dtype!r}")
        if (self.accum_dtype != "f32"
                and self.gradient_accumulation_steps == 1):
            raise ValueError(
                "--accum_dtype selects the microbatch grad-accumulator "
                "dtype; it has no meaning without "
                "--gradient_accumulation_steps > 1")
        self._resolve_moe(t)
        if self.rnn_impl not in ("hoisted", "bidi", "flax"):
            raise ValueError(f"--rnn_impl must be hoisted|bidi|flax: "
                             f"{self.rnn_impl!r}")
        if self.overlap_grad_comm not in ("on", "off"):
            raise ValueError(f"--overlap_grad_comm must be on|off: "
                             f"{self.overlap_grad_comm!r}")
        if self.fusion_threshold_bytes < 0:
            raise ValueError(f"--fusion_threshold_bytes must be >= 0: "
                             f"{self.fusion_threshold_bytes}")
        if self.num_classes < 1:
            raise ValueError(f"--num_classes must be >= 1: {self.num_classes}")
        self._resolve_sequence_parallel(t)
        if self.pipeline_parallel > 1:
            note = (
                f"{self.variable_update}->n/a (pipeline_parallel="
                f"{self.pipeline_parallel} runs the dedicated GPipe "
                f"shard_map step with its own gradient psums)"
            )
            # appended: an earlier horovod->psum record stays
            prior = t.get("variable_update")
            t["variable_update"] = f"{prior}; {note}" if prior else note
        sharded = max(self.model_parallel, self.expert_parallel)
        # not under the SP or PP hybrids: their own steps keep running
        # and the model axis rides inside them
        if (sharded > 1 and self.variable_update != "replicated"
                and self.sequence_parallel == 1
                and self.pipeline_parallel == 1):
            which = ("model_parallel" if self.model_parallel > 1
                     else "expert_parallel")
            t["variable_update"] = (
                f"{self.variable_update}->replicated ({which}={sharded} "
                f"runs on the GSPMD arm; the explicit fused-psum path and "
                f"fusion_threshold do not apply)")
            self.variable_update = "replicated"
        if self.attention_impl not in ATTENTION_IMPLS + SEQ_SHARDED_IMPLS:
            raise ValueError(f"--attention_impl must be dense|flash|ring|"
                             f"ulysses|ulysses_flash: "
                             f"{self.attention_impl!r}")
        if self.seq_len is not None and self.seq_len < 1:
            raise ValueError(f"--seq_len must be >= 1: {self.seq_len}")
        if self.wire_dtype not in ("uint8", "float32"):
            raise ValueError(
                f"--wire_dtype must be float32|uint8: {self.wire_dtype!r}")
        if self.prefetch_depth < 1:
            raise ValueError(
                f"--prefetch_depth must be >= 1 (1 = no lookahead): "
                f"{self.prefetch_depth}")
        if self.datasets_num_private_threads < 0:
            raise ValueError(
                f"--datasets_num_private_threads must be >= 0 (0 = auto): "
                f"{self.datasets_num_private_threads}")
        if self.input_service not in ("on", "off", "auto"):
            raise ValueError(f"--input_service must be on|off|auto: "
                             f"{self.input_service!r}")
        if self.service_decode_workers < 0:
            raise ValueError(
                f"--service_decode_workers must be >= 0 (0 = auto): "
                f"{self.service_decode_workers}")
        if self.input_service == "on":
            self._translate_input_service(t)
        if self.resume not in RESUME_POLICIES:
            raise ValueError(f"--resume must be auto|never|must|elastic: "
                             f"{self.resume!r}")
        if self.resume in ("must", "elastic") and not self.train_dir:
            raise ValueError(f"--resume={self.resume} needs --train_dir")
        if self.keep_checkpoints < 0:
            raise ValueError(
                f"--keep_checkpoints must be >= 0: {self.keep_checkpoints}")
        if self.save_model_steps < 0:
            raise ValueError(
                f"--save_model_steps must be >= 0: {self.save_model_steps}")
        self._resolve_resilience_obs()
        if self.datasets_repeat_cached_sample and (self.eval
                                                   or self.num_epochs):
            raise ValueError(
                "--datasets_repeat_cached_sample is a throughput-isolation "
                "mode (a handful of batches cycled forever); it cannot "
                "define an epoch (--num_epochs) or a split-wide metric "
                "(--eval)")
        self.translations = t
        return self

    def _resolve_sequence_parallel(self, t: dict) -> None:
        """JAX's sequence-parallel rules and translation notes: SP > 1
        takes the sequence-sharded attention (``dense->ring``,
        ``flash->ulysses_flash``) and ``replicated->psum``; a
        sequence-sharded impl at ``--sequence_parallel=1`` runs the
        degenerate seq axis (a one-rank seq group)."""
        if self.sequence_parallel < 1:
            raise ValueError(f"--sequence_parallel must be >= 1: "
                             f"{self.sequence_parallel}")
        # the supported hybrids are DPxPPxTP and DPxSPxTP
        if self.pipeline_parallel > 1 and self.sequence_parallel > 1:
            raise ValueError(
                "--pipeline_parallel x --sequence_parallel is not a "
                "supported composition (supported: DPxPPxTP, DPxSPxTP)"
            )
        if self.expert_parallel > 1 and (self.pipeline_parallel > 1
                                         or self.sequence_parallel > 1):
            raise ValueError(
                "--expert_parallel composes with data parallelism only")
        if self.sequence_parallel > 1:
            if self.variable_update == "replicated":
                note = (
                    f"replicated->psum (sequence_parallel="
                    f"{self.sequence_parallel} runs the explicit shard_map "
                    f"step; gradients fuse-psum over both mesh axes)"
                )
                prior = t.get("variable_update")
                t["variable_update"] = f"{prior}; {note}" if prior else note
                self.variable_update = "psum"
            # SP needs a sequence-sharded attention impl; translate the
            # single-device names to their SP counterparts
            sp_map = {"dense": "ring", "flash": "ulysses_flash"}
            if self.attention_impl in sp_map:
                new = sp_map[self.attention_impl]
                t["attention_impl"] = (
                    f"{self.attention_impl}->{new} (sequence_parallel="
                    f"{self.sequence_parallel} shards the sequence axis)"
                )
                self.attention_impl = new
        elif self.attention_impl in SEQ_SHARDED_IMPLS:
            # degenerate SP: the seq-sharded impls run on a size-1 seq
            # axis (world-1 collectives: copies), the SP machinery's cost
            # on one card; plain data parallelism only (JAX's rule: the
            # PP/EP/TP compositions key on sequence_parallel > 1)
            if (self.pipeline_parallel > 1 or self.expert_parallel > 1
                    or self.model_parallel > 1):
                raise ValueError(
                    f"--attention_impl={self.attention_impl} with "
                    "--sequence_parallel=1 (degenerate SP) composes with "
                    "plain data parallelism only; set "
                    "--sequence_parallel>1 for the SP hybrids")
            note = (f"sequence_parallel=1: degenerate seq axis (size 1) — "
                    f"{self.attention_impl} collectives are world-1 no-ops")
            t["sequence_parallel"] = note
            if self.variable_update == "replicated":
                note2 = ("replicated->psum (degenerate seq axis runs the "
                         "explicit (data, seq) shard_map step)")
                prior = t.get("variable_update")
                t["variable_update"] = (f"{prior}; {note2}" if prior
                                        else note2)
                self.variable_update = "psum"

    def _resolve_resilience_obs(self) -> None:
        """The resilience and observability flags, loud at flag time
        (JAX's rules and messages)."""
        if self.on_nonfinite not in NONFINITE_POLICIES:
            raise ValueError(
                f"--on_nonfinite must be abort|skip|rewind: "
                f"{self.on_nonfinite!r}")
        if self.on_nonfinite in ("skip", "rewind") and (self.forward_only
                                                        or self.eval):
            raise ValueError(
                "--on_nonfinite=skip/rewind guards the optimizer "
                "update; forward-only/--eval runs have none (abort "
                "still applies)")
        if (self.on_nonfinite in ("skip", "rewind")
                and self.pipeline_parallel > 1):
            raise ValueError(
                "--on_nonfinite=skip/rewind is not supported on the "
                "GPipe arm yet (the PP step owns its own update "
                "loop); supported: DP / TP / EP / SP / multislice")
        if self.on_nonfinite == "rewind" and not self.train_dir:
            raise ValueError(
                "--on_nonfinite=rewind restores the last checkpoint — "
                "set --train_dir")
        if self.on_nonfinite == "rewind" and self.resume == "never":
            raise ValueError(
                "--on_nonfinite=rewind restores from --train_dir; "
                "--resume=never contradicts that (a rewind could "
                "resurrect the very checkpoints you asked to ignore)")
        if self.max_bad_steps < 1:
            raise ValueError(
                f"--max_bad_steps must be >= 1: {self.max_bad_steps}")
        if self.step_timeout_s is not None:
            from tpu_hc_bench_torch.resilience.watchdog import (
                resolve_timeout)

            resolve_timeout(self.step_timeout_s)        # loud check
        if self.inject_fault:
            from tpu_hc_bench_torch.resilience.inject import parse_plan

            parse_plan(self.inject_fault)               # loud check
        if self.flight_recorder not in ("on", "off"):
            raise ValueError(
                f"--flight_recorder must be on|off: "
                f"{self.flight_recorder!r}")
        if self.profile_steps is not None:
            if not self.trace_dir:
                raise ValueError(
                    "--profile_steps selects WHICH timed steps to profile; "
                    "--trace_dir says where the trace goes — set both")
            if self.eval:
                raise ValueError(
                    "--profile_steps applies to the timed training loop; "
                    "it has no meaning under --eval")
            parse_profile_steps(self.profile_steps)     # loud check
        if self.hbm_budget is not None:
            from tpu_hc_bench_torch.obs.memory import parse_hbm_budget

            parse_hbm_budget(self.hbm_budget)           # loud check
        # --fabric_ceiling and --compile_cache are read at run start
        # (resolve stays filesystem-pure, as JAX's)

    def _resolve_moe(self, t: dict) -> None:
        """JAX's MoE flag rules: ``--moe_impl=auto`` picks einsum below
        seq 4096, under EP or TP, and ragged from there on a single
        shard; the capacity factor belongs to the einsum dispatch, and
        the ragged dispatch is refused under EP or TP."""
        if self.moe_impl == "auto":
            from tpu_hc_bench_torch.models import get_model_spec

            try:
                is_moe = get_model_spec(self.model).moe
            except ValueError:
                is_moe = False      # an unknown model: create_model raises
            if not is_moe:
                raise ValueError(f"--moe_impl=auto only applies to MoE "
                                 f"members, not {self.model}")
            long_seq = (self.seq_len or 0) >= 4096
            new = ("ragged" if (long_seq and self.expert_parallel == 1
                                and self.model_parallel == 1
                                and self.moe_capacity_factor == 1.25)
                   else "einsum")
            t["moe_impl"] = (f"auto->{new} (einsum short-seq/EP/TP, "
                             f"ragged at seq>=4096 single-shard)")
            self.moe_impl = new
        if self.moe_impl not in ("einsum", "ragged"):
            raise ValueError(f"--moe_impl must be einsum|ragged|auto: "
                             f"{self.moe_impl!r}")
        if self.moe_impl == "ragged" and self.moe_capacity_factor != 1.25:
            raise ValueError(
                "--moe_capacity_factor applies to the einsum dispatch "
                "only: the ragged grouped-matmul path has no capacity "
                "concept (zero token drops), so the flag would be silently "
                "ignored")
        if self.moe_impl == "ragged" and (
                self.expert_parallel > 1 or self.model_parallel > 1):
            raise ValueError(
                "--expert_parallel/--model_parallel require "
                "--moe_impl=einsum (ragged_dot grouped matmuls are "
                "single-shard; the GShard einsum dispatch is the "
                "GSPMD-shardable path)")
        if self.moe_capacity_factor <= 0:
            raise ValueError(f"--moe_capacity_factor must be > 0: "
                             f"{self.moe_capacity_factor}")
        if self.moe_f_chunk < 0:
            raise ValueError(f"--moe_f_chunk must be >= 0: "
                             f"{self.moe_f_chunk}")

    def _translate_input_service(self, t: dict) -> None:
        """``--input_service=on`` where no host pipeline can be shared
        turns to ``off``, loudly (JAX's translations); the world's shape
        is the driver's to check."""
        is_text = False
        if self.data_dir is not None:
            from tpu_hc_bench_torch.models import get_model_spec

            try:
                is_text = get_model_spec(self.model).is_text
            except ValueError:
                pass            # an unknown model: create_model raises
        if self.data_dir is None:
            why = "synthetic input has no host decode pipeline to share"
        elif is_text:
            why = ("text members read a memmapped corpus per-process; the "
                   "packed-token service is not driver-wired yet — see "
                   "data.service.make_packed_token_service")
        elif self.datasets_repeat_cached_sample:
            why = ("--datasets_repeat_cached_sample decodes a handful of "
                   "batches once and shuts the pipeline down — nothing "
                   "to serve")
        elif self.eval:
            why = ("--eval reads the validation split per-process; the "
                   "service targets the sustained training input plane")
        else:
            return
        t["input_service"] = f"on->off ({why})"
        self.input_service = "off"

    def summary_lines(self) -> list[str]:
        lines = [
            f"train: model={self.model} batch_size={self.batch_size} "
            f"device={self.device} dtype={self.compute_dtype} "
            f"seed={self.seed}",
            f"warmup={self.num_warmup_batches} timed={self.num_batches} "
            f"display_every={self.display_every} optimizer={self.optimizer} "
            f"lr={self.init_learning_rate} momentum={self.momentum}",
            f"forward_only={self.forward_only} eval={self.eval} data="
            + ("synthetic" if self.data_dir is None else self.data_dir)
            + (" [repeat_cached_sample]"
               if self.datasets_repeat_cached_sample else "")
            + f" ({self.data_name}, {self.data_format}) "
            f"wire_dtype={self.wire_dtype} "
            f"prefetch_depth={self.prefetch_depth}",
            f"fused_conv={self.fused_conv} "
            f"use_space_to_depth={self.use_space_to_depth} "
            f"num_classes={self.num_classes}",
            f"attention_impl={self.attention_impl} "
            f"seq_len={self.seq_len or 'model default'} "
            f"fused_xent={self.fused_xent} "
            f"sequence_parallel={self.sequence_parallel} "
            f"model_parallel={self.model_parallel} "
            f"expert_parallel={self.expert_parallel} "
            f"pipeline_parallel={self.pipeline_parallel} "
            f"num_microbatches={self.num_microbatches or 'auto'} "
            f"num_slices={self.num_slices or 'one a host'}",
            f"variable_update={self.variable_update} "
            f"overlap_grad_comm={self.overlap_grad_comm} "
            f"fusion_threshold_bytes={self.fusion_threshold_bytes} "
            f"gradient_accumulation_steps="
            f"{self.gradient_accumulation_steps} "
            f"accum_dtype={self.accum_dtype}",
            f"gradient_checkpointing={self.gradient_checkpointing} "
            f"scan_layers={self.scan_layers} moe_impl={self.moe_impl} "
            f"moe_capacity_factor={self.moe_capacity_factor} "
            f"moe_f_chunk={self.moe_f_chunk} rnn_impl={self.rnn_impl}",
            f"input_service={self.input_service} "
            f"service_decode_workers={self.service_decode_workers or 'auto'}"
            f" train_dir={self.train_dir} resume={self.resume} "
            f"save_model_steps={self.save_model_steps} "
            f"async_checkpoint={self.async_checkpoint} "
            f"keep_checkpoints={self.keep_checkpoints}",
            f"on_nonfinite={self.on_nonfinite} "
            f"max_bad_steps={self.max_bad_steps} "
            f"step_timeout_s={self.step_timeout_s} "
            f"inject_fault={self.inject_fault}",
        ]
        if (self.metrics_dir or self.trace_dir or self.hbm_budget
                or self.fabric_ceiling or self.compile_cache
                or self.flight_recorder != "on"):
            lines.append(
                f"metrics_dir={self.metrics_dir} "
                f"flight_recorder={self.flight_recorder} "
                f"trace_dir={self.trace_dir} "
                f"profile_steps={self.profile_steps} "
                f"hbm_budget={self.hbm_budget} "
                f"fabric_ceiling={self.fabric_ceiling} "
                f"compile_cache={self.compile_cache}")
        for k, v in self.translations.items():
            lines.append(f"translated: {k}: {v}")
        return lines


def build_benchmark_parser() -> argparse.ArgumentParser:
    d = BenchmarkConfig()
    p = argparse.ArgumentParser(
        prog="python -m tpu_hc_bench_torch NUM_HOSTS WORKERS_PER_HOST "
             "BATCH_SIZE FABRIC",
        description="Train on synthetic data to the tf_cnn_benchmarks "
                    "protocol (PyTorch/CUDA port).")
    for f in dataclasses.fields(BenchmarkConfig):
        if f.name in DERIVED_FIELDS:
            continue
        v = getattr(d, f.name)
        kind = _OPTIONAL_TYPES.get(f.name, type(v))
        p.add_argument(f"--{f.name}", default=v,
                       type=_parse_bool if isinstance(v, bool) else kind)
    return p


def parse_benchmark_flags(argv: list[str]) -> BenchmarkConfig:
    args = build_benchmark_parser().parse_args(argv)
    names = {f.name for f in dataclasses.fields(BenchmarkConfig)
             if f.name not in DERIVED_FIELDS}
    cfg = BenchmarkConfig(**{n: getattr(args, n) for n in names})
    # what the operator typed, before resolve(): --config=auto honours
    # an explicit flag even at its default value
    cfg.explicit_flags = _typed(argv, names)
    return cfg.resolve()
