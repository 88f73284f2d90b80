"""Configurations and flag parsers of the port's two lanes.

- ``ServeConfig`` / ``parse_flags``: the serving lane (``python -m
  tpu_hc_bench_torch serve``).
- ``BenchmarkConfig`` / ``parse_benchmark_flags``: the training lane
  (``python -m tpu_hc_bench_torch NUM_HOSTS WORKERS BATCH FABRIC``).

Flag spellings and defaults are the JAX package's (``flags.py``), for
the part of each lane ported so far, plus ``--device=cuda|cpu``.  Flags
of the JAX lane that are not ported yet parse and are rejected loudly,
so no run silently ignores one; the other lane's flags are unknown.

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

# serving knobs of the JAX lane that this port does not carry yet
LATER_SLICE_FLAGS = (
    "slo_e2e_ms", "deadline_ms", "shed", "kv_preempt", "serve_faults",
    "serve_journal", "serve_resume", "serve_step_timeout_s", "kv_reserve",
    "prefix_cache", "kv_growth_headroom", "metrics_dir", "data_dir",
    "compile_cache", "hbm_budget", "flight_recorder", "config",
)


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
    quant: str = "off"                        # only off is ported
    decode_block_pages: int = 0               # paged kernel pages per step
                                              # (0 = auto: 1)

    def resolve(self) -> "ServeConfig":
        """Validate (the JAX serving matrix, for the ported knobs)."""
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
        if self.quant in ("int8_w", "int8_kv"):
            raise ValueError(
                f"--quant={self.quant} is not ported yet (off only)")
        if self.quant != "off":
            raise ValueError(
                f"--quant must be off|int8_w|int8_kv: {self.quant!r}")
        if self.decode_block_pages < 0:
            raise ValueError(
                f"--decode_block_pages must be >= 0 (0 = auto): "
                f"{self.decode_block_pages}")
        if self.decode_block_pages and self.decode_attention != "paged":
            raise ValueError(
                "--decode_block_pages sizes the paged kernel's page "
                "blocks; it has no meaning under --decode_attention=gather")
        parse_serve_buckets(self.serve_buckets, self.max_in_flight)
        return self

    def summary_lines(self) -> list[str]:
        buckets = ",".join(str(b) for b in parse_serve_buckets(
            self.serve_buckets, self.max_in_flight))
        return [
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


def build_parser() -> argparse.ArgumentParser:
    d = ServeConfig()
    p = argparse.ArgumentParser(
        prog="python -m tpu_hc_bench_torch serve",
        description="Serve a decoder with continuous batching over a "
                    "paged KV pool (PyTorch/CUDA port).")
    for f in dataclasses.fields(ServeConfig):
        p.add_argument(f"--{f.name}", type=type(getattr(d, f.name)),
                       default=getattr(d, f.name))
    for name in LATER_SLICE_FLAGS:
        p.add_argument(f"--{name}", default=None, help=argparse.SUPPRESS)
    return p


def parse_flags(argv: list[str]) -> ServeConfig:
    args = build_parser().parse_args(argv)
    later = [n for n in LATER_SLICE_FLAGS if getattr(args, n) is not None]
    if later:
        raise ValueError(
            "flag(s) of the JAX serving lane not ported yet: "
            + ", ".join(f"--{n}" for n in later))
    vals = {f.name: getattr(args, f.name)
            for f in dataclasses.fields(ServeConfig)}
    return ServeConfig(**vals).resolve()


# --- training lane -------------------------------------------------------

# training knobs of the JAX lane that this port does not carry yet
LATER_SLICE_TRAIN_FLAGS = (
    "train_dir", "save_model_steps",
    "async_checkpoint", "compile_cache",
    "service_decode_workers", "config",
    "on_nonfinite", "max_bad_steps", "resume", "step_timeout_s",
    "keep_checkpoints", "inject_fault", "moe_capacity_factor",
    "trace_dir", "profile_steps", "metrics_dir",
    "flight_recorder", "fabric_ceiling", "hbm_budget", "num_slices",
    "accum_dtype", "model_parallel",
    "expert_parallel", "pipeline_parallel", "num_microbatches",
    "sequence_parallel", "virtual_devices", "gradient_checkpointing",
    "moe_impl", "rnn_impl", "scan_layers", "moe_f_chunk",
)

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

# attention impls of the JAX lane: the single-device two are ported, the
# sequence-parallel ones come with the multi-card slices
ATTENTION_IMPLS = ("dense", "flash")
SEQ_SHARDED_IMPLS = ("ring", "ulysses", "ulysses_flash")


OPTIMIZERS = ("momentum", "sgd", "adam", "adamw", "rmsprop")

# fields whose default is None: the type their flag parses to
_OPTIONAL_TYPES = {"seq_len": int, "num_batches": int, "data_dir": str}


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
                                              # replicated (per tensor);
                                              # horovod -> psum
    gradient_accumulation_steps: int = 1      # microbatches a step
    overlap_grad_comm: str = "on"             # on: buckets launch during
                                              # the backward | off: after
    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES
    attention_impl: str = "dense"             # transformer attention:
                                              # dense (plain) | flash (the
                                              # CUDA flash kernels)
    seq_len: int | None = None                # text models: override the
                                              # registry sequence length
    fused_xent: bool = False                  # text models: the CUDA
                                              # blocked cross-entropy

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
    input_service: str = "auto"               # off | auto (the per-process
                                              # pipelines); on: not ported

    # --- the reference's engine and thread knobs: parsed, translated ---
    mkl: bool = False
    horovod_device: str = "fabric"
    local_parameter_device: str = "fabric"
    num_intra_threads: int = 0
    num_inter_threads: int = 2
    kmp_blocktime: int = 1
    kmp_affinity: str = "granularity=fine,noverbose,compact,1,0"

    translations: dict = dataclasses.field(default_factory=dict)

    @property
    def compute_dtype(self) -> str:
        return "bfloat16" if self.use_fp16 else "float32"

    def resolve(self) -> "BenchmarkConfig":
        """Translate the reference's literal values and validate (the JAX
        training matrix, for the ported knobs)."""
        t: dict[str, str] = {}
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"--device must be cuda|cpu: {self.device!r}")
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
            raise ValueError("--variable_update=zero1 is not ported yet "
                             "(psum|horovod|replicated)")
        if self.variable_update not in ("psum", "replicated"):
            raise ValueError(f"--variable_update must be psum|horovod|"
                             f"replicated|zero1: {self.variable_update!r}")
        if self.gradient_accumulation_steps < 1:
            raise ValueError(f"--gradient_accumulation_steps must be >= 1: "
                             f"{self.gradient_accumulation_steps}")
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
        if self.overlap_grad_comm not in ("on", "off"):
            raise ValueError(f"--overlap_grad_comm must be on|off: "
                             f"{self.overlap_grad_comm!r}")
        if self.fusion_threshold_bytes < 0:
            raise ValueError(f"--fusion_threshold_bytes must be >= 0: "
                             f"{self.fusion_threshold_bytes}")
        if self.num_classes < 1:
            raise ValueError(f"--num_classes must be >= 1: {self.num_classes}")
        if self.attention_impl in SEQ_SHARDED_IMPLS:
            raise ValueError(f"--attention_impl={self.attention_impl} is not "
                             "ported yet (dense|flash: one worker, no "
                             "sequence parallelism)")
        if self.attention_impl not in ATTENTION_IMPLS:
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
        if self.input_service == "on":
            raise ValueError("--input_service=on (the shared host decode "
                             "service) is not ported yet (off|auto: the "
                             "per-process pipelines)")
        if self.input_service not in ("off", "auto"):
            raise ValueError(f"--input_service must be on|off|auto: "
                             f"{self.input_service!r}")
        if self.datasets_repeat_cached_sample and (self.eval
                                                   or self.num_epochs):
            raise ValueError(
                "--datasets_repeat_cached_sample is a throughput-isolation "
                "mode (a handful of batches cycled forever); it cannot "
                "define an epoch (--num_epochs) or a split-wide metric "
                "(--eval)")
        self.translations = t
        return self

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
            f"fused_xent={self.fused_xent}",
            f"variable_update={self.variable_update} "
            f"overlap_grad_comm={self.overlap_grad_comm} "
            f"fusion_threshold_bytes={self.fusion_threshold_bytes} "
            f"gradient_accumulation_steps="
            f"{self.gradient_accumulation_steps}",
        ]
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
        if f.name == "translations":
            continue
        v = getattr(d, f.name)
        kind = _OPTIONAL_TYPES.get(f.name, type(v))
        p.add_argument(f"--{f.name}", default=v,
                       type=_parse_bool if isinstance(v, bool) else kind)
    for name in LATER_SLICE_TRAIN_FLAGS:
        p.add_argument(f"--{name}", default=None, help=argparse.SUPPRESS)
    return p


def parse_benchmark_flags(argv: list[str]) -> BenchmarkConfig:
    args = build_benchmark_parser().parse_args(argv)
    later = [n for n in LATER_SLICE_TRAIN_FLAGS
             if getattr(args, n) is not None]
    if later:
        raise ValueError(
            "flag(s) of the JAX training lane not ported yet: "
            + ", ".join(f"--{n}" for n in later))
    vals = {f.name: getattr(args, f.name)
            for f in dataclasses.fields(BenchmarkConfig)
            if f.name != "translations"}
    return BenchmarkConfig(**vals).resolve()
