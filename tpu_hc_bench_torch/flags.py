"""Serving-lane configuration and flag parser of the port.

Flag spellings and defaults are the JAX package's (``flags.py``, the
serving knobs of ``BenchmarkConfig``), for the part of the lane ported
so far, plus ``--device=cuda|cpu``.  Serving flags of later slices parse
and are rejected loudly, so no run silently ignores one; training flags
are unknown here.
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
