"""Continuous-batching serving engine over a paged KV pool.

The scheduler half of the port's serving lane (``serve.decode`` is the
program half), ported from the JAX package's ``serve/engine.py``:

1. **Bucket ladders.**  One prefill shape per prompt-length bucket and
   one decode shape per batch bucket, built exactly as the JAX engine
   builds them.  PyTorch runs eagerly, so there is no ahead-of-time
   compile; construction runs every bucket once instead, so the kernel
   build and the libraries' first-call setup land before traffic.
2. **Continuous batching** (Orca): admission and retirement happen per
   decode step.  ``batching="static"`` is the control arm: collect a
   full batch, run it to completion, only then admit again.
3. **Paged KV cache** (vLLM): requests hold page tables into one shared
   pool.  A request's worst-case page count is reserved at admission;
   page 0 is the trash page that padded rows read and write.

Timing goes through an injectable clock, so tests drive the closed loop
in virtual time (``VirtualClock``).  On the GPU every step ends in
``torch.cuda.synchronize()`` before its time is read.

Not ported yet: shedding, preemption, fault injection, drain/resume,
lazy reservation and the prefix cache, and the obs writers.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from tpu_hc_bench_torch import resolve_device
from tpu_hc_bench_torch.flags import ServeConfig, parse_serve_buckets
from tpu_hc_bench_torch.serve import slo as slo_mod
from tpu_hc_bench_torch.serve.arrivals import Request


def ceil_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def pick_bucket(ladder: tuple[int, ...], n: int) -> int:
    """Smallest bucket >= n (admission control guarantees one exists)."""
    for b in ladder:
        if b >= n:
            return b
    raise ValueError(f"no bucket >= {n} in ladder {ladder} — admission "
                     f"control should have clamped this")


class PageAllocator:
    """Refcounted free-list allocator over the KV page pool; page 0 is
    the reserved trash page and is never handed out.  A page returns to
    the free list when its last holder frees it."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(
                f"KV pool needs >= 2 pages (one is the reserved trash "
                f"page): {num_pages}")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))
        self._refcount = [0] * num_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refcount[p] = 1
        return out

    def refcount(self, page: int) -> int:
        return self._refcount[page]

    def free(self, pages: list[int]) -> None:
        for p in pages:
            if self._refcount[p] <= 0:
                raise RuntimeError(f"free of unheld page {p}")
            self._refcount[p] -= 1
            if self._refcount[p] == 0:
                self._free.append(p)


class MonotonicClock:
    """Real time: the closed-loop benchmark clock."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)

    def charge(self, kind: str, real_s: float) -> None:
        del kind, real_s        # real compute already advanced now()


class VirtualClock:
    """Deterministic test clock: ``sleep`` is instant (time jumps) and
    each engine step advances time by ``costs[kind]``, or by the real
    measured seconds when the kind has no modeled cost."""

    def __init__(self, costs: dict[str, float] | None = None):
        self.t = 0.0
        self.costs = dict(costs or {})

    def now(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.t += max(0.0, dt)

    def charge(self, kind: str, real_s: float) -> None:
        self.t += self.costs.get(kind, real_s)


@dataclasses.dataclass
class _InFlight:
    """Host-side bookkeeping for one admitted request."""

    req: Request
    pages: list[int]
    table: np.ndarray               # int32 [table_width]
    length: int = 0                 # tokens in KV cache
    produced: int = 0               # generated tokens (prefill's counts)
    last_token: int = 0
    t_admit: float = 0.0
    t_first: float | None = None
    out_tokens: list[int] = dataclasses.field(default_factory=list)


class ServeEngine:
    """One model's serving engine: bucket programs + scheduler.

    ``model`` may be passed in (for example with weights converted from
    the JAX package); by default it is built on ``cfg.device`` with
    weights drawn from ``cfg.seed``.  One engine serves any number of
    runs.
    """

    def __init__(self, cfg: ServeConfig,
                 print_fn: Callable[[str], None] = print, model=None):
        from tpu_hc_bench_torch.models import create_model, get_model_spec
        from tpu_hc_bench_torch.serve import decode as decode_mod

        self.cfg = cfg
        self.print_fn = print_fn
        self.device = resolve_device(cfg.device)
        self.spec = get_model_spec(cfg.model)
        if not self.spec.causal_lm:
            raise ValueError(f"--model {cfg.model}: the port serves "
                             "decoder members only")
        if model is None:
            model, _ = create_model(cfg.model, device=self.device,
                                    seed=cfg.seed)
        self.model = model
        self.max_ctx = cfg.max_prompt_len + cfg.max_output_len
        self.decode_attention = cfg.decode_attention
        self.quant = cfg.quant
        self.block_pages = cfg.decode_block_pages or 1

        # --- bucket ladders + KV pool geometry ---
        self.batch_buckets = parse_serve_buckets(cfg.serve_buckets,
                                                 cfg.max_in_flight)
        self.cap = min(cfg.max_in_flight, max(self.batch_buckets))
        if self.cap < cfg.max_in_flight:
            print_fn(f"serve: max_in_flight clamped to the top decode "
                     f"bucket: {cfg.max_in_flight} -> {self.cap}")
        ladder = []
        s = min(8, ceil_pow2(cfg.max_prompt_len))
        while s < cfg.max_prompt_len:
            ladder.append(s)
            s *= 2
        # the top bucket never exceeds max_ctx
        ladder.append(min(s, self.max_ctx))
        self.prefill_buckets = tuple(ladder)
        self.page_size = cfg.kv_page_size
        self.table_width = -(-self.max_ctx // self.page_size)
        self.num_pages = cfg.kv_pages or (1 + self.cap * self.table_width)
        if self.num_pages < 1 + self.table_width:
            raise ValueError(
                f"--kv_pages={cfg.kv_pages} cannot hold even one request "
                f"(need {1 + self.table_width}: a trash page + "
                f"{self.table_width} pages of {self.page_size} tokens "
                f"for prompt+output {self.max_ctx})")

        self.family = decode_mod.build_family(self.model, quant=self.quant)
        self._kv = decode_mod.init_kv_state(
            self.family, self.num_pages, self.page_size, quant=self.quant,
            device=self.device)
        w = self.table_width
        self.prefill_fn = decode_mod.build_prefill_fn(
            self.family, self.page_size, w, quant=self.quant)
        self.decode_fn = decode_mod.build_decode_fn(
            self.family, self.page_size, w, attention=self.decode_attention,
            quant=self.quant, block_pages=self.block_pages)

        # --- warmup: every bucket once, writing only the trash page ---
        t0 = time.perf_counter()
        self._warm()
        warm_s = time.perf_counter() - t0
        print_fn(f"serve decode arm: attention={self.decode_attention} "
                 f"quant={self.quant}"
                 + (f" block_pages={self.block_pages}"
                    if self.decode_attention == "paged" else ""))
        print_fn(f"serve warmup: {len(self.prefill_buckets)} prefill + "
                 f"{len(self.batch_buckets)} decode bucket(s) run in "
                 f"{warm_s:.1f}s on {self.device}")

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _warm(self) -> None:
        w = self.table_width
        for s in self.prefill_buckets:
            self.prefill_fn(self._kv, self._tensor(np.zeros((1, s),
                                                            np.int32)),
                            1, self._tensor(np.zeros((w,), np.int32)))
        for b in self.batch_buckets:
            self.decode_fn(self._kv, self._tensor(np.zeros((b,), np.int32)),
                           self._tensor(np.zeros((b, w), np.int32)),
                           self._tensor(np.zeros((b,), np.int32)),
                           self._tensor(np.zeros((b,), bool)))
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed(self, clock, kind: str, fn):
        t0 = time.perf_counter()
        out = fn()
        self._sync()
        clock.charge(kind, time.perf_counter() - t0)
        return out

    def run(self, requests: list[Request], batching: str | None = None,
            writer=None, clock=None) -> dict:
        """Play a request trace; returns the serve summary record.

        ``writer`` is any object with ``event(kind, **fields)``; it gets
        one ``request`` record per completed request, with the greedy
        tokens under ``generated``.
        """
        batching = batching or self.cfg.batching
        if batching not in ("continuous", "static"):
            raise ValueError(f"batching must be continuous|static: "
                             f"{batching!r}")
        clock = clock or MonotonicClock()
        allocator = PageAllocator(self.num_pages)
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        n = len(pending)
        over = [r for r in pending
                if r.prompt_len > self.cfg.max_prompt_len
                or r.output_len > self.cfg.max_output_len]
        if over:
            raise ValueError(
                f"{len(over)} request(s) exceed the bucket ladder "
                f"(prompt<={self.cfg.max_prompt_len}, "
                f"output<={self.cfg.max_output_len}); request "
                f"{over[0].rid} is {over[0].prompt_len}/"
                f"{over[0].output_len}")
        kv = self._kv
        queue: collections.deque[Request] = collections.deque()
        active: list[_InFlight] = []
        done: list[dict] = []
        finished = 0
        idx = 0
        steps = {"prefill": 0, "decode": 0}
        tokens_out = 0
        t0 = clock.now()

        def now() -> float:
            return clock.now() - t0

        def finish(fl: _InFlight, t_done: float) -> None:
            nonlocal finished
            finished += 1
            rec = {
                "id": fl.req.rid,
                "status": "ok",
                "arrival_s": round(fl.req.arrival_s, 6),
                "ttft_ms": round(1e3 * (fl.t_first - fl.req.arrival_s), 3),
                "e2e_ms": round(1e3 * (t_done - fl.req.arrival_s), 3),
                "queue_ms": round(1e3 * (fl.t_admit - fl.req.arrival_s), 3),
                "prompt_len": fl.req.prompt_len,
                "output_len": fl.produced,
                "generated": list(fl.out_tokens),
            }
            done.append(rec)
            if writer is not None:
                writer.event("request", **rec)
            allocator.free(fl.pages)

        def admit(req: Request) -> None:
            nonlocal kv, tokens_out
            t_admit = now()
            plen = req.prompt_len
            pages = allocator.alloc(self.table_width)
            if pages is None:
                raise RuntimeError("admission checked free_pages")
            table = np.asarray(pages, np.int32)
            s = pick_bucket(self.prefill_buckets, plen)
            toks = np.zeros((1, s), np.int32)
            toks[0, :plen] = req.prompt
            next_tok, _, kv = self._timed(
                clock, "prefill",
                lambda: self.prefill_fn(kv, self._tensor(toks), plen,
                                        self._tensor(table)))
            tok = int(next_tok[0])
            steps["prefill"] += 1
            tokens_out += 1
            fl = _InFlight(req=req, pages=pages, table=table, length=plen,
                           produced=1, last_token=tok, t_admit=t_admit,
                           t_first=now(), out_tokens=[tok])
            if fl.produced >= req.output_len:
                finish(fl, now())
            else:
                active.append(fl)

        def decode_step() -> None:
            nonlocal kv, tokens_out
            b = pick_bucket(self.batch_buckets, len(active))
            toks = np.zeros((b,), np.int32)
            # padded rows: length 0, a table of trash page 0, inactive
            tables = np.zeros((b, self.table_width), np.int32)
            lengths = np.zeros((b,), np.int32)
            mask = np.zeros((b,), bool)
            for i, fl in enumerate(active):
                toks[i] = fl.last_token
                tables[i] = fl.table
                lengths[i] = fl.length
                mask[i] = True
            next_toks, _, kv = self._timed(
                clock, "decode",
                lambda: self.decode_fn(kv, self._tensor(toks),
                                       self._tensor(tables),
                                       self._tensor(lengths),
                                       self._tensor(mask)))
            steps["decode"] += 1
            tokens_out += len(active)
            next_toks = next_toks.cpu().numpy()
            t_done = now()
            retired = []
            for i, fl in enumerate(active):
                fl.last_token = int(next_toks[i])
                fl.out_tokens.append(fl.last_token)
                fl.length += 1
                fl.produced += 1
                if fl.produced >= fl.req.output_len:
                    finish(fl, t_done)
                    retired.append(fl)
            for fl in retired:
                active.remove(fl)

        while finished < n:
            t = now()
            while idx < n and pending[idx].arrival_s <= t:
                queue.append(pending[idx])
                idx += 1
            progressed = False
            if batching == "continuous":
                while (queue and len(active) < self.cap
                       and allocator.free_pages >= self.table_width):
                    admit(queue.popleft())
                    progressed = True
            elif not active:
                # static: wait for a full batch (or the trace tail), bounded
                # by what the KV pool can hold
                want = min(self.cap, n - finished,
                           allocator.free_pages // self.table_width)
                if len(queue) >= want or idx == n:
                    for _ in range(min(want, len(queue))):
                        admit(queue.popleft())
                        progressed = True
            if active:
                decode_step()
                progressed = True
            if not progressed:
                if idx >= n:
                    raise RuntimeError(
                        "serve engine stalled: no request can make "
                        "progress — KV pool undersized?")
                clock.sleep(pending[idx].arrival_s - now())

        self._kv = kv
        wall = max(now(), 1e-9)
        summary = {
            "workload": "serve",
            "model": self.cfg.model,
            "device": str(self.device),
            "batching": batching,
            "arrival": self.cfg.arrival,
            "arrival_rate": self.cfg.arrival_rate,
            "requests": n,
            "completed": len(done),
            "wall_s": round(wall, 4),
            "tokens": tokens_out,
            "tokens_per_s": round(tokens_out / wall, 3),
            "buckets": list(self.batch_buckets),
            "max_in_flight": self.cap,
            "kv_page_size": self.page_size,
            "kv_pages": self.num_pages,
            "decode_attention": self.decode_attention,
            "quant": self.quant,
            "decode_block_pages": (self.block_pages
                                   if self.decode_attention == "paged"
                                   else None),
            **{f"{k}_steps": v for k, v in steps.items()},
            **slo_mod.fold_requests(done),
        }
        return summary
