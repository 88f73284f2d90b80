"""Continuous-batching serving engine over a paged KV pool.

The scheduler half of the port's serving lane (``serve.decode`` is the
program half), ported from the JAX package's ``serve/engine.py``:

1. **Bucket ladders.**  One prefill shape per prompt-length bucket and
   one decode shape per batch bucket, built exactly as the JAX engine
   builds them.  PyTorch runs eagerly, so there is no ahead-of-time
   compile; construction runs every bucket once instead (and the page
   copy), so the kernel build and the libraries' first-call setup land
   before traffic.
2. **Continuous batching** (Orca): admission and retirement happen per
   decode step.  ``batching="static"`` is the control arm: collect a
   full batch, run it to completion, only then admit again.
3. **Paged KV cache** (vLLM): requests hold page tables into one shared
   pool; page 0 is the trash page that padded rows read and write.
   ``kv_reserve="worst"`` reserves a request's worst-case pages at
   admission; ``"lazy"`` reserves its prompt's pages plus
   ``--kv_growth_headroom`` and grows a page each time a boundary is
   crossed.  ``prefix_cache="on"`` shares prompt pages between requests
   through ``serve.prefix_cache`` (refcounted pages, copy-on-write at
   the first append into a shared page).
4. **Graceful degradation**: deadline-aware shedding (``--shed``
   against ``--deadline_ms``), KV-pressure preemption with a requeue
   that carries the victim's generated prefix (``--kv_preempt``),
   per-request quarantine of non-finite logits, a SIGTERM drain that
   journals every unfinished request for ``--serve_resume``, and a
   scheduler-iteration watchdog (``--serve_step_timeout_s``).  Every
   knob defaults off; the logits guard (one host read a step) arms only
   under ``shed`` or ``kv_preempt``.
5. **Classify mode**: the image and speech members serve
   single-forward requests (JAX's ``decode_mode`` off): no KV pool, one
   classify program a batch bucket (``decode.build_classify_fn``), each
   request's input drawn from ``(seed, 13, rid)``, every resident
   request answered by one ``classify_step`` (``t_first`` is its
   completion, so ttft equals e2e, and its resident window is the
   decode lane's: ``t_first := t_admit`` in the breakdown).  The decode
   lane's knobs, ``--serve_faults`` and ``--kv_preempt`` are refused,
   with JAX's messages; ``ncf`` is refused at construction (its
   embeddings take integer ids; JAX's float example fails in Flax's
   ``Embed``).

Timing goes through an injectable clock, so tests drive the closed loop
in virtual time (``VirtualClock``).  On the GPU every step ends in
``torch.cuda.synchronize()`` before its time is read.

The MoE members (``gpt2_moe``, ``moe_tiny``) serve through the ragged
dispatch (``serve.decode``).  Not ported yet: the obs writers
(metrics stream, flight recorder, fleet heartbeat, latency sketches and
signals).
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
from tpu_hc_bench_torch.resilience import preempt as preempt_mod
from tpu_hc_bench_torch.resilience import watchdog as watchdog_mod
from tpu_hc_bench_torch.serve import faults as faults_mod
from tpu_hc_bench_torch.serve import kv as kv_mod
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
    the reserved trash page and is never handed out.

    A page can be held by several requests (a prefix-cache hit) and by
    the cache itself: every holder takes a reference (``alloc``,
    ``cow_alloc``, ``share``) and drops it through ``free``; a page
    returns to the free list when its last holder lets go.  ``bind`` is
    the one page-table store.  ``recycled`` counts pages handed out
    again by ``alloc`` after a free; ``cow_copies`` counts copy-on-write
    pages (``cow_alloc``), which are not recycles; ``pages_peak`` is the
    most pages ever held at once.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(
                f"KV pool needs >= 2 pages (one is the reserved trash "
                f"page): {num_pages}")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))
        self._refcount = [0] * num_pages
        self._ever_used = [False] * num_pages
        self.pages_peak = 0
        self.recycled = 0
        self.cow_copies = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def _take(self, count_recycle: bool) -> int:
        p = self._free.pop()
        self._refcount[p] = 1
        if self._ever_used[p]:
            self.recycled += count_recycle
        else:
            self._ever_used[p] = True
        return p

    def _held(self, page: int, what: str) -> None:
        if self._refcount[page] <= 0:
            raise RuntimeError(f"{what} of unheld page {page}")

    def alloc(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        out = [self._take(count_recycle=True) for _ in range(n)]
        self.pages_peak = max(self.pages_peak, self.used_pages)
        return out

    def cow_alloc(self) -> int | None:
        """One page for a copy-on-write duplication (``cow_copies``)."""
        if not self._free:
            return None
        p = self._take(count_recycle=False)
        self.cow_copies += 1
        self.pages_peak = max(self.pages_peak, self.used_pages)
        return p

    def share(self, pages: list[int]) -> None:
        """One more reference per page (a prefix-cache hit or the
        cache's own hold)."""
        for p in pages:
            self._held(p, "share")
            self._refcount[p] += 1

    def refcount(self, page: int) -> int:
        return self._refcount[page]

    def free(self, pages: list[int]) -> None:
        """Drop one reference per page; a page rejoins the free list at
        refcount zero."""
        for p in pages:
            self._held(p, "free")
            self._refcount[p] -= 1
            if self._refcount[p] == 0:
                self._free.append(p)

    def bind(self, table: np.ndarray, slot: int, page: int) -> None:
        """Point ``table[slot]`` at a page this allocator holds."""
        self._held(page, "bind")
        table[slot] = page


class KVLedger:
    """Pages reserved by admission against pages written, integrated
    over step wall into the page-seconds behind ``kv_pool_util``.
    "Written" follows the scheduler's state (the prompt at admission,
    one token a decode step), not a read of the pool."""

    __slots__ = ("page_size", "reserved_now", "written_now",
                 "reserved_page_s", "written_page_s")

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.reserved_now = 0
        self.written_now = 0
        self.reserved_page_s = 0.0
        self.written_page_s = 0.0

    def admit(self, pages_reserved: int, prompt_len: int) -> None:
        self.reserved_now += pages_reserved
        self.written_now += -(-prompt_len // self.page_size)

    def grow(self, n: int = 1) -> None:
        self.reserved_now += n

    def token(self, length_before: int) -> None:
        if length_before % self.page_size == 0:
            self.written_now += 1

    def retire(self, pages_reserved: int, length: int) -> int:
        """Release a request's pages; returns its written-page count."""
        final = -(-length // self.page_size)
        self.reserved_now -= pages_reserved
        self.written_now -= final
        return final

    def charge(self, dt: float) -> None:
        self.reserved_page_s += self.reserved_now * dt
        self.written_page_s += self.written_now * dt


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


class _NullWriter:
    def event(self, kind: str, **fields) -> None:
        del kind, fields


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
    active_s: float = 0.0           # summed wall of its decode steps
    t_last: float | None = None     # end of its last decode step
    preempts: int = 0               # completed residencies
    produced_res: int = 0           # tokens produced this residency
    pages_grown: int = 0            # pages grown after admission
    prefix_shared: int = 0          # slots admitted on shared pages


def _check_classify(cfg: ServeConfig, spec) -> None:
    """JAX's refusals for a classify member: the decode lane's knobs, and
    the id member, whose embeddings take no float example."""
    if (cfg.decode_attention != "gather" or cfg.quant != "off"
            or cfg.decode_block_pages):
        raise ValueError(
            f"--model {cfg.model} serves single-forward classify "
            "requests; --decode_attention/--quant/--decode_block_pages "
            "shape the paged decode step and have no meaning here")
    if cfg.kv_reserve != "worst" or cfg.prefix_cache != "off":
        raise ValueError(
            f"--model {cfg.model} serves single-forward classify requests "
            "with no KV pool; --kv_reserve/--prefix_cache shape "
            "paged-decode admission and have no meaning here")
    if spec.integer_input:
        raise ValueError(
            f"--model {cfg.model}: classify requests carry float inputs "
            "and its embeddings take integer ids (Flax's Embed: Input "
            "type must be an integer or unsigned integer)")


class ServeEngine:
    """One model's serving engine: bucket programs + scheduler.

    ``model`` may be passed in (for example with weights converted from
    the JAX package); by default it is built on ``cfg.device`` with
    weights drawn from ``cfg.seed``, a text model's position table
    ``max_prompt_len + max_output_len`` rows long at least.  One engine
    serves any number of runs.
    """

    def __init__(self, cfg: ServeConfig,
                 print_fn: Callable[[str], None] = print, model=None):
        from tpu_hc_bench_torch.models import create_model, get_model_spec
        from tpu_hc_bench_torch.serve import decode as decode_mod

        self.cfg = cfg
        self.print_fn = print_fn
        self.device = resolve_device(cfg.device)
        self.spec = get_model_spec(cfg.model)
        if self.spec.is_text and not self.spec.causal_lm:
            raise ValueError(
                f"--model {cfg.model}: MLM members have no "
                "autoregressive serving story; serve a decoder family "
                "(gpt2*/moe*/llama*) or a classify member")
        self.decode_mode = bool(self.spec.causal_lm)
        self.max_ctx = cfg.max_prompt_len + cfg.max_output_len
        self.decode_attention = cfg.decode_attention
        self.quant = cfg.quant
        self.block_pages = cfg.decode_block_pages or 1
        if not self.decode_mode:
            _check_classify(cfg, self.spec)
        if model is None:
            kw = (dict(seq_len=self.max_ctx) if self.decode_mode
                  else dict(num_classes=cfg.num_classes))
            model, _ = create_model(cfg.model, device=self.device,
                                    seed=cfg.seed, **kw)
        self.model = model

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
        if not self.decode_mode:
            # a classify member allocates no pool: an explicit --kv_pages
            # does not fail its construction
            self._init_classify(print_fn)
            return
        if self.num_pages < 1 + self.table_width:
            raise ValueError(
                f"--kv_pages={cfg.kv_pages} cannot hold even one request "
                f"(need {1 + self.table_width}: a trash page + "
                f"{self.table_width} pages of {self.page_size} tokens "
                f"for prompt+output {self.max_ctx})")

        self.family = decode_mod.build_family(self.model, quant=self.quant)
        self.weight_bytes = self.family.weight_bytes()
        self._kv = decode_mod.init_kv_state(
            self.family, self.num_pages, self.page_size, quant=self.quant,
            device=self.device)
        self.kv_pool_bytes = sum(x.nbytes for x in self._kv)
        self.kv_scale_bytes = sum(x.nbytes for x in self._kv
                                  if x.dtype == torch.float32
                                  and self.quant == "int8_kv")
        w = self.table_width
        self.prefill_fn = decode_mod.build_prefill_fn(
            self.family, self.page_size, w, quant=self.quant)
        self.decode_fn = decode_mod.build_decode_fn(
            self.family, self.page_size, w, attention=self.decode_attention,
            quant=self.quant, block_pages=self.block_pages)
        self.page_copy_fn = decode_mod.build_page_copy_fn()

        # --- warmup: every bucket once, writing only the trash page ---
        t0 = time.perf_counter()
        self._warm()
        self.warm_s = time.perf_counter() - t0
        self.warm_programs = (len(self.prefill_buckets)
                              + len(self.batch_buckets) + 1)
        print_fn(f"serve decode arm: attention={self.decode_attention} "
                 f"quant={self.quant}"
                 + (f" block_pages={self.block_pages}"
                    if self.decode_attention == "paged" else ""))
        print_fn(f"serve warmup: {len(self.prefill_buckets)} prefill + "
                 f"{len(self.batch_buckets)} decode bucket(s) run in "
                 f"{self.warm_s:.1f}s on {self.device}")

    def _init_classify(self, print_fn) -> None:
        """The classify mode's one program a batch bucket (JAX
        ``_warm_classify``), each run once; no KV pool."""
        from tpu_hc_bench_torch.serve import decode as decode_mod

        self.family = None
        self.weight_bytes = sum(p.nbytes for p in self.model.parameters())
        self.kv_pool_bytes, self.kv_scale_bytes = None, 0
        self.classify_fn = decode_mod.build_classify_fn(self.model,
                                                        self.spec)
        t0 = time.perf_counter()
        shape = tuple(self.spec.input_shape)
        for b in self.batch_buckets:
            self.classify_fn(self._tensor(np.zeros((b,) + shape,
                                                   np.float32)))
        self._sync()
        self.warm_s = time.perf_counter() - t0
        self.warm_programs = len(self.batch_buckets)
        print_fn(f"serve classify: {self.warm_programs} bucket program(s) "
                 f"run in {self.warm_s:.1f}s on {self.device}")

    def _classify_input(self, req: Request) -> np.ndarray:
        """Request ``rid``'s input, JAX's draw: float32, the spec's shape
        (NHWC for an image)."""
        rng = np.random.default_rng((self.cfg.seed, 13, req.rid))
        return rng.standard_normal(
            tuple(self.spec.input_shape)).astype(np.float32)

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
        self.page_copy_fn(self._kv, 0, 0)
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed(self, clock, kind: str, fn):
        """``(fn(), engine-clock seconds the step took)``."""
        c0 = clock.now()
        t0 = time.perf_counter()
        out = fn()
        self._sync()
        clock.charge(kind, time.perf_counter() - t0)
        return out, clock.now() - c0

    def run(self, requests: list[Request], batching: str | None = None,
            writer=None, clock=None, *, faults=None, shed=None,
            deadline_ms=None, kv_preempt=None, kv_reserve=None,
            prefix_cache=None, journal_path=None, drain_handler=None,
            step_timeout_s=None, on_watchdog=None) -> dict:
        """Play a request trace; returns the serve summary record.

        ``writer`` is any object with ``event(kind, **fields)``: it gets
        one ``request`` record per completed request (the greedy tokens
        under ``generated``), and ``shed``, ``quarantine``, ``preempt``
        and ``injected_fault`` records.  The keyword-only knobs override
        their config twins for this run, so one engine drives every arm.
        A ``faults`` plan is consumed as it fires: pass a fresh
        ``faults.parse_serve_plan`` result each run.  ``drain_handler``
        (anything with ``requested()``) replaces the engine's own
        SIGTERM/SIGINT handler; ``on_watchdog(age_s)`` replaces the
        watchdog's ``os._exit``.
        """
        cfg = self.cfg
        batching = batching or cfg.batching
        if batching not in ("continuous", "static"):
            raise ValueError(f"batching must be continuous|static: "
                             f"{batching!r}")
        if faults is None and cfg.serve_faults:
            faults = faults_mod.parse_serve_plan(cfg.serve_faults)
        shed = shed if shed is not None else cfg.shed
        kv_preempt = kv_preempt if kv_preempt is not None \
            else cfg.kv_preempt
        kv_reserve = kv_reserve if kv_reserve is not None \
            else cfg.kv_reserve
        prefix_cache = prefix_cache if prefix_cache is not None \
            else cfg.prefix_cache
        if kv_reserve not in ("worst", "lazy"):
            raise ValueError(
                f"kv_reserve must be worst|lazy: {kv_reserve!r}")
        if prefix_cache not in ("off", "on"):
            raise ValueError(
                f"prefix_cache must be off|on: {prefix_cache!r}")
        if prefix_cache == "on" and kv_reserve != "lazy":
            raise ValueError(
                "prefix_cache=on requires kv_reserve=lazy (sharing "
                "only saves pages when admission stops reserving the "
                "worst case)")
        headroom = cfg.kv_growth_headroom
        deadline_ms = (deadline_ms if deadline_ms is not None
                       else (cfg.deadline_ms or cfg.slo_e2e_ms))
        if shed not in ("off", "admit", "deadline"):
            raise ValueError(f"shed must be off|admit|deadline: {shed!r}")
        if shed != "off" and not deadline_ms:
            raise ValueError(
                "--shed needs a deadline to shed against: set "
                "--deadline_ms (or --slo_e2e_ms, its fallback)")
        deadline_s = (deadline_ms or 0.0) / 1e3
        decode = self.decode_mode
        if not decode and (faults or kv_preempt == "on"):
            raise ValueError(
                f"--model {cfg.model} serves single-forward classify "
                "requests; --serve_faults/--kv_preempt drive the paged "
                "decode path and have no meaning here")
        if not decode and (kv_reserve != "worst" or prefix_cache != "off"):
            raise ValueError(
                f"--model {cfg.model} serves single-forward classify "
                "requests with no KV pool; --kv_reserve/--prefix_cache "
                "have no meaning here")
        # the quarantine guard arms with either policy knob: it reads
        # the step's logits back to the host (with both off, an injected
        # NaN flows through: the faults A/B's control arm)
        guard = shed != "off" or kv_preempt == "on"
        writer = writer or _NullWriter()
        clock = clock or MonotonicClock()
        allocator = PageAllocator(self.num_pages) if decode else None
        ledger = KVLedger(self.page_size) if decode else None
        cache = None
        if prefix_cache == "on":
            from tpu_hc_bench_torch.serve import prefix_cache as prefix_mod

            cache = prefix_mod.PrefixCache(allocator, self.page_size)
        counts = {"grown": 0, "hits": 0, "lookups": 0, "shared": 0,
                  "tokens": 0}
        degrade: dict = {"shed": {}, "preempts": 0, "requeues": 0,
                         "quarantined": 0}
        # a preempted victim's carry: rid -> its generated prefix and
        # first-residency instants, so its record spans both residencies
        carry: dict[int, dict] = {}
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        n = len(pending)
        over = [r for r in pending
                if decode and (r.prompt_len > cfg.max_prompt_len
                               or r.output_len > cfg.max_output_len)]
        if over:
            raise ValueError(
                f"{len(over)} request(s) exceed the bucket ladder "
                f"(prompt<={cfg.max_prompt_len}, "
                f"output<={cfg.max_output_len}); request "
                f"{over[0].rid} is {over[0].prompt_len}/"
                f"{over[0].output_len}")
        kv = self._kv if decode else None
        queue: collections.deque[Request] = collections.deque()
        active: list[_InFlight] = []
        done: list[dict] = []
        state = {"finished": 0, "service_ewma_s": None, "idx": 0,
                 "squeezed": 0}
        steps = {"prefill": 0, "decode": 0, "classify": 0}
        drained: dict | None = None
        t0 = clock.now()

        def now() -> float:
            return clock.now() - t0

        def finish(fl: _InFlight, t_done: float, status: str = "ok",
                   cause: str | None = None) -> None:
            state["finished"] += 1
            rec = {
                "id": fl.req.rid,
                "status": status,
                "arrival_s": round(fl.req.arrival_s, 6),
                "ttft_ms": round(
                    1e3 * ((fl.t_first if fl.t_first is not None
                            else t_done) - fl.req.arrival_s), 3),
                "e2e_ms": round(1e3 * (t_done - fl.req.arrival_s), 3),
                "prompt_len": fl.req.prompt_len,
                "output_len": fl.produced,
            }
            if cause:
                rec["cause"] = cause
            if fl.preempts:
                rec["preempts"] = fl.preempts
            # a classify request has no prompt pass: its resident window
            # is the decode lane's (t_first := t_admit)
            rec.update(slo_mod.components_ms(
                fl.req.arrival_s, fl.t_admit,
                (fl.t_first if decode and fl.t_first is not None
                 else fl.t_admit),
                fl.t_last if fl.t_last is not None else t_done,
                t_done, fl.active_s))
            if decode:
                rec["generated"] = list(fl.out_tokens)
                final_pages = ledger.retire(len(fl.pages), fl.length)
                rec["pages_reserved"] = len(fl.pages)
                rec["pages_peak_used"] = final_pages
                rec["pages_final"] = final_pages
                rec["pages_grown"] = fl.pages_grown
                rec["prefix_pages_shared"] = fl.prefix_shared
            if status == "ok":
                if not fl.preempts:
                    # the predictive-shed estimate: first admission to
                    # done of never-preempted requests only (a requeued
                    # request's span holds its requeue wait)
                    svc = t_done - fl.t_admit
                    ewma = state["service_ewma_s"]
                    state["service_ewma_s"] = (
                        svc if ewma is None else 0.7 * ewma + 0.3 * svc)
                done.append(rec)
                writer.event("request", **rec)
            elif status == "shed":
                degrade["shed"][cause] = degrade["shed"].get(cause, 0) + 1
                writer.event("shed", **rec)
            else:
                degrade["quarantined"] += 1
                writer.event("quarantine", **rec)
            if decode:
                allocator.free(fl.pages)

        def shed_queued(req: Request, cause: str, t: float) -> None:
            """Admission-time shed: terminal, with its cause."""
            state["finished"] += 1
            degrade["shed"][cause] = degrade["shed"].get(cause, 0) + 1
            c = carry.pop(req.rid, None)
            rec = {"id": req.rid, "status": "shed", "cause": cause,
                   "arrival_s": round(req.arrival_s, 6),
                   "waited_ms": round(1e3 * (t - req.arrival_s), 3)}
            if c:
                rec["preempts"] = c["preempts"]
            writer.event("shed", **rec)

        def free_now() -> int:
            """Free pages less any injected squeeze: admission's one
            view of pool headroom."""
            f = allocator.free_pages
            if faults is not None:
                f -= faults.squeezed_pages(now())
            return max(0, f)

        def preempt_one() -> bool:
            """KV pressure: preempt the resident holding the most pages
            per token of progress and requeue it with its prefix.  A
            victim must have produced 2**preempts tokens this residency
            (every residency advances it; re-prefill stays bounded) and
            re-prefill prompt+prefix inside the ladder; with a deadline
            armed, it must have burned 3/4 of it."""
            top = max(self.prefill_buckets)
            t_now = now()
            cands = [fl for fl in active
                     if fl.produced_res >= (1 << fl.preempts)
                     and fl.length <= top
                     and (not deadline_s or shed == "off"
                          or t_now - fl.req.arrival_s > 0.75 * deadline_s)]
            if not cands:
                return False
            victim = max(cands, key=lambda fl: len(fl.pages)
                         / max(1, fl.produced))
            active.remove(victim)
            ledger.retire(len(victim.pages), victim.length)
            allocator.free(victim.pages)
            carry[victim.req.rid] = {
                "prefix": list(victim.out_tokens),
                "t_admit": victim.t_admit, "t_first": victim.t_first,
                "active_s": victim.active_s, "t_last": victim.t_last,
                "preempts": victim.preempts + 1,
            }
            queue.append(victim.req)
            degrade["preempts"] += 1
            writer.event("preempt", rid=victim.req.rid,
                         cause="pool_starved",
                         pages_freed=len(victim.pages),
                         produced=victim.produced)
            return True

        def drain(t: float) -> dict:
            """SIGTERM drain: stop admitting, journal every resident,
            queued and not-yet-arrived request (tmp, fsync, rename)."""
            entries = []
            for fl in list(active):
                entries.append(faults_mod.journal_entry(
                    fl.req, produced=fl.produced,
                    prefix=list(fl.out_tokens),
                    preempts=fl.preempts + 1))
                if decode:
                    ledger.retire(len(fl.pages), fl.length)
                    allocator.free(fl.pages)
            active.clear()
            for req in queue:
                c = carry.pop(req.rid, None)
                pfx = c["prefix"] if c else ()
                entries.append(faults_mod.journal_entry(
                    req, produced=len(pfx), prefix=list(pfx),
                    preempts=c["preempts"] if c else 0))
            queue.clear()
            for req in pending[state["idx"]:]:
                entries.append(faults_mod.journal_entry(req))
            path = (journal_path or cfg.serve_journal
                    or faults_mod.JOURNAL_NAME)
            faults_mod.write_journal(path, entries, model=cfg.model,
                                     seed=cfg.seed)
            writer.event("preempt", scope="drain", cause="sigterm",
                         t=round(t, 4), unfinished=len(entries),
                         journal=path)
            self.print_fn(
                f"serve drain: {len(entries)} unfinished request(s) "
                f"journaled to {path} — relaunch with "
                f"--serve_resume={path} to replay them")
            return {"journal": path, "unfinished": len(entries),
                    "reason": "sigterm"}

        def feed_of(req: Request, c: dict | None) -> np.ndarray:
            """The prefill feed: the prompt, plus a requeued victim's
            generated prefix less its newest token (the greedy pass
            regenerates that one: no token lost or repeated)."""
            if c and c["prefix"]:
                return np.concatenate(
                    [req.prompt, np.asarray(c["prefix"][:-1], np.int32)])
            return req.prompt

        def need_pages(req: Request) -> int:
            """Pages admission must take from the free list now: the
            whole table under worst; prompt + headroom less the cache's
            cover under lazy (``match`` is a pure peek)."""
            if kv_reserve == "worst":
                return self.table_width
            c = carry.get(req.rid)
            plen = req.prompt_len + (max(0, len(c["prefix"]) - 1)
                                     if c else 0)
            slots = min(self.table_width,
                        -(-plen // self.page_size) + headroom)
            if cache is not None:
                slots -= cache.match(feed_of(req, c)).slots
            return max(0, slots)

        def finite_rows(logits, rids: list[int], where: str) -> np.ndarray:
            """The guard's one host read: which rows are finite, with
            the plan's poisoned rows forced non-finite."""
            ok = torch.isfinite(logits[:len(rids)]).all(-1).cpu().numpy()
            hit = set(faults.poison_rids(rids)) if faults else set()
            for i, rid in enumerate(rids):
                if rid in hit:
                    ok[i] = False
                    self.print_fn(f"inject: nan_logits rid {rid} "
                                  f"({where})")
                    writer.event("injected_fault", fault="nan_logits",
                                 rid=rid, where=where)
            return ok

        def admit(req: Request) -> None:
            nonlocal kv
            t_admit = now()
            if not decode:
                active.append(_InFlight(req=req, pages=[],
                                        table=np.zeros(0, np.int32),
                                        t_admit=t_admit))
                return
            c = carry.pop(req.rid, None)
            prefix = c["prefix"] if c else []
            if c:
                degrade["requeues"] += 1
            feed = feed_of(req, c)
            plen = int(len(feed))
            shared: list[int] = []
            if cache is not None:
                counts["lookups"] += 1
                m = cache.match(feed)
                if m.slots:
                    counts["hits"] += 1
                    shared = cache.acquire(m)
                    counts["shared"] += len(shared)
            if kv_reserve == "lazy":
                slots = min(self.table_width,
                            -(-plen // self.page_size) + headroom)
            else:
                slots = self.table_width
            fresh = allocator.alloc(max(0, slots - len(shared)))
            if fresh is None:
                raise RuntimeError("admission checked free_pages")
            pages = shared + fresh
            table = np.pad(np.asarray(pages, np.int32),
                           (0, self.table_width - len(pages)))
            ledger.admit(len(pages), plen)
            s = pick_bucket(self.prefill_buckets, plen)
            toks = np.zeros((1, s), np.int32)
            toks[0, :plen] = feed
            # shared slots already hold this prefix's K/V: their stores
            # go to the trash page; the decode table keeps the real ids
            wtable = (np.where(np.arange(self.table_width) < len(shared),
                               0, table).astype(np.int32)
                      if shared else table)
            (next_tok, logits, kv), dt = self._timed(
                clock, "prefill",
                lambda: self.prefill_fn(kv, self._tensor(toks), plen,
                                        self._tensor(wtable)))
            tok = int(next_tok[0])
            steps["prefill"] += 1
            if not c:
                counts["tokens"] += 1   # a re-prefill regenerates one
            ledger.charge(dt)
            fl = _InFlight(
                req=req, pages=pages, table=table, length=plen,
                produced=(len(prefix) if c else 1), last_token=tok,
                t_admit=(c["t_admit"] if c else t_admit),
                t_first=(c["t_first"] if c else now()),
                out_tokens=(list(prefix[:-1]) + [tok] if c else [tok]),
                active_s=(c["active_s"] + dt if c else 0.0),
                t_last=(c["t_last"] if c else None),
                preempts=(c["preempts"] if c else 0),
                produced_res=(0 if c else 1),
                prefix_shared=len(shared))
            if guard and not finite_rows(logits, [req.rid], "prefill")[0]:
                fl.t_last = now()
                finish(fl, now(), status="quarantined",
                       cause="nonfinite_logits")
                return
            if cache is not None:
                cache.insert(feed, pages, plen)
            if fl.produced >= req.output_len:
                finish(fl, now(), status="ok")
            else:
                active.append(fl)

        def ensure_capacity(fl: _InFlight) -> bool:
            """Make this step's append slot an exclusively owned page:
            grow a page at a boundary, copy a shared page on the first
            append into it.  False pauses the row this step."""
            nonlocal kv
            slot = fl.length // self.page_size
            if slot >= len(fl.pages):
                if free_now() < 1 and cache is not None:
                    cache.evict(1)
                if free_now() < 1:
                    return False
                grown = allocator.alloc(1)
                allocator.bind(fl.table, slot, grown[0])
                fl.pages.append(grown[0])
                ledger.grow(1)
                fl.pages_grown += 1
                counts["grown"] += 1
                return True
            page = fl.pages[slot]
            if allocator.refcount(page) == 1:
                return True
            if free_now() < 1 and cache is not None:
                cache.evict(1)
            if free_now() < 1:
                return False
            dst = allocator.cow_alloc()
            kv, dt = self._timed(clock, "page_copy",
                                 lambda: self.page_copy_fn(kv, page, dst))
            ledger.charge(dt)
            allocator.bind(fl.table, slot, dst)
            fl.pages[slot] = dst
            allocator.free([page])
            return True

        def decode_step() -> bool:
            nonlocal kv
            if faults is not None:
                hang_s = faults.hang_before_decode(steps["decode"] + 1)
                if hang_s:
                    self.print_fn(f"inject: hang {hang_s}s before "
                                  f"decode step {steps['decode'] + 1}")
                    writer.event("injected_fault", fault="hang",
                                 step=steps["decode"] + 1, seconds=hang_s)
                    time.sleep(hang_s)  # real wall, whatever the clock
            sched = active
            if kv_reserve == "lazy" or cache is not None:
                sched = [fl for fl in active if ensure_capacity(fl)]
                if not sched and active and kv_preempt == "on" \
                        and preempt_one():
                    sched = [fl for fl in active if ensure_capacity(fl)]
                if not sched:
                    return False
            b = pick_bucket(self.batch_buckets, len(sched))
            toks = np.zeros((b,), np.int32)
            # padded rows: length 0, a table of trash page 0, inactive
            tables = np.zeros((b, self.table_width), np.int32)
            lengths = np.zeros((b,), np.int32)
            mask = np.zeros((b,), bool)
            for i, fl in enumerate(sched):
                toks[i] = fl.last_token
                tables[i] = fl.table
                lengths[i] = fl.length
                mask[i] = True
            (next_toks, logits, kv), dt = self._timed(
                clock, "decode",
                lambda: self.decode_fn(kv, self._tensor(toks),
                                       self._tensor(tables),
                                       self._tensor(lengths),
                                       self._tensor(mask)))
            steps["decode"] += 1
            counts["tokens"] += len(sched)
            ledger.charge(dt)
            next_toks = next_toks.cpu().numpy()
            ok = (finite_rows(logits, [fl.req.rid for fl in sched],
                              "decode") if guard else None)
            t_done = now()
            dropped: set[int] = set()
            for i, fl in enumerate(sched):
                fl.active_s += dt
                fl.t_last = t_done
                if ok is not None and not ok[i]:
                    finish(fl, t_done, status="quarantined",
                           cause="nonfinite_logits")
                    dropped.add(fl.req.rid)
                    continue
                fl.last_token = int(next_toks[i])
                fl.out_tokens.append(fl.last_token)
                ledger.token(fl.length)
                fl.length += 1
                fl.produced += 1
                fl.produced_res += 1
                if fl.produced >= fl.req.output_len:
                    finish(fl, t_done, status="ok")
                    dropped.add(fl.req.rid)
            if dropped:
                # paused rows keep their place: retire by rid
                active[:] = [fl for fl in active
                             if fl.req.rid not in dropped]
            return True

        def classify_step() -> None:
            """One forward of every resident request, padded to its batch
            bucket; each finishes with its answer."""
            b = pick_bucket(self.batch_buckets, len(active))
            x = np.zeros((b,) + tuple(self.spec.input_shape), np.float32)
            for i, fl in enumerate(active):
                x[i] = self._classify_input(fl.req)
            _, dt = self._timed(clock, "classify",
                                lambda: self.classify_fn(self._tensor(x)))
            steps["classify"] += 1
            counts["tokens"] += len(active)
            t_done = now()
            for fl in active:
                fl.t_first = t_done
                fl.produced = 1
                fl.active_s += dt
                fl.t_last = t_done
                finish(fl, t_done, status="ok")
            active.clear()

        own_handler = None
        handler = drain_handler
        if handler is None:
            own_handler = preempt_mod.PreemptionHandler(
                print_fn=self.print_fn).install()
            handler = own_handler
        timeout_s = watchdog_mod.resolve_timeout(
            step_timeout_s if step_timeout_s is not None
            else cfg.serve_step_timeout_s,
            warmup_step_s=self.warm_s / self.warm_programs)
        last_iter_t: list = [None]
        dog = None
        if timeout_s:
            dog = watchdog_mod.Watchdog(
                timeout_s, lambda: last_iter_t[0],
                on_timeout=on_watchdog).start()
        try:
            while state["finished"] < n:
                t = now()
                while state["idx"] < n and \
                        pending[state["idx"]].arrival_s <= t:
                    queue.append(pending[state["idx"]])
                    state["idx"] += 1
                if faults is not None:
                    sq = faults.squeezed_pages(t)
                    if sq != state["squeezed"]:
                        self.print_fn(
                            f"inject: pool_squeeze -> {sq} page(s) "
                            f"withheld at t={t:.3f}s")
                        writer.event("injected_fault",
                                     fault="pool_squeeze", pages=sq,
                                     t=round(t, 4))
                        state["squeezed"] = sq
                    if faults.sigterm_due(t):
                        self.print_fn(f"inject: sigterm at t={t:.3f}s")
                        writer.event("injected_fault", fault="sigterm",
                                     t=round(t, 4))
                        faults.deliver_sigterm()
                if handler is not None and handler.requested():
                    drained = drain(t)
                    break
                progressed = False
                if shed != "off":
                    # a request past its deadline decodes only dead
                    # tokens: shed it (queued) or retire it (resident)
                    for req in [r for r in queue
                                if t - r.arrival_s > deadline_s]:
                        queue.remove(req)
                        shed_queued(req, "deadline_expired", t)
                        progressed = True
                    for fl in [f for f in active
                               if t - f.req.arrival_s > deadline_s]:
                        active.remove(fl)
                        finish(fl, t, status="shed",
                               cause="resident_expired")
                        progressed = True
                if batching == "continuous":
                    while queue and len(active) < self.cap:
                        head = queue[0]
                        ewma = state["service_ewma_s"]
                        if (shed == "deadline" and ewma is not None
                                and (now() - head.arrival_s) + ewma
                                > deadline_s):
                            # queue wait plus the admit-to-done EWMA
                            # already blows the deadline
                            shed_queued(queue.popleft(),
                                        "deadline_predicted", now())
                            progressed = True
                            continue
                        if not decode or free_now() >= need_pages(head):
                            admit(queue.popleft())
                            progressed = True
                            continue
                        # starved: reclaim cold cache pages first, then
                        # preempt
                        if cache is not None and cache.evict(
                                need_pages(head) - free_now()):
                            continue
                        if kv_preempt == "on" and preempt_one():
                            progressed = True
                            continue
                        break
                elif not active:
                    # static: wait for a full batch (or the trace tail),
                    # bounded by what the KV pool can hold
                    want = min(self.cap, n - state["finished"])
                    if decode:
                        want = min(want, free_now() // self.table_width)
                    if len(queue) >= want or state["idx"] == n:
                        for _ in range(min(want, len(queue))):
                            admit(queue.popleft())
                            progressed = True
                if active and not decode:
                    classify_step()
                    progressed = True
                elif active and decode_step():
                    progressed = True
                if not progressed:
                    if state["idx"] >= n:
                        if shed == "off" or not queue:
                            raise RuntimeError(
                                "serve engine stalled: no request can "
                                "make progress — KV pool undersized? "
                                "(under --kv_reserve=lazy, "
                                "--kv_preempt=on frees pages by "
                                "preempting the worst resident)")
                        # shedding armed: idle to the next deadline; the
                        # expiry pass drains the pinned queue
                        nxt = min(r.arrival_s for r in queue) + deadline_s
                        clock.sleep(max(1e-4, nxt - now() + 1e-4))
                    else:
                        gap = pending[state["idx"]].arrival_s - now()
                        if timeout_s:
                            # an idle arrival gap is not a wedged step
                            gap = min(gap, timeout_s / 2)
                        clock.sleep(gap)
                last_iter_t[0] = time.perf_counter()
        finally:
            if dog is not None:
                dog.stop()
            if own_handler is not None:
                own_handler.uninstall()

        wall = max(now(), 1e-9)
        kv_fold = None
        if decode:
            self._kv = kv
            kv_fold = kv_mod.fold_ledger(
                reserved_page_s=ledger.reserved_page_s,
                written_page_s=ledger.written_page_s,
                pages_peak=allocator.pages_peak,
                pages_recycled=allocator.recycled,
                pages_grown=counts["grown"],
                cow_copies=allocator.cow_copies,
                prefix_hits=counts["hits"],
                prefix_lookups=counts["lookups"],
                prefix_pages_shared=counts["shared"],
                request_records=done)
        shed_total = sum(degrade["shed"].values())
        summary = {
            "workload": "serve",
            "model": cfg.model,
            "device": str(self.device),
            "batching": batching,
            "arrival": cfg.arrival,
            "arrival_rate": cfg.arrival_rate,
            "requests": n,
            "completed": len(done),
            "wall_s": round(wall, 4),
            "tokens": counts["tokens"],
            "tokens_per_s": round(counts["tokens"] / wall, 3),
            "buckets": list(self.batch_buckets),
            "max_in_flight": self.cap,
            "kv_page_size": self.page_size,
            "kv_pages": self.num_pages,
            "kv_layers": self.family.num_layers if decode else None,
            "kv_pool_bytes": self.kv_pool_bytes,
            "kv_scale_bytes": self.kv_scale_bytes,
            "weight_bytes": self.weight_bytes,
            "kv_pool": kv_fold,
            **kv_mod.flatten_kv(kv_fold),
            "kv_reserve": kv_reserve if decode else None,
            "prefix_cache": prefix_cache if decode else None,
            "decode_attention": self.decode_attention if decode else None,
            "quant": self.quant,
            "decode_block_pages": (self.block_pages
                                   if decode
                                   and self.decode_attention == "paged"
                                   else None),
            **{f"{k}_steps": v for k, v in steps.items()},
            **slo_mod.fold_requests(done),
            "shed_frac": round(shed_total / max(1, n), 4),
        }
        summary["degrade"] = {
            "shed": dict(sorted(degrade["shed"].items())),
            "shed_frac": summary["shed_frac"],
            "preempts": degrade["preempts"],
            "requeues": degrade["requeues"],
            "quarantined": degrade["quarantined"],
        }
        if drained is not None:
            summary["drained"] = drained
        if cfg.slo_e2e_ms:
            summary["slo"] = slo_mod.fold_burn_rate(done, cfg.slo_e2e_ms)
        return summary
