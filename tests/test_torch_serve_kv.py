"""The port's lazy KV reservation, prefix cache and refcounted allocator.

- **units**: each case of the JAX lane's ``tests/test_prefix_cache.py``
  allocator and trie tests, driven through the same operation sequence
  on JAX's classes (numpy-only) and on the port's: the match slots, the
  refcounts, the evictions, and the ``cow_copies`` and ``recycled``
  counts equal (JAX refuses a dead page with ``AssertionError``, the
  port with ``RuntimeError``; both refuse).
- **engine** (the ``llama_tiny`` engine, virtual time): the shared-
  prompt trace of the JAX tests decodes token for token the same under
  ``lazy`` + ``prefix_cache=on`` as under ``lazy`` alone and under
  ``worst``, with prefix hits and a copy-on-write on a 6-token prompt;
  lazy reservation lifts the pool's utilization and lowers its peak;
  growth with no headroom grows one page a request.
"""

from __future__ import annotations

import numpy as np
import pytest

from tpu_hc_bench.serve import engine as jax_engine
from tpu_hc_bench.serve import prefix_cache as jax_pc
from tpu_hc_bench_torch import flags
from tpu_hc_bench_torch.serve import arrivals
from tpu_hc_bench_torch.serve import engine as engine_mod
from tpu_hc_bench_torch.serve import prefix_cache as pc
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

VCOSTS = {"prefill": 0.004, "decode": 0.003, "page_copy": 0.001}
SIDES = {"jax": (jax_engine, jax_pc), "port": (engine_mod, pc)}


def _raises(fn) -> bool:
    try:
        fn()
    except (AssertionError, RuntimeError):
        return True
    return False


# --- the same operation sequences on both packages' classes ------------


def case_share_free_refcount(em, _):
    a = em.PageAllocator(6)
    pages = a.alloc(2)
    out = [list(pages), [a.refcount(p) for p in pages]]
    a.share(pages)
    out.append([a.refcount(p) for p in pages])
    before = a.free_pages
    a.free(pages)
    out += [[a.refcount(p) for p in pages], a.free_pages - before]
    a.free(pages)
    out += [[a.refcount(p) for p in pages], a.free_pages - before,
            _raises(lambda: a.free(pages[:1]))]
    return out


def case_cow_apart_from_recycled(em, _):
    a = em.PageAllocator(4)
    first = a.alloc(3)
    a.free(first)
    out = [a.recycled]
    again = a.alloc(2)
    out.append(a.recycled)
    dst = a.cow_alloc()
    out += [dst, a.refcount(dst), a.cow_copies, a.recycled, a.pages_peak]
    a.free(again + [dst])
    return out + [a.free_pages, a.alloc(4), a.cow_alloc()]


def case_bind_refuses_dead_page(em, _):
    a = em.PageAllocator(4)
    table = np.zeros(3, np.int32)
    (p,) = a.alloc(1)
    a.bind(table, 1, p)
    out = [table.tolist()]
    a.free([p])
    return out + [_raises(lambda: a.bind(table, 2, p)),
                  _raises(lambda: a.share([p])), table.tolist()]


def _cache(em, cm, num_pages=16, ps=4):
    a = em.PageAllocator(num_pages)
    return a, cm.PrefixCache(a, page_size=ps)


def _m(m):
    return (list(m.pages), m.tokens_covered, m.partial_key)


def case_match_walks_full_chunks(em, cm):
    a, c = _cache(em, cm)
    toks = list(range(100, 108))
    pages = a.alloc(3)
    out = [c.insert(toks, pages, len(toks)),
           [a.refcount(p) for p in pages], _m(c.match(toks)),
           _m(c.match(toks[:4] + [999, 998, 997, 996]))]
    got = c.acquire(c.match(toks))
    return out + [got, [a.refcount(p) for p in pages], c.cached_pages]


def case_partial_tail_exact_key_only(em, cm):
    a, c = _cache(em, cm)
    toks = list(range(200, 206))
    pages = a.alloc(2)
    return [c.insert(toks, pages, len(toks)), _m(c.match(toks)),
            _m(c.match(toks[:4] + [777, 778])),
            [a.refcount(p) for p in pages]]


def case_never_retains_trash_page(em, cm):
    a, c = _cache(em, cm)
    (p1,) = a.alloc(1)
    return [c.insert(list(range(12)), [p1, 0, 0], 12), a.refcount(p1),
            a.refcount(0), _m(c.match(list(range(12))))]


def case_evicts_cold_leaves_never_held_pages(em, cm):
    a, c = _cache(em, cm, num_pages=8)
    hot, cold = list(range(300, 308)), list(range(400, 408))
    hot_pages, cold_pages = a.alloc(2), a.alloc(2)
    c.insert(cold, cold_pages, 8)
    c.insert(hot, hot_pages, 8)
    resident = c.acquire(c.match(hot))
    a.free(cold_pages)
    a.free(hot_pages)
    out = [c.evict(4), _m(c.match(cold)), _m(c.match(hot)),
           a.refcount(cold_pages[0]), c.evicted_pages, a.free_pages]
    a.free(resident)
    return out + [c.evict(4), _m(c.match(hot)), c.evicted_pages,
                  c.cached_pages, a.free_pages]


CASES = [case_share_free_refcount, case_cow_apart_from_recycled,
         case_bind_refuses_dead_page, case_match_walks_full_chunks,
         case_partial_tail_exact_key_only, case_never_retains_trash_page,
         case_evicts_cold_leaves_never_held_pages]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_allocator_and_cache_cases_equal_jax(case):
    want = case(*SIDES["jax"])
    got = case(*SIDES["port"])
    assert got == want


def test_cache_counts_after_cases():
    """Spot values of the JAX tests, on the port's classes alone."""
    a, c = _cache(engine_mod, pc)
    toks = list(range(100, 108))
    pages = a.alloc(3)
    assert c.insert(toks, pages, 8) == 2
    assert [a.refcount(p) for p in pages] == [2, 2, 1]
    m = c.match(toks + [1, 2])
    assert m.slots == 2 and m.tokens_covered == 8


# --- the engine ----------------------------------------------------------


@pytest.fixture(scope="module")
def engine():
    cfg = flags.ServeConfig(
        model="llama_tiny", device="cpu", arrival_rate=50.0,
        num_requests=8, max_prompt_len=8, max_output_len=4,
        max_in_flight=2, kv_page_size=4, seed=0).resolve()
    return engine_mod.ServeEngine(cfg, print_fn=lambda _m: None)


class _Tap:
    def __init__(self):
        self.records = []

    def event(self, kind, **fields):
        self.records.append({"kind": kind, **fields})

    def generated(self):
        return {r["id"]: r["generated"] for r in self.records
                if r["kind"] == "request"}


def _run(engine, reqs, **policy):
    tap = _Tap()
    summary = engine.run(reqs, batching="continuous", writer=tap,
                         clock=engine_mod.VirtualClock(VCOSTS), **policy)
    return summary, tap


def _shared_prompt_trace(vocab, n, plen, seed=25):
    block = np.random.default_rng((seed, plen)).integers(
        0, vocab, size=plen, dtype=np.int32)
    return [arrivals.Request(rid=i, arrival_s=0.001 * i,
                             prompt=block.copy(), output_len=4)
            for i in range(n)]


def test_shared_prefix_run_matches_unshared_tokens(engine):
    reqs = _shared_prompt_trace(engine.spec.vocab_size, 6, plen=8)
    worst, tw = _run(engine, reqs, kv_reserve="worst")
    off, t_off = _run(engine, reqs, kv_reserve="lazy", prefix_cache="off")
    on, t_on = _run(engine, reqs, kv_reserve="lazy", prefix_cache="on")
    assert t_on.generated() == t_off.generated() == tw.generated()
    assert all(len(v) == 4 for v in t_on.generated().values())
    kvf = on["kv_pool"]
    assert kvf["prefix_lookups"] == 6
    assert kvf["prefix_hits"] >= 1
    assert kvf["prefix_pages_shared"] >= 2
    assert on["prefix_hit_frac"] == pytest.approx(
        kvf["prefix_hits"] / 6, abs=1e-4)
    assert on["kv_reserve"] == "lazy" and on["prefix_cache"] == "on"
    assert off["kv_pool"]["prefix_hit_frac"] is None
    assert worst["kv_pool"]["prefix_lookups"] == 0
    assert on["kv_pool"]["pages_peak"] < worst["kv_pool"]["pages_peak"]


def test_shared_tail_triggers_cow_copy(engine):
    reqs = _shared_prompt_trace(engine.spec.vocab_size, 6, plen=6)
    _, t_off = _run(engine, reqs, kv_reserve="lazy", prefix_cache="off")
    on, t_on = _run(engine, reqs, kv_reserve="lazy", prefix_cache="on")
    assert t_on.generated() == t_off.generated()
    assert on["kv_pool"]["cow_copies"] >= 1
    assert on["kv_pool"]["prefix_hits"] >= 1


def test_lazy_reservation_raises_pool_util(engine):
    cfg = flags.ServeConfig(
        model="llama_tiny", device="cpu", arrival_rate=10000.0,
        num_requests=8, max_prompt_len=8, max_output_len=4,
        max_in_flight=2, kv_page_size=4, seed=0).resolve()
    reqs = arrivals.build_requests(cfg, engine.spec.vocab_size)
    worst, tw = _run(engine, reqs, kv_reserve="worst")
    lazy, tl = _run(engine, reqs, kv_reserve="lazy")
    assert tl.generated() == tw.generated()
    assert lazy["kv_pool_util"] > worst["kv_pool_util"]
    assert lazy["kv_req_gap_frac"] < worst["kv_req_gap_frac"]
    assert lazy["kv_pool"]["pages_peak"] < worst["kv_pool"]["pages_peak"]


def test_on_demand_growth_grows_and_accounts(engine):
    reqs = _shared_prompt_trace(engine.spec.vocab_size, 4, plen=4)
    _, tw = _run(engine, reqs, kv_reserve="worst")
    saved = engine.cfg.kv_growth_headroom
    engine.cfg.kv_growth_headroom = 0
    try:
        lazy, tl = _run(engine, reqs, kv_reserve="lazy")
    finally:
        engine.cfg.kv_growth_headroom = saved
    assert tl.generated() == tw.generated()
    # a 4-token prompt + 4 outputs writes 7 tokens = 2 pages: 1 reserved,
    # 1 grown
    assert lazy["kv_pool"]["pages_grown"] == 4
    assert [r["pages_grown"] for r in tl.records
            if r["kind"] == "request"] == [1, 1, 1, 1]
    assert lazy["pages_grown_total"] == 4


def test_policy_knobs_validated():
    with pytest.raises(ValueError, match="kv_reserve"):
        flags.ServeConfig(kv_reserve="sometimes").resolve()
    with pytest.raises(ValueError, match="prefix_cache"):
        flags.ServeConfig(prefix_cache="maybe").resolve()
    with pytest.raises(ValueError, match="lazy"):
        flags.ServeConfig(prefix_cache="on").resolve()
    with pytest.raises(ValueError, match="headroom"):
        flags.ServeConfig(kv_growth_headroom=-1).resolve()
