"""The port engine's prefix cache, chunked prefill, deadlines and bounded
admission against the JAX engine, on the CPU.

The scenarios are the JAX package's own (tests/test_prefix_cache.py and
tests/test_paged_engine.py), driven through both engines at one set of
f32 weights (the JAX model's state carried into the port by
`from_paddle_tpu_state`). Greedy tokens must be identical, and so must
the page ledger: both engines hand out pages from the same free list in
the same order, so the slots' pages, the refcounts, the cached pages and
`prefix_stats()` are compared as they stand. The JAX engine's decode
attend runs its plain path (`kernel="jnp"`); the port's decode goes
through its kernel wrapper, which on the CPU is the plain twin.
"""
import time

import numpy as np
import pytest

import paddle_tpu
from paddle_tpu.inference.overload import \
    EngineOverloaded as JEngineOverloaded
from paddle_tpu.inference.paged import PagedKVEngine as JEngine
from paddle_tpu.inference.prefix import PrefixCache as JPrefixCache
from paddle_tpu.inference.prefix import chain_keys as j_chain_keys
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference.overload import (Deadline,
                                                 DeadlineExceeded,
                                                 EngineOverloaded)
from paddle_tpu_torch.inference.paged import PagedKVEngine as TEngine
from paddle_tpu_torch.inference.prefix import PrefixCache, chain_keys
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import from_paddle_tpu_state

TINY = dict(num_hidden_layers=2, vocab_size=97, hidden_size=64,
            num_attention_heads=4, num_key_value_heads=2,
            fused_norm=True, fused_rope=True)
# 31 allocatable pages of 4 tokens, two slots of up to 8 pages
GEOM = dict(max_slots=2, page_size=4, num_pages=32, max_pages_per_slot=8,
            steps_per_tick=2)
PREFIX = [5, 9, 2, 14, 17, 3, 11, 4]           # two full pages of 4


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model with its weights), f32."""
    paddle_tpu.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.tiny_llama_config(**TINY))
    cfg = tllama.tiny_llama_config(**TINY)
    tm = tllama.LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(from_paddle_tpu_state(
        {k: np.asarray(v._value) for k, v in jm.state_dict().items()}, cfg))
    return jm, tm


def _pair(models, **kw):
    """(JAX engine, port engine) of one geometry."""
    jm, tm = models
    geom = dict(GEOM, **kw)
    return JEngine(jm, kernel="jnp", **geom), TEngine(tm, device="cpu",
                                                      **geom)


def _solo(models, prompt, n, **kw):
    """The port's cold run: a fresh engine, no cache, no chunks."""
    geom = dict(GEOM, **kw)
    return TEngine(models[1], device="cpu", **geom).generate(
        [prompt], max_new_tokens=n)[0]


def _ledger(eng):
    """The page ledger as both engines keep it."""
    cache = eng.prefix_cache
    return dict(free=list(eng._free), reserved=eng._reserved_unalloc,
                refs=dict(eng._page_refs),
                cached=None if cache is None else cache.pages(),
                cached_set=set(eng._cached_pages),
                reclaimable=eng._reclaimable,
                slots=[None if s is None else (list(s.pages), s.shared,
                                               s.lens)
                       for s in eng._slots])


def _prefix_counts(eng):
    keys = ("prefix_hits", "prefix_misses", "prefix_hit_tokens",
            "prefix_pages_shared", "prefix_evictions", "admitted",
            "finished", "cancelled", "expired", "overloaded", "prefills")
    return {k: eng.stats[k] for k in keys}


def _settled(eng):
    """After every retirement only the cache holds refs: each cached
    page has exactly its ref, and free + cached is the whole pool."""
    cached = set(eng.prefix_cache.pages())
    assert set(eng._page_refs) == cached
    assert all(eng._page_refs[p] == 1 for p in cached)
    assert len(eng._free) + len(cached) == eng.num_pages - 1
    assert eng._reclaimable == len(cached) == len(eng._cached_pages)
    assert eng._reserved_unalloc == 0


# -- the hash chain and the LRU map --------------------------------------------

@pytest.mark.parametrize("page_size,max_pages", [(1, None), (4, None),
                                                 (4, 2), (16, None),
                                                 (16, 0)])
def test_chain_keys_equal_the_jax_modules(page_size, max_pages):
    rng = np.random.default_rng(page_size)
    for n in (0, 3, 16, 37, 130):
        toks = rng.integers(0, 128256, size=n).astype(np.int32)
        got = chain_keys(toks, page_size, max_pages)
        assert got == j_chain_keys(toks, page_size, max_pages)
        assert len(got) == min(n // page_size, n if max_pages is None
                               else max_pages)


def test_chain_keys_contract():
    ps = 4
    toks = list(range(1, 14))                    # 13 tokens: 3 full pages
    keys = chain_keys(toks, ps)
    assert len(keys) == 3                        # partial page never keyed
    assert chain_keys(toks + [99, 98], ps)[:3] == keys
    other = list(toks)
    other[5] += 1                                # diverge in page 1
    ok = chain_keys(other, ps)
    assert ok[0] == keys[0]
    assert ok[1] != keys[1] and ok[2] != keys[2]
    with pytest.raises(ValueError):
        chain_keys(toks, 0)
    # tokens hash by value, not by concatenated digits
    assert chain_keys([1, 23], 2) != chain_keys([12, 3], 2)


def test_prefix_cache_lru_unit():
    c = PrefixCache(2)
    assert c.insert("a", 1) and c.insert("b", 2)
    assert not c.insert("a", 9)                  # existing entry wins
    assert c.get("a") == 1 and "b" in c and len(c) == 2
    assert c.match(["a", "b"]) == [1, 2]
    assert c.match(["a", "x", "b"]) == [1]       # leading run only
    assert c.leading_run(["b", "a", "x"]) == 2
    c.insert("c", 3)
    assert c.over_budget() == 1
    assert c.pop_lru() == ("b", 2)               # "a" was touched later
    assert c.pop_lru_where(lambda p: p == 99) is None
    assert c.pop_lru_where(lambda p: p == 1) == ("a", 1)
    assert c.pop("c") == 3 and c.pop("c") is None and c.pop_lru() is None
    with pytest.raises(ValueError):
        PrefixCache(0)


def test_prefix_cache_follows_the_jax_map_op_for_op():
    rng = np.random.default_rng(5)
    mine, ref = PrefixCache(6), JPrefixCache(6)
    keys = [f"k{i}" for i in range(10)]
    for _ in range(400):
        op = rng.integers(0, 5)
        ks = list(rng.choice(keys, size=int(rng.integers(1, 4))))
        page = int(rng.integers(1, 50))
        if op == 0:
            got = (mine.insert(ks[0], page), ref.insert(ks[0], page))
        elif op == 1:
            got = (mine.match(ks), ref.match(ks))
        elif op == 2:
            got = (mine.pop_lru(), ref.pop_lru())
        elif op == 3:
            got = (mine.pop_lru_where(lambda p: p % 3 == 0),
                   ref.pop_lru_where(lambda p: p % 3 == 0))
        else:
            got = (mine.over_budget(), ref.over_budget())
        assert got[0] == got[1]
        assert mine.pages() == ref.pages()


# -- warm hits ----------------------------------------------------------------

def _warm_scenario(eng):
    """pa cold, then pb warm (inspected right after its admission), then
    pa again, warm over its full prompt."""
    pa, pb = PREFIX + [21, 22, 23], PREFIX + [31, 32]
    ra = eng.submit(pa, max_new_tokens=8)
    eng.run_until_idle()
    cold = dict(ledger=_ledger(eng), stats=_prefix_counts(eng))
    rb = eng.submit(pb, max_new_tokens=6)
    eng.step()
    warm = _ledger(eng)
    eng.run_until_idle()
    ra2 = eng.submit(pa, max_new_tokens=8)
    eng.run_until_idle()
    return dict(tokens=[r.result() for r in (ra, rb, ra2)], cold=cold,
                warm=warm, end=_ledger(eng), stats=_prefix_counts(eng),
                prefix_stats=eng.prefix_stats())


@pytest.mark.parametrize("kv", [None, "int8"])
def test_warm_hit_tokens_refs_and_stats_equal_the_jax_engines(models, kv):
    je, te = _pair(models, prefix_cache_pages=8, kv_dtype=kv)
    want, got = _warm_scenario(je), _warm_scenario(te)
    assert got == want
    assert got["tokens"][0] == got["tokens"][2]
    solo = [_solo(models, p, n, kv_dtype=kv) for p, n in
            ((PREFIX + [21, 22, 23], 8), (PREFIX + [31, 32], 6))]
    assert got["tokens"][:2] == solo
    # pa cached both prefix pages; pb's slot points at them (refs 2)
    cached = got["cold"]["ledger"]["cached"][:2]
    slot = next(s for s in got["warm"]["slots"] if s is not None)
    assert slot[0][:2] == cached and slot[1] == 2
    assert [got["warm"]["refs"][p] for p in cached] == [2, 2]
    assert got["stats"]["prefix_hits"] == 2
    assert got["stats"]["prefix_hit_tokens"] == 16
    _settled(te)


def test_int8_shared_pages_keep_frozen_scales(models):
    """A shared page's scale rows do not move while a warm request
    prefills its tail and decodes, and an engine whose pages were shared
    decodes like a fresh one and like the JAX engine."""
    je, used = _pair(models, prefix_cache_pages=8, kv_dtype="int8")
    prompts = [PREFIX + [21, 22], PREFIX + [31]]
    first = used.generate([prompts[0]], max_new_tokens=5)[0]
    shared = used.prefix_cache.match(chain_keys(PREFIX, 4))
    assert len(shared) == 2
    before = used._scales[:, :, shared].clone()
    assert float(before.abs().min()) > 0.0
    second = used.generate([prompts[1]], max_new_tokens=5)[0]
    assert used.stats["prefix_hits"] == 1
    assert bool((used._scales[:, :, shared] == before).all())
    fresh = TEngine(models[1], device="cpu", kv_dtype="int8",
                    prefix_cache_pages=8, **GEOM)
    assert [first, second] == [
        fresh.generate([p], max_new_tokens=5)[0] for p in prompts]
    assert [first, second] == [
        je.generate([p], max_new_tokens=5)[0] for p in prompts]
    # every freed page went back with zeroed scales; cached ones keep
    # theirs
    free = list(used._free)
    assert float(used._scales[:, :, free].abs().sum()) == 0.0
    _settled(used)


# -- refcounts and eviction ----------------------------------------------------

def _pressure_scenario(eng):
    """A tiny budget: a slot holds two shared pages while another
    prefix evicts both entries; the shared pages must never reach the
    free list while their slot lives."""
    eng.generate([PREFIX + [21]], max_new_tokens=2)
    shared = eng.prefix_cache.match(chain_keys(PREFIX, 4))
    rw = eng.submit(PREFIX + [55], max_new_tokens=10)
    eng.step()
    refs = [eng._page_refs[p] for p in shared]
    eng.submit([50 + i for i in range(8)] + [70], max_new_tokens=2)
    while not rw.done.is_set() or eng.has_work():
        assert not (set(shared) & set(eng._free)) or rw.done.is_set()
        eng.step()
    return dict(tokens=rw.result(), shared=shared, refs=refs,
                end=_ledger(eng), stats=_prefix_counts(eng))


def test_eviction_under_pressure_never_frees_live_refs(models):
    je, te = _pair(models, steps_per_tick=1, prefix_cache_pages=2)
    want, got = _pressure_scenario(je), _pressure_scenario(te)
    assert got == want
    assert got["refs"] == [2, 2] and len(got["shared"]) == 2
    assert got["stats"]["prefix_evictions"] >= 2
    assert got["tokens"] == _solo(models, PREFIX + [55], 10,
                                  steps_per_tick=1)
    _settled(te)


def test_admission_not_starved_by_cold_cache(models):
    """Cached pages only the cache holds count as headroom and are
    evicted on demand: a request that fits only if the cache lets go
    still admits, on both engines alike."""
    geom = dict(max_slots=1, num_pages=8, max_pages_per_slot=7,
                prefix_cache_pages=6)
    outs = []
    for eng in _pair(models, **geom):
        eng.generate([list(range(1, 9)) + [40]], max_new_tokens=3)
        assert len(eng.prefix_cache) == 2
        # 7 allocatable, 2 cached: 6 pages fit only by evicting
        pb = [60 + i for i in range(12)]
        outs.append((eng.generate([pb], max_new_tokens=12)[0],
                     _prefix_counts(eng), _ledger(eng)))
    assert outs[1] == outs[0]
    assert outs[1][1]["prefix_evictions"] >= 1
    assert outs[1][0] == _solo(models, [60 + i for i in range(12)], 12,
                               max_slots=1, num_pages=8,
                               max_pages_per_slot=7)


def test_requeued_warm_request_drops_its_refs(models):
    """A warm request that finds a slot but not enough headroom takes
    refs on its shared pages for the check and drops them on requeue:
    the cached pages stay reclaimable, and it admits warm later."""
    geom = dict(num_pages=12, max_pages_per_slot=8, prefix_cache_pages=4)
    outs = []
    for eng in _pair(models, **geom):
        eng.generate([PREFIX + [21]], max_new_tokens=2)
        big = eng.submit([70 + i for i in range(9)], max_new_tokens=20)
        eng.step()                 # headroom 6 free + 2 cached - 5
        warm = eng.submit(PREFIX + [31, 32, 33, 34, 35], max_new_tokens=12)
        eng.step()                 # needs 7 - 2 shared > headroom 1
        shared = [eng.prefix_cache.get(k) for k in chain_keys(PREFIX, 4)]
        mid = (_ledger(eng), _prefix_counts(eng), len(eng._pending),
               [eng._page_refs[p] for p in shared])
        eng.run_until_idle()
        outs.append((mid, big.result(), warm.result(), _ledger(eng),
                     _prefix_counts(eng)))
    assert outs[1] == outs[0]
    (ledger, counts, queued, refs), *_ = outs[1]
    assert queued == 1 and counts["prefix_hits"] == 0
    # the prefix's pages: the cache's ref alone, so still reclaimable
    assert refs == [1, 1] and ledger["reclaimable"] == 2
    assert outs[1][4]["prefix_hits"] == 1


def test_prefix_disabled_default_and_validation(models):
    eng = TEngine(models[1], device="cpu", **GEOM)
    assert eng.prefix_cache is None and eng.prefix_stats() is None
    r = eng.submit([1, 2, 3, 4, 5], max_new_tokens=2)
    assert r.prefix_keys == []                   # no hashing when off
    eng.run_until_idle()
    assert sorted(eng._free) == list(range(1, eng.num_pages))
    assert eng._page_refs == {} and eng._reclaimable == 0
    with pytest.raises(ValueError, match="prefix_cache_pages"):
        TEngine(models[1], device="cpu", prefix_cache_pages=-1, **GEOM)
    with pytest.raises(ValueError, match="prefill_chunk"):
        TEngine(models[1], device="cpu", prefill_chunk=-8, **GEOM)
    assert TEngine(models[1], device="cpu", prefill_chunk=0,
                   **GEOM).prefill_chunk is None
    on = TEngine(models[1], device="cpu", prefix_cache_pages=3, **GEOM)
    assert on.prefix_stats() == {
        "enabled": True, "hits": 0, "misses": 0, "hit_rate": 0.0,
        "hit_tokens": 0, "pages_shared": 0, "evictions": 0,
        "cached_pages": 0, "page_budget": 3}
    assert on.submit([1, 2, 3, 4, 5], 2).prefix_keys == chain_keys(
        [1, 2, 3, 4, 5], 4)


# -- chunked prefill -----------------------------------------------------------

def test_chunked_prefill_long_prompt_parity(models):
    """A prompt longer than the chunk prefills in rounds that append at
    lens > 0; its tokens equal the JAX engine's and the whole-prompt
    run's, and a short co-traveller still prefills whole."""
    geom = dict(num_pages=40, max_pages_per_slot=10, steps_per_tick=3,
                prefill_chunk=8)
    prompt = list(np.random.RandomState(3).randint(1, 90, 19))
    outs = []
    for eng in _pair(models, **geom):
        r = eng.submit(prompt, max_new_tokens=6)
        r2 = eng.submit([5, 9, 2], max_new_tokens=4)
        eng.run_until_idle()
        outs.append([r.result(), r2.result()])
    assert outs[1] == outs[0]
    te = eng
    # rounds of 8, 8 and 3 tokens, then the short prompt's own call
    assert te.stats["prefill_calls"] == 4 and te.stats["prefills"] == 2
    assert te.stats["prefill_tokens"] == 19 + 3
    whole = dict(geom, prefill_chunk=None)
    assert outs[1] == [_solo(models, prompt, 6, **whole),
                       _solo(models, [5, 9, 2], 4, **whole)]


def test_chunked_prefill_storm_lockstep(models):
    """Long prompts of different lengths prefill in lockstep rounds:
    ceil(longest / chunk) calls in all, tokens equal to the JAX
    engine's."""
    geom = dict(max_slots=4, num_pages=60, max_pages_per_slot=8,
                steps_per_tick=3, prefill_chunk=8)
    rng = np.random.RandomState(11)
    prompts = [list(rng.randint(1, 90, n)) for n in (13, 21, 9)]
    je, te = _pair(models, **geom)
    outs = [eng.generate(prompts, max_new_tokens=4) for eng in (je, te)]
    assert outs[1] == outs[0]
    assert te.stats["prefill_calls"] == 3
    assert te.stats["prefill_tokens"] == 13 + 21 + 9
    assert outs[1] == [_solo(models, p, 4, **dict(geom, prefill_chunk=None))
                       for p in prompts]


def test_warm_row_in_the_chunked_group(models):
    """A warm request whose uncached tail is longer than the chunk
    starts its rounds past its shared pages, beside a cold long prompt;
    tokens, ledger and counters equal the JAX engine's."""
    geom = dict(max_slots=3, num_pages=60, max_pages_per_slot=10,
                prefill_chunk=8, prefix_cache_pages=16)
    rng = np.random.RandomState(7)
    warm_p = PREFIX + list(rng.randint(1, 90, 13))
    cold_p = list(rng.randint(1, 90, 17))
    outs = []
    for eng in _pair(models, **geom):
        eng.generate([PREFIX], max_new_tokens=2)
        toks = eng.generate([warm_p, cold_p], max_new_tokens=5)
        outs.append((toks, _prefix_counts(eng), _ledger(eng)))
    assert outs[1] == outs[0]
    assert outs[1][1]["prefix_hits"] == 1
    # 1 call for the first prompt; rounds of the 13-token tail and the
    # 17-token prompt: 8 + 8, 5 + 8, then 1
    assert eng.stats["prefill_calls"] == 4
    assert eng.stats["prefill_tokens"] == 8 + 13 + 17
    whole = dict(geom, prefill_chunk=None, prefix_cache_pages=0)
    assert outs[1][0] == [_solo(models, p, 5, **whole)
                          for p in (warm_p, cold_p)]
    _settled(eng)


# -- bounded admission and deadlines -------------------------------------------

def test_engine_sheds_when_pending_bounded(models):
    geom = dict(max_slots=1, num_pages=9, max_pages_per_slot=None,
                max_pending=0)
    counts = []
    for eng, shed in zip(_pair(models, **geom),
                         (JEngineOverloaded, EngineOverloaded)):
        r1 = eng.submit([1, 2, 3], max_new_tokens=4)    # admissible now
        with pytest.raises(shed) as ei:
            eng.submit([1, 2, 3], max_new_tokens=4)     # queued behind r1
        assert ei.value.retry_after == 0.1 and ei.value.status == 503
        assert eng.stats["overloaded"] == 1
        # a queue-state rejection, not a permanent one
        r1.cancel()
        eng.step()
        assert eng.stats["cancelled"] == 1
        r3 = eng.submit([1, 2, 3], max_new_tokens=4)
        r3.cancel()
        eng.step()
        counts.append(_prefix_counts(eng))
    assert counts[1] == counts[0]


def test_engine_submit_deadline_expiry(models):
    eng = TEngine(models[1], device="cpu", **dict(
        GEOM, max_slots=1, num_pages=9, max_pages_per_slot=None))
    with pytest.raises(DeadlineExceeded) as ei:
        eng.submit([1, 2], max_new_tokens=2,
                   deadline=Deadline(time.monotonic() - 1.0))
    assert ei.value.status == 504
    assert not eng.has_work() and eng._submitted == 0
    # expires while queued: the next pass fails it without a prefill
    r = eng.submit([1, 2], max_new_tokens=2, deadline=Deadline.after_ms(1))
    time.sleep(0.02)
    eng.step()
    with pytest.raises(DeadlineExceeded, match="queued"):
        r.result(stall_timeout=5)
    assert eng.stats["expired"] == 1 and eng.stats["prefills"] == 0
    assert not eng.has_work()
    # a live deadline is no obstacle
    ok = eng.submit([1, 2], max_new_tokens=3,
                    deadline=Deadline.after_ms(60_000))
    eng.run_until_idle()
    assert len(ok.result()) == 3


def test_deadline_expires_behind_a_full_engine(models):
    """A request queued behind a full engine expires there: no slot, no
    pages, no prefill; the running request is untouched."""
    eng = TEngine(models[1], device="cpu", **dict(GEOM, max_slots=1))
    busy = eng.submit([5, 9, 2], max_new_tokens=12)
    eng.step()
    prefills = eng.stats["prefills"]
    late = eng.submit([7, 8], max_new_tokens=4,
                      deadline=Deadline.after_ms(500))
    eng.step()                                  # no slot: requeued
    assert not late.done.is_set()
    time.sleep(0.6)
    eng.run_until_idle()
    with pytest.raises(DeadlineExceeded):
        late.result(stall_timeout=5)
    assert eng.stats["expired"] == 1
    assert eng.stats["prefills"] == prefills
    assert busy.result() == _solo(models, [5, 9, 2], 12)
    assert sorted(eng._free) == list(range(1, eng.num_pages))


def test_engine_stream_deadline_threads_through(models):
    eng = TEngine(models[1], device="cpu", **dict(GEOM, max_slots=1))
    try:
        it = eng.stream(np.asarray([[1, 2]], np.int32), max_new_tokens=2,
                        deadline=Deadline(time.monotonic() - 1.0))
        with pytest.raises(DeadlineExceeded):
            next(it)
        rows = list(eng.stream(np.asarray([[1, 2]], np.int32),
                               max_new_tokens=3,
                               deadline=Deadline.after_ms(60_000)))
        assert len(rows) == 3
    finally:
        eng.stop()
    assert not eng._ticker.is_alive()
