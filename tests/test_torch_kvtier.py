"""The port's host KV tier and sessions against the JAX package, on the
CPU.

The scenarios are tests/test_kvtier.py's without chaos, driven through
both engines at one set of f32 weights (the JAX model's state carried
into the port by `from_paddle_tpu_state`): spill and restore at f32 and
int8 KV, int8 pages through a round trip, session retention,
suspend/resume, a tier at its byte budget, the validation messages,
draft mirrors shed first and a restore without its draft mirror. Both
engines hand out pages from the same free list in the same order, so
the greedy tokens, the page ledger and `kvtier_stats()` compare as they
stand. The JAX engine's decode attend runs its plain path
(`kernel="jnp"`); the port's decode goes through its kernel wrapper,
which on the CPU is the plain twin.

One test has no JAX counterpart: a spilled page is taken and written
over by another request (at int8 KV its scales zeroed first) before the
restore, which must still give the first request's tokens. JAX arrays
are immutable; a torch capture that kept a view of the pool would fail
it.
"""
import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.inference.kvtier as j_kvtier
import paddle_tpu_torch.inference.kvtier as t_kvtier
from paddle_tpu.inference.paged import PagedKVEngine as JEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference.paged import PagedKVEngine as TEngine
from paddle_tpu_torch.inference.prefix import chain_keys
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import from_paddle_tpu_state

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

TINY = dict(num_hidden_layers=2, vocab_size=97, hidden_size=64,
            num_attention_heads=4, num_key_value_heads=2,
            fused_norm=True, fused_rope=True)
# tests/test_kvtier.py's `_mk` geometry
GEOM = dict(max_slots=2, page_size=4, num_pages=32, max_pages_per_slot=8,
            steps_per_tick=2, prefix_cache_pages=4, host_tier_bytes=1 << 20)
PREFIX = [5, 9, 2, 14, 17, 3, 11, 4]             # 2 full pages of 4
# one page of TINY: 2 layers x (k, v) x (2 heads x 4 x 16) f32
PAGE_BYTES = 2 * 2 * 2 * 4 * 16 * 4
TIERS = {"jax": j_kvtier, "port": t_kvtier}


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


@pytest.fixture(scope="module")
def draft_models():
    """An independent 2-layer draft, (JAX, port), f32."""
    paddle_tpu.seed(5)
    jd = jllama.LlamaForCausalLM(jllama.tiny_llama_config(**TINY))
    cfg = tllama.tiny_llama_config(**TINY)
    td = tllama.LlamaForCausalLM(cfg, device="cpu")
    td.load_state_dict(from_paddle_tpu_state(
        {k: np.asarray(v._value) for k, v in jd.state_dict().items()}, cfg))
    return jd, td


def _pair(models, draft=None, **kw):
    """(JAX engine, port engine) of one geometry."""
    jm, tm = models
    geom = dict(GEOM, **kw)
    jkw = {} if draft is None else dict(draft_model=draft[0])
    tkw = {} if draft is None else dict(draft_model=draft[1])
    return (JEngine(jm, kernel="jnp", **jkw, **geom),
            TEngine(tm, device="cpu", **tkw, **geom))


def _solo(models, prompt, n):
    """The port's cold run: a fresh engine without cache or tier."""
    return TEngine(models[1], device="cpu", max_slots=1, page_size=4,
                   num_pages=32).generate([prompt], max_new_tokens=n)[0]


def _evict_prefix(eng, keys, rng):
    """Churn the device cache with random prompts until none of `keys`
    is device-resident (each eviction spills), then drain the spill
    worker. Returns the prompts, so another engine can replay them."""
    prompts = []
    while any(k in eng.prefix_cache for k in keys):
        p = [int(x) for x in rng.randint(1, 97, 9)]
        prompts.append(p)
        eng.generate([p], max_new_tokens=2)
    assert eng.host_tier.flush()
    return prompts


def _replay(eng, prompts):
    for p in prompts:
        eng.generate([p], max_new_tokens=2)
    assert eng.host_tier.flush()


def _ledger(eng):
    cached = eng.prefix_cache.pages()
    return dict(free=list(eng._free), refs=dict(eng._page_refs),
                cached=cached, reclaimable=eng._reclaimable)


def _ledger_settled(eng):
    cached_now = set(eng.prefix_cache.pages())
    assert set(eng._page_refs) == cached_now
    assert eng._cached_pages == cached_now
    assert eng._reclaimable == len(cached_now)
    assert len(eng._free) == eng.num_pages - 1 - len(cached_now)


def _stop(*engines):
    for e in engines:
        e.stop()


def _page_bytes(eng, page):
    """Every pool array's bytes at `page`, JAX or port engine."""
    out = []
    for grp in eng.pools:
        for a in grp:
            x = a[page]
            out.append(x.numpy().copy() if isinstance(x, torch.Tensor)
                       else np.asarray(x))
    return out


# -- the tier itself -------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TIERS))
def test_host_tier_unit(name):
    """Byte-budgeted LRU under the spill worker: commit order, budget
    eviction, leading-run match semantics, counters."""
    page = [(np.ones((2, 4, 8), np.float32),) * 2]     # 256 B an array
    nbytes = 2 * page[0][0].nbytes
    tier = TIERS[name].HostKVTier(budget_bytes=3 * nbytes)
    try:
        for k in ("a", "b", "c"):
            tier.spill(k, page)
        assert tier.flush()
        assert len(tier) == 3
        assert [k for k, _e in tier.match_run(["a", "b"])] == ["a", "b"]
        assert tier.match_run(["x", "a"]) == []
        assert [k for k, _ in tier.peek_run(["c", "x"])] == ["c"]
        tier.spill("d", page)               # "c" is LRU: peek touched none
        assert tier.flush()
        snap = tier.snapshot()
        assert snap["host_pages"] == 3 and snap["evictions"] == 1
        assert not tier.has("c") and tier.has("d")
        assert snap["host_bytes"] <= snap["budget_bytes"]
        assert snap["spilled_pages"] == 4
        assert snap["spill_bytes"] == 4 * nbytes
        assert snap["lookups"] == 2 and snap["hits"] == 1
        tier.spill("d", page)
        assert tier.flush()
        assert tier.snapshot()["host_bytes"] == 3 * nbytes
        tier.discard("d")
        assert len(tier) == 2
    finally:
        tier.stop()
    with pytest.raises(ValueError):
        TIERS[name].HostKVTier(0)


def test_host_tier_snapshots_equal_the_jax_modules():
    """The same spill, match, discard and accounting calls give the same
    `snapshot()` in both modules (the /stats block's keys and values)."""
    page = [(np.ones((2, 4, 8), np.float32),) * 2]
    draft = [(np.zeros((2, 4, 8), np.float32),) * 2]
    snaps = []
    for mod in (j_kvtier, t_kvtier):
        tier = mod.HostKVTier(budget_bytes=4 * 512)
        try:
            for i, k in enumerate("abcde"):
                tier.spill(k, page, draft=draft if i % 2 else None)
            assert tier.flush()
            tier.match_run(["a", "b", "z"])
            tier.match_run(["q"])
            tier.note_restored(2, 1024)
            tier.note_suspend()
            tier.note_resume()
            tier.discard("e")
            snaps.append(tier.snapshot())
        finally:
            tier.stop()
    assert snaps[0] == snaps[1]
    assert snaps[1]["draft_dropped"] == 2 and snaps[1]["evictions"] == 1


@pytest.mark.parametrize("name", sorted(TIERS))
def test_draft_mirrors_shed_before_whole_entries(name):
    page = [(np.ones((2, 4, 8), np.float32),) * 2]      # 512 B
    draft = [(np.ones((2, 4, 8), np.float32),) * 2]     # +512 B
    nb = 512
    tier = TIERS[name].HostKVTier(budget_bytes=3 * nb)
    try:
        tier.spill("a", page, draft=draft)
        assert tier.flush()
        assert tier.snapshot()["host_bytes"] == 2 * nb
        tier.spill("b", page, draft=draft)
        assert tier.flush()
        snap = tier.snapshot()
        assert snap["draft_dropped"] == 1 and snap["evictions"] == 0
        assert snap["host_pages"] == 2
        (_, ea), (_, eb) = tier.match_run(["a", "b"])
        assert ea.draft is None and eb.draft is not None
        tier.spill("c", page)
        assert tier.flush()
        snap = tier.snapshot()
        assert snap["draft_dropped"] == 2 and snap["evictions"] == 0
        assert snap["host_pages"] == 3 and eb.draft is None
        tier.spill("d", page)
        assert tier.flush()
        snap = tier.snapshot()
        assert snap["draft_dropped"] == 2 and snap["evictions"] == 1
        assert snap["host_pages"] == 3
        assert snap["host_bytes"] <= snap["budget_bytes"]
    finally:
        tier.stop()


def test_worker_waits_for_the_copy_and_survives_a_failed_one():
    """The port's spill takes an event recorded after the copies that
    fill its arrays: the worker waits on it before committing, and an
    event that raises costs one page (spill_errors), not the worker."""
    class Ready:
        def __init__(self, fail=False):
            self.fail, self.waited = fail, False

        def synchronize(self):
            self.waited = True
            if self.fail:
                raise RuntimeError("planted copy failure")
    page = [(torch.ones(2, 4, 8),) * 2]
    tier = t_kvtier.HostKVTier(budget_bytes=1 << 20)
    try:
        ok, bad = Ready(), Ready(fail=True)
        tier.spill("a", page, ready=ok)
        tier.spill("b", page, ready=bad)
        tier.spill("c", page)
        assert tier.flush()
        assert ok.waited and bad.waited
        snap = tier.snapshot()
        assert snap["spill_errors"] == 1 and snap["host_pages"] == 2
        assert tier.has("a") and not tier.has("b") and tier.has("c")
        assert snap["host_bytes"] == 2 * 2 * page[0][0].nbytes
    finally:
        tier.stop()
    tier.spill("d", page)                   # stop() then a spill: restarts
    try:
        assert tier.flush() and tier.has("d")
    finally:
        tier.stop()


def test_concurrent_spills_and_reads_keep_the_byte_ledger():
    """Threads spill, match, peek and discard at once against a small
    budget, with a short switch interval: afterwards the tier's byte
    count is the sum of its entries' bytes, within the budget, and the
    draft count matches the entries that carry one."""
    page = [(torch.ones(2, 4, 8),) * 2]                 # 512 B
    draft = [(torch.zeros(2, 4, 8),) * 2]
    tier = t_kvtier.HostKVTier(budget_bytes=12 * 512)

    def worker(i):
        for j in range(40):
            key = f"k{(i * 7 + j) % 25}"
            tier.spill(key, page, draft=draft if j % 3 == 0 else None)
            tier.match_run([key, f"k{j % 25}"])
            tier.peek_run([f"k{(j + 1) % 25}"])
            if j % 11 == 0:
                tier.discard(f"k{(i + j) % 25}")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        assert tier.flush(timeout=60)
    finally:
        sys.setswitchinterval(old)
        tier.stop()
    with tier._lock:
        entries = list(tier._entries.values())
        assert tier._bytes == sum(e.nbytes for e in entries)
        assert tier._drafts == sum(e.draft is not None for e in entries)
        assert tier._bytes <= tier.budget_bytes
    snap = tier.snapshot()
    assert snap["spilled_pages"] == 12 * 40 and snap["pending_spills"] == 0


# -- restore-on-hit parity --------------------------------------------------------

@pytest.mark.parametrize("kv", [None, "int8"])
def test_spill_restore_exact_parity(models, kv):
    """Evict a cached prefix to the host tier, then resubmit: the prefix
    comes back through one upload, prefill runs only the tail, and the
    tokens, the ledger and kvtier_stats() equal the JAX engine's."""
    je, te = _pair(models, kv_dtype=kv)
    try:
        pa = PREFIX + [21, 22, 23]
        keys = chain_keys(PREFIX, 4)
        runs = {}
        for name, eng in (("jax", je), ("port", te)):
            r1 = eng.submit(pa, max_new_tokens=8)
            eng.run_until_idle()
            warm = eng.submit(pa, max_new_tokens=8)
            eng.run_until_idle()
            assert warm.result() == r1.result()
            if name == "jax":
                churn = _evict_prefix(eng, keys, np.random.RandomState(0))
            else:
                _replay(eng, churn)
            assert not any(k in eng.prefix_cache for k in keys)
            pre = eng.kvtier_stats()
            r2 = eng.submit(pa, max_new_tokens=8)
            eng.run_until_idle()
            snap = eng.kvtier_stats()
            assert snap["restored_pages"] - pre["restored_pages"] == 2
            assert snap["hits"] == pre["hits"] + 1
            assert all(k in eng.prefix_cache for k in keys)
            assert all(eng.host_tier.has(k) for k in keys)
            _ledger_settled(eng)
            runs[name] = (r1.result(), r2.result(), snap, _ledger(eng),
                          eng.stats["prefix_hits"])
        assert runs["port"] == runs["jax"]
        assert runs["port"][1] == runs["port"][0]
        if kv is None:
            assert runs["port"][0] == _solo(models, pa, 8)
    finally:
        _stop(je, te)


def test_int8_scales_survive_round_trip(models):
    """int8 pools spill their scale rows beside the codes: in each
    engine the restored page's bytes (int8 k/v and f32 scales) equal
    the page's bytes before the spill, bit for bit; the two engines'
    restored pages agree, and a used engine gives a fresh one's
    tokens."""
    je, te = _pair(models, kv_dtype="int8")
    fresh = TEngine(models[1], device="cpu", kv_dtype="int8", **GEOM)
    try:
        pa = PREFIX + [21, 22]
        keys = chain_keys(PREFIX, 4)
        out = {}
        for name, eng in (("jax", je), ("port", te)):
            out1 = eng.generate([pa], max_new_tokens=5)[0]
            before = [_page_bytes(eng, p)
                      for p in eng.prefix_cache.match(keys)]
            if name == "jax":
                churn = _evict_prefix(eng, keys, np.random.RandomState(1))
            else:
                _replay(eng, churn)
            out2 = eng.generate([pa], max_new_tokens=5)[0]
            assert eng.kvtier_stats()["restored_pages"] >= 2
            after = [_page_bytes(eng, p)
                     for p in eng.prefix_cache.match(keys)]
            for b_arrs, a_arrs in zip(before, after):
                for b, a in zip(b_arrs, a_arrs):
                    assert b.dtype == a.dtype
                    np.testing.assert_array_equal(b, a)
            out[name] = (out1, out2, after)
        (j1, j2, jpages), (t1, t2, tpages) = out["jax"], out["port"]
        assert (t1, t2) == (j1, j2)
        assert t2 == t1 == fresh.generate([pa], max_new_tokens=5)[0]
        # against the JAX engine's restored pages: the two models' f32
        # k/v differ in the last bits, so the scale rows agree to f32
        # rounding and a code may sit one step over a rounding edge
        for jp, tp in zip(jpages, tpages):
            for i, (ja, ta) in enumerate(zip(jp, tp)):
                assert ja.dtype == ta.dtype and ja.shape == ta.shape
                if i % 4 < 2:
                    assert np.abs(ja.astype(int) - ta).max() <= 1
                else:
                    np.testing.assert_allclose(ta, ja, rtol=1e-6)
    finally:
        _stop(je, te, fresh)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_restore_after_the_spilled_page_is_written_over(models, kv):
    """A spill is a snapshot: the spilled pages go back to the free
    list (int8: their scale rows zeroed), the next request takes them
    and writes its own k/v (and scales) there, and the restore must
    still give the first request's tokens."""
    eng = TEngine(models[1], device="cpu", **dict(
        GEOM, max_slots=1, prefix_cache_pages=2, kv_dtype=kv))
    try:
        pa = PREFIX + [21, 22, 23]
        keys = chain_keys(PREFIX, 4)
        first = eng.generate([pa], max_new_tokens=6)[0]
        pages = eng.prefix_cache.match(keys)
        idx = torch.tensor(pages)
        kv0 = eng._kv[:, :, idx].clone()
        sc0 = None if eng._scales is None else eng._scales[:, :, idx].clone()
        # q's two pages evict PREFIX's (spilled); r takes the recycled
        # pages from the top of the free list and writes over them
        q = [60 + i for i in range(9)]
        r = [30 + i for i in range(10)]
        eng.generate([q], max_new_tokens=2)
        assert not any(k in eng.prefix_cache for k in keys)
        assert eng.host_tier.flush()
        eng.generate([r], max_new_tokens=6)
        assert not torch.equal(eng._kv[:, :, idx], kv0)
        if sc0 is not None:
            assert not torch.equal(eng._scales[:, :, idx], sc0)
        assert eng.host_tier.flush()
        pre = eng.kvtier_stats()["restored_pages"]
        assert eng.generate([pa], max_new_tokens=6)[0] == first
        assert eng.kvtier_stats()["restored_pages"] - pre == 2
        _ledger_settled(eng)
    finally:
        eng.stop()


# -- sessions ---------------------------------------------------------------------

def test_session_retention_warm_second_turn(models):
    """A finished turn with a session id keeps prompt and generated
    pages keyed: the next turn warm-hits past the generated text, and
    both engines give the same tokens, sessions and hits."""
    je, te = _pair(models, num_pages=64, max_pages_per_slot=16,
                   prefix_cache_pages=16)
    try:
        rng = np.random.RandomState(2)
        turn1 = [int(x) for x in rng.randint(1, 97, 11)]
        tail = [int(x) for x in rng.randint(1, 97, 5)]
        res = {}
        for name, eng in (("jax", je), ("port", te)):
            r1 = eng.submit(np.asarray(turn1, np.int32), max_new_tokens=8,
                            session="s1")
            eng.run_until_idle()
            out1 = r1.result()
            rec = dict(eng._sessions["s1"])
            # 11 + 8 - 1 committed tokens -> 4 full pages keyed
            assert len(rec["keys"]) == 4 and not rec["suspended"]
            turn2 = turn1 + out1 + tail
            r2 = eng.submit(np.asarray(turn2, np.int32), max_new_tokens=6,
                            session="s1")
            eng.run_until_idle()
            res[name] = (out1, r2.result(), rec["keys"],
                         eng.stats["prefix_hits"],
                         eng.stats["prefix_pages_shared"], _ledger(eng))
        assert res["port"] == res["jax"]
        out1, out2, _, hits, shared, _ = res["port"]
        assert hits == 1 and shared >= 4
        assert out2 == _solo(models, turn1 + out1 + tail, 6)
    finally:
        _stop(je, te)


# long enough that turn 2's own prefill and decode (a JAX compile
# included) never idle the session past it: a second suspend mid-turn
# would make the counts depend on timing. The idle window itself is
# made by moving the session's clock back past it
SUSPEND_S = 60.0


def _two_turns(eng, turn1, tail, suspend):
    r1 = eng.submit(np.asarray(turn1, np.int32), max_new_tokens=8,
                    session="s1")
    eng.run_until_idle()
    out1 = r1.result()
    mid = None
    if suspend:
        eng._sessions["s1"]["last"] -= SUSPEND_S + 1.0   # idle past it
        eng.step()                          # the sweep fires
        assert eng.host_tier.flush()
        mid = eng.kvtier_stats()
        assert mid["suspends"] == 1 and mid["host_pages"] >= 3
        assert len(eng.prefix_cache) == 0           # device side freed
        assert len(eng._free) == eng.num_pages - 1
        assert eng._sessions["s1"]["suspended"]
    r2 = eng.submit(np.asarray(turn1 + out1 + tail, np.int32),
                    max_new_tokens=6, session="s1")
    eng.run_until_idle()
    return out1, r2.result(), mid


def test_suspend_resume_token_parity(models):
    """A suspended session's round trip (idle, pages spilled, device
    freed; the next turn restores them) gives the tokens of an
    unsuspended session and of the JAX engine, and the suspends and
    resumes counters and the tier's stats equal the JAX engine's."""
    geom = dict(num_pages=64, max_pages_per_slot=16, prefix_cache_pages=16)
    je, te = _pair(models, suspend_after_s=SUSPEND_S, **geom)
    plain = TEngine(models[1], device="cpu", **dict(GEOM, **geom))
    try:
        rng = np.random.RandomState(3)
        turn1 = [int(x) for x in rng.randint(1, 97, 11)]
        tail = [int(x) for x in np.random.RandomState(4).randint(1, 97, 5)]
        res = {}
        for name, eng in (("jax", je), ("port", te)):
            out1, out2, mid = _two_turns(eng, turn1, tail, suspend=True)
            snap = eng.kvtier_stats()
            assert snap["resumes"] == 1 and snap["restored_pages"] >= 3
            assert not eng._sessions["s1"]["suspended"]
            _ledger_settled(eng)
            res[name] = (out1, out2, mid, snap, _ledger(eng))
        assert res["port"] == res["jax"]
        assert _two_turns(plain, turn1, tail, suspend=False)[:2] \
            == res["port"][:2]
        assert res["port"][1] == _solo(models, turn1 + res["port"][0]
                                       + tail, 6)
    finally:
        _stop(je, te, plain)


# -- budget and admission ---------------------------------------------------------

def test_admission_not_starved_with_tier_at_budget(models):
    """A tier whose budget holds one page sheds host LRU entries while
    the engine churns; admission keeps its headroom guarantee, and the
    tokens, ledger and stats equal the JAX engine's."""
    je, te = _pair(models, max_slots=1, num_pages=8, max_pages_per_slot=7,
                   prefix_cache_pages=6, host_tier_bytes=PAGE_BYTES)
    try:
        pa = list(range(1, 9)) + [40]
        pb = [60 + i for i in range(12)]            # fits only by evicting
        pc = [30 + i for i in range(12)]            # evicts pb's pages too
        res = {}
        for name, eng in (("jax", je), ("port", te)):
            eng.generate([pa], max_new_tokens=3)
            assert len(eng.prefix_cache) == 2
            toks = [eng.generate([p], max_new_tokens=12)[0]
                    for p in (pb, pc)]
            assert eng.host_tier.flush()
            snap = eng.kvtier_stats()
            assert snap["spilled_pages"] >= 2 and snap["evictions"] >= 1
            assert snap["host_bytes"] <= snap["budget_bytes"]
            assert snap["host_pages"] <= 1
            _ledger_settled(eng)
            res[name] = (toks, snap, _ledger(eng),
                         eng.stats["prefix_evictions"])
        assert res["port"] == res["jax"]
        assert res["port"][0] == [_solo(models, p, 12) for p in (pb, pc)]
    finally:
        _stop(je, te)


def _error(make):
    with pytest.raises(ValueError) as ei:
        make()
    return str(ei.value)


def test_tier_disabled_default_and_validation(models):
    jm, tm = models
    base = dict(max_slots=1, page_size=4, num_pages=16)
    eng = TEngine(tm, device="cpu", **base)
    try:
        assert eng.host_tier is None and eng.kvtier_stats() is None
        # a session id without a prefix cache is inert, never an error
        r = eng.submit(PREFIX + [1], max_new_tokens=2, session="s")
        eng.run_until_idle()
        r.result()
        assert eng._sessions == {}
    finally:
        eng.stop()
    for bad in (dict(host_tier_bytes=-1), dict(host_tier_bytes=1 << 20),
                dict(prefix_cache_pages=4, suspend_after_s=1.0)):
        want = _error(lambda: JEngine(jm, **base, **bad))
        assert _error(lambda: TEngine(tm, device="cpu", **base,
                                      **bad)) == want


def test_restore_with_stripped_draft_stays_exact(models, draft_models):
    """A restore whose entry lost its draft mirror zero-fills the draft's
    pages; the speculative engine's output is still the exact greedy
    sequence (the target verifies every proposal), as in the JAX
    engine."""
    je, te = _pair(models, draft=draft_models, spec_tokens=3,
                   num_pages=48, max_pages_per_slot=8, steps_per_tick=3)
    try:
        pa = PREFIX + [21]
        want = _solo(models, pa, 6)
        keys = chain_keys(PREFIX, 4)
        res = {}
        for name, eng in (("jax", je), ("port", te)):
            assert eng.generate([pa], max_new_tokens=6)[0] == want
            if name == "jax":
                churn = _evict_prefix(eng, keys, np.random.RandomState(3))
            else:
                _replay(eng, churn)
            # shed every draft mirror, as budget pressure would
            t = eng.host_tier
            with t._cond:
                for e in t._entries.values():
                    if e.draft is not None:
                        d = sum(a.nbytes for grp in e.draft for a in grp)
                        e.draft = None
                        e.nbytes -= d
                        t._bytes -= d
                        t._drafts -= 1
            pre = t.snapshot()["restored_pages"]
            assert eng.generate([pa], max_new_tokens=6)[0] == want
            assert t.snapshot()["restored_pages"] - pre >= 2
            assert eng.stats["spec_ticks"] > 0
            _ledger_settled(eng)
            res[name] = (t.snapshot(), _ledger(eng))
        assert res["port"] == res["jax"]
        # the restored pages' draft k/v are zeros in the port's pools
        pages = torch.tensor(te.prefix_cache.match(keys))
        assert float(te._draft_kv[:, :, pages].abs().sum()) == 0.0
    finally:
        _stop(je, te)


def test_restore_carries_the_draft_mirror(models, draft_models):
    """With its draft mirror, a restored page brings the draft's k/v
    back too: the draft pools' restored pages equal their bytes before
    the spill."""
    _, te = _pair(models, draft=draft_models, spec_tokens=3,
                  num_pages=48, max_pages_per_slot=8, steps_per_tick=3)
    try:
        pa = PREFIX + [21]
        keys = chain_keys(PREFIX, 4)
        first = te.generate([pa], max_new_tokens=6)[0]
        before = te._draft_kv[:, :, torch.tensor(
            te.prefix_cache.match(keys))].clone()
        _evict_prefix(te, keys, np.random.RandomState(3))
        assert te.generate([pa], max_new_tokens=6)[0] == first
        after = te._draft_kv[:, :, torch.tensor(
            te.prefix_cache.match(keys))]
        assert torch.equal(after, before)
    finally:
        te.stop()
