"""The port engine's request tracing, counters and chaos sites against
the JAX engine's, on the CPU.

The engine-level tests of tests/test_request_tracing.py (TTFT and ITL
under a chaos-delayed tick, the error outcome, the shed row's ref, the
multi-row context, stream()'s guard ref across its submissions, a
direct submit's own context and the tenant counters) run over both
engines (the `pkg` fixture), with the JAX tests' counts. The chaos tests
of tests/test_kvtier.py (`kvtier.spill.fail` degrades to a plain
eviction, `kvtier.restore.delay` slows but never corrupts) and
`prefix.cache.bypass` run over both engines and give equal tokens and
stats. Both packages' models hold one set of f32 weights (the JAX
model's state carried into the port). The JAX engine's decode attend
runs its plain path (`kernel="jnp"`); the port's goes through its
kernel wrapper, which on the CPU is the plain twin.
"""
import time
import types

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu.inference.overload as j_overload
import paddle_tpu.inference.tenancy as j_tenancy
import paddle_tpu_torch.inference.overload as t_overload
import paddle_tpu_torch.inference.tenancy as t_tenancy
from paddle_tpu import observability as j_obs
from paddle_tpu.distributed import chaos as j_chaos
from paddle_tpu.inference.paged import PagedKVEngine as JEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import observability as t_obs
from paddle_tpu_torch.distributed import chaos as t_chaos
from paddle_tpu_torch.inference.paged import PagedKVEngine as TEngine
from paddle_tpu_torch.inference.prefix import chain_keys
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import from_paddle_tpu_state

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

TINY = dict(num_hidden_layers=2, vocab_size=97, hidden_size=64,
            num_attention_heads=4, num_key_value_heads=2,
            fused_norm=True, fused_rope=True)
GEOM = dict(max_slots=2, page_size=4, num_pages=32, max_pages_per_slot=8,
            steps_per_tick=2, prefix_cache_pages=8)
PKGS = {
    "jax": types.SimpleNamespace(
        obs=j_obs, chaos=j_chaos, ten=j_tenancy, ovl=j_overload,
        engine=lambda m, **kw: JEngine(m, kernel="jnp", **kw)),
    "port": types.SimpleNamespace(
        obs=t_obs, chaos=t_chaos, ten=t_tenancy, ovl=t_overload,
        engine=lambda m, **kw: TEngine(m, device="cpu", **kw))}


@pytest.fixture(scope="module")
def models():
    """{"jax": JAX model, "port": port model with its weights}, f32."""
    paddle_tpu.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.tiny_llama_config(**TINY))
    cfg = tllama.tiny_llama_config(**TINY)
    tm = tllama.LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(from_paddle_tpu_state(
        {k: np.asarray(v._value) for k, v in jm.state_dict().items()}, cfg))
    return {"jax": jm, "port": tm}


@pytest.fixture(params=sorted(PKGS))
def pkg(request, models):
    """(package namespace, its model)."""
    return PKGS[request.param], models[request.param]


@pytest.fixture(autouse=True)
def _clean_slate():
    for p in PKGS.values():
        p.obs.disable()
        p.obs.REGISTRY.reset()
        p.obs.requests.clear()
        p.chaos.disable()
    yield
    for p in PKGS.values():
        p.obs.disable()
        p.obs.REGISTRY.reset()
        p.obs.requests.clear()
        p.chaos.disable()


# -- engine-level tracing (tests/test_request_tracing.py) -----------------------------

def test_ttft_itl_histograms_under_chaos_delayed_tick(pkg):
    p, model = pkg
    eng = p.engine(model, max_slots=2, page_size=4, num_pages=24,
                   max_pages_per_slot=6, steps_per_tick=2)
    try:
        with p.obs.scoped(reset=True) as reg:
            with p.chaos.scoped(seed=0, rates={"engine.tick.delay": 1.0},
                                delay_ms=25.0):
                steps = list(eng.stream(np.asarray([[5, 9, 2]], np.int32),
                                        max_new_tokens=6))
            assert len(steps) == 6
            ttft = reg.histogram("request.ttft.seconds")
            assert ttft.count() == 1
            assert ttft.percentile(50) >= 0.02
            itl = reg.histogram("request.itl.seconds")
            assert itl.count() == 3
            assert itl.percentile(50) > 0.0
            assert reg.counter("request.outcome").value(
                reason="finished") == 1
            assert reg.histogram("request.tokens").percentile(50) == 6
            assert p.obs.requests.live_count() == 0
            assert reg.counter("chaos.injections").value(
                site="engine.tick.delay") >= 3
    finally:
        eng.stop()


def test_engine_error_finishes_context_with_error_outcome(pkg, monkeypatch):
    p, model = pkg
    eng = p.engine(model, max_slots=1, page_size=4, num_pages=24,
                   max_pages_per_slot=6, steps_per_tick=2)
    try:
        with p.obs.scoped(reset=True) as reg:
            r1 = eng.submit(np.asarray([5, 9, 2], np.int32), 8)
            r2 = eng.submit(np.asarray([1, 2], np.int32), 4)
            assert eng.step() is True
            assert not r1.obs.finished

            def boom(*a, **k):
                raise RuntimeError("chip fell over")
            monkeypatch.setattr(eng, "_slot_arrays", boom)
            with pytest.raises(RuntimeError, match="chip fell over"):
                eng._ticker_loop()
            assert r1.done.is_set() and r2.done.is_set()
            assert r1.obs.outcome == "error" and r2.obs.outcome == "error"
            assert reg.counter("request.outcome").value(reason="error") == 2
            assert p.obs.requests.live_count() == 0
    finally:
        eng.stop()


def test_shed_submit_releases_its_context_ref(pkg):
    p, model = pkg
    eng = p.engine(model, max_slots=1, page_size=4, num_pages=9,
                   steps_per_tick=2, max_pending=0)
    try:
        with p.obs.scoped(reset=True) as reg:
            r1 = eng.submit([1, 2, 3], max_new_tokens=4)
            with pytest.raises(p.ovl.EngineOverloaded):
                eng.submit([1, 2, 3], max_new_tokens=4)
            assert reg.counter("request.outcome").value(
                reason="shed_engine") == 1
            assert p.obs.requests.live_count() == 1
            assert not r1.obs.finished
            eng.run_until_idle()
            assert r1.obs.outcome == "finished"
            assert p.obs.requests.live_count() == 0
    finally:
        eng.stop()


def test_multi_row_request_context_outlives_the_first_retired_row(pkg):
    p, model = pkg
    eng = p.engine(model, max_slots=2, page_size=4, num_pages=24,
                   max_pages_per_slot=6, steps_per_tick=2)
    try:
        with p.obs.scoped(reset=True) as reg:
            req = p.obs.requests
            ctx = req.register(req.RequestContext.new())
            token = req.set_current(ctx)
            try:
                r1 = eng.submit(np.asarray([5, 9, 2], np.int32), 2)
                r2 = eng.submit(np.asarray([17, 3, 11, 4], np.int32), 6)
            finally:
                req.reset_current(token)
            assert eng.step() is True
            assert r1.done.is_set() and not r2.done.is_set()
            assert not ctx.finished
            assert req.live_count() == 1
            eng.run_until_idle()
            assert ctx.finished and ctx.outcome == "finished"
            assert ctx.tokens == 2 + 6
            h = reg.histogram("request.tokens")
            assert h.count() == 1 and h.percentile(50) == 8
            names = [e[0] for e in ctx.timeline()]
            assert names.count("queued") == 2
            assert names.count("scheduled") == 2
            assert names.count("prefill_start") == 2
    finally:
        eng.stop()


def test_stream_guard_ref_spans_the_submission_window(pkg):
    """stream() of two rows under one ambient context: the context
    finishes once, after the last row, with both rows' tokens."""
    p, model = pkg
    eng = p.engine(model, max_slots=2, page_size=4, num_pages=24,
                   max_pages_per_slot=6, steps_per_tick=2)
    try:
        with p.obs.scoped(reset=True) as reg:
            req = p.obs.requests
            ctx = req.register(req.RequestContext.new())
            token = req.set_current(ctx)
            try:
                steps = list(eng.stream(np.asarray([[5, 9, 2], [7, 1, 3]],
                                                   np.int32),
                                        max_new_tokens=3))
            finally:
                req.reset_current(token)
            assert len(steps) == 3
            assert ctx.finished and ctx.outcome == "finished"
            assert ctx.tokens == 6
            assert reg.histogram("request.tokens").count() == 1
            assert reg.histogram("request.ttft.seconds").count() == 1
    finally:
        eng.stop()


def test_direct_submit_starts_its_own_context_with_tenant(pkg):
    p, model = pkg
    table = p.ten.TenantTable([p.ten.TenantPolicy("a")])
    eng = p.engine(model, max_slots=1, page_size=4, num_pages=24,
                   max_pages_per_slot=6, steps_per_tick=2, tenancy=table)
    try:
        with p.obs.scoped(reset=True) as reg:
            r = eng.submit([5, 9, 2], max_new_tokens=3, tenant="a")
            assert r.obs is not None and r.obs.tenant == "a"
            assert r.obs.tenant_key == "a" and r.obs.tokens_claimed
            eng.run_until_idle()
            assert reg.counter("request.outcome").value(
                reason="finished", tenant="a") == 1
            assert reg.counter("tenant.admitted").value(tenant="a") == 1
            assert reg.histogram("tenant.queue_wait.seconds").count(
                tenant="a") == 1
            assert reg.counter("tenant.decode.slots").value(tenant="a") \
                == eng.stats["ticks"]
    finally:
        eng.stop()


# -- the engine's chaos sites (tests/test_kvtier.py) --------------------------------

PREFIX = [5, 9, 2, 14, 17, 3, 11, 4]


def _tier_engine(p, model):
    return p.engine(model, max_slots=2, page_size=4, num_pages=32,
                    max_pages_per_slot=8, steps_per_tick=2,
                    prefix_cache_pages=4, host_tier_bytes=1 << 20)


def _evict_prefix(eng, keys, rng):
    while any(k in eng.prefix_cache for k in keys):
        eng.generate([list(rng.randint(1, 97, 9))], max_new_tokens=2)
    assert eng.host_tier.flush()


def _spill_fail(p, model):
    eng = _tier_engine(p, model)
    try:
        pa = PREFIX + [21, 22, 23]
        keys = chain_keys(PREFIX, 4)
        with p.chaos.scoped(rates={"kvtier.spill.fail": 1.0}):
            first = eng.generate([pa], max_new_tokens=8)[0]
            _evict_prefix(eng, keys, np.random.RandomState(5))
        snap = eng.kvtier_stats()
        assert snap["host_pages"] == 0 and snap["spilled_pages"] == 0
        assert snap["spill_skipped"] >= 2
        pre_misses = eng.stats["prefix_misses"]
        again = eng.generate([pa], max_new_tokens=8)[0]
        assert again == first
        assert eng.stats["prefix_misses"] == pre_misses + 1     # cold
        assert eng.kvtier_stats()["restored_pages"] == 0
        return first, snap
    finally:
        eng.stop()


def test_spill_fail_chaos_degrades_to_plain_eviction(models):
    got = {n: _spill_fail(p, models[n]) for n, p in PKGS.items()}
    assert got["port"] == got["jax"]


def _restore_delay(p, model):
    eng = _tier_engine(p, model)
    try:
        pa = PREFIX + [21]
        keys = chain_keys(PREFIX, 4)
        first = eng.generate([pa], max_new_tokens=6)[0]
        _evict_prefix(eng, keys, np.random.RandomState(6))
        with p.chaos.scoped(rates={"kvtier.restore.delay": 1.0},
                            delay_ms=30.0):
            t0 = time.perf_counter()
            assert eng.generate([pa], max_new_tokens=6)[0] == first
            assert time.perf_counter() - t0 >= 0.03
            fired = p.chaos.fire_count("kvtier.restore.delay")
        assert fired == 1
        assert eng.kvtier_stats()["restored_pages"] >= 2
        return first, eng.kvtier_stats()["restored_pages"]
    finally:
        eng.stop()


def test_restore_delay_chaos_slows_but_never_corrupts(models):
    got = {n: _restore_delay(p, models[n]) for n, p in PKGS.items()}
    assert got["port"] == got["jax"]


def _bypass(p, model):
    eng = p.engine(model, **GEOM)
    try:
        pa = PREFIX + [21]
        first = eng.generate([pa], max_new_tokens=4)[0]
        with p.chaos.scoped(rates={"prefix.cache.bypass": 1.0}):
            assert eng.generate([pa], max_new_tokens=4)[0] == first
        assert eng.generate([pa], max_new_tokens=4)[0] == first
        return first, eng.prefix_stats()
    finally:
        eng.stop()


def test_prefix_cache_bypass_turns_a_hit_into_a_miss(models):
    got = {n: _bypass(p, models[n]) for n, p in PKGS.items()}
    assert got["port"] == got["jax"]
    stats = got["port"][1]
    assert stats["misses"] == 2 and stats["hits"] == 1
