"""The port's tenancy module and the engine's multi-tenant scheduling
against the JAX package, on the CPU.

The unit tests are those of tests/test_tenant_qos.py, run over the JAX
module and the port's copy: each gives the same results, and the
weighted-fair scheduler the same pick sequences. The four engine
scenarios of that file (the 3:1 slot split, strict priority, the
pressure victim, the typed 429 quota) run over the port engine and the
JAX engine side by side, at one set of f32 weights (the JAX model's
state carried into the port): the same admission order, the same
`tenant_snapshot()` and the same greedy tokens. The JAX test reads the
3:1 slot ratio from its metrics registry; here it is
`tenant_snapshot()["a"]["slot_ticks"]` over `["b"]`, which both engines
keep. The JAX engine's decode attend runs its plain path
(`kernel="jnp"`); the port's decode goes through its kernel wrapper,
which on the CPU is the plain twin.
"""
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu.inference.overload as j_overload
import paddle_tpu.inference.tenancy as j_tenancy
import paddle_tpu_torch.inference.overload as t_overload
import paddle_tpu_torch.inference.tenancy as t_tenancy
from paddle_tpu.inference.paged import PagedKVEngine as JEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference.paged import PagedKVEngine as TEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import from_paddle_tpu_state

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

TINY = dict(num_hidden_layers=2, vocab_size=97, hidden_size=64,
            num_attention_heads=4, num_key_value_heads=2,
            fused_norm=True, fused_rope=True)
# the JAX test's engine geometry
GEOM = dict(max_slots=1, page_size=4, num_pages=32)
PACKAGES = {"jax": (j_tenancy, j_overload), "port": (t_tenancy, t_overload)}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """(tenancy module, overload module) of one package."""
    return PACKAGES[request.param]


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


def _engines(models, policies, **kw):
    """(JAX engine, port engine), each with its own package's table."""
    jm, tm = models
    geom = dict(GEOM, **kw)
    jt = j_tenancy.TenantTable([j_tenancy.TenantPolicy(t, **p)
                                for t, p in policies])
    tt = t_tenancy.TenantTable([t_tenancy.TenantPolicy(t, **p)
                                for t, p in policies])
    return (JEngine(jm, kernel="jnp", tenancy=jt, **geom),
            TEngine(tm, device="cpu", tenancy=tt, **geom))


def _record_admissions(eng):
    seen = []
    orig = eng._note_tenant_admitted

    def wrapper(req):
        seen.append(eng.tenancy.key(req.tenant))
        return orig(req)
    eng._note_tenant_admitted = wrapper
    return seen


def _drain(eng):
    while eng.has_work():
        eng.step()


# -- policy / table units -------------------------------------------------------

def test_tenant_policy_validation(pkg):
    ten, _ = pkg
    p = ten.TenantPolicy("acme", max_in_flight=2, max_queued=4, weight=3.0,
                         priority=1, rate_limit=10.0)
    assert p.describe() == {"max_in_flight": 2, "max_queued": 4,
                            "weight": 3.0, "priority": 1,
                            "rate_limit": 10.0}
    for bad in (dict(tenant=""), dict(tenant="bad id with spaces"),
                dict(tenant="x", weight=0.0),
                dict(tenant="x", max_in_flight=-1),
                dict(tenant="x", max_queued=-1),
                dict(tenant="x", rate_limit=0)):
        with pytest.raises(ValueError):
            ten.TenantPolicy(**bad)
    with pytest.raises(ValueError):
        ten.TenantTable([ten.TenantPolicy("a"), ten.TenantPolicy("a")])
    with pytest.raises(TypeError):
        ten.TenantTable(["a"])


def test_tenant_table_default_and_key(pkg):
    ten, _ = pkg
    t = ten.TenantTable([ten.TenantPolicy("a", weight=2.0)],
                        default=ten.TenantPolicy(ten.DEFAULT_TENANT,
                                                 max_queued=1))
    assert t.key(None) == ten.DEFAULT_TENANT
    assert t.key("a") == "a"
    assert t.policy("a").weight == 2.0
    # unknown and unlabeled tenants share the default policy AND key
    assert t.policy("whoever").max_queued == 1
    assert t.policy(None).max_queued == 1
    assert t.key("whoever") == ten.DEFAULT_TENANT
    assert t.tenants() == ["a", ten.DEFAULT_TENANT]
    assert t.describe()["a"]["weight"] == 2.0


def test_unknown_tenant_ids_share_the_default_budget(pkg):
    ten, ovl = pkg
    t = ten.TenantTable([ten.TenantPolicy("known")],
                        default=ten.TenantPolicy(ten.DEFAULT_TENANT,
                                                 max_in_flight=1))
    adm = ten.TenantAdmission(t)
    adm.try_acquire("rando-1")
    with pytest.raises(ovl.TenantQuotaExceeded):
        adm.try_acquire("rando-2")
    assert set(adm.snapshot()) == {ten.DEFAULT_TENANT, "known"}
    adm.rollback("rando-1")
    assert adm.snapshot()[ten.DEFAULT_TENANT] == {"in_flight": 0,
                                                  "admitted": 0, "shed": 1}


def test_resolve_tenant_sanitizes(pkg):
    # the chaos stamping of unlabeled requests is held in
    # tests/test_torch_chaos.py
    ten, _ = pkg
    assert ten.resolve_tenant({"X-Tenant-Id": "acme-1"}) == "acme-1"
    assert ten.resolve_tenant({"X-Tenant-Id": "bad\r\nX-Evil: 1"}) is None
    assert ten.resolve_tenant({"X-Tenant-Id": "has space"}) is None
    assert ten.resolve_tenant({"X-Tenant-Id": "x" * 200}) is None
    assert ten.resolve_tenant({"X-Tenant-Id": "x" * 128}) == "x" * 128
    assert ten.resolve_tenant({}) is None
    assert ten.resolve_tenant(None) is None
    assert ten.safe_tenant_id("ok-token") == "ok-token"
    assert ten.safe_tenant_id(7) is None
    assert ten.STORM_TENANT == "storm"


def test_wfq_three_to_one_split_and_determinism(pkg):
    ten, _ = pkg
    t = ten.TenantTable([ten.TenantPolicy("a", weight=3.0),
                         ten.TenantPolicy("b", weight=1.0)])
    w = ten.WeightedFairScheduler(t)
    order = []
    for _ in range(12):
        c = w.pick(["a", "b"])
        order.append(c)
        w.charge(c)
    assert order == ["a", "b", "a", "a", "a", "b",
                     "a", "a", "a", "b", "a", "a"]
    with pytest.raises(ValueError):
        w.pick([])


def test_wfq_strict_priority_above_fair_tiers(pkg):
    ten, _ = pkg
    t = ten.TenantTable([ten.TenantPolicy("vip", priority=1, weight=1.0),
                         ten.TenantPolicy("bulk", weight=100.0)])
    w = ten.WeightedFairScheduler(t)
    for _ in range(5):
        assert w.pick(["bulk", "vip"]) == "vip"
        w.charge("vip")
    assert w.pick(["bulk"]) == "bulk"


def test_wfq_idle_tenant_banks_no_credit(pkg):
    ten, _ = pkg
    t = ten.TenantTable([ten.TenantPolicy("a"), ten.TenantPolicy("b")])
    w = ten.WeightedFairScheduler(t)
    for _ in range(10):
        w.charge("a")
    order = []
    for _ in range(4):
        c = w.pick(["a", "b"])
        order.append(c)
        w.charge(c)
    assert order.count("b") == 2 and order.count("a") == 2


def test_tenant_rate_limiter_token_bucket(pkg):
    ten, _ = pkg
    table = ten.TenantTable([ten.TenantPolicy("r", rate_limit=2.0)])
    now = [0.0]
    rl = ten.TenantRateLimiter(table, clock=lambda: now[0])
    assert rl.allow("r") == (True, None)
    assert rl.allow("r") == (True, None)
    ok, hint = rl.allow("r")
    assert not ok and hint == pytest.approx(0.5)
    now[0] = 0.6
    assert rl.allow("r")[0] is True
    assert rl.allow("r")[0] is False
    assert rl.allow("free") == (True, None)
    assert rl.shed_counts() == {"r": 2}


def test_tenant_admission_bulkhead_unit(pkg):
    ten, ovl = pkg
    table = ten.TenantTable([ten.TenantPolicy("a", max_in_flight=1),
                             ten.TenantPolicy("b")])
    adm = ten.TenantAdmission(table)
    adm.try_acquire("a")
    with pytest.raises(ovl.TenantQuotaExceeded) as ei:
        adm.try_acquire("a")
    assert ei.value.status == 429
    assert ei.value.counter == "shed_tenant"
    assert isinstance(ei.value, ovl.AdmissionRejected)
    assert ei.value.retry_after is not None
    adm.try_acquire("b")
    adm.try_acquire(None)
    adm.release("a")
    adm.try_acquire("a")
    assert adm.in_flight("a") == 1
    snap = adm.snapshot()
    assert snap["a"] == {"in_flight": 1, "admitted": 2, "shed": 1}
    assert snap[ten.DEFAULT_TENANT]["in_flight"] == 1


def test_wfq_pick_sequences_equal_the_jax_modules():
    """Random weights, priorities, backlogs and charges: the two
    schedulers pick the same tenant at every step, and keep the same
    passes and class clocks."""
    rng = np.random.default_rng(3)
    for trial in range(20):
        names = [f"t{i}" for i in range(int(rng.integers(2, 6)))]
        pols = [dict(weight=float(rng.choice([0.5, 1.0, 2.0, 3.0, 7.0])),
                     priority=int(rng.integers(0, 2)))
                for _ in names]
        scheds = [ten.WeightedFairScheduler(ten.TenantTable(
            [ten.TenantPolicy(n, **p) for n, p in zip(names, pols)]))
            for ten in (j_tenancy, t_tenancy)]
        for _ in range(60):
            live = [n for n in names if rng.random() < 0.7] or names[:1]
            picks = [s.pick(live) for s in scheds]
            assert picks[0] == picks[1], (trial, picks)
            cost = float(rng.choice([1.0, 1.0, 2.5]))
            for s in scheds:
                s.charge(picks[0], cost)
        assert scheds[0].snapshot() == scheds[1].snapshot()


def test_overload_errors_equal_the_jax_modules():
    for name in ("AdmissionRejected", "TenantQuotaExceeded"):
        j, t = getattr(j_overload, name), getattr(t_overload, name)
        assert (t.status, t.counter) == (j.status, j.counter)
        assert issubclass(t, t_overload.OverloadError)
        assert t("x", retry_after=0.5).retry_after == 0.5
    assert issubclass(t_overload.TenantQuotaExceeded,
                      t_overload.AdmissionRejected)


# -- the engine: weighted-fair slots, priority, pressure, quota ---------------

def _three_to_one(eng):
    seen = _record_admissions(eng)
    reqs = [eng.submit([1, 2, 3], max_new_tokens=2, tenant=tid)
            for tid in ["a"] * 9 + ["b"] * 3]
    _drain(eng)
    return seen, eng.tenant_snapshot(), [r.result() for r in reqs]


def test_engine_weighted_fair_three_to_one_slot_split(models):
    je, te = _engines(models, [("a", dict(weight=3.0)),
                               ("b", dict(weight=1.0))],
                      steps_per_tick=2)
    jres, tres = _three_to_one(je), _three_to_one(te)
    assert tres == jres
    seen, snap, _ = tres
    assert seen == ["a", "b", "a", "a", "a", "b",
                    "a", "a", "a", "b", "a", "a"]
    assert snap["a"]["admitted"] == 9 and snap["b"]["admitted"] == 3
    ratio = snap["a"]["slot_ticks"] / snap["b"]["slot_ticks"]
    assert 2.5 <= ratio <= 3.5, ratio
    assert snap["a"]["pending"] == snap["b"]["pending"] == 0


def _priority(eng):
    seen = _record_admissions(eng)
    reqs = [eng.submit([1, 2, 3], max_new_tokens=2, tenant=tid)
            for tid in ["bulk", "bulk", "vip", "bulk", "vip"]]
    _drain(eng)
    return seen, eng.tenant_snapshot(), [r.result() for r in reqs]


def test_engine_strict_priority_class_served_first(models):
    je, te = _engines(models, [("bulk", dict(weight=5.0)),
                               ("vip", dict(priority=1))],
                      steps_per_tick=2)
    jres, tres = _priority(je), _priority(te)
    assert tres == jres
    assert tres[0] == ["vip", "vip", "bulk", "bulk", "bulk"]


def _pressure(eng, overloaded):
    long_req = eng.submit([1, 2, 3], max_new_tokens=8, tenant="b")
    eng.step()                          # occupies the only slot
    a1 = eng.submit([1, 2, 3], max_new_tokens=2, tenant="a")
    a2 = eng.submit([1, 2, 3], max_new_tokens=2, tenant="a")
    # max_pending hit, but tenant a is over its weighted share against
    # the newcomer: a's newest request is evicted in b's favor
    b1 = eng.submit([1, 2, 3], max_new_tokens=2, tenant="b")
    assert a2.done.is_set()
    with pytest.raises(overloaded):
        a2.result()
    names = {id(a1): "a1", id(b1): "b1"}
    pending = [names.get(id(r), "?") for r in eng._pending]
    # a newcomer from the over-share tenant finds no victim
    with pytest.raises(overloaded):
        eng.submit([1, 2, 3], max_new_tokens=2, tenant="a")
    mid = eng.tenant_snapshot()
    overloads = eng.stats["overloaded"]
    _drain(eng)
    return (pending, mid, overloads, eng.tenant_snapshot(),
            [r.result() for r in (long_req, a1, b1)])


def test_engine_pressure_eviction_prefers_over_share_tenant(models):
    je, te = _engines(models, [("a", {}), ("b", {})], steps_per_tick=1,
                      max_pending=2)
    jres = _pressure(je, j_overload.EngineOverloaded)
    tres = _pressure(te, t_overload.EngineOverloaded)
    assert tres == jres
    pending, mid, overloads, end, toks = tres
    assert pending == ["a1", "b1"]
    assert mid["a"]["shed"] == 1 and mid["a"]["pending"] == 1
    assert overloads == 2
    assert [len(t) for t in toks] == [8, 2, 2]
    assert end["a"]["pending"] == end["b"]["pending"] == 0


def _quota(eng, quota_error):
    storm = j_tenancy.STORM_TENANT
    reqs = [eng.submit([1, 2, 3], max_new_tokens=4, tenant=storm)]
    eng.step()                          # slot occupied
    reqs.append(eng.submit([1, 2, 3], max_new_tokens=4, tenant=storm))
    with pytest.raises(quota_error) as ei:
        eng.submit([1, 2, 3], max_new_tokens=4, tenant=storm)
    assert ei.value.status == 429 and ei.value.retry_after == 0.1
    # the quota holds while an _admit pass has swapped the pending list
    # out (its prefill window): the queued counter is the truth
    with eng._lock:
        held, eng._pending = eng._pending, []
    try:
        with pytest.raises(quota_error):
            eng.submit([1, 2, 3], max_new_tokens=4, tenant=storm)
    finally:
        with eng._lock:
            eng._pending = held + eng._pending
    reqs.append(eng.submit([1, 2, 3], max_new_tokens=4, tenant="calm"))
    _drain(eng)
    return (eng.tenant_snapshot(), dict(eng._queued_by_tenant),
            eng.stats["overloaded"], [r.result() for r in reqs])


def test_engine_tenant_queue_quota_sheds_typed_429(models):
    storm = j_tenancy.STORM_TENANT
    je, te = _engines(models, [(storm, dict(max_queued=1)), ("calm", {})],
                      steps_per_tick=1)
    jres = _quota(je, j_overload.TenantQuotaExceeded)
    tres = _quota(te, t_overload.TenantQuotaExceeded)
    assert tres == jres
    snap, queued, overloaded, _ = tres
    assert snap[storm]["shed"] == 2 and overloaded == 2
    assert queued == {}                 # the counter drains exactly


def test_engine_queued_counter_drains_on_cancel_expire_and_failure(models):
    """Every way out of the queue takes its tenant's count down: a
    cancel and an expiry while queued, and a tick failure that fails
    every waiter."""
    _, te = _engines(models, [("a", dict(max_queued=2))], steps_per_tick=1)
    first = te.submit([1, 2, 3], max_new_tokens=4, tenant="a")
    te.step()
    q1 = te.submit([1, 2, 3], max_new_tokens=2, tenant="a")
    q2 = te.submit([1, 2, 3], max_new_tokens=2, tenant="a",
                   deadline=t_overload.Deadline.after_ms(50))
    assert te._queued_by_tenant == {"a": 2}
    q1.cancel()
    time.sleep(0.1)                     # q2 expires while queued
    _drain(te)
    assert te._queued_by_tenant == {}
    assert te.stats["cancelled"] == 1 and te.stats["expired"] == 1
    assert len(first.result()) == 4
    with pytest.raises(t_overload.DeadlineExceeded):
        q2.result()
    te.submit([1, 2, 3], max_new_tokens=2, tenant="a")
    te.submit([1, 2, 3], max_new_tokens=2, tenant="a")
    te._fail_all(RuntimeError("planted"))
    assert te._queued_by_tenant == {} and not te.has_work()
    assert te.tenant_snapshot()["a"]["pending"] == 0


def _stream_rows(eng):
    try:
        ids = np.asarray([[5, 9, 2, 14, 17], [3, 11, 4, 0, 0]], np.int32)
        mask = np.asarray([[1] * 5, [1, 1, 1, 0, 0]], bool)
        rows = [r.tolist() for r in eng.stream(
            ids, max_new_tokens=5, attention_mask=mask, tenant="a",
            session="s1")]
        return (rows, eng.tenant_snapshot(), list(eng._sessions),
                eng.stats["admitted"])
    finally:
        eng.stop()


def test_stream_with_tenant_and_session_equals_the_jax_engine(models):
    je, te = _engines(models, [("a", dict(weight=2.0)), ("b", {})],
                      max_slots=2, steps_per_tick=2, prefix_cache_pages=4)
    jres, tres = _stream_rows(je), _stream_rows(te)
    assert tres == jres
    rows, snap, sessions, admitted = tres
    assert len(rows) == 5 and admitted == 2
    assert snap["a"]["admitted"] == 2 and sessions == ["s1"]


def test_concurrent_submitters_keep_the_tenant_ledger_whole(models):
    """16 threads submit for two tenants against a running ticker, with
    a short switch interval: every request ends (admitted and finished,
    or shed by its tenant's quota), the queued counter drains to empty,
    and the admissions and sheds add up to the submits."""
    _, te = _engines(models, [("a", dict(weight=3.0, max_queued=3)),
                              ("b", dict(max_queued=3))],
                     max_slots=2, steps_per_tick=2)
    shed, done = [], []
    lock = threading.Lock()

    def submitter(i):
        for j in range(6):
            try:
                r = te.submit([1 + i, 2, 3 + j], max_new_tokens=2,
                              tenant="ab"[i % 2])
            except t_overload.TenantQuotaExceeded:
                with lock:
                    shed.append(i)
                continue
            with lock:
                done.append(r)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    te.start()
    try:
        threads = [threading.Thread(target=submitter, args=(i,), daemon=True)
                   for i in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        for r in done:
            assert len(r.result(stall_timeout=60)) == 2
    finally:
        sys.setswitchinterval(old)
        te.stop()
    assert not te._ticker.is_alive()
    assert len(done) + len(shed) == 16 * 6
    snap = te.tenant_snapshot()
    assert te._queued_by_tenant == {} and not te.has_work()
    assert sum(r["admitted"] for r in snap.values()) == len(done)
    assert sum(r["shed"] for r in snap.values()) == len(shed)
    assert all(r["pending"] == 0 for r in snap.values())
