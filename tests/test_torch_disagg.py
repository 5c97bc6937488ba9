"""The port's disaggregated prefill/decode handoff, and the engine's
`dtype` and `kernel` arguments, against the JAX package, on the CPU.

The bundle wire format is the JAX module's byte for byte: the same
arrays packed by either package give the same bytes, and each package
unpacks the other's bundles (bf16 through torch in the port, through
ml_dtypes in the JAX package). The engine scenarios are those of
tests/test_disagg.py (the handoff's greedy parity with int8 KV, role
validation and the stats block, the arbiter's grant order), plus the
handoff across packages: pages exported by the JAX prefill engine,
packed by the JAX module and unpacked by the port, decode in the port
to the JAX monolithic engine's greedy tokens. Both packages' models
hold one set of f32 weights (the JAX model's state carried into the
port). The JAX engine's decode attend runs its plain path
(`kernel="jnp"`); the port's decode goes through its kernel wrapper,
which on the CPU is the plain twin.
"""
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.inference.disagg as j_disagg
import paddle_tpu.inference.tenancy as j_tenancy
import paddle_tpu_torch.inference.disagg as t_disagg
import paddle_tpu_torch.inference.tenancy as t_tenancy
from paddle_tpu.inference.paged import PagedKVEngine as JEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference.paged import PagedKVEngine as TEngine
from paddle_tpu_torch.inference.prefix import chain_keys
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import from_paddle_tpu_state

from conftest import wait_for as _wait_for  # noqa: E402

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

TINY = dict(num_hidden_layers=2, vocab_size=97, hidden_size=64,
            num_attention_heads=4, num_key_value_heads=2,
            fused_norm=True, fused_rope=True)
# tests/test_disagg.py's engine geometry
GEOM = dict(max_slots=2, page_size=4, num_pages=32, max_pages_per_slot=8,
            steps_per_tick=2, prefix_cache_pages=8)
PREFIX = [5, 9, 2, 14, 17, 3, 11, 4]          # 2 full pages of 4
PROMPT = PREFIX + [21, 22, 23]


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


def _ledger_settled(eng):
    cached = set(eng.prefix_cache.pages())
    assert set(eng._page_refs) == cached
    assert eng._cached_pages == cached
    assert eng._reclaimable == len(cached)
    assert len(eng._free) == eng.num_pages - 1 - len(cached)


def _torch_of(a):
    """The numpy array `a` as a torch tensor of the same bits."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _numpy_of(t):
    """A torch tensor as a numpy array of the same bits (ml_dtypes
    bfloat16 for bf16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _entries(mod, conv):
    """Three entries of mod.PageBundleEntry over f32, bf16 and int8 arrays
    with f32 scale rows, a draft mirror and an empty array, made from a
    numpy seed and passed through `conv`."""
    rng = np.random.RandomState(0)
    f32 = rng.randn(2, 4, 8).astype(np.float32)
    bf16 = rng.randn(4, 2, 8).astype(ml_dtypes.bfloat16)
    i8 = rng.randint(-128, 128, (4, 2, 8)).astype(np.int8)
    scale = rng.rand(4, 2).astype(np.float32)
    c = lambda *xs: tuple(conv(x) for x in xs)        # noqa: E731
    return [mod.PageBundleEntry("k1", [c(i8, i8 * 2, scale, scale + 1.0)],
                                draft=[c(i8 * 3, i8, scale, scale)]),
            mod.PageBundleEntry("k2", [c(bf16, bf16 + 1), c(f32, f32)]),
            mod.PageBundleEntry("k3", [c(f32[:0], f32)])]


# -- bundle wire format ------------------------------------------------------------

def test_bundle_bytes_equal_the_jax_modules():
    """The same arrays, numpy in the JAX package and torch in the port,
    pack to the same bytes; numpy arrays packed by the port too."""
    raw_j = j_disagg.pack_bundle(_entries(j_disagg, lambda a: a))
    raw_t = t_disagg.pack_bundle(_entries(t_disagg, _torch_of))
    assert raw_t == raw_j
    no_bf16 = [e for e in _entries(j_disagg, lambda a: a) if e.key != "k2"]
    assert t_disagg.pack_bundle(no_bf16) == j_disagg.pack_bundle(no_bf16)
    assert raw_t.startswith(b"PTKV1\n")


@pytest.mark.parametrize("packer", ["jax", "port"])
def test_bundle_roundtrip_byte_identity(packer):
    """Either package's bundle unpacks in the port to the same arrays,
    bit for bit, as CPU torch tensors (bf16 without ml_dtypes), and in
    the JAX package too."""
    src = _entries(j_disagg, lambda a: a)
    pack = (j_disagg if packer == "jax" else t_disagg).pack_bundle
    raw = pack(src if packer == "jax" else _entries(t_disagg, _torch_of))
    out = t_disagg.unpack_bundle(raw)
    back = j_disagg.unpack_bundle(raw)
    assert [o.key for o in out] == ["k1", "k2", "k3"]
    assert out[1].draft is None and out[0].draft is not None
    for orig, got, jgot in zip(src, out, back):
        assert got.nbytes == orig.nbytes == jgot.nbytes
        pairs = list(zip(orig.layers, got.layers, jgot.layers))
        if orig.draft is not None:
            pairs += list(zip(orig.draft, got.draft, jgot.draft))
        for g_orig, g_got, g_j in pairs:
            for a, t, j in zip(g_orig, g_got, g_j):
                assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
                assert tuple(t.shape) == a.shape
                assert t_disagg.dtype_name(t) == str(a.dtype)
                assert _numpy_of(t).tobytes() == a.tobytes() == j.tobytes()
    # the port's tensors are its own: writing one leaves the blob alone
    out[0].layers[0][0].zero_()
    assert t_disagg.unpack_bundle(raw)[0].layers[0][0].abs().sum() > 0


def test_bundle_rejects_malformed_blobs():
    raw = t_disagg.pack_bundle(_entries(t_disagg, _torch_of))
    for bad in (b"nope" + raw, raw[:len(raw) - 8], raw[:8], b""):
        with pytest.raises(ValueError):
            t_disagg.unpack_bundle(bad)
    odd = j_disagg.pack_bundle([j_disagg.PageBundleEntry(
        "x", [(np.zeros(2, np.complex64),)])])
    with pytest.raises(ValueError, match="complex64"):
        t_disagg.unpack_bundle(odd)


# -- engine-level handoff ----------------------------------------------------------

@pytest.mark.parametrize("kv", [None, "int8"])
def test_engine_handoff_greedy_parity(models, kv):
    """export -> pack -> unpack -> stage -> import -> decode in the port
    gives the port monolithic engine's greedy tokens (and the JAX
    engine's); the imported pages are the prefill engine's, byte for
    byte, every pool plane; the decode ledger settles; a re-staged
    bundle of resident keys dedups to no work."""
    jm, tm = models
    kw = dict(GEOM, kv_dtype=kv)
    mono = TEngine(tm, device="cpu", **kw)
    jmono = JEngine(jm, kernel="jnp", **kw)
    pre = TEngine(tm, device="cpu", role="prefill", host_tier_bytes=1 << 20,
                  **kw)
    dec = TEngine(tm, device="cpu", role="decode", **kw)
    try:
        want = mono.generate([PROMPT], max_new_tokens=6)[0]
        assert want == jmono.generate([PROMPT], max_new_tokens=6)[0]
        pre.generate([PROMPT], max_new_tokens=1)      # the prefill phase
        keys = chain_keys(PROMPT, 4)
        entries = pre.export_pages(keys)
        assert [e.key for e in entries] == keys and len(keys) == 2
        raw = t_disagg.pack_bundle(entries)
        assert dec.disagg_missing(keys) == keys
        dec.stage_import(t_disagg.unpack_bundle(raw))
        assert dec.generate([PROMPT], max_new_tokens=6)[0] == want
        snap = dec.disagg_stats()
        assert snap["role"] == "decode" and snap["imported_pages"] == 2
        assert snap["imported_bytes"] == sum(e.nbytes for e in entries)
        for key in keys:
            p_pre, p_dec = pre.prefix_cache.get(key), dec.prefix_cache.get(key)
            assert p_pre is not None and p_dec is not None
            for gp, gd in zip(pre.pools, dec.pools):
                assert len(gp) == (4 if kv else 2)
                for a, b in zip(gp, gd):
                    assert torch.equal(a[p_pre], b[p_dec])
        _ledger_settled(dec)
        assert dec.disagg_missing(keys) == []
        dec.stage_import(t_disagg.unpack_bundle(raw))
        dec.generate([[1, 2, 3]], max_new_tokens=1)   # drains the staged
        snap = dec.disagg_stats()
        assert snap["imported_pages"] == 2 and snap["dedup_skipped_pages"] == 2
        _ledger_settled(dec)
        assert pre.disagg_stats()["role"] == "prefill"
        assert pre.kvtier_stats()["spilled_pages"] == 2
    finally:
        for e in (mono, jmono, pre, dec):
            e.stop()


@pytest.mark.parametrize("kv", [None, "int8"])
def test_jax_prefill_bundle_decodes_in_the_port(models, kv):
    """Pages exported by the JAX prefill engine and packed by the JAX
    module decode in the port to the JAX monolithic engine's greedy
    tokens, and the port's decode engine counts the import as the JAX
    decode engine counts the same bundle."""
    jm, tm = models
    kw = dict(GEOM, kv_dtype=kv)
    jmono = JEngine(jm, kernel="jnp", **kw)
    jpre = JEngine(jm, kernel="jnp", role="prefill", host_tier_bytes=1 << 20,
                   **kw)
    jdec = JEngine(jm, kernel="jnp", role="decode", **kw)
    dec = TEngine(tm, device="cpu", role="decode", **kw)
    try:
        want = jmono.generate([PROMPT], max_new_tokens=6)[0]
        jpre.generate([PROMPT], max_new_tokens=1)
        keys = chain_keys(PROMPT, 4)
        raw = j_disagg.pack_bundle(jpre.export_pages(keys))
        entries = t_disagg.unpack_bundle(raw)
        assert dec.disagg_missing(keys) == keys
        dec.stage_import(entries)
        assert dec.generate([PROMPT], max_new_tokens=6)[0] == want
        jdec.stage_import(j_disagg.unpack_bundle(raw))
        assert jdec.generate([PROMPT], max_new_tokens=6)[0] == want
        assert dec.disagg_stats() == jdec.disagg_stats()
        assert dec.stats["prefix_hits"] == jdec.stats["prefix_hits"] == 1
        # the JAX engine's pages landed in the port's pools unchanged
        for e in entries:
            page = dec.prefix_cache.get(e.key)
            for grp, pools in zip(e.layers, dec.pools):
                for a, pool in zip(grp, pools):
                    assert torch.equal(pool[page], a)
        _ledger_settled(dec)
    finally:
        for e in (jmono, jpre, jdec, dec):
            e.stop()


def test_incompatible_bundle_pages_are_skipped(models):
    """A bundle of another pool geometry or type is dropped at import,
    never written over pages."""
    _, tm = models
    f32 = TEngine(tm, device="cpu", role="prefill", host_tier_bytes=1 << 20,
                  **GEOM)
    dec = TEngine(tm, device="cpu", role="decode", kv_dtype="int8", **GEOM)
    try:
        f32.generate([PROMPT], max_new_tokens=1)
        keys = chain_keys(PROMPT, 4)
        dec.stage_import(f32.export_pages(keys))
        dec.generate([[1, 2, 3]], max_new_tokens=1)
        assert dec.disagg_stats()["imported_pages"] == 0
        assert not any(k in dec.prefix_cache for k in keys)
        _ledger_settled(dec)
    finally:
        f32.stop()
        dec.stop()


def _error(make, exc=ValueError):
    with pytest.raises(exc) as ei:
        make()
    return str(ei.value)


def test_role_validation_and_stats_block(models):
    jm, tm = models
    base = dict(max_slots=1, page_size=4, num_pages=16)
    for bad in (dict(role="prefill"), dict(role="decode"),
                dict(role="router")):
        want = _error(lambda: JEngine(jm, **base, **bad))
        assert _error(lambda: TEngine(tm, device="cpu", **base,
                                      **bad)) == want
    eng = TEngine(tm, device="cpu", **base)
    jeng = JEngine(jm, **base)
    try:
        assert eng.disagg_stats() == jeng.disagg_stats()
        assert eng.disagg_stats()["role"] == "both"
        assert eng.export_pages(["x"]) == []
        assert eng.disagg_missing(["x"]) == ["x"]
        eng.stage_import([])                    # nothing to stage
        with pytest.raises(RuntimeError):
            eng.stage_import([t_disagg.PageBundleEntry(
                "x", [(torch.zeros(1, dtype=torch.int8),)])])
    finally:
        eng.stop()
        jeng.stop()


def test_disagg_stats_counters():
    s = t_disagg.DisaggStats("prefill")
    s.note_export(2, 100)
    s.note_pull(3, 300, 0.25, skipped=1)
    s.note_dedup(2)
    s.note_imported(3, 300)
    s.note_pull_failure()
    j = j_disagg.DisaggStats("prefill")
    j.note_export(2, 100)
    j.note_pull(3, 300, 0.25, skipped=1)
    j.note_dedup(2)
    j.note_imported(3, 300)
    j.note_pull_failure()
    assert s.snapshot() == j.snapshot()
    assert s.snapshot()["dedup_skipped_pages"] == 3


# -- the handoff arbiter -----------------------------------------------------------

def test_arbiter_weighted_fair_grant_order():
    """With a storm tenant's backlog queued, a heavier late arrival is
    granted first (lower virtual finish time); a timeout yields False
    and never wedges the queue."""
    table = t_tenancy.TenantTable([t_tenancy.TenantPolicy("storm",
                                                          weight=1.0),
                                   t_tenancy.TenantPolicy("vip",
                                                          weight=4.0)])
    arb = t_disagg.HandoffArbiter(table, max_concurrent=1)
    assert arb.acquire(None)
    order, threads = [], []

    def waiter(tenant):
        assert arb.acquire(tenant, timeout=10.0)
        order.append(tenant)
        arb.release()

    for t in ("storm", "storm", "storm", "vip"):
        th = threading.Thread(target=waiter, args=(t,), daemon=True)
        th.start()
        threads.append(th)
        _wait_for(lambda n=len(threads): arb.snapshot()["waiting"] == n,
                  what="waiter enqueued")
    assert arb.acquire("late", timeout=0.05) is False
    arb.release()
    for th in threads:
        th.join(timeout=10)
        assert not th.is_alive()
    assert order == ["vip", "storm", "storm", "storm"]
    snap = arb.snapshot()
    assert snap == {"active": 0, "waiting": 0, "granted": 5,
                    "max_concurrent": 1}
    with pytest.raises(ValueError):
        t_disagg.HandoffArbiter(max_concurrent=0)
    arb2 = t_disagg.HandoffArbiter(max_concurrent=1)
    assert arb2.acquire(None)
    with arb2.slot(None, timeout=0.05) as held:
        assert held is False
    arb2.release()
    with arb2.slot(None) as held:
        assert held is True
    assert arb2.snapshot()["active"] == 0


def test_arbiter_virtual_times_equal_the_jax_modules():
    """Uncontended grants advance the same virtual clocks in both
    modules, with weights from either package's table."""
    arbs = []
    for ten, dis in ((j_tenancy, j_disagg), (t_tenancy, t_disagg)):
        table = ten.TenantTable([ten.TenantPolicy("a", weight=2.0),
                                 ten.TenantPolicy("b", weight=0.5)])
        arb = dis.HandoffArbiter(table, max_concurrent=3)
        for t in ("a", "b", "a", None, "b", "zz"):
            assert arb.acquire(t)
            arb.release()
        arbs.append(arb)
    assert arbs[0]._tenant_vft == arbs[1]._tenant_vft
    assert arbs[0]._vt == arbs[1]._vt
    assert arbs[0].snapshot() == arbs[1].snapshot()


# -- the engine's dtype and kernel ------------------------------------------------

def test_dtype_and_kernel_validation_match_the_jax_engine(models):
    jm, tm = models
    base = dict(max_slots=1, page_size=4, num_pages=16)
    want = _error(lambda: JEngine(jm, kernel="bogus", **base))
    assert _error(lambda: TEngine(tm, device="cpu", kernel="bogus",
                                  **base)) == want
    want = _error(lambda: JEngine(jm, dtype="bogus", **base), TypeError)
    assert _error(lambda: TEngine(tm, device="cpu", dtype="bogus",
                                  **base), TypeError) == want
    # every kernel value runs the twin on the CPU
    for kernel in (None, "pallas", "jnp"):
        eng = TEngine(tm, device="cpu", kernel=kernel, **base)
        assert eng.decode_kernel == "twin"
        assert eng.generate([[5, 9, 2]], max_new_tokens=3) == \
            TEngine(tm, device="cpu", **base).generate([[5, 9, 2]],
                                                       max_new_tokens=3)


@pytest.mark.parametrize("dtype", ["bfloat16", torch.bfloat16, "float32"])
def test_dtype_sets_the_pool_type(models, dtype):
    """`dtype` is the pool type when kv_dtype is None: bf16 pools on an
    f32 model, as the JAX engine's; kv_dtype still wins."""
    jm, tm = models
    base = dict(max_slots=1, page_size=4, num_pages=16)
    eng = TEngine(tm, device="cpu", dtype=dtype, **base)
    jeng = JEngine(jm, dtype=str(dtype).removeprefix("torch."), **base)
    assert t_disagg.dtype_name(eng.pools[0][0]) == \
        str(jeng.pools[0][0].dtype)
    assert eng.kv_bytes_per_slot() == jeng.kv_bytes_per_slot()
    assert len(eng.generate([[5, 9, 2]], max_new_tokens=3)[0]) == 3
    int8 = TEngine(tm, device="cpu", dtype=dtype, kv_dtype="int8", **base)
    assert int8.pools[0][0].dtype == torch.int8


def test_engine_takes_every_keyword_of_the_jax_engine():
    """Every keyword of the JAX constructor and of its `submit` and
    `stream` is a keyword of the port's (the port adds only `device`),
    and the JAX engine's reporting and handoff methods all exist."""
    import inspect

    def params(fn):
        return {n: p.default for n, p in
                inspect.signature(fn).parameters.items()
                if p.kind is not p.VAR_KEYWORD}
    for name in ("__init__", "submit", "stream"):
        jp, tp = params(getattr(JEngine, name)), params(getattr(TEngine,
                                                                name))
        assert set(jp) <= set(tp), (name, set(jp) - set(tp))
        assert {k: tp[k] for k in jp} == jp, name
    assert set(params(TEngine.__init__)) - set(params(JEngine.__init__)) \
        == {"device"}
    for name in ("tenant_snapshot", "kvtier_stats", "disagg_stats",
                 "export_pages", "disagg_missing", "stage_import",
                 "prefix_stats", "kv_bytes_per_slot", "admission_headroom"):
        assert callable(getattr(TEngine, name)), name
