"""The port's replica router over the port's engine-backed servers
against the JAX router over the JAX package's, on the CPU: the
disaggregated two-hop handoff, its fallbacks and prefix routing.

The scenarios of tests/test_disagg.py's HTTP tests run on both fleets,
at f32 and at int8 KV: the router learns the roles from the probed
/stats, hop 1 prefills on the prefill replica, hop 2 decodes on the
decode replica after it pulled the pages over /kv/pull, and the tokens
equal the JAX fleet's and a solo greedy run's (at int8 KV, the port's
monolithic int8 engine's); the warm repeat pulls nothing;
`disagg.transfer.fail` decodes on the warm prefill replica with the same
tokens; a pull from a dead peer degrades to a cold local prefill. Two
monolithic replicas behind a router with prefix routing pin a repeated
prefix to one replica, with the same hit counts in both packages. Both
packages' models hold one set of f32 weights (the JAX model's state
carried into the port). The JAX engines run their plain decode attend
(`kernel="jnp"`); the port's go through the kernel wrapper, which on the
CPU is the plain twin. Requests go one at a time, so every count is
deterministic.
"""
import json
import types
import urllib.request

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu.inference.router as j_router
import paddle_tpu.inference.serving as j_serving
import paddle_tpu_torch.inference.router as t_router
import paddle_tpu_torch.inference.serving as t_serving
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
from paddle_tpu_torch.models.generation import generate

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

TINY = dict(num_hidden_layers=2, vocab_size=97, hidden_size=64,
            num_attention_heads=4, num_key_value_heads=2,
            fused_norm=True, fused_rope=True)
# tests/test_disagg.py's engine geometry
GEOM = dict(max_slots=2, page_size=4, num_pages=32, max_pages_per_slot=8,
            steps_per_tick=2, prefix_cache_pages=8)
PREFIX = [5, 9, 2, 14, 17, 3, 11, 4]          # 2 full pages of 4
PROMPT = PREFIX + [21, 22, 23]
FAIL_PROMPTS = [PREFIX + [30 + i] for i in range(2)]
PKGS = {
    "jax": types.SimpleNamespace(
        obs=j_obs, chaos=j_chaos, srv=j_serving, rt=j_router,
        engine=lambda m, **kw: JEngine(m, kernel="jnp", **kw)),
    "port": types.SimpleNamespace(
        obs=t_obs, chaos=t_chaos, srv=t_serving, rt=t_router,
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


@pytest.fixture(autouse=True)
def _clean_slate():
    for p in PKGS.values():
        p.obs.disable()
        p.obs.REGISTRY.reset()
        p.chaos.disable()
    yield
    for p in PKGS.values():
        p.obs.disable()
        p.obs.REGISTRY.reset()
        p.chaos.disable()


def _gen(port, ids, n, headers=None):
    """(tokens, X-Routed-To) of one unary /generate."""
    body = json.dumps({"ids": ids, "max_new_tokens": n}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=body,
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return (json.loads(resp.read())["sequences"][0],
                resp.headers.get("X-Routed-To"))


def _want(tm, prompt, n, kv):
    """The port's solo greedy tokens: dense-cache generate at f32 KV, the
    monolithic engine at int8 KV (whose pages round as the fleet's do)."""
    if kv is None:
        out = generate(tm, np.asarray([prompt], np.int64), max_new_tokens=n)
        return np.asarray(out)[0].tolist()[len(prompt):]
    eng = TEngine(tm, device="cpu", kv_dtype=kv, **GEOM)
    try:
        return eng.generate([prompt], max_new_tokens=n)[0]
    finally:
        eng.stop()


def _counts(router, name):
    return sorted((tuple(sorted(k)), v) for k, v in
                  router.metrics.counter(name).labeled().items())


def _snap(eng):
    s = dict(eng.disagg.snapshot())
    s.pop("transfer_s", None)
    s.pop("arbiter", None)
    return s


def _pooled_fleet(p, model, kv):
    kw = dict(GEOM, kv_dtype=kv)
    pre = p.engine(model, role="prefill", host_tier_bytes=1 << 20, **kw)
    dec = p.engine(model, role="decode", **kw)
    servers = [p.srv.PredictorServer(lambda x: x, model_name=f"r{i}",
                                     generator=e).start()
               for i, e in enumerate((pre, dec))]
    router = p.rt.ReplicaRouter(
        [(f"r{i}", f"127.0.0.1:{s.port}") for i, s in enumerate(servers)],
        prefix_page_size=4)
    return pre, dec, servers, router


def _two_pool_script(p, model, kv):
    """Two-hop handoff, warm repeat and `disagg.transfer.fail` over one
    package's two-pool fleet; returns what is compared."""
    pre, dec, servers, router = _pooled_fleet(p, model, kv)
    out = {}
    try:
        router.probe_all()
        router.start(probe=False)
        out["roles"] = [r["role"] for r in
                        router.debug_replicas()["replicas"]]
        out["hop"] = _gen(router.port, [PROMPT], 4)
        out["after_hop"] = (_snap(pre), _snap(dec))
        out["warm"] = _gen(router.port, [PROMPT], 4)
        out["after_warm"] = (_snap(pre), _snap(dec))
        with p.chaos.scoped(rates={"disagg.transfer.fail": 1.0}):
            out["fail"] = [_gen(router.port, [q], 3) for q in FAIL_PROMPTS]
        out["after_fail"] = (_snap(pre), _snap(dec))
        out["router"] = {n: _counts(router, n) for n in
                         ("router.disagg.handoffs",
                          "router.disagg.fallbacks", "router.prefix.hits",
                          "router.prefix.pins")}
        out["summary"] = router.debug_replicas()["summary"]
        out["hits"] = (pre.stats["prefix_hits"], dec.stats["prefix_hits"])
    finally:
        router.stop()
        for s in servers:
            s.stop()
        pre.stop()
        dec.stop()
    return out


@pytest.mark.parametrize("kv", [None, "int8"])
def test_two_hop_handoff_warm_dedup_and_transfer_fail(models, kv):
    res = {name: _two_pool_script(p, models[name], kv)
           for name, p in PKGS.items()}
    j, t = res["jax"], res["port"]
    assert t == j
    want = _want(models["port"], PROMPT, 4, kv)
    assert t["roles"] == ["prefill", "decode"]
    assert t["hop"] == (want, "r1") and t["warm"] == (want, "r1")
    pre_s, dec_s = t["after_hop"]
    assert pre_s["handoff_pages"] == 2
    assert dec_s["pulled_pages"] == 2 and dec_s["imported_pages"] == 2
    pre_w, dec_w = t["after_warm"]
    assert dec_w["pulled_pages"] == 2               # no second pull
    assert dec_w["dedup_skipped_pages"] >= 2
    assert pre_w["handoff_pages"] == 2
    for q, got in zip(FAIL_PROMPTS, t["fail"]):
        assert got == (_want(models["port"], q, 3, kv), "r0")
    assert t["after_fail"][1]["pulled_pages"] == 2
    r = dict(t["router"])
    assert r["router.disagg.handoffs"] == [((), 2)]
    assert r["router.disagg.fallbacks"] == [
        ((("reason", "transfer_fail"),), len(FAIL_PROMPTS))]
    assert t["summary"]["pools"] == {"prefill": 1, "decode": 1}


def _pull_fail(p, model, kv):
    dec = p.engine(model, role="decode", kv_dtype=kv, **GEOM)
    server = p.srv.PredictorServer(lambda x: x, generator=dec).start()
    try:
        got = _gen(server.port, [PROMPT], 3,
                   {"X-Disagg-KV-From": "127.0.0.1:1",      # a dead peer
                    "X-Disagg-Keys": ",".join(chain_keys(PROMPT, 4))})[0]
        return got, _snap(dec)
    finally:
        server.stop()
        dec.stop()


@pytest.mark.parametrize("kv", [None, "int8"])
def test_failed_pull_degrades_to_cold_local_prefill(models, kv):
    res = {name: _pull_fail(p, models[name], kv)
           for name, p in PKGS.items()}
    assert res["port"] == res["jax"]
    got, snap = res["port"]
    assert got == _want(models["port"], PROMPT, 3, kv)
    assert snap["pull_failures"] == 1 and snap["imported_pages"] == 0


def _prefix_script(p, model):
    engines = [p.engine(model, **GEOM) for _ in range(2)]
    servers = [p.srv.PredictorServer(lambda x: x, model_name=f"r{i}",
                                     generator=e).start()
               for i, e in enumerate(engines)]
    router = p.rt.ReplicaRouter(
        [(f"r{i}", f"127.0.0.1:{s.port}") for i, s in enumerate(servers)],
        prefix_page_size=4).start(probe=False)
    try:
        got = [_gen(router.port, [PREFIX + [40 + i, 41, 42]], 3)
               for i in range(3)]
        # a prompt shorter than a page has no chain key: least-loaded pick
        got.append(_gen(router.port, [[60, 61, 62]], 3))
        return dict(got=got,
                    prefix={n: _counts(router, n) for n in
                            ("router.prefix.hits", "router.prefix.pins")},
                    stats=[dict(e.prefix_stats()) for e in engines])
    finally:
        router.stop()
        for s in servers:
            s.stop()
        for e in engines:
            e.stop()


def test_prefix_routing_pins_a_repeated_prefix_to_one_replica(models):
    res = {name: _prefix_script(p, models[name])
           for name, p in PKGS.items()}
    assert res["port"] == res["jax"]
    t = res["port"]
    homes = {routed for _toks, routed in t["got"][:3]}
    assert len(homes) == 1
    home = int(homes.pop()[1:])
    assert t["prefix"]["router.prefix.hits"] == [((), 2)]
    assert t["prefix"]["router.prefix.pins"] == [((), 2)]
    assert t["stats"][home]["hits"] == 2
    assert t["stats"][1 - home]["hits"] == 0
    for i, (toks, _r) in enumerate(t["got"][:3]):
        assert toks == _want(models["port"], PREFIX + [40 + i, 41, 42], 3,
                             None)
