"""The port's PredictorServer over the port's PagedKVEngine against the
JAX server over the JAX engine, on the CPU.

Both packages' models hold one set of f32 weights (the JAX model's state
carried into the port by `from_paddle_tpu_state`), and both servers run
in this process with their package's observability plane on. The same
HTTP script goes to each pair of servers (a role="prefill" engine with
tenancy, sessions and the host KV tier behind one, a role="decode"
engine behind the other), at f32 and at int8 KV: unary and ndjson
stream, tenant headers, a session's second turn, a deadline, a 504 at
admission, the prefill hop, /kv/pull and the decode hop. The requests
go one at a time, so every count is deterministic. Held equal, exactly:
the greedy tokens, the /stats blocks (prefix, kvtier, disagg, tenants,
requests; the time-valued fields dropped), the request.* counts and
outcome labels, the tenant.*, inference.prefix.*, inference.kvtier.*
and inference.disagg.* counters, the decode-kernel counter with its
label mapped (the JAX engine's plain path "jnp" is the port's "twin" on
the CPU), and the /metrics engine gauges. The JAX engine's decode
attend runs its plain path (`kernel="jnp"`); the port's goes through
its kernel wrapper, which on the CPU is the plain twin. The engine-level
tracing and chaos tests are in tests/test_torch_engine_tracing.py.
"""
import json
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu.inference.disagg as j_disagg
import paddle_tpu.inference.overload as j_overload
import paddle_tpu.inference.serving as j_serving
import paddle_tpu.inference.tenancy as j_tenancy
import paddle_tpu_torch.inference.disagg as t_disagg
import paddle_tpu_torch.inference.overload as t_overload
import paddle_tpu_torch.inference.serving as t_serving
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

from conftest import wait_for as _wait_for

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

TINY = dict(num_hidden_layers=2, vocab_size=97, hidden_size=64,
            num_attention_heads=4, num_key_value_heads=2,
            fused_norm=True, fused_rope=True)
GEOM = dict(max_slots=2, page_size=4, num_pages=32, max_pages_per_slot=8,
            steps_per_tick=2, prefix_cache_pages=8)
_TP = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
PKGS = {
    "jax": types.SimpleNamespace(
        obs=j_obs, chaos=j_chaos, srv=j_serving, ten=j_tenancy,
        disagg=j_disagg, ovl=j_overload, path="jnp",
        engine=lambda m, **kw: JEngine(m, kernel="jnp", **kw)),
    "port": types.SimpleNamespace(
        obs=t_obs, chaos=t_chaos, srv=t_serving, ten=t_tenancy,
        disagg=t_disagg, ovl=t_overload, path="twin",
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
        p.obs.requests.clear()
        p.chaos.disable()
    yield
    for p in PKGS.values():
        p.obs.disable()
        p.obs.REGISTRY.reset()
        p.obs.requests.clear()
        p.chaos.disable()


def _http(port, path, obj=None, headers=None, raw=False):
    """(status, body, headers); `raw` keeps the body as bytes."""
    data = None if obj is None else json.dumps(obj).encode()
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                               headers={"Content-Type": "application/json",
                                        **(headers or {})})
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            body = resp.read()
            return (resp.status, body if raw else json.loads(body),
                    dict(resp.headers))
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, json.loads(body) if body else {}, dict(e.headers)


def _stream(port, obj, headers=None):
    """POST a streamed /generate; (status, per-row tokens, headers)."""
    r = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({**obj, "stream": True}).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(r, timeout=60) as resp:
        lines = [json.loads(ln) for ln in resp.read().decode().splitlines()
                 if ln.strip()]
        hdrs = dict(resp.headers)
        status = resp.status
    steps = [ln["tokens"] for ln in lines if "tokens" in ln]
    assert lines[-1] == {"done": True, "steps": len(steps)}
    rows = [[s[b] for s in steps] for b in range(len(steps[0]))]
    return status, rows, hdrs


# -- the HTTP script over both packages -----------------------------------------

P1 = [5, 9, 2, 14, 17, 3, 11, 4, 21]          # 2 full pages + 1
P2 = [40, 41, 42, 43, 44, 45, 46]
P3 = [60, 61, 62, 63, 64, 65, 66, 67, 68, 69]
TAIL = [30, 31, 32]


def _series(reg, name):
    snap = reg.snapshot().get(name)
    if snap is None:
        return []
    return [(s["labels"], s.get("value", s.get("count"))) for s in
            snap["series"]]


def _outcome_ok(series):
    """`series` with the "ok" outcome named "finished", cells merged."""
    cells = {}
    for labels, v in series:
        if labels.get("reason") == "ok":
            labels = {**labels, "reason": "finished"}
        key = tuple(sorted(labels.items()))
        cells[key] = cells.get(key, 0) + v
    return [(dict(k), v) for k, v in sorted(cells.items())]


def _run_script(p, model, kv):
    """The script over one package's servers; returns what is compared."""
    kw = dict(GEOM, kv_dtype=kv)
    table = p.ten.TenantTable([p.ten.TenantPolicy("a", weight=3.0),
                               p.ten.TenantPolicy("b")])
    pre = p.engine(model, role="prefill", host_tier_bytes=1 << 20,
                   tenancy=table, **kw)
    dec = p.engine(model, role="decode", **kw)
    sp = p.srv.PredictorServer(lambda d: d, generator=pre,
                               tenancy=table).start()
    sd = p.srv.PredictorServer(lambda d: d, generator=dec).start()
    out = {}
    p.obs.enable(reset=True)
    p.ovl.seed_retry_jitter(3)
    try:
        code, body, hdrs = _http(
            sp.port, "/generate",
            {"ids": [P1], "max_new_tokens": 6, "session": "s1",
             "timeout_ms": 60000},
            {"X-Tenant-Id": "a", "traceparent": _TP, "X-Request-Id": "r1"})
        assert code == 200, body
        assert hdrs["X-Request-Id"] == "r1" and hdrs["X-Tenant-Id"] == "a"
        assert hdrs["traceparent"].split("-")[1] == "ab" * 16
        out1 = body["sequences"][0]
        code, rows, hdrs = _stream(sp.port, {"ids": [P2],
                                             "max_new_tokens": 5},
                                   {"X-Tenant-Id": "b",
                                    "X-Request-Id": "r2"})
        assert code == 200 and hdrs["X-Request-Id"] == "r2"
        out2 = rows[0]
        code, body, _h = _http(
            sp.port, "/generate",
            {"ids": [P1 + out1 + TAIL], "max_new_tokens": 4,
             "session": "s1"}, {"X-Tenant-Id": "a"})
        assert code == 200
        out3 = body["sequences"][0]
        with p.chaos.scoped(seed=1, rates={"serving.admit.delay": 1.0},
                            delay_ms=30):
            code, body, _h = _http(sp.port, "/generate",
                                   {"ids": [P2], "max_new_tokens": 2},
                                   {"X-Timeout-Ms": "5"})
        assert code == 504 and "deadline" in body["error"]
        code, body, _h = _http(sp.port, "/generate",
                               {"ids": [P3], "max_new_tokens": 6},
                               {"X-Disagg-Phase": "prefill"})
        assert code == 200 and len(body["sequences"][0]) == 1
        first3 = body["sequences"][0]
        keys = chain_keys(P3, GEOM["page_size"])
        code, raw, hdrs = _http(sp.port, "/kv/pull", {"keys": keys},
                                raw=True)
        assert code == 200 and hdrs["X-Disagg-Pages"] == str(len(keys))
        bundle = [e.key for e in p.disagg.unpack_bundle(raw)]
        code, body, _h = _http(sd.port, "/generate",
                               {"ids": [P3], "max_new_tokens": 6},
                               {"X-Disagg-KV-From": f"127.0.0.1:{sp.port}",
                                "X-Disagg-Keys": ",".join(keys)})
        assert code == 200
        out4 = body["sequences"][0]
        out["tokens"] = (out1, out2, out3, first3, out4)
        out["bundle"] = (bundle, len(raw))
        _wait_for(lambda: p.obs.requests.live_count() == 0
                  and not pre.has_work() and not dec.has_work(),
                  what="contexts and rows to retire")
        for e in (pre, dec):
            assert e.host_tier is None or e.host_tier.flush()
        stats = {}
        for name, s in (("pre", sp), ("dec", sd)):
            code, st, _h = _http(s.port, "/stats")
            assert code == 200
            st.pop("latency_ms")
            st["disagg"].pop("transfer_s")
            stats[name] = st
        out["stats"] = stats
        code, _b, _h = _http(sp.port, "/debug/requests")
        assert _b["count"] == 0
        metrics = {}
        for name, s in (("pre", sp), ("dec", sd)):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{s.port}/metrics", timeout=60) as r:
                text = r.read().decode()
            metrics[name] = sorted(
                ln for ln in text.splitlines()
                if ln.startswith(("paddle_tpu_engine_",
                                  "paddle_tpu_inference_kv_",
                                  "paddle_tpu_inference_kvtier_host")))
        out["metrics"] = metrics
        reg = p.obs.REGISTRY
        # both engines retire a row after its last tokens reach the
        # stream, so the HTTP handler's "ok" and the engine's "finished"
        # race for a request's outcome. Both name a request that completed
        out["counters"] = {
            n: _outcome_ok(_series(reg, n)) for n in sorted(reg.names())
            if n.startswith(("tenant.", "inference.prefix.",
                             "inference.kvtier.", "request.outcome",
                             "inference.disagg.handoff",
                             "inference.disagg.imported",
                             "inference.disagg.dedup",
                             "inference.disagg.pull"))}
        out["hist_counts"] = {
            n: _series(reg, n) for n in
            ("request.ttft.seconds", "request.tokens",
             "request.queue_wait.seconds", "request.prefill.seconds",
             "request.itl.seconds", "tenant.queue_wait.seconds",
             "inference.disagg.transfer_seconds")}
        tok = reg.snapshot()["request.tokens"]["series"][0]
        out["tokens_sum"] = tok["sum"]
        out["decode_kernel"] = [
            (lab["path"], v) for lab, v in
            _series(reg, "inference.decode.kernel")]
        out["ticks"] = pre.stats["ticks"] + dec.stats["ticks"]
    finally:
        p.obs.disable()
        sp.stop()
        sd.stop()
        pre.stop()
        dec.stop()
    return out


@pytest.mark.parametrize("kv", [None, "int8"])
def test_http_over_engines_equals_the_jax_servers(models, kv):
    res = {name: _run_script(p, models[name], kv)
           for name, p in PKGS.items()}
    j, t = res["jax"], res["port"]
    assert t["tokens"] == j["tokens"]
    assert t["bundle"] == j["bundle"]
    assert t["stats"] == j["stats"]
    assert t["metrics"] == j["metrics"]
    assert t["counters"] == j["counters"]
    assert t["hist_counts"] == j["hist_counts"]
    assert t["tokens_sum"] == j["tokens_sum"]
    assert [("jnp" if path == "twin" else path, n)
            for path, n in t["decode_kernel"]] == j["decode_kernel"]
    # the decode-kernel counter is one per tick, on the port's label
    assert t["decode_kernel"] == [("twin", t["ticks"])]
    # and what the script exercised
    outcomes = {lab["reason"]: v for lab, v in
                t["counters"]["request.outcome"]
                if "tenant" not in lab}
    assert outcomes == {"deadline_exceeded": 1, "finished": 2}
    tenanted = {(lab["reason"], lab["tenant"]): v for lab, v in
                t["counters"]["request.outcome"] if "tenant" in lab}
    assert tenanted == {("finished", "a"): 2, ("finished", "b"): 1}
    st = t["stats"]["pre"]
    assert st["prefix"]["hits"] >= 1 and st["kvtier"]["spilled_pages"] >= 2
    # the direct /kv/pull and the decode hop's pull, two pages each
    assert st["disagg"]["handoff_pages"] == 4
    assert t["stats"]["dec"]["disagg"]["imported_pages"] == 2
    assert st["requests"] == {"total": 5, "ok": 4, "deadline_exceeded": 1}
    assert set(st["tenants"]) == {"a", "b", "default"}
