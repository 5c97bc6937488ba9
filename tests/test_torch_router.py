"""The port's replica router (paddle_tpu_torch/inference/router.py) and
retry policy (paddle_tpu_torch/distributed/retries.py) against the JAX
package's, on the CPU.

Every scenario of tests/test_replica_router.py runs over both packages
(the `pkg` fixture: one package's router, servers, chaos, overload,
retries and observability), with the JAX tests' status codes, bodies,
headers and counters; on a breaker ejection each router dumps a
`replica_ejected` bundle through its own package's flight recorder.
Beside them, one
script over a two-replica fleet in each package (routing, prefix pins,
session affinity, shed with Retry-After, `router.connect.fail`, a
draining replica, a probe flap, a kill mid-stream) gives the same
transcript, router.* counters and /debug/replicas view in both; the
port's RetryPolicy gives the JAX module's delay sequence; and
`default_policy()` reads no environment variable. Predictors and token
sources are plain numpy objects, event-controlled; probes are explicit
`probe_all()` calls; chaos faults are seeded. Every HTTP call has a
client timeout and every router and server is stopped in a `finally`.
"""
import ast
import json
import os
import random
import socket
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu.distributed.retries as j_retries
import paddle_tpu.inference.overload as j_overload
import paddle_tpu.inference.router as j_router
import paddle_tpu.inference.serving as j_serving
import paddle_tpu_torch.distributed.retries as t_retries
import paddle_tpu_torch.inference.overload as t_overload
import paddle_tpu_torch.inference.router as t_router
import paddle_tpu_torch.inference.serving as t_serving
from paddle_tpu import observability as j_obs
from paddle_tpu.distributed import chaos as j_chaos
from paddle_tpu.observability import fleet as j_fleet
from paddle_tpu_torch import observability as t_obs
from paddle_tpu_torch.observability import fleet as t_fleet
from paddle_tpu_torch.distributed import chaos as t_chaos
from tools.router_status import fetch, render

from conftest import wait_for as _wait_for

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {
    "jax": types.SimpleNamespace(
        name="jax", obs=j_obs, chaos=j_chaos, ovl=j_overload,
        retries=j_retries, rt=j_router, srv=j_serving, fleet=j_fleet,
        src=os.path.join(_ROOT, "paddle_tpu", "inference", "router.py")),
    "port": types.SimpleNamespace(
        name="port", obs=t_obs, chaos=t_chaos, ovl=t_overload,
        retries=t_retries, rt=t_router, srv=t_serving, fleet=t_fleet,
        src=os.path.join(_ROOT, "paddle_tpu_torch", "inference",
                         "router.py"))}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """One package's router, serving, chaos, overload, retries,
    observability and flight recorder."""
    return PACKAGES[request.param]


@pytest.fixture(autouse=True)
def _clean_slate():
    """Observability, chaos and the flight recorders are process-global;
    every test starts disabled and leaves the process the same way."""
    def reset():
        for p in PACKAGES.values():
            p.obs.disable()
            p.obs.REGISTRY.reset()
            p.chaos.disable()
            p.ovl.seed_retry_jitter(None)
            p.fleet.configure_flight_recorder(dir=None, max_keep=5)
    reset()
    yield
    reset()


# -- helpers (tests/test_replica_router.py) -----------------------------------

def _req(port, path, obj=None, headers=None):
    """(status, body_dict, headers_dict) for one HTTP round trip."""
    url = f"http://127.0.0.1:{port}{path}"
    data = None if obj is None else json.dumps(obj).encode()
    r = urllib.request.Request(url, data=data,
                               headers={"Content-Type": "application/json",
                                        **(headers or {})})
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, json.loads(body) if body else {}, dict(e.headers)


def _stream(port, obj, headers=None):
    """POST a streamed /generate; (status, ndjson lines, headers)."""
    r = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({**obj, "stream": True}).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(r, timeout=30) as resp:
        lines = [json.loads(ln) for ln in resp if ln.strip()]
        return resp.status, lines, dict(resp.headers)


def _stop(router, servers):
    """Stop the router and every server at once: each stop waits up to a
    poll interval of its serving loop."""
    ts = [threading.Thread(target=x.stop) for x in [router, *servers]
          if x is not None]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts), "a stop() hung"


def _no_sleep_policy(p, seed=0):
    """Deterministic jittered policy whose sleep is a recorder, not a
    clock: tests assert on the requested delays instead of paying them."""
    slept = []
    policy = p.retries.RetryPolicy(max_attempts=3, base_delay=0.05,
                                   max_delay=1.0, jitter="full",
                                   rng=random.Random(seed),
                                   sleep=slept.append)
    return policy, slept


class _Pred:
    """Plain dict->dict predictor; optionally blocks on an event."""

    def __init__(self, block=None):
        self.calls = 0
        self.block = block

    def __call__(self, inputs):
        self.calls += 1
        if self.block is not None:
            assert self.block.wait(timeout=30)
        return {"y": np.asarray([[2.0]], np.float32)}


class _TokSource:
    """generator= object streaming `n` tokens."""

    concurrent_safe = False

    def __init__(self, n=3):
        self.n = n

    def stream(self, ids, **kw):
        def gen():
            for i in range(self.n):
                yield np.asarray([i])
        return gen()


class _SwitchPred:
    """Predictor that blocks only while `hold` is set, so a replica can
    serve fast and then be saturated."""

    def __init__(self):
        self.hold = threading.Event()
        self.release = threading.Event()

    def __call__(self, inputs):
        if self.hold.is_set():
            assert self.release.wait(timeout=30)
        return {"y": np.asarray([[2.0]], np.float32)}


class _GatedSource:
    """Streaming generator: token 0 flows immediately, every later token
    waits on the gate; a killed replica's streams raise once released
    (the backend-died-mid-stream shape)."""

    concurrent_safe = False

    def __init__(self, tokens=4):
        self.tokens = tokens
        self.gate = threading.Event()
        self.killed = threading.Event()

    def stream(self, ids, **kw):
        src = self

        def gen():
            yield np.asarray([0])
            for i in range(1, src.tokens):
                assert src.gate.wait(timeout=30), "gate never opened"
                if src.killed.is_set():
                    raise RuntimeError("replica killed mid-stream")
                yield np.asarray([i])
        return gen()


_BODY = {"inputs": {"x": [[1.0, 2.0]]}}


def _mk_fleet(p, n=2, preds=None, gens=None, **server_kw):
    preds = preds or [_Pred() for _ in range(n)]
    servers = [p.srv.PredictorServer(
        preds[i], model_name=f"r{i}",
        generator=(gens[i] if gens else None), **server_kw).start()
        for i in range(n)]
    pairs = [(f"r{i}", f"127.0.0.1:{s.port}") for i, s in enumerate(servers)]
    return preds, servers, pairs


def _occupy(port):
    """A direct (not routed) /predict on its own thread."""
    t = threading.Thread(target=lambda: _req(port, "/predict", _BODY),
                         daemon=True)
    t.start()
    return t


# -- routing & the probe state machine ------------------------------------------

def test_basic_routing_and_readyz(pkg):
    _preds, servers, pairs = _mk_fleet(pkg, 2)
    router = pkg.rt.ReplicaRouter(pairs).start(probe=False)
    try:
        code, body, _h = _req(router.port, "/readyz")
        assert code == 200 and body["replicas_in_rotation"] == 2
        code, body, hdrs = _req(router.port, "/predict", _BODY)
        assert code == 200 and "outputs" in body
        assert hdrs.get("X-Routed-To") in ("r0", "r1")
        _wait_for(lambda: router.stats()["requests"].get("ok") == 1,
                  what="ok outcome counted")
        st = router.stats()
        assert st["requests"]["ok"] == 1 and st["in_rotation"] == 2
    finally:
        _stop(router, servers)


def test_least_loaded_pick_and_saturated_deprioritized(pkg):
    """Replica 0 carries one blocked in-flight request (max_concurrent 1:
    /readyz says "saturated" with numeric load fields); the probe
    deprioritizes it and the router sends new work to replica 1."""
    release = threading.Event()
    preds = [_Pred(block=release), _Pred()]
    _p, servers, pairs = _mk_fleet(pkg, 2, preds=preds, max_concurrent=1)
    router = pkg.rt.ReplicaRouter(pairs).start(probe=False)
    try:
        t = _occupy(servers[0].port)
        _wait_for(lambda: servers[0].admission.in_flight == 1,
                  what="replica 0 in flight")
        router.probe_all()
        rows = {r["id"]: r for r in router.debug_replicas()["replicas"]}
        assert rows["r0"]["deprioritized"] is True
        assert rows["r0"]["in_rotation"] is True
        assert rows["r0"]["replica_in_flight"] == 1
        assert rows["r1"]["deprioritized"] is False
        for _ in range(3):
            code, _b, hdrs = _req(router.port, "/predict", _BODY)
            assert code == 200 and hdrs["X-Routed-To"] == "r1"
        release.set()
        t.join(timeout=10)
    finally:
        release.set()
        _stop(router, servers)


def test_draining_replica_ejected_immediately_but_finishes_work(pkg):
    """The probe ejects a draining replica the moment /readyz says so; new
    work routes away while it finishes its in-flight request."""
    release = threading.Event()
    preds = [_Pred(block=release), _Pred()]
    _p, servers, pairs = _mk_fleet(pkg, 2, preds=preds)
    router = pkg.rt.ReplicaRouter(pairs).start(probe=False)
    drained, inflight = {}, {}
    dt = None
    try:
        t = threading.Thread(
            target=lambda: inflight.update(
                resp=_req(servers[0].port, "/predict", _BODY)), daemon=True)
        t.start()
        _wait_for(lambda: servers[0].admission.in_flight == 1,
                  what="in-flight request on replica 0")
        dt = threading.Thread(
            target=lambda: drained.update(clean=servers[0].drain(timeout=20)),
            daemon=True)
        dt.start()
        _wait_for(lambda: servers[0]._draining, what="draining flag")
        router.probe_all()
        rows = {r["id"]: r for r in router.debug_replicas()["replicas"]}
        assert rows["r0"]["in_rotation"] is False
        assert rows["r0"]["reason"] == "draining"
        assert router.metrics.counter("router.ejections").value(
            reason="draining") == 1
        code, _b, hdrs = _req(router.port, "/predict", _BODY)
        assert code == 200 and hdrs["X-Routed-To"] == "r1"
        release.set()
        t.join(timeout=10)
        assert inflight["resp"][0] == 200
        dt.join(timeout=20)
        assert drained["clean"] is True
    finally:
        release.set()
        _stop(router, servers[1:])
        if dt is not None:
            dt.join(timeout=20)     # drain stopped servers[0] itself


def test_retry_on_shed_fails_over_to_healthy_replica(pkg):
    """Replica 0 sheds 429; the router retries against replica 1 and the
    client sees one clean 200."""
    release = threading.Event()
    preds = [_Pred(block=release), _Pred()]
    _p, servers, pairs = _mk_fleet(pkg, 2, preds=preds, max_concurrent=1,
                                   max_queue_depth=0)
    policy, slept = _no_sleep_policy(pkg)
    router = pkg.rt.ReplicaRouter(pairs,
                                  retry_policy=policy).start(probe=False)
    try:
        t = _occupy(servers[0].port)
        _wait_for(lambda: servers[0].admission.in_flight == 1,
                  what="replica 0 saturated")
        code, _body, hdrs = _req(router.port, "/predict", _BODY)
        assert code == 200 and hdrs["X-Routed-To"] == "r1"
        assert router.stats()["retries"]["shed"] == 1
        assert slept == []
        assert servers[0].stats()["requests"]["shed_admission"] == 1
        release.set()
        t.join(timeout=10)
    finally:
        release.set()
        _stop(router, servers)


def test_all_replicas_shed_honors_retry_after_floor_then_relays(pkg):
    """When every routable replica sheds, the router backs off once (at
    least the advertised Retry-After floor, full-jittered), retries the
    round, and then relays the upstream shed reply."""
    release = threading.Event()
    preds = [_Pred(block=release), _Pred(block=release)]
    _p, servers, pairs = _mk_fleet(pkg, 2, preds=preds, max_concurrent=1,
                                   max_queue_depth=0)
    policy, slept = _no_sleep_policy(pkg)
    router = pkg.rt.ReplicaRouter(pairs, retry_policy=policy,
                                  shed_rounds=2).start(probe=False)
    try:
        ts = [_occupy(s.port) for s in servers]
        _wait_for(lambda: all(s.admission.in_flight == 1 for s in servers),
                  what="both replicas saturated")
        code, body, hdrs = _req(router.port, "/predict", _BODY)
        assert code == 429
        assert "Retry-After" in hdrs
        assert "admission rejected" in body["error"]
        assert len(slept) == 1 and slept[0] >= 1.0
        st = router.stats()
        assert st["requests"]["shed_upstream"] == 1
        assert st["retries"]["shed"] == 4       # 2 replicas x 2 rounds
        release.set()
        for t in ts:
            t.join(timeout=10)
    finally:
        release.set()
        _stop(router, servers)


def test_connect_fail_chaos_drives_failover(pkg):
    _preds, servers, pairs = _mk_fleet(pkg, 2)
    router = pkg.rt.ReplicaRouter(pairs).start(probe=False)
    try:
        with pkg.chaos.scoped(seed=5,
                              rates={"router.connect.fail": (1.0, 1)}):
            code, _b, _h = _req(router.port, "/predict", _BODY)
            assert pkg.chaos.fire_count("router.connect.fail") == 1
        assert code == 200
        assert router.stats()["retries"]["connect"] == 1
    finally:
        _stop(router, servers)


def test_forward_failures_open_breaker_eject_and_flight_record(pkg,
                                                               tmp_path):
    """A dead replica: forwards fail over to the survivor; the replica's
    breaker opens and it is ejected with reason breaker_open. With
    observability on the router dumps a `replica_ejected` bundle with
    its last-known stats."""
    _preds, servers, pairs = _mk_fleet(pkg, 2)
    router = pkg.rt.ReplicaRouter(pairs, breaker_threshold=2,
                                  eject_after=5).start(probe=False)
    pkg.obs.enable(reset=True)
    pkg.fleet.configure_flight_recorder(dir=str(tmp_path), max_keep=5)
    try:
        router.probe_all()              # capture last_stats while alive
        servers[0].stop()
        for _ in range(4):
            code, _b, hdrs = _req(router.port, "/predict", _BODY)
            assert code == 200 and hdrs["X-Routed-To"] == "r1"
        r0 = router.replica("r0")
        assert r0.breaker.state == "open"
        assert not r0.in_rotation and r0.reason == "breaker_open"
        assert r0.last_stats["model"] == "r0"
        assert router.metrics.counter("router.ejections").value(
            reason="breaker_open") == 1
        recs = pkg.fleet.flight_records(str(tmp_path))
        assert len(recs) == 1
        with open(os.path.join(recs[0], "manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["reason"] == "replica_ejected"
        assert manifest["extra"]["replica"] == "r0"
        assert manifest["extra"]["reason"] == "breaker_open"
        assert manifest["extra"]["last_stats"]["model"] == "r0"
        before = router.stats()["retries"].get("connect", 0)
        for _ in range(3):
            code, _b, hdrs = _req(router.port, "/predict", _BODY)
            assert code == 200 and hdrs["X-Routed-To"] == "r1"
        assert router.stats()["retries"].get("connect", 0) == before
    finally:
        _stop(router, servers)


def test_probe_failures_eject_and_flap_damping_gates_reentry(pkg):
    """Probe-driven ejection (eject_after consecutive failures), then
    re-entry damping: K consecutive clean probes, and a
    `router.probe.flap` resets the streak."""
    _preds, servers, pairs = _mk_fleet(pkg, 2)
    router = pkg.rt.ReplicaRouter(pairs, eject_after=2,
                                  reenter_probes=2).start(probe=False)
    try:
        port0 = servers[0].port
        servers[0].stop()
        router.probe_all()
        assert router.replica("r0").in_rotation
        router.probe_all()
        r0 = router.replica("r0")
        assert not r0.in_rotation and r0.reason == "probe_failed"
        assert router.metrics.counter("router.ejections").value(
            reason="probe_failed") == 1
        servers[0] = pkg.srv.PredictorServer(_Pred(), model_name="r0",
                                             port=port0).start()
        with pkg.chaos.scoped(seed=3, rates={"router.probe.flap": (1.0, 2)}):
            router.probe_all()          # both clean probes flapped
            assert not router.replica("r0").in_rotation
            assert router.replica("r1").in_rotation
            router.probe_all()
            assert not router.replica("r0").in_rotation
            router.probe_all()
        assert router.replica("r0").in_rotation
        assert router.replica("r1").in_rotation
        assert router.metrics.counter("router.reentries").value() == 1
        assert router.metrics.counter("router.probes").value(
            result="flap") == 2
        code, _b, _h = _req(router.port, "/readyz")
        assert code == 200
    finally:
        _stop(router, servers)


# -- session affinity ---------------------------------------------------------

def test_session_affinity_sticks_and_survives_nonaffine_death(pkg):
    gens = [_TokSource() for _ in range(3)]
    _preds, servers, pairs = _mk_fleet(pkg, 3, gens=gens)
    router = pkg.rt.ReplicaRouter(pairs, eject_after=1).start(probe=False)
    try:
        hdr = {"X-Session-Id": "conv-1"}
        code, _b, hdrs = _req(router.port, "/predict", _BODY, headers=hdr)
        assert code == 200
        home = hdrs["X-Routed-To"]
        for _ in range(3):
            code, _b, hdrs = _req(router.port, "/predict", _BODY,
                                  headers=hdr)
            assert code == 200 and hdrs["X-Routed-To"] == home
        other = next(rid for rid, _u in pairs if rid != home)
        servers[int(other[1:])].stop()
        router.probe_all()
        assert not router.replica(other).in_rotation
        code, _b, hdrs = _req(router.port, "/predict", _BODY, headers=hdr)
        assert code == 200 and hdrs["X-Routed-To"] == home
        assert router.metrics.counter("router.affinity.rebinds").value() == 0
        servers[int(home[1:])].stop()
        router.probe_all()
        code, _b, hdrs = _req(router.port, "/predict", _BODY, headers=hdr)
        assert code == 200
        new_home = hdrs["X-Routed-To"]
        assert new_home not in (home, other)
        assert router.metrics.counter("router.affinity.rebinds").value() == 1
        code, _b, hdrs = _req(router.port, "/predict", _BODY, headers=hdr)
        assert hdrs["X-Routed-To"] == new_home
    finally:
        _stop(router, servers)


def test_affinity_not_repinned_on_transient_shed(pkg):
    """One shed from the pinned replica routes this request around it but
    keeps the pin."""
    preds = [_SwitchPred(), _SwitchPred()]
    _p, servers, pairs = _mk_fleet(pkg, 2, preds=preds, max_concurrent=1,
                                   max_queue_depth=0)
    policy, _slept = _no_sleep_policy(pkg)
    router = pkg.rt.ReplicaRouter(pairs,
                                  retry_policy=policy).start(probe=False)
    pinned = None
    try:
        hdr = {"X-Session-Id": "sticky"}
        code, _b, hdrs = _req(router.port, "/predict", _BODY, headers=hdr)
        assert code == 200
        home = hdrs["X-Routed-To"]
        i = int(home[1:])
        srv, pinned = servers[i], preds[i]
        pinned.hold.set()
        t = _occupy(srv.port)
        _wait_for(lambda: srv.admission.in_flight == 1,
                  what="pinned replica saturated")
        code, _b, hdrs = _req(router.port, "/predict", _BODY, headers=hdr)
        assert code == 200 and hdrs["X-Routed-To"] != home
        pinned.release.set()
        t.join(timeout=10)
        pinned.hold.clear()
        code, _b, hdrs = _req(router.port, "/predict", _BODY, headers=hdr)
        assert code == 200 and hdrs["X-Routed-To"] == home
        assert router.metrics.counter("router.affinity.rebinds").value() == 0
    finally:
        if pinned is not None:
            pinned.release.set()
        _stop(router, servers)


def test_all_shed_backoff_never_outlives_client_budget(pkg):
    """A Retry-After floor larger than the client's remaining X-Timeout-Ms
    budget: a typed, non-retryable 504 now, not a sleep."""
    release = threading.Event()
    _p, servers, pairs = _mk_fleet(pkg, 1, preds=[_Pred(block=release)],
                                   max_concurrent=1, max_queue_depth=0)
    policy, slept = _no_sleep_policy(pkg)
    router = pkg.rt.ReplicaRouter(pairs, retry_policy=policy,
                                  shed_rounds=3).start(probe=False)
    try:
        t = _occupy(servers[0].port)
        _wait_for(lambda: servers[0].admission.in_flight == 1,
                  what="replica saturated")
        code, body, _h = _req(router.port, "/predict", _BODY,
                              headers={"X-Timeout-Ms": "400"})
        assert code == 504
        assert body["reason"] == "deadline_exceeded"
        assert body["retryable"] is False
        assert slept == []
        release.set()
        t.join(timeout=10)
    finally:
        release.set()
        _stop(router, servers)


def test_affinity_lru_bound(pkg):
    _preds, servers, pairs = _mk_fleet(pkg, 1)
    router = pkg.rt.ReplicaRouter(pairs,
                                  affinity_capacity=3).start(probe=False)
    try:
        for i in range(5):
            _req(router.port, "/predict", _BODY,
                 headers={"X-Session-Id": f"s{i}"})
        assert router.debug_replicas()["summary"]["sessions"] == 3
    finally:
        _stop(router, servers)


# -- observability continuity ---------------------------------------------------

def test_trace_headers_span_router_to_replica(pkg):
    """The inbound X-Request-Id and traceparent reach the replica, which
    adopts them; the reply through the router carries the same request id
    and trace id with a fresh parent span."""
    _preds, servers, pairs = _mk_fleet(pkg, 1)
    router = pkg.rt.ReplicaRouter(pairs).start(probe=False)
    pkg.obs.enable(reset=True)
    try:
        trace_id = "a" * 32
        inbound_tp = f"00-{trace_id}-{'b' * 16}-01"
        code, _b, hdrs = _req(router.port, "/predict", _BODY,
                              headers={"X-Request-Id": "req-e2e-42",
                                       "traceparent": inbound_tp})
        assert code == 200
        assert hdrs["X-Request-Id"] == "req-e2e-42"
        ver, tid, parent, _flags = hdrs["traceparent"].split("-")
        assert tid == trace_id and parent != "b" * 16 and ver == "00"
    finally:
        _stop(router, servers)


def test_router_origin_reply_echoes_sanitized_identity(pkg):
    router = pkg.rt.ReplicaRouter([]).start(probe=False)
    try:
        tp = f"00-{'c' * 32}-{'d' * 16}-01"
        code, body, hdrs = _req(router.port, "/predict", _BODY,
                                headers={"X-Request-Id": "rid-7",
                                         "traceparent": tp})
        assert code == 503
        assert body["reason"] == "no_replicas"
        assert body["retryable"] is True
        assert "Retry-After" in hdrs
        assert hdrs["X-Request-Id"] == "rid-7"
        assert hdrs["traceparent"] == tp
        code, _b, hdrs = _req(router.port, "/predict", _BODY,
                              headers={"traceparent": "garbage"})
        assert "traceparent" not in hdrs
        safe = pkg.obs.requests.safe_request_id
        assert safe("ok-id_1.2") == "ok-id_1.2"
        assert safe("bad id") is None
        assert safe("x" * 200) is None
    finally:
        _stop(router, [])


# -- debug & tooling surfaces ---------------------------------------------------

def test_debug_replicas_schema_and_stats_queue_depth(pkg):
    _preds, servers, pairs = _mk_fleet(pkg, 2)
    router = pkg.rt.ReplicaRouter(pairs).start(probe=False)
    try:
        code, view, _h = _req(router.port, "/debug/replicas")
        assert code == 200
        assert view["summary"] == {"total": 2, "in_rotation": 2,
                                   "ejected": 0, "deprioritized": 0,
                                   "sessions": 0, "prefix_pins": 0,
                                   "tenants": 0,
                                   "pools": {"prefill": 0, "decode": 0}}
        row = view["replicas"][0]
        for key in ("id", "url", "in_rotation", "deprioritized",
                    "reason", "consecutive_ok", "consecutive_fail",
                    "in_flight_router", "replica_in_flight",
                    "replica_queue_depth", "load_score",
                    "last_probe_age_s", "breaker", "ejections",
                    "served", "prefix_hit_rate", "role", "disagg"):
            assert key in row, key
        assert row["breaker"]["state"] == "closed"
        code, st, _h = _req(servers[0].port, "/stats")
        assert code == 200 and st["queue_depth"] == 0
        code, body, _h = _req(router.port, "/debug/autopilot")
        assert code == 404 and body == {"error": "no autopilot attached"}
    finally:
        _stop(router, servers)


def test_router_metrics_endpoint_and_status_tool(pkg):
    """/metrics carries the router.* family, and tools/router_status.py
    (a stdlib client of neither package) renders either router's view."""
    _preds, servers, pairs = _mk_fleet(pkg, 1)
    router = pkg.rt.ReplicaRouter(pairs).start(probe=False)
    try:
        _req(router.port, "/predict", _BODY)
        _wait_for(lambda: router.stats()["requests"].get("ok") == 1,
                  what="ok outcome counted")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{router.port}/metrics",
                timeout=30) as resp:
            text = resp.read().decode()
        assert 'paddle_tpu_router_requests_total{outcome="ok"} 1' in text
        assert "paddle_tpu_router_replicas_in_rotation 1" in text
        out = render(fetch(f"127.0.0.1:{router.port}"))
        assert "r0" in out and "in rotation" in out
        assert "requests: {'ok': 1}" in out
        assert "replicas:" in render({"replicas": [], "summary": None})
    finally:
        _stop(router, servers)


# -- deadline budget across the hop ---------------------------------------------

class _HeaderEchoStub:
    """Raw one-shot HTTP replica recording the X-Timeout-Ms it was
    forwarded (a real PredictorServer consumes the header before any
    test-visible surface)."""

    def __init__(self):
        self.seen = {}
        self.got = threading.Event()
        self._sock = socket.socket()
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(4)
        self.port = self._sock.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        while True:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return              # stop() shut the listener
            with conn:
                data = b""
                while b"\r\n\r\n" not in data:
                    chunk = conn.recv(4096)
                    if not chunk:
                        break
                    data += chunk
                lines = data.split(b"\r\n\r\n", 1)[0].decode().split("\r\n")
                post = bool(lines) and lines[0].startswith("POST")
                if post:
                    for line in lines[1:]:
                        k, _, v = line.partition(": ")
                        self.seen[k] = v
                body = b'{"outputs": {}}'
                conn.sendall(b"HTTP/1.1 200 OK\r\nConnection: close\r\n"
                             b"Content-Type: application/json\r\n"
                             + f"Content-Length: {len(body)}\r\n\r\n"
                             .encode() + body)
                if post:
                    self.got.set()

    def stop(self):
        # shutdown() wakes the thread blocked in accept(); close() alone
        # does not
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._thread.join(timeout=5)
        assert not self._thread.is_alive()


def test_forwarded_deadline_budget_is_decremented_not_restarted(pkg):
    stub = _HeaderEchoStub()
    router = pkg.rt.ReplicaRouter([("s0", f"127.0.0.1:{stub.port}")])
    try:
        router.start(probe=False)
        assert router.replica("s0").in_rotation
        code, _b, _h = _req(router.port, "/predict", _BODY,
                            headers={"X-Timeout-Ms": "5000"})
        assert code == 200 and stub.got.wait(timeout=10)
        fwd = float(stub.seen["X-Timeout-Ms"])
        assert 4000.0 < fwd < 5000.0
    finally:
        _stop(router, [stub])


def test_deadline_exhausted_during_failover_is_typed_504(pkg):
    release = threading.Event()
    _p, servers, pairs = _mk_fleet(pkg, 1, preds=[_Pred(block=release)],
                                   max_concurrent=1, max_queue_depth=0)
    policy, _slept = _no_sleep_policy(pkg)
    router = pkg.rt.ReplicaRouter(pairs, retry_policy=policy,
                                  shed_rounds=3).start(probe=False)
    try:
        t = _occupy(servers[0].port)
        _wait_for(lambda: servers[0].admission.in_flight == 1,
                  what="replica saturated")
        code, body, _h = _req(router.port, "/predict", _BODY,
                              headers={"X-Timeout-Ms": "1"})
        assert code == 504
        assert body["reason"] == "deadline_exceeded"
        assert body["retryable"] is False
        assert router.stats()["requests"]["deadline_exceeded"] == 1
        release.set()
        t.join(timeout=10)
    finally:
        release.set()
        _stop(router, servers)


def test_replica_url_validation_and_fresh_replicas_not_ejected(pkg):
    with pytest.raises(ValueError, match="bare host:port"):
        pkg.rt.ReplicaRouter([("r0", "http://10.0.0.1:8866")])
    with pytest.raises(ValueError, match="bare host:port"):
        pkg.rt.ReplicaRouter(["hostwithoutport"])
    router = pkg.rt.ReplicaRouter([("r0", "127.0.0.1:1")])
    try:
        router.probe_all()
        assert router.metrics.gauge("router.replicas.ejected").value() == 0.0
        assert router.debug_replicas()["summary"]["ejected"] == 0
        assert not router.replica("r0").in_rotation
        with pytest.raises(ValueError, match="already registered"):
            router.add_replica("127.0.0.1:2", rid="r0")
        with pytest.raises(ValueError, match="role must be"):
            router.add_replica("127.0.0.1:2", rid="r9", role="both")
    finally:
        router.stop()


# -- jitter ---------------------------------------------------------------------

def test_retry_after_jitter_seeded_deterministic_and_bounded(pkg):
    pkg.ovl.seed_retry_jitter(7)
    exp = random.Random(7)
    vals = [pkg.ovl.jittered_retry_after(2.0) for _ in range(5)]
    assert vals == [exp.uniform(1.5, 2.5) for _ in range(5)]
    assert all(1.5 <= v <= 2.5 for v in vals)
    assert len(set(vals)) > 1
    assert pkg.ovl.jittered_retry_after(None) is None
    assert pkg.ovl.jittered_retry_after(0.01) == pytest.approx(0.05)


def test_serving_emits_jittered_retry_after(pkg):
    srv = pkg.srv.PredictorServer(_Pred(), max_concurrent=0,
                                  max_queue_depth=4).start()
    try:
        pkg.ovl.seed_retry_jitter(11)
        exp = random.Random(11)
        code, body, hdrs = _req(srv.port, "/readyz")
        assert code == 503 and body["reason"] == "saturated"
        want = exp.uniform(0.75, 1.25)
        assert body["retry_after_s"] == pytest.approx(round(want, 3))
        assert int(hdrs["Retry-After"]) == max(1, int(np.ceil(want)))
    finally:
        srv.stop()


def test_retry_policy_full_jitter_deterministic(pkg):
    p = pkg.retries.RetryPolicy(base_delay=0.1, max_delay=1.0,
                                multiplier=2.0, jitter="full",
                                rng=random.Random(3))
    exp = random.Random(3)
    gen = p.delays()
    got = [next(gen) for _ in range(4)]
    want = [exp.uniform(0.0, c) for c in (0.1, 0.2, 0.4, 0.8)]
    assert got == want
    assert all(0.0 <= d <= c for d, c in zip(got, (0.1, 0.2, 0.4, 0.8)))
    gen = pkg.retries.RetryPolicy(base_delay=0.05).delays()
    assert [next(gen) for _ in range(3)] == [0.05, 0.1, 0.2]


# -- replica removal purges pins ------------------------------------------------

def test_remove_replica_purges_pins_and_resets_breaker(pkg):
    _preds, servers, pairs = _mk_fleet(pkg, 2)
    router = pkg.rt.ReplicaRouter(pairs).start(probe=False)
    try:
        hdr = {"X-Session-Id": "sess-1"}
        code, _b, hdrs = _req(router.port, "/predict", _BODY, headers=hdr)
        assert code == 200
        home = hdrs["X-Routed-To"]
        assert router._affinity["sess-1"] == home
        with router._lock:
            router._prefix[("k", 0)] = home
            router._prefix_decode[("k", 1)] = home
        before_aff = router.metrics.counter("router.affinity.rebinds").value()
        before_pfx = router.metrics.counter("router.prefix.rebinds").value()
        rep = router.replica(home)
        for _ in range(rep.breaker.failure_threshold):
            rep.breaker.record_failure()
        assert rep.breaker.state != "closed"
        assert router.remove_replica(home) is True
        assert router.remove_replica(home) is False
        assert "sess-1" not in router._affinity
        assert ("k", 0) not in router._prefix
        assert ("k", 1) not in router._prefix_decode
        assert router.metrics.counter(
            "router.affinity.rebinds").value() == before_aff + 1
        assert router.metrics.counter(
            "router.prefix.rebinds").value() == before_pfx + 1
        router.add_replica(dict(pairs)[home], rid=home)
        assert router.replica(home).breaker.state == "closed"
        router.probe_all()
        assert router.replica(home).in_rotation
        code, _b, hdrs = _req(router.port, "/predict", _BODY, headers=hdr)
        assert code == 200
        assert router._affinity["sess-1"] == hdrs["X-Routed-To"]
        assert router.metrics.counter(
            "router.affinity.rebinds").value() == before_aff + 1
    finally:
        _stop(router, servers)


# -- catalogue pins -------------------------------------------------------------

def test_router_chaos_sites_registered(pkg):
    for site in ("router.probe.delay", "router.probe.flap",
                 "router.connect.fail", "router.replica.kill",
                 "router.prefix.scramble", "disagg.transfer.fail",
                 "disagg.transfer.delay"):
        assert site in pkg.chaos.POINTS, site


def test_router_metrics_catalogued_both_directions(pkg):
    """Every inc/observe/set_gauge literal in the package's router.py is
    catalogued, and every catalogued router.* instrument is recorded by a
    literal call site there."""
    metrics = pkg.obs.metrics.METRICS
    with open(pkg.src) as f:
        tree = ast.parse(f.read())
    seen = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("inc", "observe", "set_gauge",
                                       "counter", "gauge", "histogram"):
            arg = node.args[0]
            if node.func.attr in ("inc", "observe", "set_gauge"):
                assert isinstance(arg, ast.Constant) and \
                    isinstance(arg.value, str), \
                    f"non-literal metric name at router.py:{node.lineno}"
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                assert arg.value in metrics, arg.value
                seen.add(arg.value)
    missing = {n for n in metrics if n.startswith("router.")} - seen
    assert not missing, f"catalogued but never recorded: {missing}"


# -- lifecycle ------------------------------------------------------------------

def test_router_stop_joins_threads(pkg):
    router = pkg.rt.ReplicaRouter([]).start()      # with the prober thread
    router.stop()
    assert router._probe_thread is None
    assert router._thread is None


# -- the chaos soak -------------------------------------------------------------

def test_chaos_soak_kill_replica_mid_stream(pkg):
    """3 replicas serve concurrent token streams; `router.replica.kill`
    tears one down right after it relayed a token. Every request either
    completes on a survivor or fails with a typed retryable status, none
    hangs, and the killed replica, restarted, re-enters rotation after K
    clean probes."""
    TOKENS, CLIENTS, REENTER = 4, 6, 2
    sources = [_GatedSource(TOKENS) for _ in range(3)]
    _preds, servers, pairs = _mk_fleet(pkg, 3, gens=sources)
    ports = [s.port for s in servers]
    policy, _slept = _no_sleep_policy(pkg)
    router = pkg.rt.ReplicaRouter(pairs, eject_after=1,
                                  reenter_probes=REENTER,
                                  retry_policy=policy)
    kill_done = threading.Event()
    killed_rid = {}

    def kill_hook(rid):
        i = int(rid[1:])
        killed_rid["rid"] = rid
        sources[i].killed.set()
        sources[i].gate.set()
        servers[i].stop()
        kill_done.set()

    router.kill_hook = kill_hook
    router.start(probe=False)
    results = [None] * CLIENTS

    def client(i):
        try:
            status, lines, _h = _stream(router.port,
                                        {"ids": [[1, 2]],
                                         "max_new_tokens": TOKENS})
            results[i] = ("stream", status, lines)
        except urllib.error.HTTPError as e:
            raw = e.read()
            results[i] = ("http_error", e.code,
                          json.loads(raw) if raw else {})
        except Exception as e:      # noqa: BLE001 — recorded for the assert below
            results[i] = ("exception", None, repr(e))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(CLIENTS)]
    try:
        with pkg.chaos.scoped(seed=42,
                              rates={"router.replica.kill": (1.0, 1)}):
            for t in threads:
                t.start()
            assert kill_done.wait(timeout=30), "kill site never fired"
            for s in sources:
                s.gate.set()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads), "a client hung"
            assert pkg.chaos.fire_count("router.replica.kill") == 1
        rid = killed_rid["rid"]
        completed = failed_typed = 0
        for kind, status, payload in results:
            assert kind != "exception", payload
            if kind == "http_error":
                assert status in (429, 503), (status, payload)
                assert payload.get("retryable") is True \
                    or "error" in payload, payload
                failed_typed += 1
                continue
            assert status == 200
            last = payload[-1]
            if last.get("done"):
                toks = [ln["tokens"][0] for ln in payload if "tokens" in ln]
                assert toks == list(range(TOKENS)), payload
                completed += 1
            else:
                assert last.get("retryable") is True, payload
                assert last.get("reason") == "replica_failed", payload
                assert last.get("replica") == rid
                failed_typed += 1
        assert completed + failed_typed == CLIENTS
        assert completed >= 1 and failed_typed >= 1
        router.probe_all()
        assert not router.replica(rid).in_rotation
        for _ in range(4):
            code, _b, hdrs = _req(router.port, "/predict", _BODY)
            assert code == 200 and hdrs["X-Routed-To"] != rid
        i = int(rid[1:])
        servers[i] = pkg.srv.PredictorServer(
            _Pred(), model_name=rid, generator=_GatedSource(TOKENS),
            port=ports[i]).start()
        br = router.replica(rid).breaker
        with br._lock:
            br._changed_at -= 1000.0
        for k in range(REENTER - 1):
            router.probe_all()
            assert not router.replica(rid).in_rotation, \
                f"re-entered after only {k + 1} probes"
        router.probe_all()
        assert router.replica(rid).in_rotation
        assert router.metrics.counter("router.reentries").value() >= 1
        others = {r for r, _u in pairs} - {rid}
        picked = router._pick(others, None)
        assert picked is not None and picked.rid == rid
        code, _b, _h = _req(router.port, "/predict", _BODY)
        assert code == 200
    finally:
        for s in sources:
            s.gate.set()
        _stop(router, servers)


# -- one script, both packages ----------------------------------------------------

_PROMPT = list(range(1, 10))        # 2 shareable pages of 4


def _script(p):
    """A fixed request script over a two-replica fleet of one package;
    returns its transcript, the router's counters and its replica view."""
    preds = [_SwitchPred(), _SwitchPred()]
    sources = [_GatedSource(4), _GatedSource(4)]
    for s in sources:
        s.gate.set()
    servers = [p.srv.PredictorServer(
        preds[i], model_name=f"r{i}", generator=sources[i],
        max_concurrent=1, max_queue_depth=0).start() for i in range(2)]
    pairs = [(f"r{i}", f"127.0.0.1:{s.port}") for i, s in enumerate(servers)]
    policy, slept = _no_sleep_policy(p, seed=1)

    def kill_hook(rid):
        i = int(rid[1:])
        sources[i].killed.set()
        sources[i].gate.set()
        servers[i].stop()

    router = p.rt.ReplicaRouter(pairs, retry_policy=policy, eject_after=2,
                                reenter_probes=2, prefix_page_size=4,
                                kill_hook=kill_hook).start(probe=False)
    p.ovl.seed_retry_jitter(5)
    log, routed = [], [0]

    def rec(tag, res):
        status, body, hdrs = res
        log.append((tag, status, body, hdrs.get("X-Routed-To"),
                    hdrs.get("Retry-After")))
        routed[0] += 1

    def rotation():
        return [router.replica(r).in_rotation for r in ("r0", "r1")]

    held = []
    try:
        for _ in range(2):
            rec("predict", _req(router.port, "/predict", _BODY))
        for _ in range(2):
            rec("prefix", _req(router.port, "/generate",
                               {"ids": [_PROMPT], "max_new_tokens": 3}))
        for _ in range(2):
            rec("session", _req(router.port, "/predict", _BODY,
                                headers={"X-Session-Id": "s1"}))
        # one replica saturated: the router fails over on its shed
        preds[0].hold.set()
        held.append(_occupy(servers[0].port))
        _wait_for(lambda: servers[0].admission.in_flight == 1,
                  what="r0 saturated")
        for _ in range(2):
            rec("one_shed", _req(router.port, "/predict", _BODY))
        # both saturated: a backoff, a second round, the shed relayed
        preds[1].hold.set()
        held.append(_occupy(servers[1].port))
        _wait_for(lambda: servers[1].admission.in_flight == 1,
                  what="r1 saturated")
        rec("all_shed", _req(router.port, "/predict", _BODY))
        for pr in preds:
            pr.release.set()
        for t in held:
            t.join(timeout=10)
        for pr in preds:
            pr.hold.clear()
        with p.chaos.scoped(seed=2, rates={"router.connect.fail": (1.0, 1)}):
            rec("connect_fail", _req(router.port, "/predict", _BODY))
        servers[1]._draining = True
        router.probe_all()
        log.append(("drain_probe", rotation()))
        rec("draining", _req(router.port, "/predict", _BODY))
        servers[1]._draining = False
        with p.chaos.scoped(seed=3, rates={"router.probe.flap": (1.0, 2)}):
            for _ in range(3):
                router.probe_all()
                log.append(("flap_probe", rotation()))
        for s in sources:
            s.gate.clear()
        with p.chaos.scoped(seed=4, rates={"router.replica.kill": (1.0, 1)}):
            rec("kill", _stream(router.port, {"ids": [[1, 2]],
                                              "max_new_tokens": 4}))
        router.probe_all()
        log.append(("kill_probe", rotation()))
        for _ in range(2):
            rec("after_kill", _req(router.port, "/predict", _BODY))
        _wait_for(lambda: sum(router.stats()["requests"].values())
                  == routed[0], what="every outcome counted")
        snap = router.metrics.snapshot()
        counters = {
            name: [(s["labels"], s.get("value", s.get("count")))
                   for s in v["series"]]
            for name, v in sorted(snap.items()) if name.startswith("router.")}
        view = router.debug_replicas()
        for row in view["replicas"]:
            row["url"] = row["url"].rpartition(":")[0]
            row["last_probe_age_s"] = None
        return dict(log=log, slept=slept, counters=counters, view=view,
                    stats=router.stats(), render=render(view))
    finally:
        for pr in preds:
            pr.release.set()
        for s in sources:
            s.gate.set()
        _stop(router, servers)


def test_same_script_same_transcript_counters_and_replica_view():
    res = {name: _script(p) for name, p in PACKAGES.items()}
    j, t = res["jax"], res["port"]
    assert t["log"] == j["log"]
    assert t["slept"] == j["slept"]
    assert t["counters"] == j["counters"]
    assert t["view"] == j["view"]
    assert t["stats"] == j["stats"]
    assert t["render"] == j["render"]
    # and what the script exercised
    steps = {}
    for entry in t["log"]:
        steps.setdefault(entry[0], []).append(entry[1:])
    assert [s[0] for s in steps["predict"]] == [200, 200]
    assert {s[2] for s in steps["predict"]} == {"r0", "r1"}
    assert steps["prefix"][0][2] == steps["prefix"][1][2]
    assert steps["session"][0][2] == steps["session"][1][2]
    assert [s[0] for s in steps["one_shed"]] == [200, 200]
    assert steps["all_shed"][0][0] == 429 and steps["all_shed"][0][3]
    assert steps["connect_fail"][0][0] == 200
    assert steps["drain_probe"] == [([True, False],)]
    assert steps["draining"][0][2] == "r0"
    assert [s[0] for s in steps["flap_probe"]] == [[True, False],
                                                   [True, False],
                                                   [True, True]]
    status, lines, killed = steps["kill"][0][:3]
    assert status == 200 and "tokens" in lines[0]
    assert lines[-1]["reason"] == "replica_failed"
    assert lines[-1]["retryable"] is True and lines[-1]["replica"] == killed
    assert {s[2] for s in steps["after_kill"]} == {"r0", "r1"} - {killed}
    c = dict((k, dict((tuple(sorted(lab.items())), v) for lab, v in s))
             for k, s in t["counters"].items())
    assert c["router.prefix.hits"][()] == 1
    assert c["router.retries"][(("kind", "shed"),)] >= 3
    assert c["router.retries"][(("kind", "connect"),)] == 1
    assert c["router.probes"][(("result", "flap"),)] == 2
    assert c["router.ejections"][(("reason", "draining"),)] == 1
    assert c["router.reentries"][()] == 1
    assert len(t["slept"]) == 1 and t["slept"][0] >= 1.0


# -- retries.py -------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 11])
def test_retry_policy_delays_and_run_equal_the_jax_modules(seed):
    """The same policy and seeded rng give the same delays in both
    packages, and `run` the same attempts, sleeps, on_retry calls and
    final error."""
    out = {}
    for name, mod in (("jax", j_retries), ("port", t_retries)):
        slept, retried, calls = [], [], []

        def flaky():
            calls.append(1)
            raise ConnectionError(f"drop {len(calls)}")
        p = mod.RetryPolicy(max_attempts=4, base_delay=0.1, max_delay=0.3,
                            jitter="full", rng=random.Random(seed),
                            sleep=slept.append)
        gen = mod.RetryPolicy(jitter="full", rng=random.Random(seed)).delays()
        delays = [next(gen) for _ in range(6)]
        with pytest.raises(mod.RetryBudgetExceeded) as ei:
            p.run(flaky, on_retry=lambda a, e: retried.append((a, str(e))))
        ok = mod.RetryPolicy(sleep=slept.append)(lambda x: x + 1)(41)
        with pytest.raises(ValueError):      # not retryable: one throw
            p.run(lambda: (_ for _ in ()).throw(ValueError("fatal")))
        out[name] = (delays, slept, retried, len(calls), str(ei.value.last),
                     isinstance(ei.value.__cause__, ConnectionError), ok)
    assert out["port"] == out["jax"]
    assert out["port"][3] == 4 and out["port"][6] == 42


def test_default_policy_reads_no_environment(monkeypatch):
    """The JAX module's PADDLE_TPU_RETRY_* variables set its defaults;
    the port's default_policy takes the module constants and overrides
    only."""
    monkeypatch.setenv("PADDLE_TPU_RETRY_MAX_ATTEMPTS", "9")
    monkeypatch.setenv("PADDLE_TPU_RETRY_DEADLINE_S", "1.5")
    assert j_retries.default_policy().max_attempts == 9
    p = t_retries.default_policy()
    assert p.max_attempts == t_retries.DEFAULT_MAX_ATTEMPTS == 3
    assert p.deadline is t_retries.DEFAULT_DEADLINE_S is None
    assert t_retries.default_policy(max_attempts=5,
                                    deadline=2.0).deadline == 2.0
    monkeypatch.delenv("PADDLE_TPU_RETRY_MAX_ATTEMPTS")
    monkeypatch.delenv("PADDLE_TPU_RETRY_DEADLINE_S")
    fields = ("max_attempts", "deadline", "base_delay", "max_delay",
              "multiplier", "retryable", "jitter", "rng", "sleep")
    assert [getattr(t_retries.default_policy(), f) for f in fields] == \
        [getattr(j_retries.default_policy(), f) for f in fields]


@pytest.mark.parametrize("mod", [t_router, t_retries])
def test_router_and_retries_read_no_environment(mod):
    """Neither module touches os.environ / os.getenv (the port is switched
    in-process only); the JAX router's retries module does."""
    with open(mod.__file__) as f:
        tree = ast.parse(f.read())
    names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    imported = {a.name for n in ast.walk(tree)
                if isinstance(n, (ast.Import, ast.ImportFrom))
                for a in n.names}
    assert not ({"environ", "getenv", "putenv"} & (names | imported))
    assert "os" not in imported
    with open(j_retries.__file__) as f:
        assert "os.environ" in f.read()


def test_retry_counters_land_in_the_ports_registry():
    t_obs.enable(reset=True)
    p = t_retries.RetryPolicy(max_attempts=3, sleep=lambda s: None)
    with pytest.raises(t_retries.RetryBudgetExceeded):
        p.run(lambda: (_ for _ in ()).throw(TimeoutError("t")))
    assert t_obs.REGISTRY.counter("retry.attempts").value() == 2
    assert t_obs.REGISTRY.counter("retry.exhausted").value() == 1
    assert j_obs.REGISTRY.counter("retry.attempts").value() == 0
