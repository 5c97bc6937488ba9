"""The port's HTTP serving front end (paddle_tpu_torch/inference/serving.py
and the rest of overload.py) against the JAX package's, on the CPU.

Every scenario of tests/test_serving_overload.py, the PredictorServer /
DynamicBatcher tests of tests/test_rpc_serving.py (over numpy predictors:
the port has no exported-program Predictor) and the model-free HTTP
tests of tests/test_request_tracing.py run over both packages (the `pkg`
fixture, one server per package), with the JAX tests' status codes,
bodies and headers. Beside them, a fixed request script gets the same
transcript (status, body, Retry-After) from both servers after the same
`seed_retry_jitter` seed, and the overload primitives give the same
jittered values. Predictors and token sources are plain numpy objects,
event-controlled; chaos faults are seeded. Every HTTP call has a client
timeout and every server is stopped in a `finally`.
"""
import http.client
import json
import socket
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu.inference.overload as j_overload
import paddle_tpu.inference.serving as j_serving
import paddle_tpu_torch.inference.overload as t_overload
import paddle_tpu_torch.inference.serving as t_serving
from paddle_tpu import observability as j_obs
from paddle_tpu.distributed import chaos as j_chaos
from paddle_tpu_torch import observability as t_obs
from paddle_tpu_torch.distributed import chaos as t_chaos

from conftest import wait_for as _wait_for

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

PACKAGES = {
    "jax": types.SimpleNamespace(chaos=j_chaos, ovl=j_overload,
                                 srv=j_serving, obs=j_obs,
                                 req=j_obs.requests),
    "port": types.SimpleNamespace(chaos=t_chaos, ovl=t_overload,
                                  srv=t_serving, obs=t_obs,
                                  req=t_obs.requests)}
_TP = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
_TRACE_ID = "ab" * 16
_ONE_ROW = {"x0": [[1.0, 2.0]]}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """One package's chaos, overload, serving and observability."""
    return PACKAGES[request.param]


@pytest.fixture(autouse=True)
def _clean_slate():
    for p in PACKAGES.values():
        p.obs.disable()
        p.obs.REGISTRY.reset()
        p.obs.trace.clear()
        p.req.clear()
        p.chaos.disable()
    yield
    for p in PACKAGES.values():
        p.obs.disable()
        p.obs.REGISTRY.reset()
        p.obs.trace.clear()
        p.req.clear()
        p.chaos.disable()
        p.ovl.seed_retry_jitter(None)


# -- helpers (tests/test_serving_overload.py) -----------------------------------

def _req(port, path, obj=None, headers=None, data=None):
    """(status, body_dict, headers_dict) for one HTTP round trip."""
    url = f"http://127.0.0.1:{port}{path}"
    if obj is not None:
        data = json.dumps(obj).encode()
    r = urllib.request.Request(url, data=data,
                               headers={"Content-Type": "application/json",
                                        **(headers or {})})
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, json.loads(body) if body else {}, dict(e.headers)


def _post_bg(port, path, obj, headers=None):
    out = {}

    def go():
        try:
            out["resp"] = _req(port, path, obj, headers)
        except Exception as e:      # noqa: BLE001
            out["error"] = e
    t = threading.Thread(target=go, daemon=True)
    t.start()
    return t, out


def _elapse_cooldown(breaker, seconds=1000.0):
    with breaker._lock:
        breaker._changed_at -= seconds


class _CountingCallable:
    """Plain dict->dict predictor (solo path, no batcher)."""

    def __init__(self, block=None):
        self.calls = 0
        self.block = block

    def __call__(self, inputs):
        self.calls += 1
        if self.block is not None:
            assert self.block.wait(timeout=30)
        return {"y": np.asarray([[2.0]], np.float32)}


class _RunPredictor:
    """run(list)->list predictor with a fixed leading dim."""

    def __init__(self, dim=4, started=None, release=None):
        self.dim = dim
        self.calls = 0
        self.started = started
        self.release = release

    def get_input_names(self):
        return ["x0"]

    def get_output_names(self):
        return ["out0"]

    def input_shapes(self):
        return [(self.dim, 2)]

    def run(self, arrays):
        self.calls += 1
        if self.started is not None:
            self.started.set()
        if self.release is not None:
            assert self.release.wait(timeout=30)
        return [np.asarray(arrays[0]) * 2.0]


class _Linear:
    """A run(list)->list predictor computing x @ w + b at a fixed batch
    (the dynamic-batching end-to-end of tests/test_rpc_serving.py)."""

    def __init__(self, dim=8):
        rng = np.random.RandomState(0)
        self.w = rng.randn(4, 2).astype(np.float32)
        self.b = rng.randn(2).astype(np.float32)
        self.dim = dim

    def get_input_names(self):
        return ["x0"]

    def get_output_names(self):
        return ["out0"]

    def input_shapes(self):
        return [(self.dim, 4)]

    def run(self, arrays):
        assert arrays[0].shape[0] == self.dim
        return [arrays[0] @ self.w + self.b]


# -- circuit breaker through HTTP (chaos-driven) --------------------------------

def test_breaker_opens_fast_fails_and_recloses(pkg):
    pred = _CountingCallable()
    srv = pkg.srv.PredictorServer(pred, breaker_threshold=3,
                                  breaker_reset_s=1000.0).start()
    try:
        with pkg.chaos.scoped(seed=7, rates={"serving.run.fail": (1.0, 3)}):
            for _ in range(3):
                code, body, _h = _req(srv.port, "/predict",
                                      {"inputs": _ONE_ROW})
                assert code == 500
                assert "injected predictor run failure" in body["error"]
            assert pred.calls == 0
            code, body, hdrs = _req(srv.port, "/predict",
                                    {"inputs": _ONE_ROW})
            assert code == 503 and "circuit breaker" in body["error"]
            assert "Retry-After" in hdrs
            assert pred.calls == 0
            code, body, _h = _req(srv.port, "/healthz")
            assert code == 200
            code, body, hdrs = _req(srv.port, "/readyz")
            assert code == 503 and body["reason"].startswith("breaker_")
            assert "Retry-After" in hdrs
            _elapse_cooldown(srv.breaker)
            code, body, _h = _req(srv.port, "/predict",
                                  {"inputs": _ONE_ROW})
            assert code == 200 and pred.calls == 1
        _wait_for(lambda: srv.breaker.state == pkg.ovl.CircuitBreaker.CLOSED,
                  what="breaker reclose")
        code, body, _h = _req(srv.port, "/readyz")
        assert code == 200 and body["status"] == "ready"
        st = srv.stats()
        assert st["breaker"]["state"] == "closed"
        assert st["breaker"]["opens"] == 1
        assert st["breaker"]["recloses"] == 1
        assert st["requests"]["server_error"] == 3
        assert st["requests"]["shed_breaker"] == 1
        assert st["requests"]["ok"] >= 1
    finally:
        srv.stop()


def test_breaker_not_tripped_by_client_errors(pkg):
    srv = pkg.srv.PredictorServer(_CountingCallable(),
                                  breaker_threshold=2).start()
    try:
        for _ in range(4):
            code, _b, _h = _req(srv.port, "/predict",
                                {"inputs": {"x": {"dtype": "float32"}}})
            assert code == 400
        assert srv.breaker.state == pkg.ovl.CircuitBreaker.CLOSED
        code, _b, _h = _req(srv.port, "/predict", {"inputs": _ONE_ROW})
        assert code == 200
    finally:
        srv.stop()


# -- admission / saturation ------------------------------------------------------

def test_saturated_admission_sheds_429_with_retry_after(pkg):
    release = threading.Event()
    pred = _CountingCallable(block=release)
    srv = pkg.srv.PredictorServer(pred, max_concurrent=1,
                                  max_queue_depth=0).start()
    try:
        t, out = _post_bg(srv.port, "/predict", {"inputs": _ONE_ROW})
        _wait_for(lambda: srv.admission.in_flight == 1,
                  what="first request in flight")
        code, body, _h = _req(srv.port, "/readyz")
        assert code == 503 and body["reason"] == "saturated"
        code, body, hdrs = _req(srv.port, "/predict", {"inputs": _ONE_ROW})
        assert code == 429
        assert "admission rejected" in body["error"]
        assert "Retry-After" in hdrs
        release.set()
        t.join(timeout=10)
        assert out["resp"][0] == 200
        assert srv.stats()["requests"]["shed_admission"] == 1
        # the handler releases its admission just after the reply
        _wait_for(lambda: srv.admission.in_flight == 0, what="released")
        code, _b, _h = _req(srv.port, "/readyz")
        assert code == 200
    finally:
        release.set()
        srv.stop()


def test_deadline_expired_at_admission_is_504_chaos_driven(pkg):
    srv = pkg.srv.PredictorServer(_CountingCallable()).start()
    try:
        with pkg.chaos.scoped(seed=3, rates={"serving.admit.delay": 1.0},
                              delay_ms=60):
            code, body, _h = _req(srv.port, "/predict",
                                  {"inputs": _ONE_ROW},
                                  headers={"X-Timeout-Ms": "20"})
        assert code == 504 and "deadline exceeded" in body["error"]
        assert srv.stats()["requests"]["deadline_exceeded"] == 1
    finally:
        srv.stop()


def test_timeout_ms_body_field_and_validation(pkg):
    srv = pkg.srv.PredictorServer(_CountingCallable()).start()
    try:
        code, _b, _h = _req(srv.port, "/predict",
                            {"inputs": _ONE_ROW, "timeout_ms": 5000})
        assert code == 200
        code, body, _h = _req(srv.port, "/predict",
                              {"inputs": _ONE_ROW, "timeout_ms": -5})
        assert code == 400 and "timeout_ms" in body["error"]
        code, body, _h = _req(srv.port, "/predict",
                              {"inputs": _ONE_ROW, "timeout_ms": "nope"})
        assert code == 400
    finally:
        srv.stop()


# -- the batcher ----------------------------------------------------------------

def test_expired_in_batcher_queue_gets_504_and_no_batch_slot(pkg):
    started, release = threading.Event(), threading.Event()
    pred = _RunPredictor(dim=4, started=started, release=release)
    srv = pkg.srv.PredictorServer(pred, dynamic_batching=True,
                                  max_batch_size=4,
                                  batch_timeout_ms=1.0).start()
    try:
        t, out = _post_bg(srv.port, "/predict", {"inputs": _ONE_ROW})
        assert started.wait(timeout=10)
        code, body, _h = _req(srv.port, "/predict", {"inputs": _ONE_ROW},
                              headers={"X-Timeout-Ms": "40"})
        assert code == 504
        assert "queued for batching" in body["error"]
        assert pred.calls == 1
        release.set()
        t.join(timeout=10)
        assert out["resp"][0] == 200
        st = srv.stats()
        assert st["batcher"]["expired_in_queue"] == 1
        assert st["batcher"]["batches_run"] == 1
        assert pred.calls == 1
    finally:
        release.set()
        srv.stop()


def test_batcher_worker_skips_expired_requests(pkg):
    ran = []
    b = pkg.srv.DynamicBatcher(
        lambda arrays: (ran.append(len(arrays[0])), [arrays[0]])[1],
        max_batch=8, timeout_ms=1.0)
    try:
        p_dead = pkg.ovl.Deadline(time.monotonic() - 1.0)
        with pytest.raises(pkg.ovl.DeadlineExceeded):
            b.submit([np.ones((1, 2), np.float32)], deadline=p_dead)
        out = b.submit([np.ones((2, 2), np.float32)])
        assert np.asarray(out[0]).shape == (2, 2)
        assert ran == [2]
    finally:
        b.stop()


def test_batcher_bounded_queue_sheds(pkg):
    started, release = threading.Event(), threading.Event()

    def run_fn(arrays):
        started.set()
        assert release.wait(timeout=30)
        return [arrays[0]]

    b = pkg.srv.DynamicBatcher(run_fn, max_batch=1, timeout_ms=1.0,
                               max_queue=1)
    try:
        holders, threads = [{}, {}], []
        for h in holders:
            th = threading.Thread(
                target=lambda h=h: h.update(
                    r=b.submit([np.ones((1, 1), np.float32)])),
                daemon=True)
            th.start()
            threads.append(th)
            if len(threads) == 1:
                assert started.wait(timeout=10)
        _wait_for(lambda: len(b._buf) == 1, what="queued request")
        with pytest.raises(pkg.ovl.AdmissionRejected):
            b.submit([np.ones((1, 1), np.float32)])
        assert b.shed_full == 1
        release.set()
        for th in threads:
            th.join(timeout=10)
        assert all("r" in h for h in holders)
    finally:
        release.set()
        b.stop()


def test_batcher_failed_batch_chaos_fans_out(pkg):
    b = pkg.srv.DynamicBatcher(lambda arrays: [arrays[0]], max_batch=4,
                               timeout_ms=1.0)
    try:
        with pkg.chaos.scoped(rates={"serving.batch.fail": (1.0, 1)}):
            with pytest.raises(RuntimeError, match="injected batch"):
                b.submit([np.ones((1, 2), np.float32)])
            out = b.submit([np.ones((1, 2), np.float32)])
        assert np.asarray(out[0]).shape == (1, 2)
        assert b.batches_run == 1
    finally:
        b.stop()


def test_dynamic_batcher_coalesces_and_splits(pkg):
    calls = []

    def run_fn(arrays):
        calls.append(arrays[0].shape)
        return [arrays[0] * 2.0, arrays[0].sum(-1, keepdims=True)]

    b = pkg.srv.DynamicBatcher(run_fn, max_batch=8, timeout_ms=300.0)
    try:
        results = {}

        def client(i, rows, width):
            x = np.full((rows, width), float(i), "float32")
            results[i] = b.submit([x])

        ts = [threading.Thread(target=client, args=(i, 1, 4))
              for i in range(4)]
        ts += [threading.Thread(target=client, args=(10, 2, 6))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        for i in range(4):
            np.testing.assert_array_equal(results[i][0],
                                          np.full((1, 4), 2.0 * i))
            np.testing.assert_array_equal(results[i][1], [[4.0 * i]])
        np.testing.assert_array_equal(results[10][0], np.full((2, 6), 20.0))
        assert b.requests_served == 5
        assert b.batches_run < 5, (b.batches_run, calls)
        assert any(s[1] == 6 for s in calls) and \
            any(s[1] == 4 for s in calls)
    finally:
        b.stop()


def test_dynamic_batcher_error_propagates_to_all(pkg):
    def bad(arrays):
        raise RuntimeError("kaboom")

    b = pkg.srv.DynamicBatcher(bad, max_batch=4, timeout_ms=20.0)
    try:
        errs = []

        def client():
            try:
                b.submit([np.ones((1, 3), "float32")])
            except RuntimeError as e:
                errs.append(str(e))

        ts = [threading.Thread(target=client) for _ in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
        assert errs == ["kaboom"] * 3
    finally:
        b.stop()


def test_serving_dynamic_batching_end_to_end(pkg):
    pred = _Linear(dim=8)
    srv = pkg.srv.PredictorServer(pred, model_name="lin",
                                  dynamic_batching=True, max_batch_size=8,
                                  batch_timeout_ms=300).start()
    try:
        outs = {}

        def client(i):
            x = np.full((1, 4), float(i), "float32")
            outs[i] = _req(srv.port, "/predict", {"inputs": {"x0": {
                "data": x.tolist(), "dtype": "float32"}}})[1]["outputs"]

        ts = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert len(outs) == 6
        for i in range(6):
            got = np.asarray(outs[i]["out0"]["data"], "float32")
            exp = np.full((1, 4), float(i), "float32") @ pred.w + pred.b
            np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-6)
        assert srv.batcher.requests_served == 6
        assert srv.batcher.batches_run < 6
    finally:
        srv.stop()


def test_oversized_request_is_clear_400(pkg):
    pred = _RunPredictor(dim=2)
    srv = pkg.srv.PredictorServer(pred, dynamic_batching=True,
                                  max_batch_size=8).start()
    try:
        three_rows = {"x0": [[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]]}
        code, body, _h = _req(srv.port, "/predict", {"inputs": three_rows})
        assert code == 400
        assert "exceeds the exported leading dim 2" in body["error"]
        assert pred.calls == 0
        with pytest.raises(pkg.srv.OversizedBatch):
            srv._run_locked([np.zeros((3, 2), np.float32)])
    finally:
        srv.stop()


def test_batched_roundtrip_still_works(pkg):
    pred = _RunPredictor(dim=4)
    srv = pkg.srv.PredictorServer(pred, dynamic_batching=True,
                                  max_batch_size=8,
                                  batch_timeout_ms=1.0).start()
    try:
        code, body, _h = _req(srv.port, "/predict", {"inputs": _ONE_ROW})
        assert code == 200
        out = body["outputs"]["out0"]
        assert out["data"] == [[2.0, 4.0]]
        assert out["shape"] == [1, 2]
    finally:
        srv.stop()


# -- the plain predictor surface (tests/test_rpc_serving.py) --------------------

def test_serving_wrapper_end_to_end(pkg):
    rng = np.random.RandomState(0)
    w = rng.randn(4, 2).astype(np.float32)

    def mlp(inputs):
        return {"y": np.maximum(inputs["x"], 0.0) @ w}

    x = rng.randn(3, 4).astype("float32")
    srv = pkg.srv.PredictorServer(mlp, model_name="mlp").start()
    try:
        code, health, _h = _req(srv.port, "/health")
        assert code == 200 and health == {"status": "ok", "model": "mlp"}
        code, meta, _h = _req(srv.port, "/metadata")
        assert meta == {"inputs": [], "outputs": []}
        code, resp, _h = _req(srv.port, "/predict", {"inputs": {"x": {
            "data": x.tolist(), "dtype": "float32"}}})
        assert code == 200
        out = resp["outputs"]["y"]
        np.testing.assert_allclose(np.asarray(out["data"], "float32"),
                                   np.maximum(x, 0.0) @ w, rtol=1e-6)
        assert out["shape"] == [3, 2] and out["dtype"] == "float32"
        code, body, _h = _req(srv.port, "/predict", data=b"notjson")
        assert code == 400 and body["error"]
        code, body, _h = _req(srv.port, "/nope")
        assert code == 404
        code, body, _h = _req(srv.port, "/nope", {"x": 1})
        assert code == 404
        assert _req(srv.port, "/health")[1]["status"] == "ok"
    finally:
        srv.stop()


# -- graceful drain --------------------------------------------------------------

def test_drain_finishes_inflight_then_rejects_and_stops(pkg):
    release = threading.Event()
    pred = _CountingCallable(block=release)
    srv = pkg.srv.PredictorServer(pred).start()
    try:
        t, out = _post_bg(srv.port, "/predict", {"inputs": _ONE_ROW})
        _wait_for(lambda: srv.admission.in_flight == 1,
                  what="in-flight request")
        drained = {}
        dt = threading.Thread(
            target=lambda: drained.update(clean=srv.drain(timeout=20)),
            daemon=True)
        dt.start()
        _wait_for(lambda: srv._draining, what="draining flag")
        code, body, hdrs = _req(srv.port, "/predict", {"inputs": _ONE_ROW})
        assert code == 503 and "draining" in body["error"]
        assert "Retry-After" in hdrs
        code, body, _h = _req(srv.port, "/readyz")
        assert code == 503 and body["reason"] == "draining"
        release.set()
        t.join(timeout=10)
        assert out["resp"][0] == 200
        dt.join(timeout=20)
        assert drained["clean"] is True
        assert not srv._thread.is_alive()
    finally:
        release.set()
        if srv._thread.is_alive():
            srv.stop()


def test_second_drain_is_idempotent(pkg):
    srv = pkg.srv.PredictorServer(_CountingCallable()).start()
    assert srv.drain(timeout=5) is True
    assert srv.drain(timeout=5) is True
    assert srv._draining
    assert not srv._thread.is_alive()


def test_readyz_reason_taxonomy_with_warming(pkg):
    release = threading.Event()
    srv = pkg.srv.PredictorServer(_CountingCallable(block=release),
                                  max_concurrent=0, max_queue_depth=0,
                                  start_warming=True).start()
    try:
        code, body, _h = _req(srv.port, "/readyz")
        assert code == 503 and body["reason"] == "warming"
        assert srv.stats()["warming"] is True
        srv.mark_warm()
        code, body, _h = _req(srv.port, "/readyz")
        assert code == 503 and body["reason"] == "saturated"
        for _ in range(srv.breaker.failure_threshold):
            srv.breaker.record_failure()
        code, body, _h = _req(srv.port, "/readyz")
        assert code == 503 and body["reason"] == "breaker_open"
        srv.mark_warming()
        code, body, _h = _req(srv.port, "/readyz")
        assert code == 503 and body["reason"] == "warming"
        srv._draining = True
        code, body, _h = _req(srv.port, "/readyz")
        assert code == 503 and body["reason"] == "draining"
        srv._draining = False
    finally:
        release.set()
        srv.stop()


def test_warming_clears_on_first_completed_request(pkg):
    srv = pkg.srv.PredictorServer(_CountingCallable(),
                                  start_warming=True).start()
    try:
        code, body, _h = _req(srv.port, "/readyz")
        assert code == 503 and body["reason"] == "warming"
        code, _b, _h = _req(srv.port, "/predict", {"inputs": _ONE_ROW})
        assert code == 200
        _wait_for(lambda: not srv._warming, what="warming cleared")
        code, body, _h = _req(srv.port, "/readyz")
        assert code == 200 and body["status"] == "ready"
        assert srv.stats()["warming"] is False
    finally:
        srv.stop()


def test_healthz_readyz_stats_surfaces(pkg):
    srv = pkg.srv.PredictorServer(_CountingCallable(),
                                  model_name="m1").start()
    try:
        for path in ("/health", "/healthz"):
            code, body, _h = _req(srv.port, path)
            assert code == 200 and body["model"] == "m1"
        code, body, _h = _req(srv.port, "/readyz")
        assert code == 200 and body["status"] == "ready"
        code, _b, _h = _req(srv.port, "/predict", {"inputs": _ONE_ROW})
        assert code == 200
        _wait_for(lambda: srv.admission.in_flight == 0,
                  what="admission released")
        code, st, _h = _req(srv.port, "/stats")
        assert code == 200
        assert st["requests"]["total"] == 1
        assert st["requests"]["ok"] == 1
        assert st["in_flight"] == 0
        assert st["latency_ms"]["count"] == 1
        assert st["latency_ms"]["p50_ms"] is not None
        assert st["breaker"]["state"] == "closed"
        code, body, _h = _req(srv.port, "/debug/fleet")
        assert code == 200 and body == {"enabled": False, "view": None}
    finally:
        srv.stop()


def test_readyz_503_body_carries_numeric_load_fields(pkg):
    srv = pkg.srv.PredictorServer(_CountingCallable(),
                                  retry_after_s=2.5).start()
    try:
        srv._draining = True
        code, body, _h = _req(srv.port, "/readyz")
        assert code == 503
        assert body["reason"] == "draining"
        assert body["in_flight"] == 0
        assert body["queue_depth"] == 0
        assert 2.5 * 0.75 <= body["retry_after_s"] <= 2.5 * 1.25
        srv._draining = False
        code, body, _h = _req(srv.port, "/readyz")
        assert code == 200 and body["status"] == "ready"
    finally:
        srv.stop()


# -- streaming ----------------------------------------------------------------------

class _SlowTokenSource:
    def __init__(self):
        self.closed = threading.Event()
        self.produced = 0

    def stream(self, ids, **kw):
        src = self

        class _It:
            def __iter__(self):
                return self

            def __next__(self):
                if src.closed.is_set():
                    raise StopIteration
                src.produced += 1
                time.sleep(0.003)
                return np.asarray([7])

            def close(self):
                src.closed.set()
        return _It()


def test_generate_close_cancels_closes_source_and_frees_lock(pkg):
    gen = _SlowTokenSource()
    srv = pkg.srv.PredictorServer(_CountingCallable(), generator=gen)
    it = srv.generate_steps({"ids": [[1, 2]], "max_new_tokens": 10000})
    assert next(it)["tokens"] == [7]
    next(it)
    it.close()
    assert gen.closed.wait(timeout=10)
    assert srv._lock.acquire(timeout=10)
    srv._lock.release()
    srv.stop()


class _MidStreamFailSource:
    def stream(self, ids, **kw):
        def gen():
            yield np.asarray([1])
            yield np.asarray([2])
            raise RuntimeError("backend died mid-stream")
        return gen()


def test_mid_stream_backend_failure_reaches_the_breaker(pkg):
    srv = pkg.srv.PredictorServer(_CountingCallable(),
                                  generator=_MidStreamFailSource(),
                                  breaker_threshold=2).start()
    try:
        url = f"http://127.0.0.1:{srv.port}/generate"
        for _ in range(2):
            r = urllib.request.Request(
                url, data=json.dumps({"ids": [[1, 2]], "stream": True,
                                      "max_new_tokens": 5}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(r, timeout=30) as resp:
                assert resp.status == 200
                text = resp.read().decode()
            assert "backend died mid-stream" in text
        _wait_for(lambda: srv.breaker.state == pkg.ovl.CircuitBreaker.OPEN,
                  what="breaker trip")
        code, body, _h = _req(srv.port, "/predict", {"inputs": _ONE_ROW})
        assert code == 503 and "circuit breaker" in body["error"]
        assert srv.stats()["requests"]["server_error"] == 2
    finally:
        srv.stop()


def test_http_stream_client_disconnect_cancels_producer(pkg):
    gen = _SlowTokenSource()
    srv = pkg.srv.PredictorServer(_CountingCallable(), generator=gen).start()
    try:
        body = json.dumps({"ids": [[1, 2]], "max_new_tokens": 100000,
                           "stream": True}).encode()
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        s.sendall(b"POST /generate HTTP/1.1\r\n"
                  b"Host: x\r\nContent-Type: application/json\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        assert s.recv(1024)
        s.close()
        assert gen.closed.wait(timeout=30)
    finally:
        srv.stop()


def test_generate_without_stream_generator(pkg):
    """A generator without stream(): both servers hand it to their
    package's models/generation.generate_stream, which finds no model
    forward there: 500 with the same error."""
    class NoStream:
        pass

    srv = pkg.srv.PredictorServer(_CountingCallable(),
                                  generator=NoStream()).start()
    try:
        code, body, _h = _req(srv.port, "/generate",
                              {"ids": [[1, 2]], "max_new_tokens": 2})
        assert code == 500
        assert body["error"] == \
            "type object 'NoStream' has no attribute 'forward'"
        code, body, _h = _req(srv.port, "/generate",
                              {"ids": [[1, 2]], "max_new_tokens": 2})
        assert code == 500
    finally:
        srv.stop()
    srv = pkg.srv.PredictorServer(_CountingCallable()).start()
    try:
        code, body, _h = _req(srv.port, "/generate", {"ids": [[1]]})
        assert code == 400 and "no generator" in body["error"]
        code, body, _h = _req(srv.port, "/kv/pull", {"keys": ["a"]})
        assert code == 404 and "disagg" in body["error"]
    finally:
        srv.stop()


# -- a CausalLM generator (models/generation.py) ----------------------------------

@pytest.fixture(scope="module")
def llamas():
    """{"jax": JAX tiny Llama, "port": the port's with its weights}."""
    import paddle_tpu
    from paddle_tpu.models import llama as jllama
    from paddle_tpu_torch.models import llama as tllama
    from paddle_tpu_torch.models.convert import from_paddle_tpu_state
    paddle_tpu.seed(0)
    kw = dict(num_hidden_layers=2, fused_norm=True, fused_rope=True)
    jm = jllama.LlamaForCausalLM(jllama.tiny_llama_config(**kw))
    jm.eval()
    cfg = tllama.tiny_llama_config(**kw)
    tm = tllama.LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(from_paddle_tpu_state(
        {k: np.asarray(v._value) for k, v in jm.state_dict().items()}, cfg))
    return {"jax": jm, "port": tm}


def _gen_ids(b=2, s=8):
    return np.random.RandomState(0).randint(0, 256, (b, s)).astype("int32")


def _post_lines(port, obj):
    """The ndjson lines of one streamed /generate."""
    r = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=60) as resp:
        assert resp.status == 200
        return [json.loads(raw) for raw in resp if raw.strip()]


def test_serving_generate_stream(llamas):
    """The JAX test of the same name over both servers, each serving its
    package's CausalLM: streamed /generate sends one ndjson line a
    position and the unary reply's sequences, and every body (greedy,
    padded, sampled, block decode) is the JAX server's."""
    bodies = {}
    for name, model in llamas.items():
        srv = PACKAGES[name].srv.PredictorServer(
            lambda d: d, generator=model).start()
        try:
            ids = _gen_ids().tolist()
            mask = [[0, 0, 1, 1, 1, 1, 1, 1], [1] * 8]
            got = []
            for extra in ({}, {"attention_mask": mask},
                          {"tokens_per_fetch": 3},
                          {"do_sample": True, "top_k": 8, "seed": 1}):
                obj = {"ids": ids, "max_new_tokens": 4, **extra}
                code, solid, _h = _req(srv.port, "/generate", obj)
                assert code == 200
                lines = _post_lines(srv.port, dict(obj, stream=True))
                toks = [ln["tokens"] for ln in lines if "tokens" in ln]
                assert len(toks) == 4
                assert lines[-1] == {"done": True, "steps": 4}
                assert [[t[b] for t in toks] for b in range(2)] \
                    == solid["sequences"]
                got.append((solid, lines))
            bodies[name] = got
        finally:
            srv.stop()
    assert bodies["port"] == bodies["jax"]


def test_stream_consumer_disconnect_releases_lock(llamas):
    """Closing the generate_steps consumer (a client disconnect) cancels
    the producer, so the executable lock frees without the remaining
    steps, on both servers; the port's model is back in its mode."""
    import time
    for name, model in llamas.items():
        srv = PACKAGES[name].srv.PredictorServer(lambda d: d,
                                                 generator=model)
        it = srv.generate_steps({"ids": _gen_ids().tolist(),
                                 "max_new_tokens": 200})
        first = next(it)
        assert first["step"] == 0 and len(first["tokens"]) == 2
        it.close()                       # a simulated disconnect
        deadline = time.monotonic() + 30
        acquired = False
        while time.monotonic() < deadline:
            acquired = srv._lock.acquire(timeout=0.5)
            if acquired:
                srv._lock.release()
                break
        assert acquired, f"{name}: the producer kept the lock"
        srv.stop()
    assert not llamas["port"].training


# -- lifecycle joins -----------------------------------------------------------------

def test_batcher_stop_joins_worker_and_rejects_new_submits(pkg):
    b = pkg.srv.DynamicBatcher(lambda arrays: [arrays[0]])
    b.stop()
    assert not b._thread.is_alive()
    with pytest.raises(RuntimeError, match="stopped"):
        b.submit([np.ones((1, 1), np.float32)])


def test_server_stop_joins_serve_thread(pkg):
    srv = pkg.srv.PredictorServer(_CountingCallable(),
                                  dynamic_batching=False).start()
    srv.stop()
    assert not srv._thread.is_alive()


# -- overload primitives ----------------------------------------------------------------

def test_admission_controller_counts(pkg):
    ac = pkg.ovl.AdmissionController(max_concurrent=1, max_queue=1)
    ac.try_acquire()
    ac.try_acquire()
    with pytest.raises(pkg.ovl.AdmissionRejected) as ei:
        ac.try_acquire()
    assert ei.value.retry_after is not None
    assert ac.saturated and ac.in_flight == 2
    ac.release()
    ac.try_acquire()
    assert ac.admitted == 3 and ac.rejected == 1


def test_circuit_breaker_state_machine(pkg):
    CB = pkg.ovl.CircuitBreaker
    br = CB(failure_threshold=2, reset_after_s=1000.0)
    br.allow(); br.record_failure()
    br.allow(); br.record_failure()
    assert br.state == CB.OPEN
    with pytest.raises(pkg.ovl.CircuitOpenError):
        br.allow()
    _elapse_cooldown(br)
    br.allow()
    assert br.state == CB.HALF_OPEN
    with pytest.raises(pkg.ovl.CircuitOpenError):
        br.allow()
    br.record_failure()
    assert br.state == CB.OPEN
    _elapse_cooldown(br)
    br.allow()
    br.record_success()
    assert br.state == CB.CLOSED
    assert br.opens == 2 and br.recloses == 1
    br.record_failure(); br.record_failure()
    _elapse_cooldown(br)
    br.allow()
    with pytest.raises(pkg.ovl.CircuitOpenError):
        br.allow()
    _elapse_cooldown(br)
    br.allow()
    br.record_success()
    assert br.state == CB.CLOSED


def test_half_open_probe_released_on_shed(pkg):
    br = pkg.ovl.CircuitBreaker(failure_threshold=1, reset_after_s=1000.0)
    br.allow(); br.record_failure()
    _elapse_cooldown(br)
    br.allow()
    br.release_probe()
    br.allow()
    br.record_success()
    assert br.state == pkg.ovl.CircuitBreaker.CLOSED


def test_readiness_warns_before_hard_429(pkg):
    ac = pkg.ovl.AdmissionController(max_concurrent=1, max_queue=1)
    ac.try_acquire()
    assert ac.saturated
    ac.try_acquire()
    with pytest.raises(pkg.ovl.AdmissionRejected):
        ac.try_acquire()


def test_registry_latency_percentiles(pkg):
    ls = pkg.srv._RegistryLatency(pkg.obs.metrics.MetricsRegistry())
    assert ls.snapshot() == {"count": 0, "p50_ms": None, "p99_ms": None}
    for ms in range(1, 11):
        ls.record(ms / 1000.0)
    snap = ls.snapshot()
    assert snap["count"] == 10
    assert 4.0 <= snap["p50_ms"] <= 7.0
    assert snap["p99_ms"] >= 9.0


def test_deadline_helpers(pkg):
    d = pkg.ovl.Deadline.after_ms(10_000)
    assert not d.expired() and d.remaining() > 9.0
    d2 = pkg.ovl.Deadline(time.monotonic() - 0.001)
    assert d2.expired()
    with pytest.raises(pkg.ovl.DeadlineExceeded):
        d2.check("unit test")
    assert pkg.ovl.Deadline.after_ms(None).remaining() is None
    assert pkg.ovl.expired(None) is False and pkg.ovl.expired(d2) is True


def test_typed_errors_map_like_the_jax_module():
    names = ("OverloadError", "AdmissionRejected", "TenantQuotaExceeded",
             "CircuitOpenError", "ServerDraining", "DeadlineExceeded",
             "EngineOverloaded")
    assert sorted(t_overload.__all__) == sorted(j_overload.__all__)
    for n in names:
        j, t = getattr(j_overload, n), getattr(t_overload, n)
        assert (t.status, t.counter) == (j.status, j.counter), n
        assert [c.__name__ for c in t.__mro__] == \
            [c.__name__ for c in j.__mro__], n


def test_seeded_retry_jitter_equals_the_jax_module():
    vals = {}
    for name, p in PACKAGES.items():
        p.ovl.seed_retry_jitter(1234)
        vals[name] = [p.ovl.jittered_retry_after(s)
                      for s in (1.0, 0.1, 0.01, 5.0, 2.5, None, 1.0)]
    assert vals["port"] == vals["jax"]
    assert vals["port"][5] is None
    assert all(0.05 <= v for v in vals["port"] if v is not None)
    assert 0.75 <= vals["port"][0] <= 1.25


# -- /metrics ---------------------------------------------------------------------------

class _FakeEngine:
    concurrent_safe = True

    def stream(self, ids, **kw):        # pragma: no cover - unused
        yield [0]

    def export_metrics(self, registry):
        registry.set_gauge("engine.ticks", 7)
        registry.set_gauge("engine.tokens_out", 42)


def _scrape(port):
    url = f"http://127.0.0.1:{port}/metrics"
    with urllib.request.urlopen(url, timeout=30) as resp:
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith("text/plain")
        return resp.read().decode()


def test_metrics_endpoint_prometheus_text(pkg):
    import re
    srv = pkg.srv.PredictorServer(lambda inputs: {"y": np.zeros((1, 2))},
                                  generator=_FakeEngine()).start()
    try:
        _req(srv.port, "/predict", {"inputs": {"x": [[1.0, 2.0]]}})
        _wait_for(lambda: srv.latency.snapshot()["count"] == 1,
                  what="latency recorded")
        text = _scrape(srv.port)
    finally:
        srv.stop()
    sample = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [0-9.eE+-]+$")
    for line in text.strip().split("\n"):
        if not line.startswith("#"):
            assert sample.match(line), line
    for want in ('paddle_tpu_serving_requests_total{outcome="ok"} 1',
                 "paddle_tpu_serving_request_latency_ms_count 1",
                 "paddle_tpu_serving_breaker_state 0",
                 "paddle_tpu_serving_in_flight 0",
                 "paddle_tpu_serving_capacity ",
                 "paddle_tpu_engine_ticks 7",
                 "paddle_tpu_engine_tokens_out 42"):
        assert want in text, want


def test_metrics_per_server_counts_do_not_bleed(pkg):
    a = pkg.srv.PredictorServer(lambda inputs: {"y": np.zeros((1,))}).start()
    b = pkg.srv.PredictorServer(lambda inputs: {"y": np.zeros((1,))}).start()
    try:
        _req(a.port, "/predict", {"inputs": {"x": [[1.0]]}})
        assert a.stats()["requests"].get("ok") == 1
        assert b.stats()["requests"] == {}
    finally:
        a.stop()
        b.stop()


def test_metrics_shared_registry_no_duplicate_families(pkg):
    srv = pkg.srv.PredictorServer(lambda inputs: {"y": np.zeros((1,))},
                                  metrics=pkg.obs.REGISTRY).start()
    try:
        _req(srv.port, "/predict", {"inputs": {"x": [[1.0]]}})
        text = _scrape(srv.port)
    finally:
        srv.stop()
    type_lines = [ln for ln in text.split("\n") if ln.startswith("# TYPE ")]
    assert len(type_lines) == len(set(type_lines)), type_lines
    assert 'paddle_tpu_serving_requests_total{outcome="ok"} 1' in text


# -- one request script, both servers ----------------------------------------------------

def _script(p, port, srv, release):
    """A fixed sequence of requests; returns the transcript (status,
    body with volatile fields dropped, Retry-After) of each. The server
    admits one request at a time, and a handler releases its admission
    just after its reply is written, so each request but the 429 probe
    waits for the previous one's release."""
    out = []

    def rec(resp):
        code, body, hdrs = resp
        body = {k: v for k, v in body.items()
                if k not in ("latency_ms", "retry_after_s")}
        out.append((code, body, hdrs.get("Retry-After")))

    def call(*args):
        _wait_for(lambda: srv.admission.in_flight == 0, what="released")
        rec(_req(port, *args))

    call("/healthz")
    call("/predict", {"inputs": _ONE_ROW})
    call("/predict", {"inputs": {"x": {"dtype": "f"}}})
    call("/predict", [1, 2])
    call("/predict", {"inputs": _ONE_ROW, "timeout_ms": 0})
    call("/nope")
    with p.chaos.scoped(seed=5, rates={"serving.run.fail": (1.0, 2)}):
        call("/predict", {"inputs": _ONE_ROW})
        call("/predict", {"inputs": _ONE_ROW})
    call("/predict", {"inputs": _ONE_ROW})                # breaker open
    call("/readyz")
    _wait_for(lambda: srv.admission.in_flight == 0, what="released")
    _elapse_cooldown(srv.breaker)
    t, bg = _post_bg(port, "/predict", {"inputs": _ONE_ROW})
    _wait_for(lambda: srv.admission.in_flight == 1, what="in flight")
    rec(_req(port, "/predict", {"inputs": _ONE_ROW}))     # 429
    rec(_req(port, "/readyz"))                            # saturated
    release.set()
    t.join(timeout=10)
    rec(bg["resp"])
    _wait_for(lambda: srv.admission.in_flight == 0, what="released")
    st = srv.stats()
    st.pop("latency_ms")
    out.append(st)
    out.append(srv.metrics_text())
    return out


def test_same_script_same_transcript_and_retry_after():
    got = {}
    for name, p in PACKAGES.items():
        release = threading.Event()

        class Blocking(_CountingCallable):
            def __call__(self, inputs):
                if self.calls == 1:
                    self.block = release
                return super().__call__(inputs)

        srv = p.srv.PredictorServer(Blocking(), breaker_threshold=2,
                                    breaker_reset_s=1000.0,
                                    max_concurrent=1, max_queue_depth=0,
                                    retry_after_s=3.0).start()
        try:
            p.ovl.seed_retry_jitter(42)
            got[name] = _script(p, srv.port, srv, release)
        finally:
            release.set()
            srv.stop()
    for a, b in zip(got["port"][:-1], got["jax"][:-1]):
        assert a == b
    # the scrape bodies match but for the latency histogram's sum
    strip = [ln for ln in got["port"][-1].split("\n")
             if "latency_ms_sum" not in ln and "latency_ms_bucket" not in ln]
    want = [ln for ln in got["jax"][-1].split("\n")
            if "latency_ms_sum" not in ln and "latency_ms_bucket" not in ln]
    assert strip == want
    codes = [r[0] for r in got["port"][:-2]]
    assert codes == [200, 200, 400, 400, 400, 404, 500, 500, 503, 503,
                     429, 503, 200]
    assert all(r[2] is not None for r in got["port"][8:12])


# -- request tracing through HTTP (tests/test_request_tracing.py) -------------------------

class _GatedSource:
    def __init__(self, n=3):
        self.n = n
        self.release = threading.Event()

    def stream(self, ids, **kw):
        def gen():
            yield np.asarray([11])
            for i in range(self.n - 1):
                assert self.release.wait(timeout=30)
                yield np.asarray([12 + i])
        return gen()


def test_e2e_traceparent_streamed_echo_debug_view_and_chrome_trace(pkg):
    pkg.obs.enable(reset=True)
    pkg.req.configure(slow_ttft_s=0.0)
    gated = _GatedSource(n=3)
    srv = pkg.srv.PredictorServer(lambda d: d, generator=gated).start()
    try:
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
        conn.request("POST", "/generate",
                     json.dumps({"ids": [[1, 2]], "max_new_tokens": 3,
                                 "stream": True}),
                     {"Content-Type": "application/json",
                      "traceparent": _TP, "X-Request-Id": "my-req-7"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("X-Request-Id") == "my-req-7"
        tid, parent, _fl = pkg.req.parse_traceparent(
            resp.getheader("traceparent"))
        assert tid == _TRACE_ID and parent != "cd" * 8
        assert json.loads(resp.readline())["tokens"] == [11]
        code, body, _h = _req(srv.port, "/debug/requests")
        assert code == 200 and body["enabled"] is True
        row = {r["request_id"]: r for r in body["requests"]}["my-req-7"]
        assert row["trace_id"] == _TRACE_ID
        assert row["stage"] == "first_token"
        assert row["tokens"] == 1 and row["age_s"] >= 0.0
        gated.release.set()
        while resp.readline():
            pass
        conn.close()
        _wait_for(lambda: pkg.req.live_count() == 0,
                  what="request to leave the in-flight registry")
        reg = pkg.obs.REGISTRY
        assert reg.histogram("request.ttft.seconds").count() == 1
        assert reg.histogram("request.itl.seconds").count() == 2
        assert reg.histogram("request.tokens").percentile(50) == 3
        assert reg.counter("request.outcome").value(reason="ok") == 1
        by_name = {}
        for e in pkg.obs.trace.export_chrome_trace()["traceEvents"]:
            by_name.setdefault(e["name"], e)
        assert by_name["request"]["args"]["request_id"] == "my-req-7"
        assert by_name["request"]["args"]["tokens"] == 3
        assert "decode" in by_name and "ev.first_token" in by_name
    finally:
        srv.stop()


def test_unary_reply_and_error_reply_echo_headers(pkg):
    pkg.obs.enable(reset=True)
    srv = pkg.srv.PredictorServer(
        lambda inputs: {"y": np.asarray([[2.0]], np.float32)}).start()
    try:
        code, _b, hdrs = _req(srv.port, "/predict",
                              {"inputs": {"x": [[1.0]]}},
                              headers={"traceparent": _TP,
                                       "X-Tenant-Id": "acme"})
        assert code == 200
        assert pkg.req.parse_traceparent(hdrs["traceparent"])[0] \
            == _TRACE_ID
        assert hdrs["X-Request-Id"].startswith("req-")
        assert hdrs["X-Tenant-Id"] == "acme"
        reg = pkg.obs.REGISTRY
        assert reg.counter("request.outcome").value(reason="ok") == 1
        code, _b, hdrs = _req(srv.port, "/predict", [1, 2],
                              headers={"traceparent": _TP})
        assert code == 400
        assert pkg.req.parse_traceparent(hdrs["traceparent"])[0] \
            == _TRACE_ID
        assert reg.counter("request.outcome").value(
            reason="client_error") == 1
        _wait_for(lambda: pkg.req.live_count() == 0, what="contexts retire")
    finally:
        srv.stop()


def test_multirow_pad_emissions_not_counted(pkg):
    class TwoRow:
        def stream(self, ids, **kw):
            def gen():
                yield np.asarray([5, 21])
                yield np.asarray([9, 22])
                yield np.asarray([0, 23])
                yield np.asarray([0, 24])
            return gen()

    pkg.obs.enable(reset=True)
    srv = pkg.srv.PredictorServer(lambda d: d, generator=TwoRow())
    ctx = pkg.req.register(pkg.req.RequestContext.new())
    token = pkg.req.set_current(ctx)
    try:
        steps = [o for o in srv.generate_steps(
            {"ids": [[1], [2]], "max_new_tokens": 4, "eos_token_id": 9})
            if "tokens" in o]
    finally:
        pkg.req.reset_current(token)
        srv.stop()
    assert len(steps) == 4
    assert ctx.tokens == 6
    ctx.finish("finished")
    assert pkg.obs.REGISTRY.histogram("request.tokens").count() == 1


def test_tenant_storm_stamp_rides_the_echo_and_the_context(pkg):
    pkg.obs.enable(reset=True)
    srv = pkg.srv.PredictorServer(
        lambda inputs: {"y": np.asarray([[2.0]], np.float32)}).start()
    try:
        with pkg.chaos.scoped(rates={"tenant.storm": 1.0}):
            code, _b, hdrs = _req(srv.port, "/predict",
                                  {"inputs": {"x": [[1.0]]}})
            code2, _b, hdrs2 = _req(srv.port, "/predict",
                                    {"inputs": {"x": [[1.0]]}},
                                    headers={"X-Tenant-Id": "calm"})
        assert code == code2 == 200
        assert hdrs["X-Tenant-Id"] == "storm"
        assert hdrs2["X-Tenant-Id"] == "calm"
    finally:
        srv.stop()


def test_disabled_path_creates_no_context_and_records_nothing(pkg):
    class _Boom:
        def __init__(self, *a, **k):
            raise AssertionError(
                "RequestContext constructed on the disabled path")
        from_headers = new = __init__

    real = pkg.req.RequestContext
    pkg.req.RequestContext = _Boom
    try:
        assert pkg.obs.ENABLED is False
        gated = _GatedSource(n=2)
        gated.release.set()
        srv = pkg.srv.PredictorServer(
            lambda inputs: {"y": np.asarray([[2.0]], np.float32)},
            generator=gated).start()
        try:
            code, body, hdrs = _req(
                srv.port, "/generate",
                {"ids": [[1, 2]], "max_new_tokens": 2},
                headers={"traceparent": _TP, "X-Request-Id": "my-req-7"})
            assert code == 200 and body["sequences"] == [[11, 12]]
            lower = {k.lower() for k in hdrs}
            assert "traceparent" not in lower
            assert "x-request-id" not in lower
            code, body, _h = _req(srv.port, "/debug/requests")
            assert code == 200
            assert body == {"enabled": False, "count": 0, "requests": []}
        finally:
            srv.stop()
    finally:
        pkg.req.RequestContext = real
    assert pkg.req.live_count() == 0
    assert pkg.obs.trace.spans() == []
    assert pkg.obs.REGISTRY.histogram("request.ttft.seconds").count() == 0
