"""HTTP serving over the port: a dependency-free HTTP/JSON server in
front of a predictor callable and the port's paged engine.

Counterpart of paddle_tpu/inference/serving.py, copied and adapted (the
module is stdlib + numpy, but importing it would import the JAX
package). The endpoints, their bodies, status codes and headers are the
JAX server's:

POST /predict  {"inputs": {name: nested-list | {"data": .., "dtype": ..}},
                "timeout_ms": optional budget}
           ->  {"outputs": {name: {"data": .., "dtype": .., "shape": ..}}}
               over any dict->dict callable, or an object with
               `run(list) -> list` (and `input_shapes()` for dynamic
               batching)
POST /generate {"ids": [[..]], "max_new_tokens": n, "stream": bool,
                "do_sample"/"temperature"/"top_k"/"top_p"/"eos_token_id"
                /"seed"/"timeout_ms"/"session": ...}
           ->  stream=false: {"sequences": [[..]]}
               stream=true: application/x-ndjson chunks, one
               {"step": i, "tokens": [..]} line per generated position,
               then {"done": true} — the token-streaming surface, over a
               generator with `stream()` (the port's PagedKVEngine), or
               a CausalLM driven by models/generation.generate_stream
               (`tokens_per_fetch` passes through to its block decode;
               serialized by the executable lock). The JAX server's
               exported-bundle generator is not ported
POST /kv/pull  {"keys": [chain keys]} -> packed KV page bundle
               (application/octet-stream) — the disaggregated
               prefill/decode handoff data plane (inference/disagg.py)
GET  /health   -> liveness (alias of /healthz)
GET  /healthz  -> {"status": "ok"} while the process serves HTTP at all
GET  /readyz   -> 200 when accepting traffic; 503 {"reason":
               "draining" | "warming" | "breaker_open" |
               "breaker_half_open" | "saturated"} when a load balancer
               should steer away ("warming": opt-in via
               start_warming=True, cleared by the first completed
               request or mark_warm())
GET  /stats    -> JSON counters (admission, sheds, breaker state,
               latency p50/p99, batcher queue, the engine's prefix /
               kvtier / disagg / tenant blocks)
GET  /metrics  -> Prometheus text exposition (observability/): request
               outcomes + latency histogram, admission/breaker/batcher
               gauges, the engine's `export_metrics` gauges, and the
               port's process-wide registry when observability is
               enabled
GET  /debug/requests -> live traced requests from the bounded in-flight
               registry (observability/requests.py)
GET  /debug/fleet -> live cross-rank heartbeat scan (observability/
               fleet.py FleetAggregator passed as `fleet=`): per-rank
               step, heartbeat age, straggler flags; {"enabled": false,
               "view": null} with observability off or none attached
GET  /metadata -> input/output names of the served program

Request tracing (observability/requests.py, enabled with the rest of
the port's observability plane): every POST gets a RequestContext
carrying `X-Request-Id` and a W3C `traceparent` (inbound headers
honored, both echoed on every reply including streamed ones),
propagated by contextvar through the admission gate, DynamicBatcher,
and PagedKVEngine — which record the request's lifecycle events and
the request.* SLO instruments. Disabled (the default), the whole path
is per-layer single attribute checks.

Requests to a plain predictor are serialized through a lock; a
generator marked `concurrent_safe` (the paged engine, whose ticker
thread is the only device user) is not. With dynamic_batching=True the
server coalesces concurrent requests that share a shape signature into
ONE predictor run.

Overload control (inference/overload.py): every POST passes an
admission gate (bounded in-flight count -> 429 + Retry-After), carries
a deadline from `timeout_ms`/`X-Timeout-Ms` (expiry -> 504, including
*while queued* in the batcher), and runs under a circuit breaker
(consecutive backend failures -> fast-fail 503 until a half-open probe
recloses it). `drain()` stops admission, finishes in-flight work, then
stops the server. Chaos points `serving.admit.delay` /
`serving.run.delay` / `serving.run.fail` / `serving.batch.delay` /
`serving.batch.fail` (distributed/chaos.py) drive these paths
deterministically in tests.

Multi-tenant QoS (inference/tenancy.py, `tenancy=` TenantTable):
requests carry a sanitized `X-Tenant-Id` (echoed on every reply); each
tenant gets an admission quota on top of the global gate, a batcher
queue quota, and a weighted-fair share of batch/decode service. The
`tenant.storm` chaos site stamps unlabeled traffic as a synthetic noisy
neighbor.

With observability on, `drain()` dumps a `serving_drain` flight-recorder
bundle (observability/fleet.py; a no-op until a bundle directory is
configured). The JAX module's `serve()` (which loads an exported program
into a Predictor) waits for its module.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import json
import math
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from paddle_tpu_torch import observability
from paddle_tpu_torch.distributed import chaos
from paddle_tpu_torch.inference.disagg import (HandoffArbiter, pack_bundle,
                                               unpack_bundle)
from paddle_tpu_torch.inference.overload import (
    AdmissionController, AdmissionRejected, CircuitBreaker, Deadline,
    DeadlineExceeded, OverloadError, ServerDraining,
    TenantQuotaExceeded, expired as _expired, jittered_retry_after)
from paddle_tpu_torch.inference.tenancy import (TenantAdmission,
                                                WeightedFairScheduler,
                                                resolve_tenant)
from paddle_tpu_torch.models.generation import generate_stream
from paddle_tpu_torch.observability import requests as obs_requests
from paddle_tpu_torch.observability.metrics import MetricsRegistry

__all__ = ["PredictorServer", "DynamicBatcher", "UnbatchableRequest",
           "OversizedBatch"]


class UnbatchableRequest(ValueError):
    """Raised by DynamicBatcher.submit for inputs that cannot join a
    dim-0 batch; servers fall back to a solo run ONLY for this (a model
    ValueError must propagate, not trigger a silent second run)."""


class OversizedBatch(UnbatchableRequest):
    """A single request larger than the exported leading dim: neither a
    merged batch nor a solo run can serve it, so it is a client error
    (HTTP 400), never a fallback."""


class _StreamAborted(RuntimeError):
    """Internal: a /generate stream failed AFTER the 200 header went
    out — the error chunk is already on the wire, so no HTTP reply can
    follow, but the failure must still reach the circuit breaker (a
    backend dying mid-stream on every request would otherwise never
    trip it) and the server_error counter."""


class _Pending:
    __slots__ = ("inputs", "n", "event", "result", "error", "deadline",
                 "ctx", "tenant")

    def __init__(self, inputs, n, deadline=None, ctx=None, tenant=None):
        self.inputs = inputs            # list of np arrays, fixed order
        self.n = n                      # leading-dim size
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.deadline = deadline
        self.ctx = ctx                  # request-tracing context (or None)
        self.tenant = tenant            # accounting key (or None)


class DynamicBatcher:
    """Coalesce concurrent single requests into one predictor run.

    run_fn(list_of_arrays) -> list_of_arrays, batching on dim 0. Only
    requests with identical (shape[1:], dtype) signatures merge; the
    first request of a batch waits up to `timeout_ms` for co-travellers,
    bounded by `max_batch` total rows.

    Overload behavior: `max_queue` bounds the pending buffer (shed with
    AdmissionRejected when full), `hard_cap` rejects single requests
    wider than the exported leading dim (OversizedBatch), and a request
    whose `deadline` expires while still buffered is withdrawn with
    DeadlineExceeded instead of wasting rows of a batch.

    Multi-tenant QoS (`tenancy=` TenantTable, inference/tenancy.py):
    the FIFO pick is replaced with a weighted-fair pick across the
    tenants currently buffered — the next batch leader comes from the
    highest-priority, least-served-by-weight tenant (per-tenant FIFO
    preserved), and every served request charges its tenant's stride.
    A tenant past its own `max_queued` sheds with a typed 429
    (TenantQuotaExceeded) while other tenants keep their buffer
    headroom. Without a table the batcher behaves exactly as before."""

    def __init__(self, run_fn, max_batch=8, timeout_ms=5.0, *,
                 max_queue=None, hard_cap=None, tenancy=None):
        self.run_fn = run_fn
        self.max_batch = max_batch
        self.timeout = timeout_ms / 1000.0
        self.max_queue = max_queue
        self.hard_cap = hard_cap
        self.tenancy = tenancy
        self._wfq = (WeightedFairScheduler(tenancy)
                     if tenancy is not None else None)
        # incremental per-tenant buffered counts (guarded by _cv):
        # the quota check and tenant_queued() read this instead of
        # O(buffer) scans under the lock on every submit
        self._tq: dict = {}
        self._buf: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._stop = False
        self.batches_run = 0            # observability / tests
        self.requests_served = 0
        self.expired_in_queue = 0
        self.shed_full = 0
        self.shed_tenant = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @staticmethod
    def _sig(arrays):
        return tuple((a.shape[1:], str(a.dtype)) for a in arrays)

    def submit(self, arrays, deadline=None, tenant=None):
        """Blocking: returns the outputs for this request's rows."""
        arrays = [np.asarray(a) for a in arrays]
        if not arrays or any(a.ndim == 0 for a in arrays):
            raise UnbatchableRequest(
                "dynamic batching needs batched (dim-0) inputs")
        if any(a.shape[0] != arrays[0].shape[0] for a in arrays):
            raise UnbatchableRequest(
                "dynamic batching needs a shared leading dim across all "
                f"inputs, got {[a.shape for a in arrays]}")
        rows = arrays[0].shape[0]
        if self.hard_cap is not None and rows > self.hard_cap:
            raise OversizedBatch(
                f"request of {rows} rows exceeds the exported leading "
                f"dim {self.hard_cap}; split it or re-export with a "
                "larger batch input_spec")
        if _expired(deadline):
            raise DeadlineExceeded("deadline exceeded before batching")
        ctx = obs_requests.current() if observability.ENABLED else None
        if ctx is not None:
            ctx.record("queued")
        tkey = (self.tenancy.key(tenant) if self.tenancy is not None
                else None)
        p = _Pending(arrays, rows, deadline, ctx=ctx, tenant=tkey)
        with self._cv:
            if self._stop:
                raise RuntimeError("DynamicBatcher stopped")
            if self.tenancy is not None:
                # the tenant's OWN buffer quota sheds first (typed 429,
                # bulkhead): a storm filling its lane must not reach
                # the global full-queue shed other tenants share
                pol = self.tenancy.policy(tenant)
                if pol.max_queued is not None \
                        and self._tq.get(tkey, 0) >= pol.max_queued:
                    self.shed_tenant += 1
                    if observability.ENABLED:
                        observability.inc("tenant.shed", tenant=tkey,
                                          reason="queue")
                    raise TenantQuotaExceeded(
                        f"tenant {tkey!r} over batcher queue quota "
                        f"({pol.max_queued} buffered)",
                        retry_after=self.timeout)
            if self.max_queue is not None \
                    and len(self._buf) >= self.max_queue:
                self.shed_full += 1
                raise AdmissionRejected(
                    f"batcher queue full ({self.max_queue} pending)",
                    retry_after=self.timeout)
            self._buf.append(p)
            if tkey is not None:
                self._tq[tkey] = self._tq.get(tkey, 0) + 1
            self._cv.notify()
        self._await(p)
        if p.error is not None:
            raise p.error
        return p.result

    def _await(self, p):
        """Wait for completion, bounded by the request's deadline: on
        expiry WITHDRAW the request if it is still buffered (it never
        occupies a batch slot); once taken by the worker the run always
        completes it."""
        if p.deadline is None or p.deadline.t is None:
            p.event.wait()
            return
        while not p.event.wait(timeout=max(p.deadline.remaining(), 0.0)):
            with self._cv:
                if p in self._buf:
                    self._buf.remove(p)
                    self._tq_dec_locked(p)
                    self.expired_in_queue += 1
                    raise DeadlineExceeded(
                        "deadline exceeded while queued for batching")
            # already taken into a batch: the worker will finish it
            p.event.wait()
            return

    def _expire_locked(self, p):
        self.expired_in_queue += 1
        p.error = DeadlineExceeded(
            "deadline exceeded while queued for batching")
        p.event.set()

    def _tq_dec_locked(self, p):
        """A request left the buffer (taken / expired / withdrawn).
        Caller holds the cv; no-op for untracked (tenancy-less)
        entries."""
        if p.tenant is None:
            return
        n = self._tq.get(p.tenant, 0) - 1
        if n > 0:
            self._tq[p.tenant] = n
        else:
            self._tq.pop(p.tenant, None)

    def _next_locked(self):
        """Next buffered request to serve: FIFO head without tenancy;
        with a TenantTable, the weighted-fair pick across the tenants
        currently buffered — the chosen tenant's OLDEST request, so
        per-tenant ordering stays FIFO while tenants interleave by
        weight/priority instead of arrival."""
        if self._wfq is None:
            return self._buf.popleft()
        firsts = {}
        for p in self._buf:
            firsts.setdefault(p.tenant, p)
        chosen = firsts[self._wfq.pick(firsts)]
        self._buf.remove(chosen)
        self._tq_dec_locked(chosen)
        return chosen

    def _fill_wfq_locked(self, batch, sig, rows):
        """Tenancy fill (caller holds the cv): reap expired buffered
        requests, then repeatedly add the WFQ-picked tenant's OLDEST
        compatible request, charging as each joins — so batch ROWS
        divide by weight under saturation, not by arrival order (a
        FIFO fill would hand a flooding tenant every co-traveller
        slot behind a fair leader). Returns the updated row count."""
        for p in [q for q in self._buf if _expired(q.deadline)]:
            self._buf.remove(p)
            self._tq_dec_locked(p)
            self._expire_locked(p)      # dead rows get no slot
        while rows < self.max_batch:
            firsts: dict = {}
            for p in self._buf:
                if p.tenant not in firsts \
                        and self._sig(p.inputs) == sig \
                        and rows + p.n <= self.max_batch:
                    firsts[p.tenant] = p
            if not firsts:
                return rows
            p = firsts[self._wfq.pick(firsts)]
            self._buf.remove(p)
            self._tq_dec_locked(p)
            self._wfq.charge(p.tenant, cost=p.n)
            batch.append(p)
            rows += p.n
        return rows

    def _take_batch(self):
        with self._cv:
            first = None
            while first is None:
                while not self._buf and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return []
                cand = self._next_locked()
                if _expired(cand.deadline):
                    self._expire_locked(cand)   # dead rows get no slot
                else:
                    first = cand
            if self._wfq is not None:
                # charge service AS it is granted (leader here, fill
                # members in _fill_wfq_locked), so every later pick
                # favors the tenants that got less
                self._wfq.charge(first.tenant, cost=first.n)
        batch = [first]
        sig = self._sig(first.inputs)
        rows = first.n
        deadline = time.monotonic() + self.timeout
        while rows < self.max_batch:
            with self._cv:
                if self._wfq is not None:
                    rows = self._fill_wfq_locked(batch, sig, rows)
                else:
                    # pull every compatible pending request (FIFO)
                    keep: collections.deque = collections.deque()
                    while self._buf and rows < self.max_batch:
                        cand = self._buf.popleft()
                        if _expired(cand.deadline):
                            self._expire_locked(cand)
                        elif self._sig(cand.inputs) == sig \
                                and rows + cand.n <= self.max_batch:
                            batch.append(cand)
                            rows += cand.n
                        else:
                            keep.append(cand)
                    keep.extend(self._buf)
                    self._buf = keep
            remaining = deadline - time.monotonic()
            if remaining <= 0 or rows >= self.max_batch:
                break
            with self._cv:
                self._cv.wait(timeout=remaining)
        return batch

    def tenant_queued(self):
        """{tenant: buffered count} for the /stats per-tenant rows
        ({} without tenancy) — the incremental counter, O(tenants)."""
        with self._cv:
            return dict(self._tq)

    def _loop(self):
        while not self._stop:
            batch = self._take_batch()
            if self._stop:
                # taken but never run (shutdown race): fan the stop to
                # the waiters instead of wedging them
                for p in batch:
                    p.error = RuntimeError("DynamicBatcher stopped")
                    p.event.set()
                return
            if not batch:
                continue
            for p in batch:
                if p.ctx is not None:
                    p.ctx.record("scheduled")
            try:
                if chaos.ENABLED:
                    # a slow backend (serving.batch.delay) and a failed
                    # batch run (serving.batch.fail): the error must fan
                    # out to every waiter, never wedge the loop
                    chaos.maybe_delay("serving.batch.delay")
                    if chaos.should_fire("serving.batch.fail"):
                        raise chaos.InjectedFault(
                            "chaos: injected batch failure")
                n_in = len(batch[0].inputs)
                merged = [np.concatenate([p.inputs[i] for p in batch], 0)
                          for i in range(n_in)]
                outs = self.run_fn(merged)
                offs = 0
                for p in batch:
                    p.result = [np.asarray(o)[offs:offs + p.n]
                                for o in outs]
                    offs += p.n
                self.batches_run += 1
                self.requests_served += len(batch)
            except Exception as e:      # noqa: BLE001
                for p in batch:
                    p.error = e
            for p in batch:
                p.event.set()

    def stop(self, join_timeout=5.0):
        with self._cv:
            self._stop = True
            pending = list(self._buf)
            self._buf.clear()
            self._tq.clear()
            self._cv.notify_all()
        # callers blocked in submit() must not hang across shutdown
        for p in pending:
            p.error = RuntimeError("DynamicBatcher stopped")
            p.event.set()
        # bounded join: a worker wedged inside run_fn must not hang
        # shutdown (it is a daemon thread and dies with the process)
        self._thread.join(timeout=join_timeout)


class _RegistryLatency:
    """The old LatencyStats surface (record seconds, snapshot in ms)
    rebased onto the server's metrics registry: the histogram
    `serving.request.latency_ms` is the single source of truth — the
    /stats JSON (keys kept stable) and the /metrics exposition both
    read it."""

    def __init__(self, metrics: MetricsRegistry):
        self._metrics = metrics
        self._hist = metrics.histogram("serving.request.latency_ms")

    def record(self, seconds):
        self._metrics.observe("serving.request.latency_ms",
                              float(seconds) * 1000.0)

    def percentile(self, p):
        """Seconds, like LatencyStats.percentile (None when empty)."""
        v = self._hist.percentile(p)
        return None if v is None else v / 1000.0

    def snapshot(self):
        count = self._hist.count()
        if not count:
            return {"count": 0, "p50_ms": None, "p99_ms": None}
        return {"count": count,
                "p50_ms": self._hist.percentile(50),
                "p99_ms": self._hist.percentile(99)}


class PredictorServer:
    """Serve a Predictor (or any callable dict->dict) over HTTP, behind
    an overload-control gate (admission / deadlines / circuit breaker /
    graceful drain — module doc).

    Observability: every server owns a MetricsRegistry (pass
    `metrics=` to share one). Request outcomes and latency are
    recorded there — /stats reads them back (old JSON keys stable) and
    GET /metrics serves the Prometheus text exposition of this
    registry, engine counters from a generator's `export_metrics`, and
    the port's process-wide observability.REGISTRY (the engine's,
    kvtier's, disagg's and chaos's counters and the request.*
    instruments, populated when observability.enable() is on)."""

    # bad requests: the backend is fine, the payload is not. These map
    # to 400 and do NOT count as breaker failures.
    _CLIENT_ERRORS = (UnbatchableRequest, ValueError, KeyError, TypeError)

    def __init__(self, predictor, host="127.0.0.1", port=0,
                 model_name="model", dynamic_batching=False,
                 max_batch_size=8, batch_timeout_ms=5.0, generator=None,
                 *, max_concurrent=32, max_queue_depth=64,
                 default_timeout_ms=None, breaker_threshold=5,
                 breaker_reset_s=5.0, retry_after_s=1.0, metrics=None,
                 fleet=None, tenancy=None, start_warming=False):
        self.predictor = predictor
        self.model_name = model_name
        self.generator = generator
        # optional observability.fleet.FleetAggregator: GET /debug/fleet
        # then serves a live cross-rank heartbeat scan from this replica
        self.fleet = fleet
        # optional tenancy.TenantTable: per-tenant admission quotas on
        # top of the global gate, weighted-fair batching, per-tenant
        # /stats rows and tenant.* instruments. None (the default)
        # keeps every path byte-identical to the pre-tenancy server.
        self.tenancy = tenancy
        self.tenants = (TenantAdmission(tenancy,
                                        retry_after_s=retry_after_s)
                        if tenancy is not None else None)
        # disagg handoff (inference/disagg.py): WFQ ordering of
        # concurrent KV pulls on the second hop — under transfer
        # saturation tenants share the pull path in weight proportion
        self.disagg_arbiter = HandoffArbiter(tenancy)
        self._lock = threading.Lock()
        self.default_timeout_ms = default_timeout_ms
        self.admission = AdmissionController(
            max_concurrent=max_concurrent, max_queue=max_queue_depth,
            retry_after_s=retry_after_s)
        self.breaker = CircuitBreaker(
            failure_threshold=breaker_threshold,
            reset_after_s=breaker_reset_s)
        # per-server by default so two servers in one process (tests,
        # multi-model deployments) never merge each other's counts
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry()
        self._requests = self.metrics.counter("serving.requests")
        self.latency = _RegistryLatency(self.metrics)
        self._draining = False
        # cold-start gate (module doc): /readyz says "warming" until
        # the first request completes (= the first compile is paid) or
        # mark_warm(). Requests are NOT refused while warming — the
        # first one through is what warms; only routing steers away.
        self._warming = bool(start_warming)
        self.retry_after_s = float(retry_after_s)
        self.batcher = None
        # batching needs the handle-free run(list) API; a plain callable
        # predictor keeps the solo path (its input names don't survive
        # the array-list hop)
        if dynamic_batching and hasattr(predictor, "run"):
            shapes = (predictor.input_shapes()
                      if hasattr(predictor, "input_shapes") else None)
            hard_cap = None
            if shapes and shapes[0]:
                # never merge past the exported leading dim
                hard_cap = shapes[0][0]
                max_batch_size = min(max_batch_size, hard_cap)
            self.batcher = DynamicBatcher(
                self._run_locked, max_batch=max_batch_size,
                timeout_ms=batch_timeout_ms, max_queue=max_queue_depth,
                hard_cap=hard_cap, tenancy=tenancy)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # chunked transfer (the /generate stream) needs HTTP/1.1;
            # every non-stream reply carries Content-Length, so 1.1
            # keep-alive semantics stay correct
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):      # quiet
                pass

            def _echo_trace_headers(self):
                """X-Request-Id / traceparent on every reply of a
                traced request (the propagation contract: the caller's
                trace id comes back, our span id is the new parent);
                X-Tenant-Id echoed whenever the request resolved to a
                tenant (sanitized on the way in — and independent of
                observability, so attribution survives the router hop
                even on an un-traced fleet)."""
                ctx = getattr(self, "_obs_ctx", None)
                if ctx is not None:
                    self.send_header("X-Request-Id", ctx.request_id)
                    self.send_header("traceparent", ctx.traceparent())
                tenant = getattr(self, "_tenant", None)
                if tenant is not None:
                    self.send_header("X-Tenant-Id", tenant)

            def _reply(self, code, obj, retry_after=None,
                       jittered=False):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self._echo_trace_headers()
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if retry_after is not None:
                    # bounded ±jitter at the point the header is
                    # emitted: fixed backoff values re-synchronize
                    # every shed client into a retry storm
                    # (jittered=True when the caller already drew one
                    # value to keep header and body consistent)
                    if not jittered:
                        retry_after = jittered_retry_after(retry_after)
                    self.send_header(
                        "Retry-After",
                        str(max(1, int(math.ceil(retry_after)))))
                self.end_headers()
                self.wfile.write(body)

            def _stream_reply(self, lines, src=None):
                """Chunked application/x-ndjson: one JSON line per chunk,
                flushed as each token batch is produced. `src` is the
                underlying generate_steps iterator — ALWAYS closed on
                the way out, so a mid-stream client disconnect cancels
                the producer (and frees the chip lock) immediately
                instead of waiting for GC. Returns the backend
                exception if the stream failed mid-flight (the caller
                raises _StreamAborted so the breaker sees it); a client
                disconnect returns None — the backend did not fail."""
                self.send_response(200)
                self._echo_trace_headers()
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(obj):
                    data = (json.dumps(obj) + "\n").encode()
                    self.wfile.write(b"%x\r\n" % len(data) + data
                                     + b"\r\n")
                    self.wfile.flush()
                exc = None
                try:
                    try:
                        for obj in lines:
                            chunk(obj)
                    except OSError:
                        # client went away mid-stream: the backend did
                        # not fail, but the request's outcome is final
                        outer._finish_request(
                            getattr(self, "_obs_ctx", None),
                            "disconnected")
                        return None
                    except Exception as e:      # noqa: BLE001
                        exc = e
                        chunk({"error": str(e)})
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    pass                # terminal chunk hit a dead socket
                finally:
                    if src is not None and hasattr(src, "close"):
                        src.close()
                return exc

            def do_GET(self):
                # keep-alive: one Handler serves several requests on a
                # connection — a stale traced POST must not echo here
                self._obs_ctx = None
                self._tenant = None
                if self.path in ("/health", "/healthz"):
                    # liveness only: the process is up and serving HTTP.
                    # Whether it should RECEIVE traffic is /readyz.
                    return self._reply(200, {"status": "ok",
                                             "model": outer.model_name})
                if self.path == "/readyz":
                    ready, reason = outer.readiness()
                    if ready:
                        return self._reply(200, {"status": "ready"})
                    # machine-readable load signals ride the 503 body:
                    # a fleet router routes/sheds on numbers, not prose.
                    # One jitter draw feeds body AND header so the two
                    # advertised backoffs agree.
                    ra = jittered_retry_after(outer.retry_after_s)
                    return self._reply(
                        503, {"status": "unready", "reason": reason,
                              "in_flight": outer.admission.in_flight,
                              "queue_depth": outer.queue_depth(),
                              "retry_after_s": round(ra, 3)},
                        retry_after=ra, jittered=True)
                if self.path == "/debug/requests":
                    live = obs_requests.live_requests()
                    return self._reply(200, {
                        "enabled": observability.ENABLED,
                        "count": len(live), "requests": live})
                if self.path == "/debug/fleet":
                    return self._reply(200, outer.fleet_view())
                if self.path == "/stats":
                    return self._reply(200, outer.stats())
                if self.path == "/metrics":
                    body = outer.metrics_text().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if self.path == "/metadata":
                    return self._reply(200, outer.metadata())
                return self._reply(404, {"error": "unknown path"})

            def do_POST(self):
                self._obs_ctx = None        # keep-alive: no stale echo
                self._tenant = None
                if self.path == "/kv/pull":
                    # internal data plane: a decode-pool peer pulling
                    # the KV pages it is missing (disagg handoff) —
                    # no tenant gate, no admission slot, no tracing
                    return outer._kv_pull(self)
                if self.path not in ("/predict", "/generate"):
                    return self._reply(404, {"error": "unknown path"})
                # tenant identity: sanitized X-Tenant-Id, or the chaos
                # storm stamp for unlabeled traffic (tenancy module doc)
                tenant = resolve_tenant(self.headers)
                self._tenant = tenant
                outer._count("total", tenant)
                ctx = cv_token = None
                if observability.ENABLED:
                    # one request context per POST: trace identity from
                    # the inbound headers, bound to this thread via
                    # contextvar so the batcher/engine layers see it
                    ctx = obs_requests.RequestContext.from_headers(
                        self.headers)
                    if ctx.tenant != tenant:
                        ctx.tenant = tenant     # chaos storm stamp
                    if outer.tenancy is not None and tenant is not None:
                        # outcome metrics label with the bounded
                        # accounting key; /debug/requests keeps raw
                        ctx.tenant_key = outer.tenancy.key(tenant)
                    obs_requests.register(ctx)
                    self._obs_ctx = ctx
                    cv_token = obs_requests.set_current(ctx)
                try:
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        req = json.loads(self.rfile.read(n)) if n else {}
                        if not isinstance(req, dict):
                            raise ValueError(
                                "request body must be a JSON object")
                        deadline = outer._request_deadline(req,
                                                           self.headers)
                        with outer._admit(deadline, tenant):
                            if self.path == "/generate":
                                stream = bool(req.pop("stream", False))
                                if self.headers.get(
                                        "X-Disagg-Phase") == "prefill":
                                    # hop 1 of a disagg handoff: run
                                    # admission + prefill, emit ONE
                                    # token (committing the prompt's
                                    # pages for export), and let the
                                    # decode pool take it from there
                                    req["max_new_tokens"] = 1
                                    stream = False
                                src = self.headers.get(
                                    "X-Disagg-KV-From")
                                if src:
                                    # hop 2: pull missing pages from
                                    # the prefill peer BEFORE engine
                                    # admission (router-forwarded
                                    # chain keys make it a prefetch)
                                    outer._disagg_prefetch(
                                        src,
                                        self.headers.get(
                                            "X-Disagg-Keys"),
                                        tenant)
                                it = outer.generate_steps(
                                    req, deadline=deadline,
                                    tenant=tenant)
                                if stream:
                                    # pull the first item BEFORE sending
                                    # the 200 header so request errors
                                    # (bad shape, no generator) still
                                    # surface as a real error status
                                    import itertools
                                    first = next(it)
                                    exc = self._stream_reply(
                                        itertools.chain([first], it),
                                        src=it)
                                    if exc is not None:
                                        raise _StreamAborted(str(exc)) \
                                            from exc
                                    outer._count("ok", tenant)
                                    outer._finish_request(ctx, "ok")
                                    return
                                steps = [o for o in it if "tokens" in o]
                                outer._count("ok", tenant)
                                outer._finish_request(ctx, "ok")
                                return self._reply(200, {
                                    "sequences": [
                                        [s["tokens"][b] for s in steps]
                                        for b in
                                        range(len(steps[0]["tokens"]))]
                                    if steps else []})
                            out = outer.predict(req.get("inputs", {}),
                                                deadline=deadline,
                                                tenant=tenant)
                            outer._count("ok", tenant)
                            outer._finish_request(ctx, "ok")
                            return self._reply(200, {"outputs": out})
                    except _StreamAborted:
                        # the 200 + error chunk are already on the wire;
                        # no reply possible, but _admit recorded the
                        # breaker failure on the way here
                        outer._count("server_error", tenant)
                        outer._finish_request(ctx, "server_error")
                        return
                    except OverloadError as e:
                        outer._count(e.counter, tenant)
                        outer._finish_request(ctx, e.counter)
                        return self._reply(e.status, {"error": str(e)},
                                           retry_after=e.retry_after)
                    except outer._CLIENT_ERRORS as e:
                        outer._count("client_error", tenant)
                        outer._finish_request(ctx, "client_error")
                        return self._reply(400, {"error": str(e)})
                    except Exception as e:      # noqa: BLE001
                        outer._count("server_error", tenant)
                        outer._finish_request(ctx, "server_error")
                        return self._reply(500, {"error": str(e)})
                finally:
                    if cv_token is not None:
                        obs_requests.reset_current(cv_token)
                    # backstop for paths that bypassed the handlers
                    # above (finish is idempotent: first reason wins)
                    outer._finish_request(ctx, "server_error")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self.host = host
        self._thread = None

    # -- overload gate ------------------------------------------------------
    def _count(self, key, tenant=None):
        self.metrics.inc("serving.requests", outcome=key)
        if self.tenancy is not None:
            # per-tenant twin of the outcome counter; unlabeled
            # traffic accounts under the default tenant so a
            # label-less storm is still visible per-tenant
            self.metrics.inc("tenant.requests", outcome=key,
                             tenant=self.tenancy.key(tenant))

    @staticmethod
    def _finish_request(ctx, reason):
        """None-tolerant RequestContext.finish (idempotent: a request
        the engine already retired keeps its engine-side outcome)."""
        if ctx is not None:
            ctx.finish(reason)

    def fleet_view(self):
        """The GET /debug/fleet body: a live FleetAggregator scan —
        step skew, per-rank heartbeat ages, straggler flags — when
        observability is on and a `fleet=` aggregator is attached;
        {"enabled": False, "view": None} otherwise (same shape as
        /debug/requests' disabled reply: routers switch on `enabled`)."""
        if not observability.ENABLED or self.fleet is None:
            return {"enabled": False, "view": None}
        # a view up to 1s old is served without store traffic: routers
        # poll every replica, and each fresh scan costs world_size
        # round-trips against the single rendezvous store
        return {"enabled": True,
                "view": self.fleet.scan(max_age_s=1.0)}

    def queue_depth(self):
        """Requests waiting for execution: buffered in the batcher
        plus pending engine admission — the /readyz 503 body's load
        number (advisory: both queues mutate concurrently)."""
        d = 0
        if self.batcher is not None:
            d += len(self.batcher._buf)
        g = self.generator
        if g is not None and hasattr(g, "_pending"):
            d += len(g._pending)
        return d

    def _request_deadline(self, req, headers):
        """Deadline from the X-Timeout-Ms header, the `timeout_ms` body
        field, or the server default — header wins. None = unbounded."""
        ms = headers.get("X-Timeout-Ms") if headers else None
        body_ms = req.pop("timeout_ms", None) \
            if isinstance(req, dict) else None
        if ms is None:
            ms = body_ms
        if ms is None:
            ms = self.default_timeout_ms
        if ms is None:
            return None
        ms = float(ms)                  # bad value -> 400 client error
        if ms <= 0:
            raise ValueError(f"timeout_ms must be > 0, got {ms}")
        return Deadline.after_ms(ms)

    def _kv_pull(self, handler):
        """POST /kv/pull {"keys": [...]} -> packed page bundle
        (application/octet-stream; inference/disagg.py wire format).
        The export half of the disagg handoff: a decode-pool peer asks
        for the chain keys it is missing and gets the longest leading
        run resident in this replica's host tier. Errors reply JSON —
        the puller treats anything non-200 as a failed transfer and
        cold-prefills locally."""
        g = self.generator
        try:
            n = int(handler.headers.get("Content-Length", 0))
            req = json.loads(handler.rfile.read(n)) if n else {}
            keys = [str(k) for k in (req.get("keys") or [])]
            if g is None or not hasattr(g, "export_pages"):
                return handler._reply(
                    404, {"error": "no disagg-capable generator"})
            entries = g.export_pages(keys)
            raw = pack_bundle(entries)
            if hasattr(g, "disagg"):
                g.disagg.note_export(len(entries), len(raw))
            handler.send_response(200)
            handler.send_header("Content-Type",
                                "application/octet-stream")
            handler.send_header("Content-Length", str(len(raw)))
            handler.send_header("X-Disagg-Pages", str(len(entries)))
            handler.end_headers()
            handler.wfile.write(raw)
        except OSError:
            pass                    # peer went away mid-transfer
        except Exception as e:      # noqa: BLE001
            try:
                handler._reply(500, {"error": str(e)})
            except OSError:
                pass

    def _disagg_prefetch(self, src, keys_csv, tenant=None):
        """Second-hop prefetch: pull the pages this replica's caches
        are missing from the prefill peer at `src` ("host:port"),
        stage them for the engine's next admission pass. Entirely
        best-effort — any failure (peer down, chaos, malformed
        bundle) leaves the request to cold-prefill locally: slower,
        never wrong."""
        g = self.generator
        if g is None or not keys_csv \
                or not hasattr(g, "stage_import"):
            return
        keys = [k for k in keys_csv.split(",") if k]
        if not keys:
            return
        missing = g.disagg_missing(keys)
        if not missing:
            # chain-key dedup: a warm decode replica transfers nothing
            g.disagg.note_dedup(len(keys))
            return
        t0 = time.monotonic()
        try:
            import http.client
            host, _, port = src.rpartition(":")
            body = json.dumps({"keys": missing}).encode()
            # WFQ transfer slot: under pull saturation tenants share
            # the path in weight proportion (a timed-out slot pulls
            # anyway — ordering is an optimization, completion is not)
            with self.disagg_arbiter.slot(tenant):
                conn = http.client.HTTPConnection(
                    host or "127.0.0.1", int(port), timeout=10.0)
                try:
                    conn.request(
                        "POST", "/kv/pull", body=body,
                        headers={"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    raw = resp.read()
                    status = resp.status
                finally:
                    conn.close()
            if status != 200:
                raise OSError(f"/kv/pull -> HTTP {status}")
            entries = unpack_bundle(raw)
            g.stage_import(entries)
            g.disagg.note_pull(len(entries), len(raw),
                               time.monotonic() - t0,
                               skipped=len(keys) - len(missing))
        except Exception:   # noqa: BLE001 — the transfer is an
            #                 optimization; admission must proceed
            g.disagg.note_pull_failure()

    @contextlib.contextmanager
    def _admit(self, deadline, tenant=None):
        """Admission front half (shed cheaply, in order: draining ->
        expired -> tenant quota -> capacity -> breaker) + outcome back
        half (breaker record, latency). The per-tenant quota runs
        BEFORE the global gate: an over-quota tenant's shed (typed
        429) never consumes a global slot, so other tenants' budgets
        are untouched by its storm. Control-plane rejections
        (OverloadError) and client errors never count as backend
        failures."""
        if chaos.ENABLED:
            chaos.maybe_delay("serving.admit.delay")
        if self._draining:
            raise ServerDraining("server is draining",
                                 retry_after=self.retry_after_s)
        if deadline is not None:
            deadline.check("before admission")
        if self.tenants is not None:
            try:
                self.tenants.try_acquire(tenant)
            except TenantQuotaExceeded:
                if observability.ENABLED:
                    observability.inc("tenant.shed", reason="admission",
                                      tenant=self.tenancy.key(tenant))
                raise
        try:
            self.admission.try_acquire()
            try:
                self.breaker.allow()
            except BaseException:
                self.admission.release()
                raise
        except BaseException:
            if self.tenants is not None:
                # shed by a LATER gate: the tenant's admitted count
                # must not include a request that never ran
                self.tenants.rollback(tenant)
            raise
        if observability.ENABLED:
            ctx = obs_requests.current()
            if ctx is not None:
                ctx.record("admitted")
        t0 = time.monotonic()
        try:
            yield
        except OverloadError:
            # shed by a later gate (deadline in queue, batcher full,
            # engine overload): the backend never answered, so hand an
            # un-judged half-open probe back instead of burning it
            self.breaker.release_probe()
            raise
        except self._CLIENT_ERRORS:
            # the backend did not fail; a bad payload must not
            # accumulate toward tripping the breaker
            self.breaker.record_success()
            raise
        except Exception:
            self.breaker.record_failure()
            raise
        else:
            self.breaker.record_success()
            self.latency.record(time.monotonic() - t0)
            if self._warming:
                # first completed request = first compile paid: the
                # cold-start gate opens itself
                self._warming = False
        finally:
            self.admission.release()
            if self.tenants is not None:
                self.tenants.release(tenant)

    @staticmethod
    def _chaos_run_gate():
        if chaos.ENABLED:
            # a slow predictor (serving.run.delay) stretches deadlines;
            # a failed run (serving.run.fail) feeds the circuit breaker
            chaos.maybe_delay("serving.run.delay")
            if chaos.should_fire("serving.run.fail"):
                raise chaos.InjectedFault(
                    "chaos: injected predictor run failure")

    def readiness(self):
        """(ready, reason) for /readyz. Liveness (/healthz) is separate:
        a draining, warming, or breaker-open server is alive but
        unready. Reason order = severity order: draining (terminal)
        beats warming (transient cold start) beats breaker (failing)
        beats saturated (busy)."""
        if self._draining:
            return False, "draining"
        if self._warming:
            return False, "warming"
        bstate = self.breaker.state
        if bstate != CircuitBreaker.CLOSED:
            return False, f"breaker_{bstate}"
        if self.admission.saturated:
            return False, "saturated"
        return True, "ready"

    def mark_warm(self):
        """Declare the cold start over (an operator-driven warmup ran
        out-of-band). The first completed request does this itself."""
        self._warming = False

    def mark_warming(self):
        """Re-enter the warming state (an in-place weight swap voids
        the compile cache; /readyz steers traffic away until the first
        post-swap request completes). Also the chaos
        `autopilot.replica.hang` wedge: alive, never ready."""
        self._warming = True

    def stats(self):
        # the registry is the source of truth; /stats keys unchanged
        counts = {dict(k).get("outcome", ""): v
                  for k, v in self._requests.labeled().items()}
        out = {"model": self.model_name,
               "draining": self._draining,
               "warming": self._warming,
               "in_flight": self.admission.in_flight,
               "queue_depth": self.queue_depth(),
               "capacity": self.admission.capacity,
               "requests": counts,
               "breaker": self.breaker.snapshot(),
               "latency_ms": self.latency.snapshot()}
        if self.batcher is not None:
            out["batcher"] = {
                "batches_run": self.batcher.batches_run,
                "requests_served": self.batcher.requests_served,
                "queued": len(self.batcher._buf),
                "expired_in_queue": self.batcher.expired_in_queue,
                "shed_full": self.batcher.shed_full,
                "shed_tenant": self.batcher.shed_tenant}
        g = self.generator
        if g is not None and hasattr(g, "prefix_stats"):
            # the engine's prefix-cache hit stats (PagedKVEngine with
            # prefix_cache_pages>0): the router probes this block to
            # make per-replica KV locality a visible number
            p = g.prefix_stats()
            if p is not None:
                out["prefix"] = p
        if g is not None and hasattr(g, "kvtier_stats"):
            # the host-RAM KV tier's spill/restore/suspend counters
            # (PagedKVEngine with host_tier_bytes>0): the router reads
            # hits/lookups for its tier-hit-rate column
            kt = g.kvtier_stats()
            if kt is not None:
                out["kvtier"] = kt
        if g is not None and hasattr(g, "disagg_stats"):
            # the disagg handoff block — always present for
            # engine-backed servers: the router's prober reads `role`
            # from it to learn each replica's pool membership
            d = g.disagg_stats()
            if d is not None:
                d = dict(d)
                d["arbiter"] = self.disagg_arbiter.snapshot()
                out["disagg"] = d
        if self.tenancy is not None:
            out["tenants"] = self.tenant_stats()
        return out

    def tenant_stats(self):
        """Per-tenant /stats rows (tenancy configured): policy knobs,
        live admission counts, batcher queue depth, and the engine's
        per-tenant shares when the generator reports them."""
        adm = self.tenants.snapshot()
        queued = (self.batcher.tenant_queued()
                  if self.batcher is not None else {})
        g = self.generator
        eng = (g.tenant_snapshot()
               if g is not None and hasattr(g, "tenant_snapshot")
               else {})
        out = {}
        for t in sorted(set(adm) | set(queued) | set(eng)):
            row = dict(adm.get(t)
                       or {"in_flight": 0, "admitted": 0, "shed": 0})
            row["queued"] = queued.get(t, 0)
            row["policy"] = self.tenancy.policy(t).describe()
            if t in eng:
                row["engine"] = eng[t]
            out[t] = row
        return out

    def metrics_text(self):
        """The GET /metrics body: scrape-time gauges for the live
        admission/breaker/batcher state, engine counters from a
        generator exposing `export_metrics(registry)` (PagedKVEngine),
        this server's request counters + latency histogram, then the
        process-wide observability registry."""
        m = self.metrics
        m.set_gauge("serving.in_flight", self.admission.in_flight)
        m.set_gauge("serving.capacity", self.admission.capacity)
        m.set_gauge("serving.draining", 1.0 if self._draining else 0.0)
        m.set_gauge("serving.warming", 1.0 if self._warming else 0.0)
        m.set_gauge("serving.admission.admitted", self.admission.admitted)
        m.set_gauge("serving.admission.rejected", self.admission.rejected)
        b = self.breaker.snapshot()
        m.set_gauge("serving.breaker.state",
                    {"closed": 0, "half_open": 1, "open": 2}.get(
                        b["state"], -1))
        m.set_gauge("serving.breaker.consecutive_failures",
                    b["consecutive_failures"])
        m.set_gauge("serving.breaker.opens", b["opens"])
        m.set_gauge("serving.breaker.recloses", b["recloses"])
        if self.batcher is not None:
            m.set_gauge("serving.batcher.queued", len(self.batcher._buf))
            m.set_gauge("serving.batcher.batches_run",
                        self.batcher.batches_run)
            m.set_gauge("serving.batcher.requests_served",
                        self.batcher.requests_served)
            m.set_gauge("serving.batcher.expired_in_queue",
                        self.batcher.expired_in_queue)
            m.set_gauge("serving.batcher.shed_full",
                        self.batcher.shed_full)
            m.set_gauge("serving.batcher.shed_tenant",
                        self.batcher.shed_tenant)
        if self.tenants is not None:
            for t, row in self.tenants.snapshot().items():
                m.set_gauge("tenant.in_flight", row["in_flight"],
                            tenant=t)
        g = self.generator
        if g is not None and hasattr(g, "export_metrics"):
            g.export_metrics(m)
        glob = observability.REGISTRY
        text = m.prometheus_text()
        if glob is not m:
            # a family already emitted from the server registry must
            # not repeat (e.g. another server sharing the global
            # registry via metrics=): duplicate # TYPE lines are
            # invalid exposition and fail the whole scrape
            text += glob.prometheus_text(exclude=m.names())
        return text

    # -- core -------------------------------------------------------------
    _GEN_PARAMS = ("max_new_tokens", "attention_mask", "eos_token_id",
                   "pad_token_id", "do_sample", "temperature", "top_k",
                   "top_p", "seed", "tokens_per_fetch")

    def generate_steps(self, req, deadline=None, tenant=None):
        """Yield {"step": i, "tokens": [...]} per generated position,
        then {"done": True, "steps": n}.

        Compute runs in a PRODUCER thread that holds the executable lock
        only while generating; this (consumer) iterator just drains a
        queue. A slow streaming client therefore stalls its own socket
        writes, never the chip lock — /predict and other /generate
        requests keep flowing."""
        if self.generator is None:
            raise ValueError("this server has no generator "
                             "(pass generator= to PredictorServer)")
        if deadline is not None:
            deadline.check("before generation")
        self._chaos_run_gate()
        ids = np.asarray(req["ids"], "int32")
        kw = {k: req[k] for k in self._GEN_PARAMS if k in req}
        g = self.generator
        if hasattr(g, "stream"):
            # stream() decodes the rows itself; the device block loop
            # of generate_stream does not apply
            kw.pop("tokens_per_fetch", None)
            if deadline is not None \
                    and getattr(g, "concurrent_safe", False):
                # the paged engine's admission understands deadlines
                kw["deadline"] = deadline
            if tenant is not None \
                    and getattr(g, "concurrent_safe", False):
                # attribution rides into the ENGINE's per-request
                # bookkeeping (stream() forwards it to submit());
                # gated like `deadline` above — bundle predictors'
                # stream() takes no tenant kwarg, and a labeled
                # request must not 500 on them
                kw["tenant"] = tenant
            if "session" in req \
                    and getattr(g, "concurrent_safe", False):
                # conversation identity rides to the engine's tiered-KV
                # session retention / suspend-resume bookkeeping; gated
                # like tenant — bundle predictors have no sessions
                kw["session"] = req["session"]
            it = g.stream(ids, **kw)
        else:
            # a CausalLM: static-cache generation, run lazily on the
            # producer thread under the executable lock below
            it = generate_stream(g, ids, **kw)

        import queue
        q: queue.Queue = queue.Queue()
        _END = object()
        cancelled = threading.Event()

        # a continuous-batching generator (PagedKVEngine) multiplexes
        # concurrent requests itself — serializing its streams through
        # the executable lock would defeat mid-decode admission
        lock = (contextlib.nullcontext()
                if getattr(g, "concurrent_safe", False) else self._lock)

        def produce():
            try:
                with lock:
                    step = 0
                    for tok in it:
                        if cancelled.is_set():
                            # consumer gone: free the chip. close() the
                            # source too — an engine-backed stream
                            # cancels its in-flight requests on close,
                            # a plain generator just stops
                            if hasattr(it, "close"):
                                it.close()
                            break
                        q.put({"step": step,
                               "tokens": np.asarray(tok).tolist()})
                        step += 1
                    else:
                        q.put({"done": True, "steps": step})
            except Exception as e:      # noqa: BLE001
                q.put(e)
            q.put(_END)

        # run the producer under a COPY of this thread's contextvars
        # context: the engine's submit() happens on the producer thread
        # and must see the same RequestContext the handler bound
        run_ctx = contextvars.copy_context()
        t = threading.Thread(target=run_ctx.run, args=(produce,),
                             daemon=True)
        t.start()
        ctx = obs_requests.current() if observability.ENABLED else None
        eos = kw.get("eos_token_id")
        finished_rows = None        # per-row EOS tracking (pad filter)
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, Exception):
                    raise item
                if ctx is not None and not ctx.tokens_claimed \
                        and "tokens" in item:
                    # generators that trace their own emissions
                    # (PagedKVEngine) claim token accounting at
                    # submit; everything else is recorded here, at
                    # the step the HTTP consumer actually saw. Two
                    # multi-row corrections: a row that hit EOS keeps
                    # yielding pad_token_id until the whole batch
                    # drains (generate_stream contract) — pads are
                    # not generated tokens; and each live row gets
                    # ONE token per step, so its user-felt ITL is the
                    # FULL step gap — per-row gap clocks (stream=i),
                    # not one shared clock that would divide the gap
                    # by the batch width and flatter the SLO.
                    toks = item["tokens"]
                    if finished_rows is None:
                        finished_rows = [False] * len(toks)
                    for i, tok in enumerate(toks):
                        if finished_rows[i]:
                            continue
                        ctx.record_tokens(1, stream=i)
                        if eos is not None and tok == eos:
                            finished_rows[i] = True
                yield item
        finally:
            # a disconnected /generate client closes this generator;
            # without the signal the producer would keep decoding (and
            # holding the chip lock) to max_new_tokens for nobody
            cancelled.set()

    def metadata(self):
        p = self.predictor
        if hasattr(p, "get_input_names"):
            return {"inputs": list(p.get_input_names()),
                    "outputs": list(p.get_output_names())}
        return {"inputs": [], "outputs": []}

    @staticmethod
    def _decode(v):
        if isinstance(v, dict):
            return np.asarray(v["data"], dtype=v.get("dtype", "float32"))
        return np.asarray(v, dtype=np.float32)

    def _run_locked(self, arrays):
        """list-of-arrays -> list-of-arrays through the predictor, under
        the executable lock (DynamicBatcher's run_fn). Exported programs
        are shape-monomorphic, so a merged batch is PADDED up to the
        exported leading dim and the outputs sliced back — deploy with
        input_spec batch = max_batch_size."""
        p = self.predictor
        rows = int(np.asarray(arrays[0]).shape[0])
        self._chaos_run_gate()
        with self._lock:
            if hasattr(p, "run"):
                shapes = (p.input_shapes()
                          if hasattr(p, "input_shapes") else None)
                if shapes and shapes[0] and shapes[0][0] < rows:
                    # an oversized batch would otherwise reach the
                    # program and die with a cryptic shape mismatch
                    raise OversizedBatch(
                        f"batch of {rows} rows exceeds the exported "
                        f"leading dim {shapes[0][0]}; split the request "
                        "or re-export with a larger batch input_spec")
                if shapes and shapes[0] and shapes[0][0] > rows:
                    tgt = shapes[0][0]
                    arrays = [np.concatenate(
                        [a, np.zeros((tgt - rows,) + a.shape[1:],
                                     a.dtype)], 0) for a in arrays]
                out = p.run(list(arrays))
                outs = out if isinstance(out, list) else [out]
                return [np.asarray(o)[:rows] if np.asarray(o).ndim >= 1
                        and np.asarray(o).shape[0] >= rows else o
                        for o in outs]
            res = p({f"x{i}": a for i, a in enumerate(arrays)})
            return [np.asarray(v) for v in res.values()]

    def _resolve_inputs(self, names, inputs):
        """Decode request inputs in the program's input order, with the
        single-input convenience (accept any key when both sides have
        exactly one)."""
        arrays = []
        for name in names:
            if name not in inputs and len(names) == 1 \
                    and len(inputs) == 1:
                (v,) = inputs.values()
            else:
                v = inputs[name]
            arrays.append(self._decode(v))
        return arrays

    def predict(self, inputs: dict, deadline=None, tenant=None) -> dict:
        p = self.predictor
        if self.batcher is not None and hasattr(p, "get_input_names"):
            arrays = self._resolve_inputs(p.get_input_names(), inputs)
            try:
                outs = self.batcher.submit(arrays, deadline=deadline,
                                           tenant=tenant)
            except OversizedBatch:
                raise       # a solo run hits the same exported-dim wall
            except UnbatchableRequest:
                outs = None             # solo run below
            if outs is not None:
                return {f"out{i}": {"data": np.asarray(a).tolist(),
                                    "dtype": str(np.asarray(a).dtype),
                                    "shape": list(np.asarray(a).shape)}
                        for i, a in enumerate(outs)}
        if deadline is not None:
            deadline.check("before predictor run")
        self._chaos_run_gate()
        with self._lock:
            if hasattr(p, "get_input_names"):
                names = p.get_input_names()
                for name, arr in zip(names,
                                     self._resolve_inputs(names, inputs)):
                    p.get_input_handle(name).copy_from_cpu(arr)
                p.run()
                out = {}
                for name in p.get_output_names():
                    arr = p.get_output_handle(name).copy_to_cpu()
                    out[name] = {"data": np.asarray(arr).tolist(),
                                 "dtype": str(np.asarray(arr).dtype),
                                 "shape": list(np.asarray(arr).shape)}
                return out
            # plain callable over numpy dict
            res = p({k: self._decode(v) for k, v in inputs.items()})
            return {k: {"data": np.asarray(v).tolist(),
                        "dtype": str(np.asarray(v).dtype),
                        "shape": list(np.asarray(v).shape)}
                    for k, v in res.items()}

    # -- lifecycle --------------------------------------------------------
    def start(self):
        # serve_forever looks for shutdown() once a poll interval; 0.05 s,
        # not the stdlib's 0.5 s, bounds how long stop() and drain() wait
        # for the serving thread
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        args=(0.05,), daemon=True)
        self._thread.start()
        return self

    def drain(self, timeout=30.0, poll_s=0.01):
        """Graceful shutdown: stop admitting (new requests shed with 503
        + Retry-After, /readyz flips to "draining"), wait up to
        `timeout` seconds for in-flight requests to finish, then stop
        the server. Returns True when nothing was left in flight.

        With observability on, drain start also dumps a flight-recorder
        bundle (no-op unless a bundle dir is configured): a SIGTERM
        drain is usually a preemption, and the in-flight registry /
        span / metric evidence is about to drain away with the
        process."""
        self._draining = True
        if observability.ENABLED:
            self._flight_dump()
        t_end = time.monotonic() + timeout
        while self.admission.in_flight > 0 and time.monotonic() < t_end:
            time.sleep(poll_s)
        clean = self.admission.in_flight == 0
        self.stop()
        return clean

    def _flight_dump(self):
        """Flight-recorder bundle at drain start (observability/
        fleet.py; no-op without a configured bundle dir). Never lets
        recording break the drain."""
        try:
            from paddle_tpu_torch.observability import fleet
            fleet.record_crash("serving_drain",
                               extra={"stats": self.stats()})
        except Exception as e:      # noqa: BLE001 — see docstring
            print(f"WARNING: flight-recorder dump failed: {e!r}",
                  file=sys.stderr)

    def stop(self, join_timeout=5.0):
        if self.batcher is not None:
            self.batcher.stop(join_timeout=join_timeout)
        if self._thread is not None:
            # shutdown() handshakes with serve_forever and would block
            # forever on a server that was never start()ed
            self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            # bounded: a handler wedged in a request must not hang
            # shutdown (daemon thread, dies with the process)
            self._thread.join(timeout=join_timeout)

