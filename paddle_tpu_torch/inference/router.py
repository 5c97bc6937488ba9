"""Replica fleet router: a health-aware HTTP frontend over N
`PredictorServer` replicas.

Counterpart of paddle_tpu/inference/router.py, copied and adapted (the
module is stdlib-only, but importing it would import the JAX package):
the same names, constructor keywords, state machine, metrics, chaos
sites and HTTP surfaces, over the port's servers (whose engines run on
the card; the router itself has no device). `attach_autopilot` takes the
port's FleetAutopilot (inference/autopilot.py) for `GET /debug/autopilot`
and the /stats rollout block.

One `PredictorServer` + one `PagedKVEngine` is a single-chip ceiling;
serving heavy traffic means N replicas behind a frontend that turns a
replica crash, drain, or overload into a *routed-around event* instead
of a user-visible outage (the Orca/vLLM deployment shape: continuous-
batching engines behind a load-balancing frontend). This router is
that frontend, built entirely on the signals the serving stack already
exports:

    replica registry   `add_replica("host:port")`; a background prober
                       polls every replica's `/readyz` (+ `/stats` when
                       ready) and drives a small state machine:
                       - 200 ready        -> in rotation
                       - 503 "saturated"  -> in rotation, deprioritized
                         (the /readyz early-warning watermark)
                       - 503 "draining"   -> ejected IMMEDIATELY (a
                         draining replica finishes its in-flight work;
                         new work must route away now)
                       - 503 "breaker_*"  -> replica backend failing:
                         counts toward ejection like a failed probe
                       - unreachable      -> `eject_after` consecutive
                         failures eject (reason "probe_failed")
                       An ejected replica re-enters only after
                       `reenter_probes` CONSECUTIVE clean probes
                       (flap damping — one good probe of a sick
                       replica must not pull traffic back onto it).
    least-loaded pick  among in-rotation replicas, ordered by the
                       numeric load signals: the router's own live
                       in-flight count per replica plus the
                       `in_flight`/`queue_depth` fields probed from
                       `/readyz` 503 bodies and `/stats`; saturated
                       replicas sort last, ties rotate round-robin.
    circuit breakers   one `overload.CircuitBreaker` per replica on the
                       FORWARD path: consecutive connect/stream
                       failures trip it open (the replica is skipped
                       without a connect attempt, then ejected), a
                       half-open probe self-heals it. Replica sheds
                       (429/503) are control-plane, never breaker
                       failures.
    session affinity   requests carrying `X-Session-Id` pin to a
                       replica (bounded LRU): a streaming conversation
                       keeps hitting the replica that holds its KV
                       pages. A pinned replica leaving rotation
                       re-pins the session to a healthy one
                       (`router.affinity.rebinds`).
    prefix routing     with `prefix_page_size=N` (match the engines'
                       `page_size`), /generate prompts are hashed by
                       the SAME page-aligned chain the engines' prefix
                       cache uses (inference/prefix.py) and a bounded
                       chain-key -> replica LRU steers repeated
                       prefixes to the replica that already holds
                       their KV pages (probing keys deepest-first =
                       longest-prefix match). Same re-pin-on-rotation-
                       exit semantics as session affinity: a healthy
                       pinned replica that is merely excluded or
                       saturated for THIS request is routed around
                       without moving the pin; pins whose replicas all
                       left rotation re-bind to the least-loaded pick
                       (`router.prefix.rebinds`). Session affinity
                       wins over prefix routing (an explicit client
                       pin beats a statistical one).
    retry-on-shed      a 429/503 from a replica fails over to the next
                       candidate immediately (the shedding replica is
                       excluded for this request); when EVERY routable
                       replica shed, the router honors the largest
                       advertised `Retry-After` floor with full-jitter
                       backoff (`distributed/retries.py`) and retries
                       one more round before relaying the shed reply.
    failover/replay    a connection that dies before any response byte
                       replays the (idempotent) request against the
                       next replica; a stream that dies MID-flight —
                       after tokens already reached the client —
                       cannot be replayed, so the client gets a typed,
                       retryable error chunk
                       `{"error", "reason": "replica_failed",
                       "retryable": true, "replica"}` instead of a
                       hang or a torn connection.

Observability continuity (the request-tracing contract): the router
forwards the inbound `X-Request-Id` / `traceparent` to the chosen
replica and echoes the replica's reply headers back to the client, so
ONE trace id spans router -> replica; router-origin replies (sheds,
no-replica) echo the sanitized inbound identity themselves. Every reply carries
`X-Routed-To: <replica id>`.

Surfaces:
    POST /predict, /generate   routed (stream=true relays chunked
                               ndjson token-by-token)
    GET  /healthz              router liveness
    GET  /readyz               200 while >=1 replica is in rotation;
                               503 {"reason": "no_replicas"} otherwise
    GET  /debug/replicas       the router's live view: per-replica
                               state/reason/load/breaker/probe
                               counters + a summary (schema in README)
    GET  /debug/autopilot      supervisor/autoscaler/rollout state when
                               a FleetAutopilot is attached
                               (inference/autopilot.py); 404 otherwise
    GET  /stats                request/retry counters, session count
                               (+ the rollout state machine when an
                               autopilot is attached)
    GET  /metrics              Prometheus exposition of the router.*
                               family (+ the global registry)

Chaos sites (distributed/chaos.py POINTS) drive every path
deterministically: `router.probe.delay`, `router.probe.flap` (a clean
probe recorded as failed — the damping lever), `router.connect.fail`
(forward-time connect drop — the failover lever), and
`router.replica.kill` (fires the registered `kill_hook` right after a
relayed stream chunk — the kill-a-replica soak's lever).

On ejection for probe failures / breaker open, the router dumps a
flight-recorder bundle (`observability.fleet.record_crash
("replica_ejected", ...)` with the replica's last-known stats) when
observability is enabled — the evidence of WHY a replica left rotation
survives the incident.

Everything here is stdlib-only (routers run on frontend nodes with no
accelerator), and reads no environment variable.
"""
from __future__ import annotations

import collections
import http.client
import json
import math
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from paddle_tpu_torch import observability
from paddle_tpu_torch.distributed import chaos
from paddle_tpu_torch.distributed.retries import RetryPolicy
from paddle_tpu_torch.inference.overload import (CircuitBreaker,
                                                 CircuitOpenError,
                                                 jittered_retry_after)
from paddle_tpu_torch.inference.prefix import chain_keys
from paddle_tpu_torch.inference.tenancy import (TenantRateLimiter,
                                                resolve_tenant)
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.observability.requests import (parse_traceparent,
                                                     safe_request_id)

__all__ = ["ReplicaRouter", "Replica"]

#: replica response headers the router relays back to its client (the
#: trace-continuity pair, the tenant echo, the shed backoff hint, and
#: the body type)
_ECHO_HEADERS = ("X-Request-Id", "traceparent", "X-Tenant-Id",
                 "Retry-After", "Content-Type")

#: request headers forwarded verbatim to the chosen replica (trace
#: identity + tenant identity + affinity key; Content-Type is always
#: set). The X-Timeout-Ms deadline budget is handled separately: the
#: router DECREMENTS it by the time already burned on failed attempts
#: and backoff sleeps before each replay — forwarding it verbatim
#: would restart the client's deadline from zero on every failover.
#: (A `timeout_ms` BODY field passes through opaque; header wins on
#: the replica anyway.)
_FORWARD_HEADERS = ("X-Request-Id", "traceparent", "X-Tenant-Id",
                    "X-Session-Id")


class Replica:
    """The router's record of one replica: identity, rotation state,
    probe counters, last-probed load numbers, and the router-side
    circuit breaker. All mutable state is guarded by the ROUTER's lock
    (single-writer registry; the breaker has its own lock)."""

    __slots__ = ("rid", "url", "host", "port", "breaker", "in_rotation",
                 "deprioritized", "reason", "consecutive_ok",
                 "consecutive_fail", "in_flight_router",
                 "probed_in_flight", "probed_queue_depth",
                 "last_probe_t", "last_stats", "ejections", "served",
                 "tenants", "probation", "role")

    def __init__(self, rid, url, breaker):
        self.rid = str(rid)
        self.url = str(url)
        host, _, port = self.url.rpartition(":")
        if "/" in host or not port.isdigit():
            # a scheme-prefixed URL would silently parse into an
            # unresolvable host and sit out of rotation forever
            raise ValueError(
                f"replica url must be bare host:port, got {url!r}")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.breaker = breaker
        self.in_rotation = False
        self.deprioritized = False
        self.reason = "unprobed"
        self.consecutive_ok = 0
        self.consecutive_fail = 0
        self.in_flight_router = 0       # live router-side forwards
        self.probed_in_flight = 0       # replica's own /readyz|/stats
        self.probed_queue_depth = 0
        self.last_probe_t = None
        self.last_stats = {}            # newest /stats body (flight rec)
        self.ejections = 0
        self.served = 0
        self.probation = False          # hold fresh registration to the
        #                                 flap-damped entry gate (autopilot
        #                                 relaunches: K clean probes)
        self.tenants = {}               # tenant -> requests served here
        #                                 (bounded; overflow folds into
        #                                 "_other" like the registry)
        self.role = None                # disagg pool: "prefill" |
        #                                 "decode" | None (monolithic).
        #                                 Set at registration or learned
        #                                 from the probed /stats disagg
        #                                 block.

    def load_score(self):
        """Least-loaded ordering key: the router's live in-flight
        count plus the replica's last-probed queue numbers (advisory —
        both mutate concurrently; the pick only needs relative order)."""
        return (self.in_flight_router + self.probed_in_flight
                + self.probed_queue_depth)


class ReplicaRouter:
    """HTTP frontend load-balancing across `PredictorServer` replicas
    (module doc). `replicas` is an iterable of "host:port" strings or
    (replica_id, "host:port") pairs; more can be added live with
    `add_replica`.

    `start()` runs one synchronous probe pass (replicas become
    routable before the first request), then starts the background
    prober and the HTTP server. Tests drive the state machine
    deterministically by calling `probe_all()` themselves without
    `start()`ing the prober.

    `kill_hook(replica_id)` is the chaos lever: when the
    `router.replica.kill` site fires mid-relay, the router invokes it
    against the replica currently being forwarded to — the fleet soak
    registers a hook that actually tears that replica down."""

    def __init__(self, replicas=(), host="127.0.0.1", port=0, *,
                 probe_interval_s=0.5, probe_timeout_s=2.0,
                 forward_timeout_s=30.0, eject_after=2, reenter_probes=3,
                 shed_rounds=2, affinity_capacity=4096,
                 breaker_threshold=3, breaker_reset_s=5.0,
                 retry_after_s=1.0, retry_policy=None, kill_hook=None,
                 metrics=None, prefix_page_size=None,
                 prefix_capacity=4096, prefix_max_pages=32,
                 tenancy=None):
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.forward_timeout_s = float(forward_timeout_s)
        self.eject_after = int(eject_after)
        self.reenter_probes = int(reenter_probes)
        self.shed_rounds = int(shed_rounds)
        self.affinity_capacity = int(affinity_capacity)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_reset_s = float(breaker_reset_s)
        self.retry_after_s = float(retry_after_s)
        self.kill_hook = kill_hook
        # full-jitter backoff for the router's own retry pacing: shed
        # replicas advertise a Retry-After floor, the policy's jittered
        # delay sequence spreads the retries of many routers/clients
        # apart instead of re-synchronizing the storm
        self._retry = retry_policy if retry_policy is not None \
            else RetryPolicy(max_attempts=3, base_delay=0.05,
                             max_delay=1.0, jitter="full")
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry()
        self._requests = self.metrics.counter("router.requests")
        # multi-tenant front door (inference/tenancy.py): the router
        # forwards X-Tenant-Id to the replica either way; with a
        # TenantTable it ALSO enforces fleet-wide per-tenant rate caps
        # (policy.rate_limit req/s token bucket) before routing —
        # over-cap traffic sheds a typed 429 + jittered Retry-After
        # at the cheapest possible point, never reaching a replica
        self.tenancy = tenancy
        if tenancy is not None:
            self._tenant_rl = TenantRateLimiter(tenancy)
        else:
            self._tenant_rl = None
        #: cap on distinct per-replica tenant rows in /debug/replicas
        #: (overflow folds into "_other", mirroring the registry guard)
        self._tenant_row_cap = 32
        # prefix-hash routing (module doc): None disables; when set it
        # must equal the replicas' engine page_size or the hashes
        # can't agree with the pages the replicas actually cache
        self.prefix_page_size = (int(prefix_page_size)
                                 if prefix_page_size else None)
        self.prefix_capacity = int(prefix_capacity)
        self.prefix_max_pages = int(prefix_max_pages)
        # optional FleetAutopilot (inference/autopilot.py): set via
        # attach_autopilot; serves /debug/autopilot + the rollout
        # block in /stats
        self.autopilot = None
        self._lock = threading.Lock()
        self._order: list[Replica] = []     # registration order
        self._by_id: dict[str, Replica] = {}
        self._affinity: collections.OrderedDict = collections.OrderedDict()
        self._prefix: collections.OrderedDict = collections.OrderedDict()
        # decode-pool pin map (disagg): chain key -> decode replica
        # whose pools hold the handed-off pages (second-hop residency
        # routing; separate from _prefix so hop-1 prefill affinity and
        # hop-2 residency never overwrite each other)
        self._prefix_decode: collections.OrderedDict = \
            collections.OrderedDict()
        self._rr = 0
        self._probe_stop = threading.Event()
        self._probe_thread = None
        for spec in replicas:
            if isinstance(spec, (tuple, list)):
                self.add_replica(spec[1], rid=spec[0])
            else:
                self.add_replica(spec)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):      # quiet
                pass

            def do_GET(self):
                if self.path in ("/health", "/healthz"):
                    return outer._reply_json(self, 200,
                                             {"status": "ok",
                                              "role": "router"})
                if self.path == "/readyz":
                    n = outer.in_rotation_count()
                    if n > 0:
                        return outer._reply_json(
                            self, 200, {"status": "ready",
                                        "replicas_in_rotation": n})
                    ra = jittered_retry_after(outer.retry_after_s)
                    return outer._reply_json(
                        self, 503, {"status": "unready",
                                    "reason": "no_replicas",
                                    "retryable": True,
                                    "retry_after_s": round(ra, 3)},
                        retry_after=ra)
                if self.path == "/debug/replicas":
                    return outer._reply_json(self, 200,
                                             outer.debug_replicas())
                if self.path == "/debug/autopilot":
                    ap = outer.autopilot
                    if ap is None:
                        return outer._reply_json(
                            self, 404, {"error": "no autopilot attached"})
                    return outer._reply_json(self, 200, ap.debug())
                if self.path == "/stats":
                    return outer._reply_json(self, 200, outer.stats())
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
                return outer._reply_json(self, 404,
                                         {"error": "unknown path"})

            def do_POST(self):
                if self.path not in ("/predict", "/generate"):
                    return outer._reply_json(self, 404,
                                             {"error": "unknown path"})
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n) if n else b""
                stream_req = False
                pkeys = ()
                if self.path == "/generate":
                    try:
                        obj = json.loads(raw) if raw else {}
                        stream_req = bool(isinstance(obj, dict)
                                          and obj.get("stream"))
                        pkeys = outer._prompt_prefix_keys(obj)
                    except ValueError:
                        pass    # opaque body: the replica will 400 it
                session = self.headers.get("X-Session-Id")
                tenant = stamp = None
                if outer.tenancy is not None:
                    gate = outer._tenant_gate(self)
                    if gate is None:
                        return      # shed; typed 429 already written
                    tenant, stamp = gate
                try:
                    if pkeys and self.path == "/generate" \
                            and outer._disagg_active():
                        outer._route_disagg(
                            self, self.path, raw, self.headers,
                            stream_req, session, pkeys,
                            tenant=tenant, stamp=stamp)
                    else:
                        outer._route(self, self.path, raw, self.headers,
                                     stream_req, session, pkeys,
                                     tenant=tenant, stamp=stamp)
                except Exception as e:      # noqa: BLE001
                    # router-bug backstop: a typed reply (or a closed
                    # socket), never a silently hung client
                    outer._count("server_error")
                    try:
                        outer._router_error(
                            self, self.headers, 500, "router_error",
                            f"router internal error: {e}",
                            retryable=False)
                    except OSError:
                        pass    # headers already sent / client gone

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self.host = host
        self._thread = None

    # -- registry -----------------------------------------------------------
    def add_replica(self, url, rid=None, probation=False, role=None):
        """Register a replica ("host:port"). It enters rotation after
        its first clean probe (never blindly); `probation=True` holds
        it to the full flap-damped gate instead — `reenter_probes`
        CONSECUTIVE clean probes — which is how the autopilot registers
        relaunched/swapped replicas so a cold or sick restart pre-warms
        behind /readyz instead of eating live traffic off one lucky
        probe. `role` ("prefill" | "decode") declares disagg pool
        membership up front; left None, the prober learns it from the
        replica's own /stats disagg block."""
        if role not in (None, "prefill", "decode"):
            raise ValueError(f"role must be None, 'prefill' or "
                             f"'decode' (got {role!r})")
        rid = str(rid if rid is not None else url)
        breaker = CircuitBreaker(failure_threshold=self.breaker_threshold,
                                 reset_after_s=self.breaker_reset_s)
        r = Replica(rid, url, breaker)
        r.probation = bool(probation)
        r.role = role
        with self._lock:
            if rid in self._by_id:
                raise ValueError(f"replica id {rid!r} already registered")
            self._by_id[rid] = r
            self._order.append(r)
            self._refresh_gauges_locked()
        return r

    def remove_replica(self, rid):
        """Administratively drop a replica (scale-in, supervisor
        restart, rollout swap). Everything keyed on it goes with it:
        the Replica record (and its breaker — a later `add_replica`
        under the same id starts with a FRESH closed breaker, never an
        inherited open one) plus every session/prefix pin pointing at
        it. The unbind is counted into the rebind counters here — the
        pinned key's next request silently creates a fresh pin, so
        purge time is the only point the forced re-pin is observable."""
        rid = str(rid)
        with self._lock:
            r = self._by_id.pop(rid, None)
            if r is not None:
                self._order.remove(r)
                dead_sessions = [k for k, v in self._affinity.items()
                                 if v == rid]
                for k in dead_sessions:
                    del self._affinity[k]
                dead_keys = [k for k, v in self._prefix.items()
                             if v == rid]
                for k in dead_keys:
                    del self._prefix[k]
                for k in [k for k, v in self._prefix_decode.items()
                          if v == rid]:
                    del self._prefix_decode[k]
                if dead_sessions:
                    self.metrics.inc("router.affinity.rebinds",
                                     len(dead_sessions))
                if dead_keys:
                    # one event per removal, matching the per-request
                    # (not per-chain-key) grain of the lazy rebind path
                    self.metrics.inc("router.prefix.rebinds")
                self._refresh_gauges_locked()
        return r is not None

    def replica(self, rid) -> Replica | None:
        # guarded read: add/remove_replica mutate _by_id under _lock
        # from admin/scale paths while probers and handlers look up
        # (found by the guarded-field analyzer pass)
        with self._lock:
            return self._by_id.get(str(rid))

    def in_rotation_count(self):
        with self._lock:
            return sum(1 for r in self._order if r.in_rotation)

    # -- probing ------------------------------------------------------------
    def probe_all(self):
        """One synchronous probe pass over every replica — what the
        background prober runs each interval, and what tests call
        directly to drive the state machine event-by-event. Replicas
        are probed CONCURRENTLY (short-lived threads, joined before
        return): one hard-down replica eating its full connect timeout
        must not stall detection for the rest of the fleet."""
        # snapshot under _lock: remove_replica mutates _order while the
        # prober iterates (found by the guarded-field analyzer pass)
        with self._lock:
            reps = list(self._order)
        if len(reps) == 1:
            self._probe_one(reps[0])
        elif reps:
            threads = [threading.Thread(
                target=self._probe_one, args=(r,), daemon=True,
                name=f"router-probe-{r.rid}") for r in reps]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        with self._lock:
            self._refresh_gauges_locked()

    def _probe_one(self, r):
        if chaos.ENABLED:
            chaos.maybe_delay("router.probe.delay")
        cls, numbers, stats = "failed", {}, None
        try:
            status, _hdrs, data = self._http_get(r, "/readyz",
                                                 self.probe_timeout_s)
            body = {}
            if data:
                try:
                    body = json.loads(data)
                except ValueError:
                    body = {}
            if status == 200:
                cls = "ready"
            else:
                reason = str(body.get("reason", f"http_{status}"))
                if reason == "saturated":
                    cls = "saturated"
                elif reason == "draining":
                    cls = "draining"
                elif reason == "warming":
                    cls = "warming"
                elif reason.startswith("breaker_"):
                    cls = "breaker"
                else:
                    cls = "failed"
                numbers = {k: body[k] for k in ("in_flight",
                                                "queue_depth")
                           if isinstance(body.get(k), (int, float))}
        except (OSError, http.client.HTTPException, ValueError):
            cls = "failed"
        if cls == "ready" and chaos.ENABLED \
                and chaos.should_fire("router.probe.flap"):
            cls = "flap"
        if cls in ("ready", "saturated"):
            # the ready body carries no load numbers; /stats does.
            # A replica that just answered /readyz but fails /stats is
            # still routable — stale numbers degrade the pick, not the
            # rotation.
            try:
                _s, _h, data = self._http_get(r, "/stats",
                                              self.probe_timeout_s)
                stats = json.loads(data) if data else None
            except (OSError, http.client.HTTPException, ValueError):
                stats = None
        with self._lock:
            ejected = self._apply_probe_locked(r, cls, numbers, stats)
        self.metrics.inc("router.probes", result=cls)
        if ejected is not None:
            self._record_ejection(r, ejected)

    def _apply_probe_locked(self, r, cls, numbers, stats):
        """Fold one probe outcome into the replica's state machine;
        returns the ejection reason when this probe ejected it."""
        r.last_probe_t = time.monotonic()
        if cls in ("ready", "saturated"):
            r.consecutive_fail = 0
            r.consecutive_ok += 1
            r.deprioritized = (cls == "saturated")
            if isinstance(stats, dict):
                r.last_stats = stats
                if r.role is None:
                    # learn disagg pool membership from the replica's
                    # own /stats (engine role knob); "both" stays None
                    role = (stats.get("disagg") or {}).get("role")
                    if role in ("prefill", "decode"):
                        r.role = role
                r.probed_in_flight = int(stats.get("in_flight", 0) or 0)
                r.probed_queue_depth = int(
                    stats.get("queue_depth", 0) or 0)
            if numbers:
                r.probed_in_flight = int(numbers.get(
                    "in_flight", r.probed_in_flight))
                r.probed_queue_depth = int(numbers.get(
                    "queue_depth", r.probed_queue_depth))
            if not r.in_rotation:
                # flap damping: a replica that was ever ejected — or
                # registered under probation (an autopilot relaunch) —
                # needs K consecutive clean probes; a fresh ordinary
                # registration needs one
                needed = self.reenter_probes \
                    if (r.ejections > 0 or r.probation) else 1
                if r.consecutive_ok >= needed:
                    r.in_rotation = True
                    r.reason = cls
                    if r.ejections > 0:
                        self.metrics.inc("router.reentries")
            else:
                r.reason = cls
            self._refresh_gauges_locked()
            return None
        r.consecutive_ok = 0
        if cls == "warming":
            # cold start (model built, first compile pending): neither
            # overload nor failure — the replica waits out of rotation
            # without burning the eject budget, and an in-rotation
            # replica that reports warming (weight swap in place) steps
            # out like a drain: expected lifecycle, no crash bundle
            r.consecutive_fail = 0
            if r.in_rotation:
                self._eject_locked(r, "warming")
                return "warming"
            r.reason = "warming"
            return None
        if cls == "draining":
            # reason-aware: a draining replica said so itself — eject
            # NOW (it finishes in-flight work; new work routes away)
            if r.in_rotation:
                self._eject_locked(r, "draining")
                return "draining"
            r.reason = "draining"
            return None
        r.consecutive_fail += 1
        reason = "replica_breaker" if cls == "breaker" else "probe_failed"
        if r.in_rotation and r.consecutive_fail >= self.eject_after:
            self._eject_locked(r, reason)
            return reason
        if not r.in_rotation:
            r.reason = reason
        return None

    def _eject_locked(self, r, reason):
        r.in_rotation = False
        r.deprioritized = False
        r.reason = reason
        r.consecutive_ok = 0
        r.ejections += 1
        self._refresh_gauges_locked()

    def _record_ejection(self, r, reason):
        """Ejection bookkeeping + the flight-recorder hook: probe-
        failure and breaker ejections dump a `replica_ejected` bundle
        carrying the replica's last-known stats (a drain is expected
        lifecycle, not evidence)."""
        self.metrics.inc("router.ejections", reason=reason)
        if reason in ("draining", "warming") or not observability.ENABLED:
            return
        try:
            from paddle_tpu_torch.observability import fleet
            fleet.record_crash(
                "replica_ejected",
                extra={"replica": r.rid, "url": r.url, "reason": reason,
                       "consecutive_fail": r.consecutive_fail,
                       "ejections": r.ejections,
                       "last_stats": dict(r.last_stats)})
        except Exception as e:      # noqa: BLE001 — recording must never break routing
            print(f"WARNING: flight-recorder dump failed: {e!r}",
                  file=sys.stderr)

    def _note_forward_failure(self, r, msg):
        """A forward-path failure (connect refused, stream died): feeds
        the replica's breaker AND the probe-failure counter, so a burst
        of dead forwards ejects without waiting for the prober."""
        r.breaker.record_failure()
        ejected = None
        with self._lock:
            r.consecutive_ok = 0
            r.consecutive_fail += 1
            if r.in_rotation:
                if r.breaker.state == CircuitBreaker.OPEN:
                    ejected = "breaker_open"
                elif r.consecutive_fail >= self.eject_after:
                    ejected = "connect_failed"
                if ejected is not None:
                    self._eject_locked(r, ejected)
        if ejected is not None:
            self._record_ejection(r, ejected)

    def _refresh_gauges_locked(self):
        self.metrics.set_gauge(
            "router.replicas.in_rotation",
            sum(1 for x in self._order if x.in_rotation))
        # ejected = removed BY the state machine; a freshly registered
        # replica still warming toward its first clean probe is neither
        # (an alert on ejected>0 must not fire during a rollout)
        self.metrics.set_gauge(
            "router.replicas.ejected",
            sum(1 for x in self._order
                if not x.in_rotation and x.ejections > 0))

    def _probe_loop(self):
        while not self._probe_stop.wait(self.probe_interval_s):
            try:
                self.probe_all()
            except Exception as e:      # noqa: BLE001 — the prober must outlive one bad pass
                print(f"WARNING: router probe pass failed: {e!r}",
                      file=sys.stderr)

    # -- picking ------------------------------------------------------------
    def _prompt_prefix_keys(self, obj):
        """The page-aligned hash chain of the inbound /generate prompt
        (first row of `ids`), capped like the engine caps sharing —
        `(len - 1) // page_size` full pages, so the router and the
        replica's cache agree on what is shareable. () when prefix
        routing is off or the body has no usable prompt. The chaos
        site `router.prefix.scramble` perturbs the keys (repeated
        prefixes stop matching — the routing tests' lever)."""
        ps = self.prefix_page_size
        if not ps or not isinstance(obj, dict):
            return ()
        ids = obj.get("ids")
        if isinstance(ids, (list, tuple)) and ids \
                and isinstance(ids[0], (list, tuple)):
            ids = ids[0]
        if not isinstance(ids, (list, tuple)) or not ids:
            return ()
        try:
            row = [int(t) for t in ids]
        except (TypeError, ValueError):
            return ()
        shareable = min((len(row) - 1) // ps, self.prefix_max_pages)
        if shareable <= 0:
            return ()
        keys = chain_keys(row, ps, max_pages=shareable)
        if chaos.ENABLED \
                and chaos.should_fire("router.prefix.scramble"):
            keys = ["scrambled:" + k for k in keys]
        return tuple(keys)

    def _pick(self, excluded, session, pkeys=(), pool=None,
              restrict=None):
        with self._lock:
            return self._pick_locked(excluded, session, pkeys,
                                     pool=pool, restrict=restrict)

    def _pick_locked(self, excluded, session, pkeys=(), pool=None,
                     restrict=None):
        cands = [r for r in self._order
                 if r.in_rotation and r.rid not in excluded
                 and r.breaker.state != CircuitBreaker.OPEN]
        if restrict is not None:
            # disagg local-decode fallback: only the named replicas
            # (the prefill replica whose pages are already warm)
            cands = [r for r in cands if r.rid in restrict]
        if pool is not None:
            # pool-aware routing (disagg): prefer same-role replicas,
            # but an empty/ejected pool DEGRADES to the whole fleet —
            # roles partition for performance, never for completion
            pooled = [r for r in cands if r.role == pool]
            if pooled:
                cands = pooled
        if not cands:
            return None
        if session:
            rid = self._affinity.get(session)
            if rid is not None:
                for r in cands:
                    if r.rid == rid:
                        self._affinity.move_to_end(session)
                        return r
        # prefix-hash pick: deepest pinned key wins (chain keys make
        # depth = prefix length, so this IS longest-prefix match).
        # The decode pool keeps its OWN pin map: hop-2 page residency
        # (where a handoff landed pages) and hop-1 prefill affinity
        # would otherwise fight over one chain-key -> replica slot
        pins = self._prefix_decode if pool == "decode" else self._prefix
        pinned = None
        stale_pin = False
        keep_pins = False
        for k in reversed(pkeys):
            rid = pins.get(k)
            if rid is None:
                continue
            pr = self._by_id.get(rid)
            if pr is not None and pr.in_rotation \
                    and pr.breaker.state != CircuitBreaker.OPEN:
                pinned = pr
                break
            stale_pin = True        # pin points at a dead replica
        if pinned is not None:
            if pinned in cands and not pinned.deprioritized:
                for k in pkeys:
                    if k in pins:
                        pins.move_to_end(k)
                self.metrics.inc("router.prefix.hits")
                return pinned
            # healthy pin, but excluded or saturated for THIS request:
            # route around it WITHOUT re-pointing the pins — the KV
            # pages are still where they say (affinity semantics; one
            # transient shed must not flap the whole chain away)
            keep_pins = True
        def key(r):
            return (1 if r.deprioritized else 0, r.load_score())
        best = min(key(r) for r in cands)
        group = [r for r in cands if key(r) == best]
        chosen = group[self._rr % len(group)]
        self._rr += 1
        if pkeys and not keep_pins:
            # (re)pin the whole chain to the chosen replica — its
            # engine will cache these pages serving this request
            new = 0
            for k in pkeys:
                if pins.get(k) != chosen.rid:
                    new += 1
                pins[k] = chosen.rid
                pins.move_to_end(k)
            while len(pins) > self.prefix_capacity:
                pins.popitem(last=False)
            if new:
                self.metrics.inc("router.prefix.pins", new)
            if stale_pin:
                self.metrics.inc("router.prefix.rebinds")
        if session:
            prev = self._affinity.get(session)
            pr = self._by_id.get(prev) if prev is not None else None
            if pr is not None and pr.in_rotation \
                    and pr.breaker.state != CircuitBreaker.OPEN:
                # the pinned replica is healthy, just excluded for
                # THIS request (one shed/failure): route around it
                # without moving the pin — its KV locality is the
                # whole point of the pin
                return chosen
            self._affinity[session] = chosen.rid
            self._affinity.move_to_end(session)
            while len(self._affinity) > self.affinity_capacity:
                self._affinity.popitem(last=False)
            if prev is not None and prev != chosen.rid:
                self.metrics.inc("router.affinity.rebinds")
        return chosen

    # -- forwarding ---------------------------------------------------------
    def _count(self, outcome):
        self.metrics.inc("router.requests", outcome=outcome)

    def _tenant_gate(self, handler):
        """Front-door tenant resolution + the fleet-wide rate cap
        (tenancy configured only). Returns (accounting key, stamp) —
        `stamp` is the synthetic tenant id the chaos `tenant.storm`
        site put on an UNLABELED request, which must be FORWARDED so
        the replica attributes the same request to the same tenant
        instead of re-rolling chaos independently — or None when the
        request was shed (the typed, retryable 429 with a jittered
        Retry-After is already on the wire). The cap fires BEFORE any
        replica is picked: a tenant storm is contained at the
        cheapest possible point."""
        raw = safe_request_id(handler.headers.get("X-Tenant-Id"))
        tenant = resolve_tenant(handler.headers)
        stamp = tenant if raw is None and tenant is not None else None
        tkey = self.tenancy.key(tenant)
        self.metrics.inc("tenant.requests", outcome="total",
                         tenant=tkey)
        ok, hint = self._tenant_rl.allow(tenant)
        if ok:
            return tkey, stamp
        self._count("shed_tenant")
        self.metrics.inc("tenant.requests", outcome="shed_tenant",
                         tenant=tkey)
        self.metrics.inc("tenant.shed", tenant=tkey, reason="rate")
        ra = jittered_retry_after(hint if hint is not None
                                  else self.retry_after_s)
        self._client_write(
            self._reply_json, handler, 429,
            {"error": f"tenant {tkey!r} over its fleet-wide rate cap",
             "reason": "tenant_rate_exceeded", "retryable": True,
             "retry_after_s": round(ra, 3)},
            retry_after=ra, echo_headers=handler.headers)
        return None

    def _note_served(self, r, tenant):
        """Per-replica served counters (router lock held): total plus
        the bounded per-tenant breakdown for /debug/replicas."""
        r.served += 1
        if tenant is None:
            return
        if tenant not in r.tenants \
                and len(r.tenants) >= self._tenant_row_cap:
            tenant = "_other"
        r.tenants[tenant] = r.tenants.get(tenant, 0) + 1

    @staticmethod
    def _client_write(fn, *args, **kwargs):
        """Router-origin terminal writes: a client that vanished before
        the reply is not a router error — the outcome was already
        counted once, and letting the OSError escape would double-count
        it as server_error in the do_POST backstop."""
        try:
            fn(*args, **kwargs)
        except OSError:
            pass

    def _route(self, handler, path, raw, headers, stream_req, session,
               pkeys=(), tenant=None, stamp=None, pool=None,
               restrict=None, extra_headers=None):
        """The retry/failover loop around `_forward_once` (module doc:
        shed -> immediate failover, all-shed -> jittered wait honoring
        the Retry-After floor, dead-before-first-byte -> replay, dead
        mid-stream -> typed retryable error). `pool`/`restrict` steer
        the pick for disagg hops; `extra_headers` ride every forward
        attempt (the second hop's handoff headers)."""
        t0 = time.monotonic()
        budget_ms = timeout_hdr = None
        raw_ms = headers.get("X-Timeout-Ms") if headers else None
        if raw_ms is not None:
            timeout_hdr = raw_ms        # unparseable: replica 400s it
            try:
                budget_ms = float(raw_ms)
            except ValueError:
                budget_ms = None
        excluded: set = set()
        shed: dict = {}             # rid -> Retry-After hint (or None)
        last_shed = None            # (status, headers, body) to relay
        rounds_left = self.shed_rounds
        delays = self._retry.delays()
        had_failure = False
        attempts = 0
        max_attempts = 8 * max(1, len(self._order))
        while True:
            attempts += 1
            if attempts > max_attempts:     # belt-and-braces bound
                self._count("failed")
                return self._client_write(
                    self._router_error, handler, headers, 503,
                    "replica_failed", "retry budget exhausted",
                    retry_after=jittered_retry_after(self.retry_after_s))
            if budget_ms is not None:
                # the client's deadline keeps ticking across failed
                # attempts and backoff sleeps: replay with what is
                # LEFT, and stop when nothing is
                remaining = budget_ms - (time.monotonic() - t0) * 1e3
                if remaining <= 0:
                    self._count("deadline_exceeded")
                    return self._client_write(
                        self._router_error, handler, headers, 504,
                        "deadline_exceeded",
                        "client timeout budget exhausted during "
                        "failover", retryable=False)
                timeout_hdr = f"{remaining:.3f}"
            r = self._pick(excluded, session, pkeys, pool=pool,
                           restrict=restrict)
            if r is None:
                if shed and rounds_left > 1:
                    # every routable replica shed: honor the largest
                    # advertised Retry-After floor, full-jittered, then
                    # give the fleet one more round — unless the wait
                    # would outlive the client's remaining budget, in
                    # which case 504 NOW instead of sleeping past it
                    rounds_left -= 1
                    hints = [h for h in shed.values() if h is not None]
                    floor = max(hints) if hints else 0.0
                    wait = max(floor, next(delays))
                    if budget_ms is not None and wait >= (
                            budget_ms - (time.monotonic() - t0) * 1e3
                    ) / 1e3:
                        self._count("deadline_exceeded")
                        return self._client_write(
                            self._router_error, handler, headers, 504,
                            "deadline_exceeded",
                            "Retry-After backoff exceeds the client "
                            "timeout budget", retryable=False)
                    self._retry.sleep(wait)
                    for rid in list(shed):
                        excluded.discard(rid)
                    shed.clear()
                    continue
                if last_shed is not None:
                    # relay the replica's own shed verbatim: typed,
                    # retryable, Retry-After and trace headers intact
                    self._count("shed_upstream")
                    return self._client_write(self._relay_response,
                                              handler, *last_shed)
                self._count("failed" if had_failure else "no_replicas")
                return self._client_write(
                    self._router_error, handler, headers, 503,
                    "replica_failed" if had_failure else "no_replicas",
                    "all replicas failed" if had_failure
                    else "no replica in rotation",
                    retry_after=jittered_retry_after(self.retry_after_s))
            try:
                r.breaker.allow()
            except CircuitOpenError:
                excluded.add(r.rid)
                continue
            with self._lock:
                r.in_flight_router += 1
            try:
                if chaos.ENABLED \
                        and chaos.should_fire("router.connect.fail"):
                    raise chaos.InjectedConnectionDrop(
                        "chaos: injected router->replica connect "
                        f"failure ({r.rid})")
                verdict = self._forward_once(handler, r, path, raw,
                                             headers, stream_req,
                                             timeout_hdr, stamp=stamp,
                                             extra_headers=extra_headers)
            except (OSError, http.client.HTTPException) as e:
                # replica-side death before any response byte: replay
                # the request against the next replica
                self._note_forward_failure(r, repr(e))
                excluded.add(r.rid)
                had_failure = True
                self.metrics.inc("router.retries", kind="connect")
                continue
            finally:
                with self._lock:
                    r.in_flight_router -= 1
            kind = verdict[0]
            if kind == "done":
                with self._lock:
                    self._note_served(r, tenant)
                self._count(verdict[1])
                self.metrics.observe("router.forward.seconds",
                                     time.monotonic() - t0)
                return
            if kind == "shed":
                _, hint, status, rhdrs, body = verdict
                # the replica answered (control-plane): hand back any
                # half-open probe un-judged, like serving's _admit
                r.breaker.release_probe()
                shed[r.rid] = hint
                last_shed = (status, rhdrs, body, r.rid)
                excluded.add(r.rid)
                self.metrics.inc("router.retries", kind="shed")
                continue
            # kind == "retry_stream": the stream died before the first
            # byte reached the client — safe to replay
            self._note_forward_failure(r, verdict[1])
            excluded.add(r.rid)
            had_failure = True
            self.metrics.inc("router.retries", kind="stream")

    # -- disaggregated prefill/decode (inference/disagg.py) ---------------
    def _disagg_active(self):
        """Two-pool routing engages only when BOTH pools have a
        routable member (roles declared at add_replica or learned
        from probes) — otherwise every request takes the monolithic
        path unchanged."""
        with self._lock:
            has_p = any(r.role == "prefill" and r.in_rotation
                        for r in self._order)
            has_d = any(r.role == "decode" and r.in_rotation
                        for r in self._order)
        return has_p and has_d

    def _forward_prefill(self, r, path, raw, headers, stamp):
        """Hop 1 of a disagg handoff: run admission + prefill on the
        prefill replica (`X-Disagg-Phase: prefill` clamps it to one
        token; the engine's prefill epilogue captures the committed
        pages for export). True on 200 — anything else sends the
        request down the monolithic path instead."""
        with self._lock:
            r.in_flight_router += 1
        try:
            conn = http.client.HTTPConnection(
                r.host, r.port, timeout=self.forward_timeout_s)
            try:
                fwd = {"Content-Type": headers.get(
                    "Content-Type", "application/json"),
                    "X-Disagg-Phase": "prefill"}
                for h in _FORWARD_HEADERS:
                    v = headers.get(h)
                    if v:
                        fwd[h] = v
                if stamp is not None and "X-Tenant-Id" not in fwd:
                    fwd["X-Tenant-Id"] = stamp
                conn.request("POST", path, body=raw, headers=fwd)
                resp = conn.getresponse()
                resp.read()
                ok = resp.status == 200
                if ok:
                    r.breaker.record_success()
                return ok
            finally:
                conn.close()
        except (OSError, http.client.HTTPException) as e:
            self._note_forward_failure(r, repr(e))
            return False
        finally:
            with self._lock:
                r.in_flight_router -= 1

    def _route_disagg(self, handler, path, raw, headers, stream_req,
                      session, pkeys, tenant=None, stamp=None):
        """Two-pool handoff orchestration. Hop 1: prefix-affine pick
        WITHIN the prefill pool runs admission + prefill (one token)
        and leaves the request's pages exported in that replica's
        host tier. Hop 2: a decode-pool pick (page residency via the
        decode pin map, then load) gets the original request plus the
        chain keys and the prefill peer's address as internal headers
        — its server prefetches the missing pages before admission.
        EVERY failure mode degrades to a decode that is merely
        slower, never wrong: no prefill replica / hop-1 failure ->
        monolithic path over the whole fleet; chaos
        `disagg.transfer.fail` -> local decode pinned to the prefill
        replica (its pages are already warm)."""
        # session-affine conversations skip the handoff: their pages
        # already live on the affine replica, and re-homing a session
        # every turn would move MORE bytes, not fewer
        r1 = None
        if not session:
            r1 = self._pick(set(), None, pkeys, pool="prefill")
        if r1 is None or r1.role != "prefill":
            return self._route(handler, path, raw, headers, stream_req,
                               session, pkeys, tenant=tenant,
                               stamp=stamp)
        if not self._forward_prefill(r1, path, raw, headers, stamp):
            self.metrics.inc("router.disagg.fallbacks",
                             reason="prefill_failed")
            return self._route(handler, path, raw, headers, stream_req,
                               session, pkeys, tenant=tenant,
                               stamp=stamp)
        if chaos.ENABLED and chaos.should_fire("disagg.transfer.fail"):
            # the transfer path is down: decode locally on the
            # prefill replica — its pages are already warm (slower,
            # never wrong). Degrading to the WHOLE fleet here would
            # silently re-prefill on a cold replica instead.
            self.metrics.inc("router.disagg.fallbacks",
                             reason="transfer_fail")
            return self._route(handler, path, raw, headers, stream_req,
                               session, pkeys, tenant=tenant,
                               stamp=stamp, restrict={r1.rid})
        if chaos.ENABLED:
            # PCIe/NIC congestion on the handoff path: the disagg
            # TTFT lever for latency tests
            chaos.maybe_delay("disagg.transfer.delay")
        self.metrics.inc("router.disagg.handoffs")
        extra = {"X-Disagg-KV-From": r1.url,
                 "X-Disagg-Keys": ",".join(pkeys)}
        return self._route(handler, path, raw, headers, stream_req,
                           session, pkeys, tenant=tenant, stamp=stamp,
                           pool="decode", extra_headers=extra)

    def _forward_once(self, handler, r, path, raw, headers, stream_req,
                      timeout_hdr=None, stamp=None, extra_headers=None):
        """One forward attempt. Returns
        ("done", outcome)                  reply fully written,
        ("shed", hint, status, hdrs, body) replica shed 429/503,
        ("retry_stream", why)              stream failed pre-first-byte;
        raises OSError/HTTPException when the connection itself died
        before a response (the caller replays). `timeout_hdr` is the
        REMAINING X-Timeout-Ms budget (decremented by the caller);
        `stamp` is the chaos-storm tenant id resolved for an unlabeled
        request (forwarded so router and replica attribute alike)."""
        conn = http.client.HTTPConnection(
            r.host, r.port, timeout=self.forward_timeout_s)
        try:
            fwd = {"Content-Type": headers.get("Content-Type",
                                               "application/json")}
            for h in _FORWARD_HEADERS:
                v = headers.get(h)
                if v:
                    fwd[h] = v
            if stamp is not None and "X-Tenant-Id" not in fwd:
                fwd["X-Tenant-Id"] = stamp
            if timeout_hdr is not None:
                fwd["X-Timeout-Ms"] = timeout_hdr
            if extra_headers:
                fwd.update(extra_headers)
            conn.request("POST", path, body=raw, headers=fwd)
            resp = conn.getresponse()
            status = resp.status
            if status in (429, 503):
                body = resp.read()
                hint = resp.getheader("Retry-After")
                try:
                    hint = float(hint) if hint is not None else None
                except ValueError:
                    hint = None
                rh = {h: resp.getheader(h) for h in _ECHO_HEADERS
                      if resp.getheader(h)}
                return ("shed", hint, status, rh, body)
            if stream_req and status == 200 and "chunked" in (
                    resp.getheader("Transfer-Encoding") or "").lower():
                return self._relay_stream(handler, r, resp)
            body = resp.read()
            if status >= 500:
                # the replica RAN the request and failed: not
                # replayable (it may have side effects / spent the
                # deadline) — relay honestly, feed the breaker
                r.breaker.record_failure()
                outcome = "server_error"
            elif status >= 400:
                r.breaker.record_success()
                outcome = "client_error"
            else:
                r.breaker.record_success()
                outcome = "ok"
            rh = {h: resp.getheader(h) for h in _ECHO_HEADERS
                  if resp.getheader(h)}
            try:
                self._relay_response(handler, status, rh, body, r.rid)
            except OSError:
                outcome = "disconnected"    # client went away; the
            return ("done", outcome)        # replica did not fail
        finally:
            conn.close()

    def _relay_stream(self, handler, r, resp):
        """Relay a chunked ndjson token stream line-by-line. The first
        line is pulled BEFORE our 200 goes out (serving.py's trick), so
        a replica that dies instantly is an invisible failover; after
        bytes have reached the client, a replica death becomes a typed
        retryable error chunk instead of a torn connection."""
        try:
            line = resp.readline()
        except (OSError, http.client.HTTPException) as e:
            return ("retry_stream", repr(e))
        err = self._error_line(line)
        if err is not None:
            return ("retry_stream",
                    f"replica error before first token: {err}")
        if not line:
            return ("retry_stream", "replica stream ended empty")
        try:
            handler.send_response(200)
            for h in ("X-Request-Id", "traceparent"):
                v = resp.getheader(h)
                if v:
                    handler.send_header(h, v)
            handler.send_header("X-Routed-To", r.rid)
            handler.send_header("Content-Type",
                                resp.getheader("Content-Type")
                                or "application/x-ndjson")
            handler.send_header("Transfer-Encoding", "chunked")
            handler.end_headers()
        except OSError:
            r.breaker.record_success()
            return ("done", "disconnected")

        def chunk(data):
            handler.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
            handler.wfile.flush()

        try:
            while True:
                chunk(line)
                if chaos.ENABLED \
                        and chaos.should_fire("router.replica.kill"):
                    self._fire_kill(r)
                try:
                    line = resp.readline()
                except (OSError, http.client.HTTPException) as e:
                    return self._stream_fail(handler, chunk, r, repr(e))
                err = self._error_line(line)
                if err is not None:
                    return self._stream_fail(handler, chunk, r, err)
                if not line:
                    handler.wfile.write(b"0\r\n\r\n")
                    r.breaker.record_success()
                    return ("done", "ok")
        except OSError:
            # the CLIENT went away mid-relay; the replica did not fail
            r.breaker.record_success()
            return ("done", "disconnected")

    def _stream_fail(self, handler, chunk, r, why):
        """Mid-stream replica death with tokens already delivered: no
        replay possible — the client gets a typed, retryable error
        line and a clean terminal chunk (never a hang)."""
        self._note_forward_failure(r, why)
        try:
            chunk((json.dumps({"error": str(why),
                               "reason": "replica_failed",
                               "retryable": True,
                               "replica": r.rid}) + "\n").encode())
            handler.wfile.write(b"0\r\n\r\n")
        except OSError:
            return ("done", "disconnected")
        return ("done", "stream_error")

    @staticmethod
    def _error_line(line):
        """The replica's mid-stream failure contract: an
        {"error": ...} ndjson line (serving._stream_reply)."""
        if not line:
            return None
        try:
            obj = json.loads(line)
        except ValueError:
            return None
        if isinstance(obj, dict) and "error" in obj:
            return str(obj["error"])
        return None

    def _fire_kill(self, r):
        hook = self.kill_hook
        if hook is None:
            return
        try:
            hook(r.rid)
        except Exception as e:      # noqa: BLE001 — a broken kill hook must not corrupt the relay
            print(f"WARNING: router kill hook failed: {e!r}",
                  file=sys.stderr)

    # -- reply plumbing -----------------------------------------------------
    def _echo_identity(self, handler, headers):
        """Router-origin replies still close the trace loop: the
        sanitized inbound X-Request-Id (the header-injection rules),
        the inbound traceparent when it parses, and the sanitized
        X-Tenant-Id — a rate-cap 429 the router itself writes must
        still be attributable to its tenant."""
        rid = safe_request_id(headers.get("X-Request-Id")
                              if headers else None)
        if rid:
            handler.send_header("X-Request-Id", rid)
        tp = headers.get("traceparent") if headers else None
        if tp and parse_traceparent(tp):
            handler.send_header("traceparent", tp)
        tenant = safe_request_id(headers.get("X-Tenant-Id")
                                 if headers else None)
        if tenant:
            handler.send_header("X-Tenant-Id", tenant)

    def _reply_json(self, handler, code, obj, retry_after=None,
                    echo_headers=None):
        """The ONE router-origin response writer; `echo_headers` is the
        inbound header map whose sanitized identity should be echoed
        (trace continuity on replies no replica produced)."""
        body = json.dumps(obj).encode()
        handler.send_response(code)
        if echo_headers is not None:
            self._echo_identity(handler, echo_headers)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(body)))
        if retry_after is not None:
            handler.send_header(
                "Retry-After", str(max(1, int(math.ceil(retry_after)))))
        handler.end_headers()
        handler.wfile.write(body)

    def _router_error(self, handler, headers, status, reason, msg,
                      retry_after=None, retryable=True):
        self._reply_json(handler, status,
                         {"error": msg, "reason": reason,
                          "retryable": retryable},
                         retry_after=retry_after, echo_headers=headers)

    def _relay_response(self, handler, status, rheaders, body, rid=None):
        handler.send_response(status)
        for h in _ECHO_HEADERS:
            v = rheaders.get(h)
            if v is not None:
                handler.send_header(h, v)
        if rid is not None:
            handler.send_header("X-Routed-To", rid)
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)

    def _http_get(self, r, path, timeout):
        conn = http.client.HTTPConnection(r.host, r.port,
                                          timeout=timeout)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()

    # -- surfaces -----------------------------------------------------------
    @staticmethod
    def _prefix_hit_rate(stats):
        """Per-replica prefix-cache hit rate from the newest probed
        /stats body (PredictorServer embeds the engine's prefix
        block); None when the replica doesn't report one."""
        p = stats.get("prefix") if isinstance(stats, dict) else None
        if not isinstance(p, dict):
            return None
        try:
            h, m = int(p.get("hits", 0)), int(p.get("misses", 0))
        except (TypeError, ValueError):
            return None
        return round(h / (h + m), 4) if (h + m) else 0.0

    @staticmethod
    def _kvtier_hit_rate(stats):
        """Per-replica host-tier hit rate from the newest probed
        /stats body (the engine's `kvtier` block). Lets operators
        split warm traffic into device-hit vs tier-hit vs cold; a
        prefix PIN survives a spill — the pinned replica still "has"
        the prefix, one H2D hop slower — so this is the number that
        explains a pinned replica's warm-TTFT spread. None when the
        replica doesn't report a tier."""
        kt = stats.get("kvtier") if isinstance(stats, dict) else None
        if not isinstance(kt, dict):
            return None
        try:
            h, lk = int(kt.get("hits", 0)), int(kt.get("lookups", 0))
        except (TypeError, ValueError):
            return None
        return round(h / lk, 4) if lk else 0.0

    @staticmethod
    def _disagg_view(stats):
        """Per-replica handoff traffic from the newest probed /stats
        body (the engine's `disagg` block); None when the replica
        doesn't report one (pre-disagg replicas, plain predictors)."""
        d = stats.get("disagg") if isinstance(stats, dict) else None
        if not isinstance(d, dict):
            return None
        try:
            return {"handoff_pages": int(d.get("handoff_pages", 0)),
                    "handoff_bytes": int(d.get("handoff_bytes", 0)),
                    "imported_pages": int(d.get("imported_pages", 0)),
                    "imported_bytes": int(d.get("imported_bytes", 0)),
                    "dedup_skipped_pages": int(
                        d.get("dedup_skipped_pages", 0)),
                    "pull_failures": int(d.get("pull_failures", 0))}
        except (TypeError, ValueError):
            return None

    def debug_replicas(self):
        """The GET /debug/replicas body (schema pinned in README): the
        router's live per-replica view + a summary."""
        now = time.monotonic()
        with self._lock:
            rows = []
            for r in self._order:
                rows.append({
                    "id": r.rid, "url": r.url,
                    "in_rotation": r.in_rotation,
                    "deprioritized": r.deprioritized,
                    "reason": r.reason,
                    "consecutive_ok": r.consecutive_ok,
                    "consecutive_fail": r.consecutive_fail,
                    "in_flight_router": r.in_flight_router,
                    "replica_in_flight": r.probed_in_flight,
                    "replica_queue_depth": r.probed_queue_depth,
                    "load_score": r.load_score(),
                    "last_probe_age_s": (
                        None if r.last_probe_t is None
                        else round(now - r.last_probe_t, 4)),
                    "breaker": r.breaker.snapshot(),
                    "ejections": r.ejections,
                    "probation": r.probation,
                    "served": r.served,
                    "prefix_hit_rate": self._prefix_hit_rate(
                        r.last_stats),
                    "kvtier_hit_rate": self._kvtier_hit_rate(
                        r.last_stats),
                    "role": r.role,
                    "disagg": self._disagg_view(r.last_stats),
                    "tenants": dict(r.tenants),
                })
            summary = {
                "total": len(self._order),
                "in_rotation": sum(1 for r in self._order
                                   if r.in_rotation),
                "ejected": sum(1 for r in self._order
                               if not r.in_rotation
                               and r.ejections > 0),
                "deprioritized": sum(1 for r in self._order
                                     if r.deprioritized),
                "sessions": len(self._affinity),
                "prefix_pins": (len(self._prefix)
                                + len(self._prefix_decode)),
                "tenants": len({t for r in self._order
                                for t in r.tenants}),
                "pools": {
                    "prefill": sum(1 for r in self._order
                                   if r.role == "prefill"),
                    "decode": sum(1 for r in self._order
                                  if r.role == "decode"),
                },
            }
        return {"replicas": rows, "summary": summary}

    def stats(self):
        counts = {dict(k).get("outcome", ""): v
                  for k, v in self._requests.labeled().items()}
        retries = {dict(k).get("kind", ""): v
                   for k, v in self.metrics.counter(
                       "router.retries").labeled().items()}
        with self._lock:
            n, rot = len(self._order), \
                sum(1 for r in self._order if r.in_rotation)
            sessions = len(self._affinity)
            prefix_pins = len(self._prefix) + len(self._prefix_decode)
            pools = {"prefill": sum(1 for r in self._order
                                    if r.role == "prefill"),
                     "decode": sum(1 for r in self._order
                                   if r.role == "decode"),
                     "decode_pins": len(self._prefix_decode)}
        out = {"replicas": n, "in_rotation": rot,
               "sessions": sessions, "prefix_pins": prefix_pins,
               "requests": counts, "retries": retries,
               "pools": pools}
        if self.tenancy is not None:
            out["tenants"] = self.tenant_stats()
        ap = self.autopilot
        if ap is not None:
            # the rollout state machine rides /stats: one scrape shows
            # where the wave is (autopilot module doc)
            out["rollout"] = ap.rollout_state()
        return out

    def attach_autopilot(self, autopilot):
        """Wire a `FleetAutopilot` into this router's surfaces (GET
        /debug/autopilot, the rollout block in /stats)."""
        self.autopilot = autopilot
        return autopilot

    def tenant_stats(self):
        """Per-tenant router rows (tenancy configured): request and
        rate-shed counts + the policy's rate cap."""
        per = {}
        for k, v in self.metrics.counter("tenant.requests") \
                .labeled().items():
            d = dict(k)
            t = d.get("tenant", "")
            row = per.setdefault(t, {"requests": 0, "shed": 0})
            if d.get("outcome") == "total":
                row["requests"] += v
            elif d.get("outcome") == "shed_tenant":
                row["shed"] += v
        for t, row in per.items():
            row["rate_limit"] = self.tenancy.policy(t).rate_limit
        return per

    def metrics_text(self):
        text = self.metrics.prometheus_text()
        if observability.REGISTRY is not self.metrics:
            text += observability.REGISTRY.prometheus_text(
                exclude=self.metrics.names())
        return text

    # -- lifecycle ----------------------------------------------------------
    def start(self, probe=True):
        """One synchronous probe pass (replicas are routable before the
        first request lands), then the background prober and the HTTP
        server. `probe=False` skips the prober thread — tests drive the
        state machine deterministically with explicit `probe_all()`
        calls instead of racing a poller."""
        self.probe_all()
        if probe:
            self._probe_stop.clear()
            self._probe_thread = threading.Thread(
                target=self._probe_loop, daemon=True,
                name="router-prober")
            self._probe_thread.start()
        # serve_forever looks for shutdown() once a poll interval; 0.05 s,
        # not the stdlib's 0.5 s, bounds how long stop() waits for it (the
        # port's PredictorServer does the same)
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        args=(0.05,), daemon=True,
                                        name="router-http")
        self._thread.start()
        return self

    def stop(self, join_timeout=5.0):
        self._probe_stop.set()
        t = self._probe_thread
        if t is not None:
            t.join(timeout=join_timeout)
            self._probe_thread = None
        if self._thread is not None:
            self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
            self._thread = None
