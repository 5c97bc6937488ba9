"""Per-request tracing & serving SLO telemetry.

Counterpart of paddle_tpu/observability/requests.py, copied (the module
is stdlib-only, but importing it would import the JAX package). The
contextvar below is the port's own: the port's serving layer binds it
and the port's engine reads it, so a request traced by one package is
never seen by the other's layers.

    RequestContext    one request's identity (request id + W3C trace
                      context) and its typed event timeline (admitted,
                      queued, scheduled, prefill start/end, first
                      token, every decode tick, finished / shed /
                      expired / cancelled / disconnected / error)
    contextvar        `set_current` / `current` propagate the context
                      from the HTTP handler thread into whatever layer
                      touches the request next (DynamicBatcher.submit,
                      PagedKVEngine.submit); serving copies the
                      contextvars context into its producer thread so
                      the engine sees the same request
    in-flight registry  bounded map of live contexts behind serving's
                      GET /debug/requests (stage + age per request)
    SLO instruments   request.ttft.seconds / request.itl.seconds /
                      request.queue_wait.seconds / request.prefill.
                      seconds / request.tokens histograms and the
                      request.outcome counter, recorded into the
                      process-wide metrics REGISTRY as the timeline
                      unfolds (catalogued in metrics.METRICS)
    exemplar sampler  a finished request that breached the configured
                      TTFT / total-latency threshold dumps its whole
                      lifecycle into the span ring as nested spans, so
                      trace.export_chrome_trace shows what a slow
                      request actually waited on

Contract with the hot path: when observability is disabled (the
default), no context is ever created and every instrumentation site in
serving / batcher / engine is a single module-attribute load + falsy
branch (or one `is not None` check on a request that never got a
context). Layers below the HTTP server guard on the context handle
itself, so a request admitted while disabled stays zero-cost for its
whole life even if observability is enabled mid-flight.

Event timestamps use time.perf_counter() — the span ring's clock — so
exemplar spans land on the same timeline as live `span()` scopes.

Stdlib-only.
"""
from __future__ import annotations

import contextvars
import itertools
import secrets
import threading
import time
import zlib

from paddle_tpu_torch.observability.metrics import REGISTRY
from paddle_tpu_torch.observability import trace

__all__ = [
    "EVENTS", "RequestContext", "parse_traceparent", "safe_request_id",
    "current", "set_current", "reset_current", "register",
    "live_requests", "configure", "clear",
]

#: the closed event-name catalogue (the metrics.METRICS pattern):
#: record() raises on anything else, so the timeline stays typed and
#: /debug/requests consumers can switch on `stage` exhaustively.
EVENTS = frozenset({
    "admitted",         # passed the server's admission gate
    "queued",           # waiting for a batch slot / engine slot
    "scheduled",        # slot assigned (batch formed / engine slot)
    "prefill_start",    # prompt prefill program dispatched
    "prefill_end",      # prompt prefill finished
    "first_token",      # first generated token accepted
    "tokens",           # a decode tick emitted tokens (attrs: n)
    # terminal events (exactly one per request, written by finish())
    "finished", "shed", "expired", "cancelled", "disconnected", "error",
})

#: finish(reason) outcome -> terminal timeline event. Reasons are the
#: serving /stats outcome keys plus the engine's terminal states; the
#: request.outcome counter keeps the RAW reason as its label.
_TERMINAL = {
    "ok": "finished", "finished": "finished",
    "expired": "expired", "deadline_exceeded": "expired",
    "cancelled": "cancelled", "disconnected": "disconnected",
}


def _terminal_event(reason: str) -> str:
    if reason.startswith("shed"):
        return "shed"
    return _TERMINAL.get(reason, "error")


# -- configuration ----------------------------------------------------------

class _Config:
    """Slow-request exemplar thresholds + bounds (module-global; set
    via configure())."""

    __slots__ = ("slow_ttft_s", "slow_total_s", "live_capacity",
                 "max_events")

    def __init__(self):
        self.slow_ttft_s = None
        self.slow_total_s = None
        self.live_capacity = 1024
        self.max_events = 256


CONFIG = _Config()


def configure(slow_ttft_s="unset", slow_total_s="unset",
              live_capacity=None, max_events=None):
    """Tune the slow-request exemplar thresholds (seconds; None
    disables that trigger) and the in-flight / timeline bounds.
    Omitted arguments keep their current value."""
    # coerce NOW: a bad value must raise here, on the caller's thread —
    # stored raw, the first comparison happens inside finish(), which
    # on the engine path runs on the ticker thread and would kill it
    if slow_ttft_s != "unset":
        CONFIG.slow_ttft_s = (None if slow_ttft_s is None
                              else float(slow_ttft_s))
    if slow_total_s != "unset":
        CONFIG.slow_total_s = (None if slow_total_s is None
                               else float(slow_total_s))
    if live_capacity is not None:
        CONFIG.live_capacity = int(live_capacity)
    if max_events is not None:
        CONFIG.max_events = int(max_events)


# -- W3C trace context ------------------------------------------------------

def _is_hex(s: str) -> bool:
    return all(c in "0123456789abcdef" for c in s)


# adopted X-Request-Id values are echoed back through send_header();
# http.server's email parser hands obs-folded request headers over WITH
# their CR/LF intact, so an unvalidated id is a response-header
# injection vector. RFC 7230 token chars only, bounded length.
_RID_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    "!#$%&'*+-.^_`|~")
_RID_MAX = 128


def _safe_request_id(rid):
    """The inbound `X-Request-Id` if it is safe to echo, else None
    (the caller then generates one)."""
    if not rid or not isinstance(rid, str) or len(rid) > _RID_MAX:
        return None
    if not all(c in _RID_CHARS for c in rid):
        return None
    return rid


def safe_request_id(rid):
    """Public form of the echo-safety check: any layer that echoes an
    inbound `X-Request-Id` (the replica router, a future gateway) must
    apply the SAME injection rules as the serving layer, or the hop
    becomes the header-injection vector the serving layer closed."""
    return _safe_request_id(rid)


def parse_traceparent(header):
    """Parse a W3C `traceparent` header -> (trace_id, parent_id,
    flags) or None when absent/malformed (the caller then starts a
    fresh trace — per spec, an invalid header is ignored, not an
    error)."""
    if not header or not isinstance(header, str):
        return None
    # no case folding: the spec requires lowercase hex and says a
    # non-conforming header MUST be ignored — uppercase ids start a
    # fresh trace rather than silently joining
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, parent_id, flags = parts[:4]
    if len(version) != 2 or not _is_hex(version) or version == "ff":
        return None
    if version == "00" and len(parts) != 4:
        # version 00 defines EXACTLY four fields; trailing data is
        # invalid there (later versions may append fields)
        return None
    if len(trace_id) != 32 or not _is_hex(trace_id) \
            or trace_id == "0" * 32:
        return None
    if len(parent_id) != 16 or not _is_hex(parent_id) \
            or parent_id == "0" * 16:
        return None
    if len(flags) != 2 or not _is_hex(flags):
        return None
    return trace_id, parent_id, int(flags, 16)


# -- the per-request context -------------------------------------------------

_seq = itertools.count(1)


class RequestContext:
    """One request's identity + typed event timeline.

    Construct through `from_headers` (serving) or `new` (anything that
    originates a request without HTTP headers, e.g. a direct
    PagedKVEngine.submit). Thread-safe: the HTTP handler, the stream
    producer thread, and the engine ticker all record into the same
    context."""

    __slots__ = ("request_id", "trace_id", "parent_id", "span_id",
                 "flags", "tenant", "tenant_key", "t0", "events",
                 "tokens", "dropped_events", "tokens_claimed",
                 "outcome", "finish_t", "_lock", "_queued_t",
                 "_prefill_t", "_last_emit", "_live_key",
                 "_engine_refs", "_engine_reason")

    def __init__(self, request_id=None, trace_id=None, parent_id=None,
                 flags=1, tenant=None):
        self.request_id = request_id or "req-" + secrets.token_hex(8)
        # tenant attribution (inference/tenancy.py): sanitized
        # X-Tenant-Id, or None for unlabeled traffic. Serving may
        # override after chaos-storm stamping (tenancy.resolve_tenant).
        # `tenant_key` is the TenantTable accounting key a tenancy-
        # configured layer sets beside it: the outcome METRIC labels
        # with the key (bounded by the configured tenant set) while
        # /debug/requests keeps the raw id — 64 junk header values
        # must not exhaust request.outcome's label budget and fold
        # real tenants into "_other" forever.
        self.tenant = tenant
        self.tenant_key = None
        self.trace_id = trace_id or secrets.token_hex(16)
        self.parent_id = parent_id          # inbound caller's span id
        self.span_id = secrets.token_hex(8)  # OUR span within the trace
        self.flags = int(flags)
        self.t0 = time.perf_counter()
        self.events: list = []              # (name, t, attrs|None)
        self.tokens = 0                     # generated tokens accepted
        self.dropped_events = 0
        # an engine claiming token accounting stops the serving layer
        # double-recording the same emissions (serving.generate_steps)
        self.tokens_claimed = False
        self.outcome = None                 # set once by finish()
        self.finish_t = None
        self._lock = threading.Lock()
        self._queued_t: dict = {}   # per-stream queued time (rid key)
        self._prefill_t: dict = {}  # per-stream prefill start (rid key)
        self._last_emit: dict = {}      # per-stream last emission time
        self._live_key = None
        self._engine_refs = 0       # engine rows sharing this context
        self._engine_reason = None  # first abnormal row outcome

    # -- constructors ---------------------------------------------------
    @classmethod
    def new(cls, request_id=None):
        return cls(request_id=request_id)

    @classmethod
    def from_headers(cls, headers):
        """Build from inbound HTTP headers: `traceparent` joins the
        caller's trace (malformed -> fresh trace), `X-Request-Id` is
        adopted when it is safe to echo — RFC 7230 token chars,
        bounded length — else generated (the id comes back on the
        response verbatim, so CR/LF or oversized values would be a
        header-injection vector)."""
        get = headers.get if headers is not None else (lambda k: None)
        parsed = parse_traceparent(get("traceparent"))
        rid = _safe_request_id(get("X-Request-Id"))
        # same sanitization rules as the request id: the tenant id is
        # echoed on replies and rides the router hop as a header
        tenant = _safe_request_id(get("X-Tenant-Id"))
        if parsed is None:
            return cls(request_id=rid, tenant=tenant)
        trace_id, parent_id, flags = parsed
        return cls(request_id=rid, trace_id=trace_id,
                   parent_id=parent_id, flags=flags, tenant=tenant)

    def traceparent(self) -> str:
        """The outbound `traceparent` header value: same trace id, OUR
        span id as the new parent (W3C propagation contract)."""
        return f"00-{self.trace_id}-{self.span_id}-{self.flags:02x}"

    # -- timeline -------------------------------------------------------
    def record(self, event, **attrs):
        """Append a typed event (EVENTS catalogue; unknown names raise)
        and derive phase instruments as the boundaries pass."""
        if event not in EVENTS:
            raise KeyError(
                f"request event {event!r} is not in the EVENTS "
                "catalogue (observability/requests.py) — register it "
                "there")
        t = time.perf_counter()
        with self._lock:
            if self.outcome is not None:
                # a layer still holding a finished context (the batcher
                # scheduling a deadline-expired request, a late row of
                # a multi-row generate) must not grow the timeline or
                # skew the phase SLOs past the terminal event
                return t
            self._append_locked(event, t, attrs or None)
            if event == "queued":
                # keyed by the caller's rid (None for single-stream
                # callers like the batcher): a multi-row request queues
                # each row at its own time, and each row's wait must be
                # measured against ITS queued instant, not whichever
                # sibling queued last
                self._queued_t[attrs.get("rid")] = t
            elif event == "scheduled":
                qt = self._queued_t.pop(attrs.get("rid"), None)
                if qt is not None:
                    REGISTRY.observe("request.queue_wait.seconds",
                                     t - qt)
            elif event == "prefill_start":
                self._prefill_t[attrs.get("rid")] = t
            elif event == "prefill_end":
                pt = self._prefill_t.pop(attrs.get("rid"), None)
                if pt is not None:
                    REGISTRY.observe("request.prefill.seconds", t - pt)
        return t

    def _append_locked(self, event, t, attrs):
        if len(self.events) >= CONFIG.max_events:
            self.dropped_events += 1
            return
        self.events.append((event, t, attrs))

    def record_tokens(self, n, stream=None):
        """One decode emission of `n` accepted tokens. The first call
        overall records `first_token` (-> request.ttft.seconds,
        measured from context creation — the user-felt clock); later
        calls record a `tokens` tick event and observe
        request.itl.seconds once per emission with the per-token mean
        gap (tokens inside one fused tick are indistinguishable
        host-side). `stream` keys the gap clock: a multi-row request
        shares one context across engine rows, and each row's ITL must
        be measured against ITS previous emission, not whichever
        sibling emitted microseconds ago in the same tick — a row's
        own first emission contributes no gap."""
        n = int(n)
        if n <= 0:
            return
        t = time.perf_counter()
        with self._lock:
            if self.outcome is not None:
                return      # post-terminal emission: drop, don't skew
            self.tokens += n
            if not self._last_emit:
                self._append_locked("first_token", t, None)
                REGISTRY.observe("request.ttft.seconds", t - self.t0)
                if n > 1:
                    # a tick can carry the first token AND successors
                    self._append_locked("tokens", t, {"n": n - 1})
            else:
                prev = self._last_emit.get(stream)
                self._append_locked("tokens", t, {"n": n})
                if prev is not None:
                    REGISTRY.observe("request.itl.seconds",
                                     (t - prev) / n)
            self._last_emit[stream] = t

    def claim_tokens(self):
        """An engine that records emissions itself (PagedKVEngine)
        claims token accounting so the serving consumer loop doesn't
        double-record the same tokens."""
        self.tokens_claimed = True

    def adopt_engine(self):
        """One engine request (one row of a possibly multi-row serving
        request) adopted this context. Pairs with engine_finish(): the
        context only reaches its terminal state when the LAST adopted
        row does, so a two-prompt /generate stays live in
        /debug/requests — and keeps recording tokens — until every row
        retires."""
        with self._lock:
            self._engine_refs += 1

    def engine_finish(self, reason):
        """Terminal transition for ONE adopted engine row. Finishes
        the whole context only on the last release; the first abnormal
        reason (anything but "finished") wins over rows that completed
        normally."""
        with self._lock:
            if self.outcome is not None:
                return False
            if reason != "finished" and self._engine_reason is None:
                self._engine_reason = reason
            self._engine_refs -= 1
            if self._engine_refs > 0:
                return False
            final = self._engine_reason or reason
        return self.finish(final)

    # -- finish ---------------------------------------------------------
    def finish(self, reason):
        """Terminal transition — idempotent, first reason wins (the
        engine retiring a request and the HTTP layer unwinding both
        call this; whoever saw the outcome first owns it). Records the
        terminal event, the request.tokens / request.outcome
        instruments, runs the slow-request exemplar check, and drops
        the context from the in-flight registry."""
        t = time.perf_counter()
        with self._lock:
            if self.outcome is not None:
                return False
            self.outcome = str(reason)
            self.finish_t = t
            # bypass the max_events cap: a long generation can fill the
            # timeline with tokens ticks, but the exactly-one-terminal-
            # event contract must hold — the exemplar dump and stage()
            # need it, and it is one element past the bound
            self.events.append((_terminal_event(self.outcome), t, None))
        REGISTRY.observe("request.tokens", self.tokens)
        if self.tenant_key is not None:
            # tenant-labeled outcome ONLY via the ACCOUNTING KEY a
            # tenancy-configured layer assigned (bounded by the
            # configured tenant set). The raw header id is never a
            # label: in attribution-only mode (no TenantTable) 64
            # junk ids would otherwise exhaust this instrument's
            # label budget and fold every real tenant into "_other"
            # forever — raw ids stay on the echo and /debug/requests.
            REGISTRY.inc("request.outcome", reason=self.outcome,
                         tenant=self.tenant_key)
        else:
            REGISTRY.inc("request.outcome", reason=self.outcome)
        self._maybe_dump_exemplar()
        _unregister(self)
        return True

    @property
    def finished(self):
        return self.outcome is not None

    # -- introspection --------------------------------------------------
    def stage(self):
        """Name of the most recent event ("created" before any)."""
        with self._lock:
            return self.events[-1][0] if self.events else "created"

    def age_s(self):
        end = self.finish_t if self.finish_t is not None \
            else time.perf_counter()
        return end - self.t0

    def snapshot(self):
        """The /debug/requests row: identity + stage + age — the
        machine-readable signal a fleet router keys on."""
        with self._lock:
            stage = self.events[-1][0] if self.events else "created"
        return {"request_id": self.request_id,
                "trace_id": self.trace_id,
                "tenant": self.tenant,
                "stage": stage,
                "age_s": round(self.age_s(), 6),
                "tokens": self.tokens}

    def timeline(self):
        """[(event, t, attrs)] copy, oldest first."""
        with self._lock:
            return list(self.events)

    # -- slow-request exemplar ------------------------------------------
    def _ttft_s(self):
        for name, t, _ in self.events:
            if name == "first_token":
                return t - self.t0
        return None

    def _maybe_dump_exemplar(self):
        ttft = self._ttft_s()
        total = (self.finish_t - self.t0) if self.finish_t else None
        slow = ((CONFIG.slow_ttft_s is not None and ttft is not None
                 and ttft > CONFIG.slow_ttft_s)
                or (CONFIG.slow_total_s is not None and total is not None
                    and total > CONFIG.slow_total_s))
        if not slow:
            return
        self.dump_spans()
        REGISTRY.inc("request.slow_exemplars")

    def dump_spans(self):
        """Reconstruct this request's lifecycle as nested spans in the
        trace ring, so export_chrome_trace shows it alongside live
        span() scopes: one root `request` span, phase spans
        (queue_wait / prefill / decode) at depth 1, and every timeline
        event as a zero-duration mark at depth 2. All spans share a
        tid derived from the request id, giving the request its own
        track in chrome://tracing / perfetto."""
        with self._lock:
            events = list(self.events)
            t_end = self.finish_t or time.perf_counter()
        tid = zlib.crc32(self.request_id.encode()) & 0x7FFFFFFF
        ident = {"request_id": self.request_id,
                 "trace_id": self.trace_id, "span_id": self.span_id}
        trace.record_span(
            "request", self.t0, (t_end - self.t0) * 1e6, depth=0,
            tid=tid, attrs={**ident, "outcome": self.outcome,
                            "tokens": self.tokens,
                            "dropped_events": self.dropped_events})
        at: dict = {}                              # first occurrence
        for name, t, _ in events:
            at.setdefault(name, t)
        phases = (("queue_wait", at.get("queued"), at.get("scheduled")),
                  ("prefill", at.get("prefill_start"),
                   at.get("prefill_end")),
                  ("decode", at.get("first_token"), t_end))
        for name, p0, p1 in phases:
            if p0 is not None and p1 is not None and p1 >= p0:
                trace.record_span(name, p0, (p1 - p0) * 1e6, depth=1,
                                  tid=tid, attrs=dict(ident))
        for name, t, attrs in events:
            trace.record_span(f"ev.{name}", t, 0.0, depth=2, tid=tid,
                              attrs={**ident, **(attrs or {})})


# -- contextvar propagation --------------------------------------------------

_current: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_torch_request_context", default=None)


def current():
    """The RequestContext bound to this execution context (None when
    observability is disabled or nothing set one)."""
    return _current.get()


def set_current(ctx):
    """Bind `ctx`; returns a token for reset_current(). Serving copies
    the whole contextvars context into its stream-producer thread
    (contextvars.copy_context().run), so the engine's submit() sees
    the same binding."""
    return _current.set(ctx)


def reset_current(token):
    _current.reset(token)


# -- bounded in-flight registry ----------------------------------------------

_live_lock = threading.Lock()
_live: dict = {}                # insertion-ordered (py3.7+): seq -> ctx


def register(ctx: RequestContext):
    """Track a live request for /debug/requests. Bounded: past
    CONFIG.live_capacity the oldest entry is evicted (a leaked or
    abandoned context must not grow the registry forever)."""
    with _live_lock:
        key = next(_seq)
        ctx._live_key = key
        _live[key] = ctx
        while len(_live) > CONFIG.live_capacity:
            _live.pop(next(iter(_live)))
    return ctx


def _unregister(ctx: RequestContext):
    with _live_lock:
        _live.pop(ctx._live_key, None)


def live_requests():
    """Snapshots of every live (registered, unfinished) request,
    oldest first — the GET /debug/requests body."""
    with _live_lock:
        ctxs = list(_live.values())
    return [c.snapshot() for c in ctxs]


def live_count() -> int:
    with _live_lock:
        return len(_live)


def clear():
    """Drop every tracked context (tests)."""
    with _live_lock:
        _live.clear()
