"""Overload control for the serving stack (admission, deadlines,
circuit breaking).

Counterpart of paddle_tpu/inference/overload.py, copied (the module is
stdlib-only, but importing it would import the JAX package). A server
that is saturated must say so cheaply (shed with a retryable status)
instead of queueing unboundedly, a request whose client has a timeout
must carry that budget through every queue it waits in, and a broken
backend must fast-fail while it recovers rather than time every caller
out. These pieces are wired through `PredictorServer` /
`DynamicBatcher` (serving.py) and `PagedKVEngine.submit` (paged.py):

    AdmissionController  bounded in-flight count (concurrency limit +
                         queue headroom); excess load -> AdmissionRejected
                         (HTTP 429 + Retry-After)
    Deadline             absolute monotonic deadline built from a
                         `timeout_ms` request field / `X-Timeout-Ms`
                         header; expiring *in a queue* fails the request
                         (HTTP 504) without occupying a batch slot
    CircuitBreaker       closed -> open after N consecutive backend
                         failures (fast-fail 503), half-open probe after
                         a cooldown, reclose on probe success

The engine sheds with `EngineOverloaded` when its pending queue is at
its bound and with `TenantQuotaExceeded` when one tenant is over its
own queue quota. Everything here is stdlib-only and thread-safe.
"""
from __future__ import annotations

import random
import threading
import time

__all__ = [
    "OverloadError", "AdmissionRejected", "TenantQuotaExceeded",
    "CircuitOpenError", "ServerDraining", "DeadlineExceeded",
    "EngineOverloaded", "Deadline", "AdmissionController",
    "CircuitBreaker", "jittered_retry_after", "seed_retry_jitter",
]


# -- Retry-After jitter -----------------------------------------------------
#
# Shed replies used to advertise FIXED Retry-After values (the
# admission controller's retry_after_s constant, the breaker's cooldown
# remainder) — so every client shed in the same overload burst backed
# off for the same interval and came back in the same instant: a
# self-sustaining retry storm. The fix is bounded ±jitter applied at
# the single point a Retry-After value is emitted (serving's reply
# writer, the router's shed replies), never where the value is
# computed — breaker math and tests keep seeing exact values.

_RETRY_JITTER_FRAC = 0.25
_retry_jitter_lock = threading.Lock()
_retry_jitter_rng = random.Random()


def seed_retry_jitter(seed):
    """Deterministic Retry-After jitter for tests / chaos harnesses:
    after seeding, the emitted values follow the seeded RNG's exact
    uniform sequence."""
    global _retry_jitter_rng
    with _retry_jitter_lock:
        _retry_jitter_rng = random.Random(seed)


def jittered_retry_after(seconds, frac=_RETRY_JITTER_FRAC):
    """`seconds` spread uniformly over ±`frac` (bounded below at 50ms
    so a tiny advertised backoff never jitters to zero). None passes
    through — no header, nothing to desynchronize."""
    if seconds is None:
        return None
    s = float(seconds)
    lo = max(0.05, s * (1.0 - frac))
    hi = max(lo, s * (1.0 + frac))
    with _retry_jitter_lock:
        return _retry_jitter_rng.uniform(lo, hi)


# -- typed rejections -------------------------------------------------------

class OverloadError(RuntimeError):
    """Base of control-plane rejections. `status` is the HTTP code the
    serving layer maps it to; `retry_after` (seconds, may be None) is
    surfaced as a Retry-After header so well-behaved clients back off."""

    status = 503
    counter = "shed"                    # /stats bucket

    def __init__(self, msg, retry_after=None):
        super().__init__(msg)
        self.retry_after = retry_after


class AdmissionRejected(OverloadError):
    """No admission headroom (queue depth + concurrency bound hit)."""

    status = 429
    counter = "shed_admission"


class TenantQuotaExceeded(AdmissionRejected):
    """One tenant is over ITS OWN quota (per-tenant admission or queue
    bound, or the router's fleet-wide rate cap — inference/tenancy.py)
    while the server may have plenty of global headroom: shed THIS
    tenant's excess with a typed, retryable 429 without touching any
    other tenant's budget (the bulkhead contract)."""

    status = 429
    counter = "shed_tenant"


class CircuitOpenError(OverloadError):
    """Breaker is open (or half-open with its probe already taken):
    the backend is failing, fail fast instead of queueing."""

    status = 503
    counter = "shed_breaker"


class ServerDraining(OverloadError):
    """Server is in graceful drain: finishing in-flight work, admitting
    nothing new."""

    status = 503
    counter = "shed_draining"


class DeadlineExceeded(OverloadError):
    """The request's deadline expired (before or while queued)."""

    status = 504
    counter = "deadline_exceeded"


class EngineOverloaded(OverloadError):
    """PagedKVEngine admission: no slot/page headroom and the pending
    queue is at its bound — shed instead of waiting unboundedly."""

    status = 503
    counter = "shed_engine"


# -- deadlines --------------------------------------------------------------

class Deadline:
    """An absolute `time.monotonic()` deadline. `Deadline(None)` (or the
    module-level absence of one) means no budget; helpers treat it as
    infinitely far away so call sites don't need None checks."""

    __slots__ = ("t",)

    def __init__(self, t=None):
        self.t = None if t is None else float(t)

    @classmethod
    def after_ms(cls, ms):
        """Deadline `ms` milliseconds from now (None -> no deadline)."""
        if ms is None:
            return cls(None)
        return cls(time.monotonic() + float(ms) / 1000.0)

    def remaining(self):
        """Seconds left (may be negative); None when unbounded."""
        return None if self.t is None else self.t - time.monotonic()

    def expired(self):
        return self.t is not None and time.monotonic() >= self.t

    def check(self, what="request"):
        """Raise DeadlineExceeded if expired."""
        if self.expired():
            raise DeadlineExceeded(f"deadline exceeded ({what})")

    def __repr__(self):
        r = self.remaining()
        return ("Deadline(unbounded)" if r is None
                else f"Deadline({r * 1000:.1f}ms left)")


def expired(deadline) -> bool:
    """None-tolerant `deadline.expired()`."""
    return deadline is not None and deadline.expired()


# -- admission --------------------------------------------------------------

class AdmissionController:
    """Bounded in-flight request count: `max_concurrent` requests may
    execute while up to `max_queue` more wait (on the executable lock /
    batcher); anything past `capacity = max_concurrent + max_queue` is
    shed with AdmissionRejected. `saturated` (at capacity) feeds the
    /readyz readiness flip so load balancers steer away *before* hard
    429s start."""

    def __init__(self, max_concurrent=32, max_queue=64,
                 retry_after_s=1.0):
        self.max_concurrent = int(max_concurrent)
        self.max_queue = int(max_queue)
        self.capacity = self.max_concurrent + self.max_queue
        self.retry_after_s = float(retry_after_s)
        self._lock = threading.Lock()
        self._in_flight = 0
        self.admitted = 0               # lifetime counters (observability)
        self.rejected = 0

    @property
    def in_flight(self):
        with self._lock:
            return self._in_flight

    @property
    def saturated(self):
        # early-warning watermark: unready once requests start QUEUEING
        # (past the concurrency limit), while still accepting up to
        # `capacity` — so /readyz steers load balancers away before
        # hard 429s begin, as documented
        with self._lock:
            return self._in_flight >= self.max_concurrent

    def try_acquire(self):
        """Admit or raise AdmissionRejected. Pair with release()."""
        with self._lock:
            if self._in_flight >= self.capacity:
                self.rejected += 1
                raise AdmissionRejected(
                    f"admission rejected: {self._in_flight} in flight >= "
                    f"capacity {self.capacity} ({self.max_concurrent} "
                    f"concurrent + {self.max_queue} queued)",
                    retry_after=self.retry_after_s)
            self._in_flight += 1
            self.admitted += 1

    def release(self):
        with self._lock:
            self._in_flight = max(0, self._in_flight - 1)


# -- circuit breaking -------------------------------------------------------

class CircuitBreaker:
    """Closed -> open -> half-open breaker around backend runs.

    `failure_threshold` CONSECUTIVE recorded failures trip it open;
    while open every allow() fast-fails with CircuitOpenError carrying
    the cooldown remainder as retry_after. After `reset_after_s` the
    first allow() transitions to half-open and admits up to
    `half_open_max` probes; a probe success recloses, a probe failure
    re-opens (fresh cooldown). A probe that never reports back (e.g.
    client disconnect) self-heals: after another cooldown the probe
    budget replenishes.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold=5, reset_after_s=5.0,
                 half_open_max=1):
        self.failure_threshold = int(failure_threshold)
        self.reset_after_s = float(reset_after_s)
        self.half_open_max = int(half_open_max)
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._changed_at = time.monotonic()
        self._probes = 0
        self.opens = 0                  # lifetime trips (observability)
        self.recloses = 0

    @property
    def state(self):
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _maybe_half_open_locked(self):
        now = time.monotonic()
        if self._state == self.OPEN \
                and now - self._changed_at >= self.reset_after_s:
            self._state = self.HALF_OPEN
            self._changed_at = now
            self._probes = 0
        elif self._state == self.HALF_OPEN \
                and self._probes >= self.half_open_max \
                and now - self._changed_at >= self.reset_after_s:
            # abandoned probes (no success/failure ever recorded):
            # replenish so one lost client can't wedge the breaker
            self._changed_at = now
            self._probes = 0

    def allow(self):
        """Admit the request or raise CircuitOpenError. Every admitted
        request should end in record_success() or record_failure()."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == self.CLOSED:
                return
            if self._state == self.HALF_OPEN \
                    and self._probes < self.half_open_max:
                self._probes += 1
                return
            left = self.reset_after_s - (time.monotonic()
                                         - self._changed_at)
            raise CircuitOpenError(
                f"circuit breaker {self._state} "
                f"({self._consecutive_failures} consecutive failures)",
                retry_after=max(left, 0.0) or self.reset_after_s)

    def record_success(self):
        with self._lock:
            self._consecutive_failures = 0
            if self._state != self.CLOSED:
                self._state = self.CLOSED
                self._changed_at = time.monotonic()
                self._probes = 0
                self.recloses += 1

    def record_failure(self):
        with self._lock:
            self._consecutive_failures += 1
            trip = (self._state == self.HALF_OPEN
                    or (self._state == self.CLOSED
                        and self._consecutive_failures
                        >= self.failure_threshold))
            if trip:
                self._state = self.OPEN
                self._changed_at = time.monotonic()
                self._probes = 0
                self.opens += 1

    def release_probe(self):
        """Return an un-judged half-open probe: the admitted request
        was shed by a later gate (deadline, queue full) without the
        backend ever answering, so it must not burn the probe budget
        for a whole extra cooldown."""
        with self._lock:
            if self._state == self.HALF_OPEN and self._probes > 0:
                self._probes -= 1

    def snapshot(self):
        with self._lock:
            self._maybe_half_open_locked()
            return {"state": self._state,
                    "consecutive_failures": self._consecutive_failures,
                    "opens": self.opens, "recloses": self.recloses}
