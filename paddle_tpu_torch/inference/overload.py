"""The engine's typed rejections and request deadlines.

Counterpart of the part of paddle_tpu/inference/overload.py that
`PagedKVEngine` uses, copied (that module is stdlib-only, but importing
it would import the JAX package): `submit` sheds with `EngineOverloaded`
when the pending queue is at its bound, with `TenantQuotaExceeded` (an
`AdmissionRejected`) when one tenant is over its own queue quota, and
fails a request whose `Deadline` expired, before or while queued, with
`DeadlineExceeded`.
The admission controller, the circuit breaker and the Retry-After
jitter belong to the HTTP serving surface and are not here.
"""
from __future__ import annotations

import time

__all__ = ["OverloadError", "DeadlineExceeded", "EngineOverloaded",
           "AdmissionRejected", "TenantQuotaExceeded", "Deadline",
           "expired"]


class OverloadError(RuntimeError):
    """Base of control-plane rejections. `status` is the HTTP code the
    serving layer maps it to; `retry_after` (seconds, may be None) is
    surfaced as a Retry-After header so well-behaved clients back off."""

    status = 503
    counter = "shed"                    # /stats bucket

    def __init__(self, msg, retry_after=None):
        super().__init__(msg)
        self.retry_after = retry_after


class DeadlineExceeded(OverloadError):
    """The request's deadline expired (before or while queued)."""

    status = 504
    counter = "deadline_exceeded"


class EngineOverloaded(OverloadError):
    """PagedKVEngine admission: no slot/page headroom and the pending
    queue is at its bound — shed instead of waiting unboundedly."""

    status = 503
    counter = "shed_engine"


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


class Deadline:
    """An absolute `time.monotonic()` deadline. `Deadline(None)` means
    no budget; helpers treat it as infinitely far away."""

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
