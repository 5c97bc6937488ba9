"""Multi-tenant isolation and QoS for the serving stack.

Counterpart of paddle_tpu/inference/tenancy.py, copied (that module is
stdlib-only, but importing it would import the JAX package):

    TenantPolicy          one tenant's knobs: admission quota
                          (max_in_flight), queue quota (max_queued),
                          fair-share weight, strict priority class,
                          and a fleet-level rate cap (requests/sec,
                          enforced by the router's front door)
    TenantTable           policy lookup with a DEFAULT policy for
                          unlabeled / unknown tenants; `key()` maps
                          tenant-or-None to the accounting id
    TenantAdmission       per-tenant in-flight counters on top of the
                          global admission gate: an over-quota tenant
                          sheds with a typed 429 (`TenantQuotaExceeded`)
                          without consuming global capacity
    WeightedFairScheduler stride/WFQ pick across per-tenant queues:
                          among backlogged tenants, the highest strict-
                          priority class wins outright; within a class,
                          the tenant with the lowest virtual pass is
                          served and charged `cost / weight`. A tenant
                          returning from idle is caught up to the class
                          virtual time, so idleness banks no credit.
                          `PagedKVEngine(tenancy=)` replaces its FIFO
                          admission with this, so decode slots divide
                          by weight under saturation.
    TenantRateLimiter     per-tenant token bucket (policy.rate_limit
                          req/s, 1s burst) for a router's fleet-wide cap.

Identity is sanitized with the same RFC 7230 rules as a request id
(observability/requests.py): it is echoed on replies, so CR/LF or
oversized values are a response-header injection vector.
`resolve_tenant(headers)` is the single extraction point; the chaos
site `tenant.storm` stamps an UNLABELED request as the synthetic storm
tenant there (the noisy-neighbor lever of the starvation soak).

Everything here activates only when a TenantTable is passed
(`tenancy=`); everything is stdlib-only and thread-safe.
"""
from __future__ import annotations

import collections
import threading
import time

from paddle_tpu_torch.distributed import chaos
from paddle_tpu_torch.inference.overload import TenantQuotaExceeded
from paddle_tpu_torch.observability.requests import safe_request_id

__all__ = [
    "DEFAULT_TENANT", "STORM_TENANT", "TenantPolicy", "TenantTable",
    "TenantAdmission", "WeightedFairScheduler", "TenantRateLimiter",
    "safe_tenant_id", "resolve_tenant",
]

#: accounting id for traffic with no (valid) X-Tenant-Id header
DEFAULT_TENANT = "default"
#: synthetic tenant id the `tenant.storm` chaos site stamps onto
#: unlabeled requests (the deterministic noisy-neighbor flood)
STORM_TENANT = "storm"


def safe_tenant_id(value):
    """The inbound `X-Tenant-Id` if it is safe to echo, else None.
    Identical rules to the request-id sanitizer (RFC 7230 token chars,
    bounded length): the id is echoed on replies and forwarded across
    the router hop, so it must never carry CR/LF or unbounded junk."""
    return safe_request_id(value)


def resolve_tenant(headers):
    """Tenant id for one inbound request: the sanitized `X-Tenant-Id`
    header, or — for UNLABELED requests only — the synthetic storm
    tenant when the `tenant.storm` chaos site fires (rate 1.0 turns
    all unlabeled traffic into a deterministic noisy-neighbor flood
    without touching labeled tenants). None when unlabeled and calm."""
    get = headers.get if headers is not None else (lambda k: None)
    tid = safe_tenant_id(get("X-Tenant-Id"))
    if tid is None and chaos.ENABLED and chaos.should_fire("tenant.storm"):
        return STORM_TENANT
    return tid


class TenantPolicy:
    """One tenant's QoS knobs. `None` quotas mean unbounded (that
    dimension falls back to the global gate alone)."""

    __slots__ = ("tenant", "max_in_flight", "max_queued", "weight",
                 "priority", "rate_limit")

    def __init__(self, tenant, *, max_in_flight=None, max_queued=None,
                 weight=1.0, priority=0, rate_limit=None):
        self.tenant = str(tenant)
        if not self.tenant:
            raise ValueError("tenant id must be non-empty")
        if safe_tenant_id(self.tenant) != self.tenant:
            raise ValueError(
                f"tenant id {tenant!r} is not a safe header token "
                "(RFC 7230 token chars, <= 128 chars)")
        self.max_in_flight = (None if max_in_flight is None
                              else int(max_in_flight))
        if self.max_in_flight is not None and self.max_in_flight < 0:
            raise ValueError(f"max_in_flight must be >= 0, got "
                             f"{max_in_flight}")
        self.max_queued = None if max_queued is None else int(max_queued)
        if self.max_queued is not None and self.max_queued < 0:
            raise ValueError(f"max_queued must be >= 0, got {max_queued}")
        self.weight = float(weight)
        if not self.weight > 0.0:
            raise ValueError(f"weight must be > 0, got {weight}")
        self.priority = int(priority)
        self.rate_limit = None if rate_limit is None else float(rate_limit)
        if self.rate_limit is not None and not self.rate_limit > 0.0:
            raise ValueError(f"rate_limit must be > 0, got {rate_limit}")

    def describe(self):
        """The /stats policy row."""
        return {"max_in_flight": self.max_in_flight,
                "max_queued": self.max_queued,
                "weight": self.weight,
                "priority": self.priority,
                "rate_limit": self.rate_limit}

    def __repr__(self):
        return (f"TenantPolicy({self.tenant!r}, "
                f"max_in_flight={self.max_in_flight}, "
                f"max_queued={self.max_queued}, weight={self.weight}, "
                f"priority={self.priority}, "
                f"rate_limit={self.rate_limit})")


class TenantTable:
    """Policy lookup for the serving layers. Unknown tenants (and
    unlabeled traffic) resolve to the `default` policy AND account
    under the default tenant's id (`key()`): a client minting a fresh
    random X-Tenant-Id per request shares ONE budget with every other
    unconfigured tenant instead of getting its own untouched quota —
    and per-tenant state (admission counters, WFQ passes, rate
    buckets, queue/stats rows) stays bounded by the configured tenant
    set, so an id flood cannot grow host memory. Attribution (header
    echo, tracing labels) keeps the raw id; enforcement folds it."""

    def __init__(self, policies=(), default=None):
        self.default = (default if default is not None
                        else TenantPolicy(DEFAULT_TENANT))
        self._policies: dict[str, TenantPolicy] = {}
        for p in policies:
            if not isinstance(p, TenantPolicy):
                raise TypeError(f"expected TenantPolicy, got {p!r}")
            if p.tenant in self._policies:
                raise ValueError(f"duplicate policy for tenant "
                                 f"{p.tenant!r}")
            self._policies[p.tenant] = p
        # the default participates in lookups by its own id too
        self._policies.setdefault(self.default.tenant, self.default)

    def key(self, tenant) -> str:
        """Accounting id: the tenant itself when a policy is
        CONFIGURED for it, the default tenant's id otherwise
        (unlabeled traffic and unconfigured ids — class doc)."""
        if tenant is None:
            return self.default.tenant
        t = str(tenant)
        return t if t in self._policies else self.default.tenant

    def policy(self, tenant) -> TenantPolicy:
        if tenant is None:
            return self.default
        return self._policies.get(str(tenant), self.default)

    def tenants(self):
        """Known (configured) tenant ids."""
        return list(self._policies)

    def describe(self):
        return {t: p.describe() for t, p in self._policies.items()}


class TenantAdmission:
    """Per-tenant in-flight bookkeeping layered over the global
    admission gate. The check runs BEFORE the global acquire, so
    an over-quota tenant's shed never consumes a global slot — other
    tenants' budgets are untouched by a storm."""

    def __init__(self, table: TenantTable, retry_after_s=1.0):
        self.table = table
        self.retry_after_s = float(retry_after_s)
        self._lock = threading.Lock()
        self._in_flight: dict[str, int] = {}
        self._served: dict[str, int] = {}
        self._shed: dict[str, int] = {}

    def try_acquire(self, tenant):
        """Admit `tenant` (raw id or None) or raise
        TenantQuotaExceeded. Pair with release(tenant)."""
        key = self.table.key(tenant)
        pol = self.table.policy(tenant)
        with self._lock:
            n = self._in_flight.get(key, 0)
            if pol.max_in_flight is not None and n >= pol.max_in_flight:
                self._shed[key] = self._shed.get(key, 0) + 1
                raise TenantQuotaExceeded(
                    f"tenant {key!r} over admission quota: {n} in "
                    f"flight >= max_in_flight {pol.max_in_flight}",
                    retry_after=self.retry_after_s)
            self._in_flight[key] = n + 1
            self._served[key] = self._served.get(key, 0) + 1

    def release(self, tenant):
        key = self.table.key(tenant)
        with self._lock:
            self._in_flight[key] = max(
                0, self._in_flight.get(key, 0) - 1)

    def rollback(self, tenant):
        """Undo a try_acquire whose request was then shed by a LATER
        gate (global admission / breaker): it never ran, so it must
        not count as admitted either."""
        key = self.table.key(tenant)
        with self._lock:
            self._in_flight[key] = max(
                0, self._in_flight.get(key, 0) - 1)
            self._served[key] = max(0, self._served.get(key, 0) - 1)

    def in_flight(self, tenant) -> int:
        with self._lock:
            return self._in_flight.get(self.table.key(tenant), 0)

    def snapshot(self) -> dict:
        """{tenant: {in_flight, admitted, shed}} over every tenant
        ever seen plus every configured one."""
        with self._lock:
            keys = (set(self._in_flight) | set(self._served)
                    | set(self._shed) | set(self.table.tenants()))
            return {k: {"in_flight": self._in_flight.get(k, 0),
                        "admitted": self._served.get(k, 0),
                        "shed": self._shed.get(k, 0)}
                    for k in sorted(keys)}


class WeightedFairScheduler:
    """Stride/WFQ pick across tenants with strict priority classes.

    State is two maps: a per-tenant virtual `pass` and a per-class
    virtual time (the pass value of the last service in that class).
    `pick(candidates)` returns the tenant to serve next: candidates in
    the highest priority class only (strict priority above the fair
    tiers), and within it the minimum effective pass — where effective
    pass is `max(stored, class virtual time)`, so a tenant returning
    from idle competes from NOW instead of replaying banked credit.
    `charge(tenant, cost)` advances the served tenant's pass by
    `cost / weight` and the class clock to its pre-service pass.

    Deterministic: ties break on the tenant id, and nothing reads the
    wall clock — two identical call sequences schedule identically
    (the 3:1-share soak relies on this)."""

    def __init__(self, table: TenantTable):
        self.table = table
        self._lock = threading.Lock()
        self._pass: dict[str, float] = {}
        self._vt: dict[int, float] = {}     # per priority class

    def _eff_pass_locked(self, tenant):
        pol = self.table.policy(tenant)
        vt = self._vt.get(pol.priority, 0.0)
        return max(self._pass.get(tenant, vt), vt)

    def pick(self, candidates):
        """The tenant id to serve next among `candidates` (an iterable
        of accounting keys; must be non-empty)."""
        with self._lock:
            best = None
            for t in candidates:
                pol = self.table.policy(t)
                k = (-pol.priority, self._eff_pass_locked(t), t)
                if best is None or k < best[0]:
                    best = (k, t)
            if best is None:
                raise ValueError("pick() needs at least one candidate")
            return best[1]

    def charge(self, tenant, cost=1.0):
        """Account one unit of service (`cost` in whatever unit the
        caller schedules: requests, batch rows, slots)."""
        pol = self.table.policy(tenant)
        with self._lock:
            vt = self._vt.get(pol.priority, 0.0)
            p = max(self._pass.get(tenant, vt), vt)
            self._vt[pol.priority] = p
            self._pass[tenant] = p + float(cost) / pol.weight

    def snapshot(self):
        with self._lock:
            return {"pass": dict(self._pass),
                    "virtual_time": dict(self._vt)}


class TenantRateLimiter:
    """Per-tenant token bucket for the router's fleet-wide rate caps:
    `policy.rate_limit` requests/sec with a one-second burst. Tenants
    without a rate_limit always pass. `allow()` returns
    (ok, retry_after_s) — the caller sheds with a typed 429 and the
    (to-be-jittered) backoff hint when ok is False."""

    def __init__(self, table: TenantTable, clock=time.monotonic):
        self.table = table
        self._clock = clock         # injectable for deterministic tests
        self._lock = threading.Lock()
        self._buckets: dict[str, list] = {}     # key -> [tokens, t_last]
        self._shed: dict[str, int] = {}

    def allow(self, tenant):
        pol = self.table.policy(tenant)
        if pol.rate_limit is None:
            return True, None
        key = self.table.key(tenant)
        burst = max(1.0, pol.rate_limit)
        now = self._clock()
        with self._lock:
            b = self._buckets.get(key)
            if b is None:
                b = self._buckets[key] = [burst, now]
            tokens, t_last = b
            tokens = min(burst, tokens + (now - t_last) * pol.rate_limit)
            if tokens >= 1.0:
                b[0], b[1] = tokens - 1.0, now
                return True, None
            b[0], b[1] = tokens, now
            self._shed[key] = self._shed.get(key, 0) + 1
            return False, (1.0 - tokens) / pol.rate_limit

    def shed_counts(self):
        with self._lock:
            return dict(self._shed)
