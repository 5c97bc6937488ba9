"""The observability plane of the port: metrics registry, span tracing,
per-request tracing, the training telemetry, the fleet plane and
flight recorder.

Counterpart of paddle_tpu/observability/__init__.py:

    metrics.py    thread-safe MetricsRegistry of Counter/Gauge/
                  Histogram with the closed name catalogue (METRICS),
                  JSON snapshot + Prometheus text exposition (served
                  at GET /metrics by inference/serving.PredictorServer)
    trace.py      span(name, **attrs) -> bounded ring buffer ->
                  chrome-trace JSON
    requests.py   per-request contexts, the TTFT / ITL / queue-wait /
                  prefill / outcome instruments, GET /debug/requests
    telemetry.py  per-step training reporter: tokens/sec + MFU over the
                  card's peak (imported on use by parallel/trainer.py)
    fleet.py      cross-rank heartbeats over a rendezvous store, the
                  straggler view behind GET /debug/fleet, and the crash
                  flight recorder (bundles read by tools/obs_dump.py)

Contract with the hot path: when observability is disabled (the
default), every instrumentation point is a single module-attribute
load + falsy branch:

    if observability.ENABLED:
        observability.inc("inference.prefix.hits")

No dict lookup, no allocation, no lock. Enabling is explicit and
in-process: `observability.enable()` or `scoped()`; the environment
switches nothing. This switch, registry, span ring and request registry
are the port's own: enabling the JAX package's plane (or setting its
PADDLE_TPU_OBS) does not enable this one, nor the other way round. The serving stack's
own request counters are always on (per-server registries, not this
module's global one).

Metric names at instrumentation sites must be string literals from the
metrics.METRICS catalogue; tests/test_torch_observability.py scans the
package for it.
"""
from __future__ import annotations

from paddle_tpu_torch.observability import metrics as metrics  # noqa: PLC0414
from paddle_tpu_torch.observability import trace as trace      # noqa: PLC0414
from paddle_tpu_torch.observability import requests as requests  # noqa: PLC0414
from paddle_tpu_torch.observability import fleet as fleet      # noqa: PLC0414
from paddle_tpu_torch.observability.metrics import (
    METRICS, MetricsRegistry, REGISTRY)
from paddle_tpu_torch.observability.trace import Span, export_chrome_trace
from paddle_tpu_torch.observability.requests import RequestContext

__all__ = [
    "ENABLED", "enable", "disable", "scoped", "inc", "observe",
    "set_gauge", "span", "METRICS", "MetricsRegistry", "REGISTRY",
    "Span", "export_chrome_trace", "metrics", "trace", "requests",
    "RequestContext", "fleet",
]

# the ONE attribute hot paths branch on
ENABLED = False


def enable(reset=False):
    """Turn instrumentation on process-wide. `reset=True` also clears
    the global registry, the span ring, the live request registry and
    the cached fleet view (test harness form)."""
    global ENABLED
    if reset:
        REGISTRY.reset()
        trace.clear()
        requests.clear()
        fleet.clear()
    ENABLED = True


def disable():
    """Back to the zero-cost default; recorded data is kept."""
    global ENABLED
    ENABLED = False


class _Scoped:
    def __init__(self, reset):
        self._reset = reset

    def __enter__(self):
        self._prev = ENABLED
        enable(reset=self._reset)
        return REGISTRY

    def __exit__(self, *exc):
        global ENABLED
        ENABLED = self._prev
        return False


def scoped(reset=True):
    """`with observability.scoped() as registry:` — enable for a block,
    restoring the previous state (including disabled) on exit."""
    return _Scoped(reset)


# -- instrumentation surface ------------------------------------------------
# Call sites gate with `if observability.ENABLED:` so the disabled cost
# is one attribute check; these helpers themselves always record (into
# the global REGISTRY), which is what tests and scoped() rely on.

def inc(name, n=1, **labels):
    REGISTRY.inc(name, n, **labels)


def observe(name, v, **labels):
    REGISTRY.observe(name, v, **labels)


def set_gauge(name, v, **labels):
    REGISTRY.set_gauge(name, v, **labels)


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


def span(name, **attrs):
    """Timed scope -> the trace ring. Cheap when disabled: returns a
    shared no-op context manager without allocating."""
    if not ENABLED:
        return _NOOP_SPAN
    return Span(name, attrs)
