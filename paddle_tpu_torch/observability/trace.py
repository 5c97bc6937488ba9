"""Lightweight span tracing into a bounded ring buffer.

Counterpart of paddle_tpu/observability/trace.py, copied (the module is
stdlib-only, but importing it would import the JAX package).
`observability.span(name, **attrs)` (the gated entry point — see
observability/__init__.py) wraps a host-side scope; completed spans
land in a process-wide ring buffer (oldest evicted first, so a
long-running job's memory is bounded) and export as chrome-trace JSON
that loads in chrome://tracing / perfetto.

The JAX module can merge its native profiler's HostTracer events into
the export (`merge_host_tracer=True`); the port has no HostTracer yet
(the profiler is not ported), so that argument raises instead of
exporting the spans alone.

Spans nest naturally: chrome-trace "X" (complete) events reconstruct
the stack from ts/dur containment per thread; `depth` is also recorded
explicitly in args for programmatic consumers.

Stdlib-only.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time

__all__ = ["Span", "record_span", "set_ring_capacity", "ring_capacity",
           "spans", "clear", "export_chrome_trace", "chrome_events"]

_DEFAULT_CAPACITY = 4096

_lock = threading.Lock()
_ring: collections.deque = collections.deque(maxlen=_DEFAULT_CAPACITY)
_tls = threading.local()


def set_ring_capacity(n: int):
    """Resize the span ring (keeps the newest spans)."""
    global _ring
    with _lock:
        _ring = collections.deque(_ring, maxlen=int(n))


def ring_capacity() -> int:
    return _ring.maxlen


def clear():
    with _lock:
        _ring.clear()


class Span:
    """One timed scope. Use through observability.span(...) so the
    disabled path stays a single attribute check; constructing a Span
    directly always records."""

    __slots__ = ("name", "attrs", "t0", "dur_us", "depth", "tid")

    def __init__(self, name, attrs=None):
        self.name = name
        self.attrs = attrs or {}
        self.t0 = 0.0
        self.dur_us = 0.0
        self.depth = 0
        self.tid = 0

    def __enter__(self):
        depth = getattr(_tls, "depth", 0)
        _tls.depth = depth + 1
        self.depth = depth
        self.tid = threading.get_ident()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.dur_us = (time.perf_counter() - self.t0) * 1e6
        _tls.depth = self.depth
        if exc_type is not None:
            self.attrs = {**self.attrs, "error": exc_type.__name__}
        with _lock:
            _ring.append(self)
        return False


def record_span(name, t0, dur_us, *, depth=0, tid=None, attrs=None):
    """Append an externally-timed completed span to the ring. The
    slow-request exemplar path (observability/requests.py) rebuilds a
    request's lifecycle from its recorded timeline after the fact
    rather than timing a live scope; `t0` must be a
    time.perf_counter() value so the span lands on the same timeline
    as live span() scopes."""
    s = Span(name, attrs or {})
    s.t0 = float(t0)
    s.dur_us = float(dur_us)
    s.depth = int(depth)
    s.tid = int(tid) if tid is not None else threading.get_ident()
    with _lock:
        _ring.append(s)
    return s


def spans() -> list:
    """Snapshot of the ring, oldest first."""
    with _lock:
        return list(_ring)


def chrome_events() -> list:
    """Ring contents as chrome-trace event dicts. perf_counter has an
    arbitrary epoch; events are self-consistent with each other."""
    evs = []
    pid = os.getpid()
    for s in spans():
        args = {"depth": s.depth}
        args.update({str(k): v for k, v in s.attrs.items()})
        evs.append({"name": s.name, "ph": "X", "pid": pid,
                    "tid": s.tid, "ts": s.t0 * 1e6,
                    "dur": s.dur_us, "cat": "observability",
                    "args": args})
    return evs


def export_chrome_trace(path=None, merge_host_tracer=False) -> dict:
    """Chrome-trace document of the recorded spans. Writes to `path`
    when given; always returns the document. `merge_host_tracer` asks
    for the profiler's HostTracer events, which the port does not have:
    it raises rather than returning the spans alone."""
    if merge_host_tracer:
        raise NotImplementedError(
            "export_chrome_trace(merge_host_tracer=True) merges the "
            "profiler's HostTracer events; paddle_tpu_torch has no "
            "profiler HostTracer yet (paddle_tpu/profiler and _native "
            "are not ported), so only the span ring can be exported")
    doc = {"traceEvents": chrome_events(), "displayTimeUnit": "ms",
           "metadata": {"producer": "paddle_tpu.observability"}}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc
