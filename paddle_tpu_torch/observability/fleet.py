"""Fleet telemetry plane: cross-rank heartbeats, straggler detection,
and a crash flight recorder.

Counterpart of paddle_tpu/observability/fleet.py, copied and adapted (the
module is stdlib-only, but importing it would import the JAX package):
the same names, snapshot fields, view, bundle layout, chaos sites and
``fleet.*`` instruments, over the port's registry, span ring and request
registry.

    FleetHeartbeat     each rank periodically publishes a compact
                       bounded JSON snapshot (step, tokens/sec, MFU,
                       recompiles, pending async saves, serving queue
                       depth, wall time) into a rendezvous store under
                       ``fleet/hb/{rank}`` -- a daemon thread, writes via
                       the distributed/retries.py policy on its own
                       cloned client connection so a blocking wait() on
                       the shared socket can never starve the beat
    FleetAggregator    rank 0 (or the serving process, behind
                       ``GET /debug/fleet``) scans every rank's key into
                       one view: step skew (max-min), slowest-rank lag
                       vs the fleet median, stale-rank count, fleet-
                       summed tokens/sec -- published as the catalogued
                       ``fleet.*`` instruments -- plus a straggler
                       detector flagging any rank whose step lags the
                       median by more than ``straggler_steps`` or whose
                       heartbeat age exceeds ``stale_after_s``
    flight recorder    ``record_crash(reason, exc=...)`` atomically
                       dumps a self-contained bundle directory --
                       metrics JSON snapshot, span-ring chrome trace,
                       /debug/requests-shape registry rows, the last-seen
                       fleet view, exception + traceback + all-thread
                       stacks -- with bounded retention. Wired to the
                       router's ejections (inference/router.py), the
                       serving drain (inference/serving.py) and the
                       autopilot's crash-loop quarantine
                       (inference/autopilot.py); ``tools/obs_dump.py``
                       pretty-prints a bundle.

The store is ``torch.distributed.TCPStore`` (any object with ``set``,
``get`` and ``check`` in its signatures): ``check`` takes a LIST of keys,
as torch's Store does. ``clone`` (a private publisher connection) and
``close`` are used when the store has them.

Chaos sites ``fleet.heartbeat.delay`` (the beat is stamped BEFORE the
injected delay, so the published snapshot ages -- the heartbeat-age
straggler lever) and ``fleet.heartbeat.drop`` (the publish is skipped,
so the rank's last beat goes stale) drive the detector deterministically
in tests.

Contract with the hot path: disabled (the default), the whole plane is
one module-attribute check at each wiring site (serving's drain dump,
the router's ejection dump and the supervisor's quarantine dump gate on
``observability.ENABLED``): no threads, no store traffic, no bundle
directories. The flight recorder additionally no-ops until a bundle
directory is configured with ``configure_flight_recorder(dir=...)``: the
port reads no environment variable, so it starts disarmed with
``max_keep=5`` (the JAX module reads PADDLE_TPU_FLIGHT_DIR and
PADDLE_TPU_FLIGHT_KEEP at import).

Heartbeat payloads are host values: numbers from the registry and from
``extra_fn``. A 0-d tensor on the CPU coerces like a number; a tensor on
a device is never read (it would synchronise the device from the daemon
thread) and ships as a short string.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
import socket
import sys
import threading
import time
import traceback

from paddle_tpu_torch.observability.metrics import REGISTRY
from paddle_tpu_torch.observability import trace
from paddle_tpu_torch.observability import requests as _requests

__all__ = [
    "HEARTBEAT_PREFIX", "FleetHeartbeat", "FleetAggregator",
    "registry_sample", "last_view", "clear",
    "FLIGHT", "configure_flight_recorder", "record_crash",
    "flight_records",
]

#: store key namespace one rank's heartbeat lives under: f"fleet/hb/{rank}"
HEARTBEAT_PREFIX = "fleet/hb/"

#: a heartbeat snapshot is COMPACT and BOUNDED: at most this many
#: fields survive (sorted; identity fields always kept), floats are
#: rounded — the store is a rendezvous service, not a time-series DB.
_MAX_FIELDS = 24

_HOST = socket.gethostname()

_view_lock = threading.Lock()
_LAST_VIEW: dict | None = None


def last_view():
    """The most recent FleetAggregator view scanned in this process
    (None before any scan) — the flight recorder ships it so a crash
    bundle carries the last cross-rank picture, not just local state."""
    with _view_lock:
        return _LAST_VIEW


def _remember(view):
    global _LAST_VIEW
    with _view_lock:
        _LAST_VIEW = view


def clear():
    """Drop the cached fleet view (tests / observability.enable(reset))."""
    global _LAST_VIEW
    with _view_lock:
        _LAST_VIEW = None


def registry_sample(registry=None) -> dict:
    """The default per-rank heartbeat payload, read from the shared
    metrics registry: only instruments that have actually recorded
    appear, so an inference-only process ships queue depth without
    fake training fields and vice versa."""
    reg = registry if registry is not None else REGISTRY
    names = reg.names()
    out = {}
    if "train.steps" in names:
        out["step"] = int(reg.counter("train.steps").value())
    if "train.tokens_per_sec" in names:
        v = reg.gauge("train.tokens_per_sec").value()
        if v is not None:
            out["tokens_per_sec"] = float(v)
    if "train.mfu" in names:
        v = reg.gauge("train.mfu").value()
        if v is not None:
            out["mfu"] = float(v)
    if "train.recompiles" in names:
        # summed across the per-shape label cells (trainer labels each
        # recompile with its triggering batch-shape signature)
        out["recompiles"] = int(sum(
            reg.counter("train.recompiles").labeled().values()))
    if "checkpoint.async.pending" in names:
        v = reg.gauge("checkpoint.async.pending").value()
        if v is not None:
            out["ckpt_async_pending"] = float(v)
    if "train.sentry.steps_since_good" in names:
        # a rank whose training is numerically degrading shows up here
        # (climbing steps-since-promoted-checkpoint, mounting trigger
        # count) BEFORE its sentry quarantines it
        v = reg.gauge("train.sentry.steps_since_good").value()
        if v is not None:
            out["steps_since_good"] = float(v)
    if "train.sentry.triggers" in names:
        out["sentry_triggers"] = int(sum(
            reg.counter("train.sentry.triggers").labeled().values()))
    return out


def _json_value(v):
    """A JSON-serializable scalar for one snapshot field. sample_fn /
    extra_fn values commonly come off numpy or torch (np.int64 queue
    depths, np.float32 gauges, 0-d tensors) -- json.dumps rejects those,
    and a publisher that raises on EVERY beat makes the rank look stale
    with no visible error. Numbers coerce through float (integral values
    stay integers); a tensor off the CPU is not read; everything else
    stringifies."""
    if v is None or isinstance(v, (bool, str, int)):
        return v
    dev = getattr(v, "device", None)
    if dev is not None and getattr(dev, "type", dev) != "cpu":
        return f"<tensor on {dev}>"[:64]
    try:
        f = float(v)
    except (TypeError, ValueError, RuntimeError):
        return str(v)[:64]
    if f != f or f in (float("inf"), float("-inf")):
        return str(f)
    if f.is_integer() and abs(f) < 2 ** 53:
        return int(f)
    return round(f, 4)


def _clone_store(store):
    """A private client connection for the publisher thread when the
    store can provide one (TCPStore.clone): a blocking wait() on the
    shared client's socket must never starve the heartbeat."""
    clone = getattr(store, "clone", None)
    if clone is not None:
        try:
            return clone()
        except Exception:  # lint: disable=silent-swallow -- clone is an optimization; fall back to the shared client
            pass
    return store


class FleetHeartbeat:
    """One rank's heartbeat publisher.

    ``sample_fn() -> dict`` overrides the registry-derived payload
    (tests drive the detector with synthetic steps this way);
    ``extra_fn() -> dict`` merges on top (serving attaches its queue
    depth). `start()` publishes one beat synchronously — the rank is
    rendezvous-visible immediately — then a daemon thread re-publishes
    every `interval` seconds through the retry policy. A store that
    stays down for `max_consecutive_errors` beats ends the loop: the
    job is ending anyway, and a daemon thread hammering a dead socket
    helps nobody.
    """

    def __init__(self, store, rank, world_size, *, interval=2.0,
                 sample_fn=None, extra_fn=None, prefix=HEARTBEAT_PREFIX,
                 retry_policy=None, max_consecutive_errors=8):
        self.store = store
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.interval = float(interval)
        self.sample_fn = sample_fn
        self.extra_fn = extra_fn
        self.key = f"{prefix}{self.rank}"
        self.max_consecutive_errors = int(max_consecutive_errors)
        self.beats = 0              # publishes that landed in the store
        self._seq = 0               # publish attempts (snapshot field)
        self._consecutive_errors = 0
        self._stop_ev = threading.Event()
        self._thread = None
        self._pub_store = _clone_store(store)
        if retry_policy is not None:
            self._retry = retry_policy
        else:
            from paddle_tpu_torch.distributed.retries import default_policy
            self._retry = default_policy(retryable=(ConnectionError,))

    # -- sampling -----------------------------------------------------
    def sample(self) -> dict:
        """The snapshot one publish ships: identity + wall-time stamp +
        the registry-derived (or sample_fn-provided) payload, bounded
        to _MAX_FIELDS fields with rounded floats."""
        snap = {"rank": self.rank, "world_size": self.world_size,
                "seq": self._seq, "time": time.time(),
                "pid": os.getpid(), "host": _HOST}
        body = (self.sample_fn() if self.sample_fn is not None
                else registry_sample())
        if self.extra_fn is not None:
            body = {**body, **self.extra_fn()}
        for k in sorted(body):
            if len(snap) >= _MAX_FIELDS:
                break
            snap[str(k)] = _json_value(body[k])
        return snap

    # -- publishing ---------------------------------------------------
    def publish(self) -> bool:
        """One beat: sample, stamp, chaos gate, store.set through the
        retry policy. Returns True when the beat landed. The snapshot
        is stamped BEFORE the chaos delay so an injected slow publish
        ages the beat the aggregator reads."""
        snap = self.sample()
        self._seq += 1
        payload = json.dumps(snap, separators=(",", ":")).encode()
        from paddle_tpu_torch.distributed import chaos
        if chaos.ENABLED:
            chaos.maybe_delay("fleet.heartbeat.delay")
            if chaos.should_fire("fleet.heartbeat.drop"):
                return False
        self._retry.run(self._pub_store.set, self.key, payload,
                        desc=f"fleet.heartbeat({self.key})")
        self.beats += 1
        REGISTRY.inc("fleet.heartbeats")
        return True

    def _loop(self):
        while not self._stop_ev.wait(self.interval):
            try:
                self.publish()
            except Exception:   # noqa: BLE001 — the plane must outlive a flaky store
                REGISTRY.inc("fleet.heartbeat.errors")
                self._consecutive_errors += 1
                if self._consecutive_errors >= self.max_consecutive_errors:
                    return      # store is gone: the job is ending anyway
            else:
                self._consecutive_errors = 0

    def start(self):
        self._stop_ev.clear()
        try:
            self.publish()
        except Exception:   # noqa: BLE001 — a slow rendezvous must not block training start
            REGISTRY.inc("fleet.heartbeat.errors")
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"fleet-heartbeat-{self.rank}")
        self._thread.start()
        return self

    def stop(self, join_timeout=5.0):
        self._stop_ev.set()
        t = self._thread
        if t is not None:
            t.join(timeout=join_timeout)
            self._thread = None
        if self._pub_store is not self.store:
            try:
                self._pub_store.close()
            except Exception:  # lint: disable=silent-swallow -- best-effort close of the private publisher connection
                pass


class FleetAggregator:
    """The cross-rank reader: scan every rank's heartbeat key into one
    view, publish the ``fleet.*`` gauges, and flag stragglers.

    A rank is STALE when its heartbeat is missing or older than
    ``stale_after_s``; a rank is a STRAGGLER when it is stale or its
    step lags the median of the fresh ranks' steps by more than
    ``straggler_steps``. `scan()` is a plain synchronous call (the
    serving ``GET /debug/fleet`` path, and what tests drive
    deterministically); `start()` wraps it in a rank-0 daemon thread.
    Every scan is cached process-wide (`last_view`) so a crash bundle
    carries the final cross-rank picture.
    """

    def __init__(self, store, world_size, *, stale_after_s=10.0,
                 straggler_steps=100, prefix=HEARTBEAT_PREFIX,
                 publish=True):
        self.store = store
        self.world_size = int(world_size)
        self.stale_after_s = float(stale_after_s)
        self.straggler_steps = int(straggler_steps)
        self.prefix = prefix
        self.publish = publish
        self._last = None           # this aggregator's newest view
        self._stop_ev = threading.Event()
        self._thread = None

    # -- reading ------------------------------------------------------
    def read(self, rank):
        """One rank's parsed snapshot, or None when the key is missing
        or unreadable (a read error is a liveness unknown, not a
        crash)."""
        key = f"{self.prefix}{rank}"
        try:
            # check() first: a blind get() on a missing key blocks for
            # the store's full timeout waiting for it to appear (torch's
            # Store.check takes a list of keys)
            if hasattr(self.store, "check") and not self.store.check([key]):
                return None
            snap = json.loads(self.store.get(key).decode())
        except Exception:   # noqa: BLE001 — an unreadable beat counts as missing
            REGISTRY.inc("fleet.heartbeat.errors")
            return None
        return snap if isinstance(snap, dict) else None

    def scan(self, now=None, max_age_s=None) -> dict:
        """One aggregation pass -> the fleet view dict (also cached via
        `last_view` and, with publish=True, mirrored into the
        catalogued fleet.* instruments). With `max_age_s`, a cached
        view at most that old is returned WITHOUT touching the store —
        the GET /debug/fleet path uses this so a router polling every
        replica does not multiply into world_size store RPCs per poll
        against the one rendezvous service."""
        now = time.time() if now is None else now
        if max_age_s is not None and self._last is not None \
                and now - self._last["time"] <= max_age_s:
            return self._last
        rows = []
        for r in range(self.world_size):
            snap = self.read(r)
            if snap is None:
                rows.append({"rank": r, "present": False, "stale": True,
                             "age_s": None, "step": None})
                continue
            age = max(0.0, now - float(snap.get("time", 0.0)))
            row = dict(snap)
            row.update(rank=r, present=True,
                       age_s=round(age, 4),
                       stale=age > self.stale_after_s)
            rows.append(row)
        fresh_steps = [r["step"] for r in rows
                       if not r["stale"] and isinstance(
                           r.get("step"), (int, float))]
        median = _median(fresh_steps)
        for row in rows:
            step = row.get("step")
            lag = (float(median) - float(step)
                   if median is not None
                   and isinstance(step, (int, float)) else None)
            row["lag"] = lag
            row["straggler"] = bool(
                row["stale"]
                or (lag is not None and lag > self.straggler_steps))
        all_steps = [r["step"] for r in rows
                     if isinstance(r.get("step"), (int, float))]
        stragglers = [r["rank"] for r in rows if r["straggler"]]
        summary = {
            "present": sum(1 for r in rows if r["present"]),
            "stale_ranks": sum(1 for r in rows if r["stale"]),
            "stragglers": stragglers,
            "median_step": median,
            "step_skew": (float(max(all_steps) - min(all_steps))
                          if all_steps else 0.0),
            "step_lag": (max(0.0, float(median) - float(min(all_steps)))
                         if median is not None and all_steps else 0.0),
            "fleet_tokens_per_sec": round(sum(
                float(r.get("tokens_per_sec") or 0.0)
                for r in rows if r["present"]), 4),
        }
        view = {"time": now, "world_size": self.world_size,
                "stale_after_s": self.stale_after_s,
                "straggler_steps": self.straggler_steps,
                "ranks": rows, "summary": summary}
        if self.publish:
            self._publish(view)
        self._last = view
        _remember(view)
        return view

    def _publish(self, view):
        s = view["summary"]
        REGISTRY.set_gauge("fleet.step.skew", s["step_skew"])
        REGISTRY.set_gauge("fleet.step.lag", s["step_lag"])
        REGISTRY.set_gauge("fleet.stale_ranks", s["stale_ranks"])
        REGISTRY.set_gauge("fleet.stragglers", len(s["stragglers"]))
        REGISTRY.set_gauge("fleet.tokens_per_sec",
                           s["fleet_tokens_per_sec"])
        for row in view["ranks"]:
            # per-rank flag gauge: cardinality bounded by world size
            REGISTRY.set_gauge("fleet.straggler",
                               1.0 if row["straggler"] else 0.0,
                               rank=row["rank"])

    # -- background form (rank 0) ------------------------------------
    def _loop(self, interval):
        while not self._stop_ev.wait(interval):
            try:
                self.scan()
            except Exception:   # noqa: BLE001 — the monitor must outlive a flaky store
                REGISTRY.inc("fleet.heartbeat.errors")

    def start(self, interval=2.0):
        self._stop_ev.clear()
        self._thread = threading.Thread(
            target=self._loop, args=(float(interval),), daemon=True,
            name="fleet-aggregator")
        self._thread.start()
        return self

    def stop(self, join_timeout=5.0):
        self._stop_ev.set()
        t = self._thread
        if t is not None:
            t.join(timeout=join_timeout)
            self._thread = None


def _median(values):
    if not values:
        return None
    vs = sorted(values)
    n = len(vs)
    mid = n // 2
    if n % 2:
        return float(vs[mid])
    return (float(vs[mid - 1]) + float(vs[mid])) / 2.0


# ---------------------------------------------------------------------------
# crash flight recorder
# ---------------------------------------------------------------------------


class _FlightConfig:
    """Flight-recorder knobs (module-global; set via
    configure_flight_recorder only -- the port reads no environment, so
    the recorder starts disarmed and keeps 5 bundles)."""

    __slots__ = ("dir", "max_keep")

    def __init__(self):
        self.dir = None
        self.max_keep = 5


FLIGHT = _FlightConfig()


def configure_flight_recorder(dir="unset", max_keep=None):
    """Arm (or with dir=None disarm) the crash flight recorder and/or
    set how many bundles are retained. Omitted arguments keep their
    current value."""
    if dir != "unset":
        FLIGHT.dir = dir
    if max_keep is not None:
        FLIGHT.max_keep = int(max_keep)


def flight_records(dir=None) -> list:
    """Bundle directories under `dir` (default: the configured one),
    oldest first — names embed a millisecond timestamp + sequence so
    lexicographic order IS recency order."""
    d = dir if dir is not None else FLIGHT.dir
    if d is None or not os.path.isdir(d):
        return []
    return sorted(os.path.join(d, n) for n in os.listdir(d)
                  if n.startswith("flight-"))


_flight_lock = threading.Lock()
_flight_seq = itertools.count(1)

#: every bundle carries exactly these artifacts (manifest.json lists
#: them too; tools/obs_dump.py renders them)
BUNDLE_FILES = ("manifest.json", "metrics.json", "trace.json",
                "requests.json", "fleet.json", "traceback.txt")


def record_crash(reason, exc=None, extra=None, view=None,
                 dir=None) -> str | None:
    """Atomically dump a self-contained diagnostic bundle directory and
    enforce retention; returns the bundle path, or None when no bundle
    directory is configured (the disarmed default — callers gate on
    ``observability.ENABLED`` so the disabled plane never reaches
    here).

    Bundle layout (BUNDLE_FILES):
        manifest.json   reason, wall time, pid/host, exception summary,
                        caller `extra`, artifact list
        metrics.json    full metrics-registry snapshot
        trace.json      span ring as a chrome-trace document
        requests.json   /debug/requests-shape rows of in-flight requests
        fleet.json      `view` or the last-seen aggregator view
        traceback.txt   the exception's traceback + ALL thread stacks
                        (the watchdog-abort case is usually a hang:
                        where every thread is stuck IS the diagnosis)

    The bundle is written into a hidden ``.tmp`` directory and renamed
    into place, so a crash *during* the dump never leaves a
    half-bundle that obs_dump would trip over.
    """
    d = dir if dir is not None else FLIGHT.dir
    if d is None:
        return None
    slug = "".join(c if c.isalnum() or c in "-_" else "_"
                   for c in str(reason))[:48] or "crash"
    with _flight_lock:
        t = time.time()
        # pid in the NAME, not just the manifest: a fleet-wide abort
        # dumps every rank in the same millisecond into a shared dir,
        # and the per-process sequence alone would collide (the loser's
        # bundle — the artifact this feature exists for — would be lost)
        name = (f"flight-{int(t * 1000):014d}-p{os.getpid()}-"
                f"{next(_flight_seq):04d}-{slug}")
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, "." + name + ".tmp")
        final = os.path.join(d, name)
        os.makedirs(tmp)
        _dump_json(os.path.join(tmp, "metrics.json"), REGISTRY.snapshot)
        _dump_json(os.path.join(tmp, "trace.json"),
                   trace.export_chrome_trace)
        _dump_json(os.path.join(tmp, "requests.json"), _snapshot_requests)
        _dump_json(os.path.join(tmp, "fleet.json"),
                   lambda: _snapshot_fleet(view))
        with open(os.path.join(tmp, "traceback.txt"), "w") as f:
            f.write(_format_failure(exc))
        manifest = {
            "version": 1, "reason": str(reason), "time": t,
            "iso_time": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                      time.gmtime(t)),
            "pid": os.getpid(), "host": _HOST,
            "exception": None if exc is None else {
                "type": type(exc).__name__, "message": str(exc)},
            "extra": extra or {},
            "files": list(BUNDLE_FILES),
        }
        _dump_json(os.path.join(tmp, "manifest.json"), lambda: manifest)
        os.replace(tmp, final)
        recs = flight_records(d)
        for old in recs[:max(0, len(recs) - FLIGHT.max_keep)]:
            shutil.rmtree(old, ignore_errors=True)
    REGISTRY.inc("fleet.flight.records", reason=slug)
    return final


def _dump_json(path, builder):
    """Write builder() as JSON; one broken artifact records its error
    in place instead of sinking the whole bundle."""
    try:
        data = builder()
    except Exception as e:      # noqa: BLE001 — see docstring
        data = {"error": repr(e)}
    with open(path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True, default=str)


def _snapshot_requests():
    rows = _requests.live_requests()
    return {"count": len(rows), "requests": rows}


def _snapshot_fleet(view):
    v = view if view is not None else last_view()
    if v is None:
        return {"available": False}
    return {"available": True, "view": v}


def _format_failure(exc):
    parts = []
    if exc is not None:
        parts.append("== exception ==\n" + "".join(
            traceback.format_exception(type(exc), exc,
                                       exc.__traceback__)))
    parts.append("== all thread stacks ==\n" + _thread_stacks())
    return "\n".join(parts)


def _thread_stacks() -> str:
    names = {t.ident: t.name for t in threading.enumerate()}
    parts = []
    for ident, frame in sys._current_frames().items():
        parts.append(f"-- thread {names.get(ident, '?')} "
                     f"(ident={ident}) --\n"
                     + "".join(traceback.format_stack(frame)))
    return "\n".join(parts)
