"""Fleet autopilot: replica supervision, SLO-driven autoscaling, and
zero-downtime weight rollout over a `ReplicaRouter` fleet.

Counterpart of paddle_tpu/inference/autopilot.py, copied (the module is
stdlib-only, but importing it would import the JAX package): the same
names, keywords, state machines, metrics and chaos sites, over the
port's router and servers. A replica is whatever the launcher's factory
returns; chip_smoke.py's factory wraps a PagedKVEngine on the card
behind a PredictorServer and stops and drops the engine with the server,
so its page pools and captured graphs are given back.

The router (inference/router.py) already turns a replica crash into a
*routed-around event* — but nothing brings the replica back, nothing
resizes a hot fleet, and a weight update still means downtime. This
module closes those three loops using only the control signals the
serving stack already exports (`/readyz` reasons, `/stats` load
numbers, the `router.*` / `request.*` instrument families):

    ReplicaSupervisor   owns replica lifecycle through a pluggable
                        `ReplicaLauncher` (spawn/stop/is_alive hooks;
                        `InProcessLauncher` thread-backs servers for
                        tests and benches). A dead replica is removed
                        from the router (its session/prefix pins purge
                        and rebind on next use) and relaunched with
                        full-jitter backoff (`retries.RetryPolicy`
                        delays, scheduled on the injected clock — the
                        supervisor never sleeps a backoff). K spawn
                        attempts inside a sliding window without ever
                        reaching rotation is a CRASH LOOP: the slot is
                        quarantined (no more restarts until
                        `release()`), a `replica_crash_loop` flight-
                        recorder bundle preserves the evidence, and
                        `autopilot.quarantines` counts it. Relaunched
                        replicas re-enter through the router's flap-
                        damped gate (`add_replica(..., probation=True)`
                        = `reenter_probes` consecutive clean probes),
                        so a cold or sick restart never eats live
                        traffic.
    Autoscaler          an SLO-burn control loop over `router.stats()`
                        / `debug_replicas()` plus the request
                        instruments: TTFT p95 vs target, mean per-
                        replica queue depth, and shed rate. Sustained
                        burn (`burn_ticks` consecutive burning samples)
                        scales out one slot; sustained idle scales in
                        the newest autoscaler-owned slot; hysteresis
                        (separate high/low watermarks + separate
                        streak lengths), a post-resize cooldown, and
                        hard min/max bounds keep it from flapping. New
                        replicas pre-warm behind `/readyz` ("warming"
                        until the first request compiles) and enter
                        rotation only after clean probes.
    RolloutController   zero-downtime weight rollout: for each
                        supervised slot, drain -> swap -> rejoin, one
                        replica at a time, refusing to start a step
                        unless the fleet would stay at or above
                        `min_in_rotation` (default N-1). Between steps
                        it re-checks SLO burn; a regression or a swap
                        that fails post-swap health rolls the CURRENT
                        replica back to its previous weights and
                        aborts the wave (already-completed swaps stay —
                        they passed health). Session/prefix pins of
                        the swapped replica purge at removal and
                        rebind through the router's dead-pin machinery.

`FleetAutopilot` bundles the three behind one start()/stop() and one
debug surface: attach it to the router (`router.attach_autopilot`) and
GET /debug/autopilot serves the supervisor/autoscaler/rollout state;
the rollout state machine also rides the router's /stats body.

Observability: the `autopilot.*` family (metrics.py catalogue) —
restarts, restart-to-ready seconds, launch failures, quarantines,
scale events, rollout steps/outcomes, desired/quarantined gauges.
Chaos (distributed/chaos.py): `autopilot.launch.fail` makes the
launcher raise at spawn; `autopilot.replica.hang` wedges a just-
spawned server before readiness (alive, never ready) — the two levers
the quarantine and pre-warm soaks are driven by.

Threading: supervisor and autoscaler loops are daemon threads joined
by stop(); `tick()` is the whole control step and is what tests call
directly (single-threaded caller contract — don't mix manual ticks
with a started loop). No lock is held across spawn/stop/probe I/O.

Everything here is stdlib-only (control planes run on frontend nodes
with no accelerator), and reads no environment variable.
"""
from __future__ import annotations

import http.client
import sys
import threading
import time

from paddle_tpu_torch import observability
from paddle_tpu_torch.distributed.retries import RetryPolicy

__all__ = ["LaunchError", "ReplicaLauncher", "InProcessLauncher",
           "ReplicaSupervisor", "Autoscaler", "RolloutController",
           "FleetAutopilot"]


class LaunchError(RuntimeError):
    """A launcher failed to spawn (or chaos made it fail)."""


class ReplicaLauncher:
    """Pluggable replica lifecycle hooks. A deployment implements these
    three against its process manager (subprocess, k8s, GKE...); the
    in-process launcher below implements them against thread-backed
    `PredictorServer`s for tests and benches.

    `spawn(slot, version=None)` -> "host:port" of a STARTED replica
    serving weight `version` (None = current), raising on failure;
    `stop(slot)` gracefully stops it (drain when supported);
    `is_alive(slot)` is the liveness check the supervisor polls.
    """

    def spawn(self, slot, version=None) -> str:
        raise NotImplementedError

    def stop(self, slot) -> None:
        raise NotImplementedError

    def is_alive(self, slot) -> bool:
        raise NotImplementedError


class InProcessLauncher(ReplicaLauncher):
    """Thread-backed launcher: `factory(slot, version)` builds an
    UNSTARTED server object exposing `.start()`, `.stop()` (and
    optionally `.drain()` / `.mark_warming()`), `.host`, `.port` —
    a `PredictorServer` fits. Liveness is a real `/healthz` round trip
    so a server torn down behind the launcher's back (chaos kill_hook)
    still reads dead."""

    def __init__(self, factory, *, drain_timeout_s=5.0,
                 probe_timeout_s=1.0):
        self._factory = factory
        self.drain_timeout_s = float(drain_timeout_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self._lock = threading.Lock()
        self._servers: dict = {}

    def server(self, slot):
        """The live server object for a slot (tests reach in to kill)."""
        with self._lock:
            return self._servers.get(slot)

    def spawn(self, slot, version=None):
        from paddle_tpu_torch.distributed import chaos
        if chaos.ENABLED and chaos.should_fire("autopilot.launch.fail"):
            raise LaunchError(
                f"chaos: injected launch failure for slot {slot!r}")
        srv = self._factory(slot, version)
        srv.start()
        if chaos.ENABLED \
                and chaos.should_fire("autopilot.replica.hang"):
            # the spawned process wedges before serving: HTTP is up
            # (alive) but readiness never comes. PredictorServer models
            # exactly that as permanent warming; a server without the
            # hook is stopped outright (hard-dead is the nearest fault).
            if hasattr(srv, "mark_warming"):
                srv.mark_warming()
            else:
                srv.stop()
        with self._lock:
            old = self._servers.pop(slot, None)
            self._servers[slot] = srv
        if old is not None:
            self._stop_server(old)      # spawn-over: no orphan listener
        return f"{srv.host}:{srv.port}"

    def stop(self, slot):
        with self._lock:
            srv = self._servers.pop(slot, None)
        if srv is not None:
            self._stop_server(srv)

    def _stop_server(self, srv):
        try:
            if hasattr(srv, "drain"):
                srv.drain(timeout=self.drain_timeout_s)
            else:
                srv.stop()
        except Exception as e:      # noqa: BLE001 — teardown of a half-dead server must not break supervision
            print(f"WARNING: launcher stop failed: {e!r}",
                  file=sys.stderr)

    def is_alive(self, slot):
        with self._lock:
            srv = self._servers.get(slot)
        if srv is None:
            return False
        conn = http.client.HTTPConnection(srv.host, srv.port,
                                          timeout=self.probe_timeout_s)
        try:
            conn.request("GET", "/healthz")
            return conn.getresponse().status == 200
        except (OSError, http.client.HTTPException):
            return False
        finally:
            conn.close()


class _Slot:
    """One supervised replica slot. All mutable fields are guarded by
    the SUPERVISOR's lock."""

    __slots__ = ("name", "version", "url", "state", "restart_t",
                 "delays", "next_t", "ready_deadline", "detect_t",
                 "restarts", "launch_failures", "last_error", "auto")

    # states: backoff (waiting to (re)launch) -> warming (spawned,
    # waiting for rotation) -> serving; quarantined / rolling / stopped
    # park the tick.

    def __init__(self, name, version, delays, auto=False):
        self.name = str(name)
        self.version = version
        self.url = None
        self.state = "backoff"
        self.restart_t: list = []       # spawn-attempt times (window)
        self.delays = delays
        self.next_t = 0.0
        self.ready_deadline = 0.0
        self.detect_t = None            # death detection time (metric)
        self.restarts = 0
        self.launch_failures = 0
        self.last_error = None
        self.auto = bool(auto)          # autoscaler-owned (scale-in ok)


class ReplicaSupervisor:
    """Replica lifecycle supervision (module doc). The slot NAME is
    also the router replica id, so the router's per-replica view and
    the supervisor's slot table line up by key.

    `tick()` is one full supervision pass — detection, backoff expiry,
    launch, warming checks — and is what deterministic tests call
    (interleaved with `router.probe_all()`); `start()` runs it on a
    loop for deployments."""

    def __init__(self, router, launcher, *, retry_policy=None,
                 crash_loop_restarts=3, crash_loop_window_s=30.0,
                 ready_timeout_s=10.0, tick_interval_s=0.25,
                 clock=time.monotonic, metrics=None):
        self.router = router
        self.launcher = launcher
        self.retry_policy = retry_policy if retry_policy is not None \
            else RetryPolicy(base_delay=0.05, max_delay=2.0,
                             jitter="full")
        self.crash_loop_restarts = int(crash_loop_restarts)
        self.crash_loop_window_s = float(crash_loop_window_s)
        self.ready_timeout_s = float(ready_timeout_s)
        self.tick_interval_s = float(tick_interval_s)
        self.clock = clock
        # default to the router's registry so autopilot.* rides the
        # router's /metrics scrape with no extra wiring
        self.metrics = metrics if metrics is not None else router.metrics
        self._lock = threading.Lock()
        self._slots: dict = {}
        self._order: list = []
        self._stop_evt = threading.Event()
        self._thread = None

    # -- slot admin ---------------------------------------------------------
    def add_slot(self, name, version=None, auto=False):
        """Register a slot and launch it now. The replica enters
        rotation only after the router's probation gate clears."""
        s = _Slot(name, version, self.retry_policy.delays(), auto=auto)
        with self._lock:
            if s.name in self._slots:
                raise ValueError(f"slot {s.name!r} already supervised")
            self._slots[s.name] = s
            self._order.append(s)
        self._attempt_launch(s)
        return s.name

    def remove_slot(self, name, stop=True):
        """Administratively retire a slot (scale-in): out of the router
        first (new traffic re-pins away), then a graceful launcher stop
        (drains in-flight work when the launcher supports it)."""
        with self._lock:
            s = self._slots.pop(str(name), None)
            if s is not None:
                self._order.remove(s)
                s.state = "stopped"
        if s is None:
            return False
        self.router.remove_replica(s.name)
        if stop:
            self.launcher.stop(s.name)
        self._refresh_quarantine_gauge()
        return True

    def release(self, name):
        """Lift a quarantine: crash history clears, backoff resets, the
        slot relaunches on the next tick."""
        with self._lock:
            s = self._slots.get(str(name))
            if s is None or s.state != "quarantined":
                return False
            s.restart_t = []
            s.delays = self.retry_policy.delays()
            s.state = "backoff"
            s.next_t = self.clock()
            s.last_error = None
        self._refresh_quarantine_gauge()
        return True

    def slot_names(self):
        with self._lock:
            return [s.name for s in self._order]

    def slot_state(self, name):
        with self._lock:
            s = self._slots.get(str(name))
            return s.state if s is not None else None

    def slot_version(self, name):
        with self._lock:
            s = self._slots.get(str(name))
            return s.version if s is not None else None

    def active_slot_count(self):
        """Slots the fleet is sized by (everything not retired)."""
        with self._lock:
            return sum(1 for s in self._order if s.state != "stopped")

    def newest_auto_slot(self):
        """The scale-in candidate: last-added autoscaler-owned slot."""
        with self._lock:
            for s in reversed(self._order):
                if s.auto and s.state != "stopped":
                    return s.name
        return None

    # -- the control step ---------------------------------------------------
    def tick(self):
        """One supervision pass (single-threaded caller contract)."""
        with self._lock:
            slots = list(self._order)
        now = self.clock()
        for s in slots:
            with self._lock:
                st, next_t = s.state, s.next_t
            if st == "serving":
                if not self.launcher.is_alive(s.name):   # I/O: unlocked
                    self._on_dead(s)
            elif st == "backoff":
                if now >= next_t:
                    self._attempt_launch(s)
            elif st == "warming":
                self._check_warming(s)
            # quarantined / rolling / stopped: parked

    def _on_dead(self, s):
        """A serving replica stopped answering liveness: out of the
        router NOW (new traffic re-pins; its session/prefix pins purge
        with it), restart after the next backoff delay."""
        self.router.remove_replica(s.name)
        now = self.clock()
        with self._lock:
            if s.detect_t is None:
                s.detect_t = now
            s.state = "backoff"
            s.next_t = now + next(s.delays)

    def _attempt_launch(self, s):
        now = self.clock()
        with self._lock:
            s.restart_t = [t for t in s.restart_t
                           if now - t <= self.crash_loop_window_s]
            if len(s.restart_t) >= self.crash_loop_restarts:
                crash_window = list(s.restart_t)
                s.state = "quarantined"
            else:
                crash_window = None
                s.restart_t.append(now)
                s.restarts += 1
        if crash_window is not None:
            self._quarantine(s, crash_window)
            return
        self.metrics.inc("autopilot.restarts", rid=s.name)
        try:
            url = self.launcher.spawn(s.name, version=s.version)
        except Exception as e:      # noqa: BLE001 — a launcher crash is the fault being supervised
            self.metrics.inc("autopilot.launch.failures", rid=s.name)
            with self._lock:
                s.launch_failures += 1
                s.last_error = repr(e)
                s.state = "backoff"
                s.next_t = self.clock() + next(s.delays)
            return
        # register under the stable slot id; probation = the flap-damped
        # gate (reenter_probes clean probes) — a relaunch never re-enters
        # rotation off one lucky probe
        self.router.remove_replica(s.name)
        self.router.add_replica(url, rid=s.name, probation=True)
        with self._lock:
            s.url = url
            s.last_error = None
            s.state = "warming"
            s.ready_deadline = self.clock() + self.ready_timeout_s

    def _check_warming(self, s):
        r = self.router.replica(s.name)
        if r is not None and r.in_rotation:
            now = self.clock()
            with self._lock:
                s.state = "serving"
                detect, s.detect_t = s.detect_t, None
                s.delays = self.retry_policy.delays()   # healthy: reset
            if detect is not None:
                self.metrics.observe("autopilot.restart.seconds",
                                     max(0.0, now - detect))
            return
        with self._lock:
            deadline = s.ready_deadline
        if self.clock() < deadline:
            return
        # spawned but never reached rotation (wedged launch, failed
        # probes): a failed launch — tear it down, back through backoff
        self.metrics.inc("autopilot.launch.failures", rid=s.name)
        self.router.remove_replica(s.name)
        self.launcher.stop(s.name)
        with self._lock:
            s.launch_failures += 1
            s.last_error = "ready_timeout"
            s.state = "backoff"
            s.next_t = self.clock() + next(s.delays)

    def _quarantine(self, s, crash_window):
        """K spawn attempts in the window without reaching rotation:
        stop restarting (a crash-looping replica flapping through
        rotation forever is worse than one missing slot), keep the
        evidence."""
        self.router.remove_replica(s.name)
        self.launcher.stop(s.name)
        self.metrics.inc("autopilot.quarantines", rid=s.name)
        self._refresh_quarantine_gauge()
        if observability.ENABLED:
            try:
                from paddle_tpu_torch.observability import fleet
                fleet.record_crash(
                    "replica_crash_loop",
                    extra={"slot": s.name, "version": s.version,
                           "restarts": s.restarts,
                           "launch_failures": s.launch_failures,
                           "window_s": self.crash_loop_window_s,
                           "attempts_in_window": len(crash_window),
                           "last_error": s.last_error})
            except Exception as e:      # noqa: BLE001 — recording must never break supervision
                print(f"WARNING: flight-recorder dump failed: {e!r}",
                      file=sys.stderr)

    def _refresh_quarantine_gauge(self):
        with self._lock:
            n = sum(1 for s in self._order if s.state == "quarantined")
        self.metrics.set_gauge("autopilot.replicas.quarantined", n)

    # -- rollout hooks (RolloutController drives these) ---------------------
    def begin_roll(self, name):
        """Park the tick for a slot the rollout is operating on (the
        supervisor must not 'fix' an intentionally-stopped replica)."""
        with self._lock:
            s = self._slots.get(str(name))
            if s is None or s.state in ("stopped", "quarantined"):
                raise ValueError(f"slot {name!r} not rollable "
                                 f"({None if s is None else s.state})")
            s.state = "rolling"

    def stop_replica(self, name):
        """Drain+stop a rolling slot's replica (router first: new
        traffic re-pins away while in-flight work finishes)."""
        self.router.remove_replica(str(name))
        self.launcher.stop(str(name))

    def launch_at(self, name, version):
        """Spawn a rolling slot at `version` and re-register it behind
        the probation gate. Raises on spawn failure (the rollout's
        rollback trigger); rollout swaps never count toward the crash-
        loop window — a weight swap is not a crash."""
        url = self.launcher.spawn(str(name), version=version)
        self.router.remove_replica(str(name))
        self.router.add_replica(url, rid=str(name), probation=True)
        with self._lock:
            s = self._slots[str(name)]
            s.version = version
            s.url = url
        return url

    def end_roll(self, name):
        """Hand a rolled slot back to the tick as warming — normal
        supervision (ready-timeout included) resumes from here."""
        with self._lock:
            s = self._slots[str(name)]
            s.state = "warming"
            s.ready_deadline = self.clock() + self.ready_timeout_s

    # -- surfaces -----------------------------------------------------------
    def debug(self):
        now = self.clock()
        with self._lock:
            rows = []
            for s in self._order:
                rows.append({
                    "slot": s.name, "state": s.state,
                    "version": s.version, "url": s.url,
                    "restarts": s.restarts,
                    "restarts_in_window": sum(
                        1 for t in s.restart_t
                        if now - t <= self.crash_loop_window_s),
                    "launch_failures": s.launch_failures,
                    "auto": s.auto,
                    "last_error": s.last_error,
                })
            summary = {
                "slots": len(self._order),
                "serving": sum(1 for s in self._order
                               if s.state == "serving"),
                "quarantined": sum(1 for s in self._order
                                   if s.state == "quarantined"),
                "crash_loop_restarts": self.crash_loop_restarts,
                "crash_loop_window_s": self.crash_loop_window_s,
            }
        return {"slots": rows, "summary": summary}

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autopilot-supervisor")
        self._thread.start()
        return self

    def stop(self, join_timeout=5.0):
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=join_timeout)
            self._thread = None

    def _loop(self):
        while not self._stop_evt.wait(self.tick_interval_s):
            try:
                self.tick()
            except Exception as e:      # noqa: BLE001 — the supervisor must outlive one bad pass
                print(f"WARNING: supervisor tick failed: {e!r}",
                      file=sys.stderr)


class Autoscaler:
    """SLO-burn autoscaling over the supervisor's slot set (module
    doc). A `signals()` override injects synthetic samples in tests;
    the default samples the router and the shared request instruments:

        ttft_p95_s   `request.ttft.seconds` recent-window p95 from the
                     process registry (None when observability is off
                     or nothing recorded — TTFT then simply does not
                     vote)
        queue_depth  mean probed (queue_depth + router in-flight) over
                     in-rotation replicas
        shed_rate    shed / total of the router requests routed since
                     the PREVIOUS sample (0.0 when no traffic)
    """

    def __init__(self, router, supervisor, *, min_replicas=1,
                 max_replicas=4, ttft_p95_target_s=None, queue_high=8.0,
                 queue_low=1.0, shed_high=0.05, burn_ticks=3,
                 idle_ticks=6, cooldown_s=10.0, slot_prefix="auto",
                 version=None, signals=None, tick_interval_s=1.0,
                 clock=time.monotonic, metrics=None):
        self.router = router
        self.supervisor = supervisor
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.ttft_p95_target_s = ttft_p95_target_s
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.shed_high = float(shed_high)
        self.burn_ticks = int(burn_ticks)
        self.idle_ticks = int(idle_ticks)
        self.cooldown_s = float(cooldown_s)
        self.slot_prefix = str(slot_prefix)
        self.version = version
        self.signals = signals if signals is not None else self._sample
        self.tick_interval_s = float(tick_interval_s)
        self.clock = clock
        self.metrics = metrics if metrics is not None else router.metrics
        self._lock = threading.Lock()
        self._burn = 0
        self._idle = 0
        self._seq = 0
        self._last_resize_t = None
        self._last_total = 0
        self._last_shed = 0
        self._last = {}                 # newest sample (debug surface)
        self._last_action = "none"
        self._stop_evt = threading.Event()
        self._thread = None

    def _sample(self):
        stats = self.router.stats()
        req = stats.get("requests", {})
        total = sum(req.values())
        shed = sum(v for k, v in req.items()
                   if k.startswith("shed_") or k == "no_replicas")
        with self._lock:
            dtot = total - self._last_total
            dshed = shed - self._last_shed
            self._last_total, self._last_shed = total, shed
        rate = (dshed / dtot) if dtot > 0 else 0.0
        rows = self.router.debug_replicas()["replicas"]
        rot = [r for r in rows if r["in_rotation"]]
        q = (sum(r["replica_queue_depth"] + r["in_flight_router"]
                 for r in rot) / len(rot)) if rot else 0.0
        ttft = None
        if observability.ENABLED:
            from paddle_tpu_torch.observability import REGISTRY
            ttft = REGISTRY.histogram(
                "request.ttft.seconds").percentile(95)
        return {"ttft_p95_s": ttft, "queue_depth": q, "shed_rate": rate}

    def _classify(self, sig):
        """'burn' / 'idle' / 'steady' for one sample. Burn and idle use
        DIFFERENT watermarks (hysteresis): the band between them is
        steady and decays both streaks."""
        tgt = self.ttft_p95_target_s
        ttft = sig.get("ttft_p95_s")
        q = float(sig.get("queue_depth") or 0.0)
        shed = float(sig.get("shed_rate") or 0.0)
        if (tgt is not None and ttft is not None and ttft > tgt) \
                or q > self.queue_high or shed > self.shed_high:
            return "burn"
        if q < self.queue_low and shed == 0.0 \
                and (tgt is None or ttft is None or ttft < 0.5 * tgt):
            return "idle"
        return "steady"

    def tick(self):
        """One control step: sample, classify, resize when a streak
        crosses its threshold and the cooldown allows. Returns the
        action taken ("out" / "in" / "none")."""
        sig = self.signals()
        cls = self._classify(sig)
        now = self.clock()
        with self._lock:
            self._last = dict(sig)
            if cls == "burn":
                self._burn += 1
                self._idle = 0
            elif cls == "idle":
                self._idle += 1
                self._burn = 0
            else:
                self._burn = 0
                self._idle = 0
            in_cooldown = (self._last_resize_t is not None
                           and now - self._last_resize_t
                           < self.cooldown_s)
            burn = self._burn
            idle = self._idle
        n = self.supervisor.active_slot_count()
        self.metrics.set_gauge("autopilot.replicas.desired", n)
        if in_cooldown:
            return self._note_action("none")
        if burn >= self.burn_ticks and n < self.max_replicas:
            with self._lock:
                self._seq += 1
                name = f"{self.slot_prefix}-{self._seq}"
                self._burn = 0
                self._last_resize_t = now
            self.supervisor.add_slot(name, version=self.version,
                                     auto=True)
            self.metrics.inc("autopilot.scale.events", direction="out")
            self.metrics.set_gauge("autopilot.replicas.desired", n + 1)
            return self._note_action("out")
        if idle >= self.idle_ticks and n > self.min_replicas:
            victim = self.supervisor.newest_auto_slot()
            if victim is None:
                return self._note_action("none")    # only founding slots left
            with self._lock:
                self._idle = 0
                self._last_resize_t = now
            self.supervisor.remove_slot(victim)
            self.metrics.inc("autopilot.scale.events", direction="in")
            self.metrics.set_gauge("autopilot.replicas.desired", n - 1)
            return self._note_action("in")
        return self._note_action("none")

    def _note_action(self, action):
        with self._lock:
            self._last_action = action
        return action

    def debug(self):
        with self._lock:
            return {
                "last_sample": dict(self._last),
                "burn_streak": self._burn,
                "idle_streak": self._idle,
                "last_action": self._last_action,
                "bounds": [self.min_replicas, self.max_replicas],
                "targets": {"ttft_p95_s": self.ttft_p95_target_s,
                            "queue_high": self.queue_high,
                            "queue_low": self.queue_low,
                            "shed_high": self.shed_high},
                "cooldown_s": self.cooldown_s,
            }

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autopilot-autoscaler")
        self._thread.start()
        return self

    def stop(self, join_timeout=5.0):
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=join_timeout)
            self._thread = None

    def _loop(self):
        while not self._stop_evt.wait(self.tick_interval_s):
            try:
                self.tick()
            except Exception as e:      # noqa: BLE001 — the autoscaler must outlive one bad pass
                print(f"WARNING: autoscaler tick failed: {e!r}",
                      file=sys.stderr)


class RolloutController:
    """Zero-downtime weight rollout (module doc). `run(version)` is a
    blocking wave over the supervisor's slots; `probe_fn` (usually
    `router.probe_all`) is invoked inside every wait so deterministic
    tests need no background prober; deployments leave it None and the
    router's own prober advances rotation."""

    def __init__(self, router, supervisor, *, min_in_rotation=None,
                 step_timeout_s=15.0, slo_burning=None, probe_fn=None,
                 poll_s=0.02, clock=time.monotonic, sleep=time.sleep,
                 metrics=None):
        self.router = router
        self.supervisor = supervisor
        self.min_in_rotation = min_in_rotation
        self.step_timeout_s = float(step_timeout_s)
        self.slo_burning = slo_burning
        self.probe_fn = probe_fn
        self.poll_s = float(poll_s)
        self.clock = clock
        self.sleep = sleep
        self.metrics = metrics if metrics is not None else router.metrics
        self._lock = threading.Lock()
        self._state = {"state": "idle", "version": None, "current": None,
                       "phase": None, "done": [], "rolled_back": [],
                       "reason": None}

    def state(self):
        """The rollout state machine (rides the router's /stats)."""
        with self._lock:
            out = dict(self._state)
            out["done"] = list(out["done"])
            out["rolled_back"] = list(out["rolled_back"])
            return out

    def _set(self, **kw):
        with self._lock:
            self._state.update(kw)

    def _wait(self, cond, timeout):
        deadline = self.clock() + timeout
        while True:
            if self.probe_fn is not None:
                self.probe_fn()
            if cond():
                return True
            if self.clock() >= deadline:
                return False
            self.sleep(self.poll_s)

    def _in_rotation(self, rid):
        r = self.router.replica(rid)
        return r is not None and r.in_rotation

    def _burning(self):
        return self.slo_burning is not None and bool(self.slo_burning())

    def run(self, version):
        """Roll every supervised slot to `version`, one at a time.
        Returns True when the wave completed, False when it aborted
        (state()["reason"] says why); raises if a wave is already
        running."""
        with self._lock:
            if self._state["state"] == "running":
                raise RuntimeError("rollout already running")
            self._state = {"state": "running", "version": version,
                           "current": None, "phase": None, "done": [],
                           "rolled_back": [], "reason": None}
        names = self.supervisor.slot_names()
        floor = self.min_in_rotation if self.min_in_rotation is not None \
            else max(0, len(names) - 1)
        for name in names:
            if self.supervisor.slot_state(name) not in ("serving",
                                                        "warming"):
                continue            # quarantined/stopped: not rollable
            old = self.supervisor.slot_version(name)
            if old == version:
                continue            # idempotent re-run
            # never start a step that would drop the fleet below the
            # floor: taking one replica out must leave >= floor serving
            self._set(current=name, phase="gating")
            if not self._wait(lambda: self.router.in_rotation_count()
                              > floor, self.step_timeout_s):
                return self._abort("fleet_below_floor")
            if self._burning():
                return self._abort("slo_burn")
            self.supervisor.begin_roll(name)
            self._set(phase="draining")
            self.supervisor.stop_replica(name)
            self._set(phase="swapping")
            try:
                self.supervisor.launch_at(name, version)
            except Exception as e:      # noqa: BLE001 — a failed swap is the rollback trigger
                self._rollback(name, old, f"swap_failed: {e!r}")
                return self._abort("swap_failed")
            self._set(phase="rejoining")
            ok = self._wait(lambda: self._in_rotation(name),
                            self.step_timeout_s)
            if not ok:
                self._rollback(name, old, "post_swap_unready")
                return self._abort("post_swap_unready")
            if self._burning():
                self._rollback(name, old, "slo_burn")
                return self._abort("slo_burn")
            self.metrics.inc("autopilot.rollout.steps", result="swapped")
            with self._lock:
                self._state["done"].append(name)
            self.supervisor.end_roll(name)
        self._set(state="completed", current=None, phase=None)
        self.metrics.inc("autopilot.rollouts", outcome="completed")
        return True

    def _rollback(self, name, old_version, why):
        """Revert ONE slot to its pre-step weights (already-completed
        swaps passed health and stay). Best effort: a rollback spawn
        that also fails hands the slot back to the supervisor, whose
        backoff/quarantine machinery owns it from there."""
        self._set(phase="rolling_back")
        self.supervisor.stop_replica(name)
        try:
            self.supervisor.launch_at(name, old_version)
            self._wait(lambda: self._in_rotation(name),
                       self.step_timeout_s)
        except Exception as e:      # noqa: BLE001 — rollback is best effort; the supervisor owns the slot next
            print(f"WARNING: rollback of {name!r} failed: {e!r}",
                  file=sys.stderr)
        self.metrics.inc("autopilot.rollout.steps",
                         result="rolled_back")
        with self._lock:
            self._state["rolled_back"].append(name)
        self.supervisor.end_roll(name)

    def _abort(self, reason):
        self._set(state="aborted", reason=reason, current=None,
                  phase=None)
        self.metrics.inc("autopilot.rollouts", outcome="aborted")
        return False


class FleetAutopilot:
    """The three loops behind one handle: attach to the router
    (`router.attach_autopilot(ap)`) for GET /debug/autopilot and the
    rollout block in /stats; start()/stop() run/reap the supervisor
    and autoscaler loops (the rollout is run on demand)."""

    def __init__(self, supervisor, autoscaler=None, rollout=None):
        self.supervisor = supervisor
        self.autoscaler = autoscaler
        self.rollout = rollout

    def debug(self):
        return {
            "supervisor": self.supervisor.debug(),
            "autoscaler": (self.autoscaler.debug()
                           if self.autoscaler is not None else None),
            "rollout": self.rollout_state(),
        }

    def rollout_state(self):
        if self.rollout is None:
            return {"state": "idle"}
        return self.rollout.state()

    def start(self):
        self.supervisor.start()
        if self.autoscaler is not None:
            self.autoscaler.start()
        return self

    def stop(self, join_timeout=5.0):
        if self.autoscaler is not None:
            self.autoscaler.stop(join_timeout=join_timeout)
        self.supervisor.stop(join_timeout=join_timeout)
