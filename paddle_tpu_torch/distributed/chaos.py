"""Deterministic, seeded fault injection ("chaos") for the runtime.

Counterpart of paddle_tpu/distributed/chaos.py, copied (the module is
stdlib-only, but importing it would import the JAX package): named
injection points threaded through the serving front end, the paged
engine and its host KV tier, each firing deterministically from a seed
so a chaos run is exactly reproducible. The decision stream is the JAX
module's: the same seed, rates and sequence of calls at a site fire
the same faults in both packages. `maybe_preempt` and `maybe_drop` come
with the elastic and store slices; `POINTS` is the JAX package's whole
catalogue.

Contract with the hot path: when chaos is disabled (the default), every
injection point is a single module-attribute load + falsy branch —
``if chaos.ENABLED: chaos.maybe_delay("site")``. No RNG, no dict
lookup, no allocation. Enabling is explicit, in-process, through
`configure(...)` or `scoped(...)`; the environment switches nothing
(the JAX module's `PADDLE_TPU_CHAOS*` variables are its own):

    configure(seed=1234, rates={"engine.tick.delay": 0.3,
                                "serving.run.fail": (1.0, 1)},
              delay_ms=50, hang_ms=0)
        a rate is a probability, or (probability, N) to cap a site at N
        fires ((1.0, 1) = fire exactly once). A rate keyed by a PREFIX
        of the site name matches (longest prefix wins), so
        {"serving": 1.0} covers every serving.* site.

Determinism: each site keeps a decision counter; decision n at site s
is uniform from sha256(f"{seed}:{s}:{n}") — independent of wall clock,
process interleaving, or Python hash randomization.

Injection vocabulary:
    maybe_delay(site)           sleep delay_ms (+hang_ms) if it fires
    maybe_corrupt_file(s, path) truncate (odd fires) or flip a byte
                                (even fires) of a just-written file
    grad_poison(site)           NaN if it fires else 1.0 (a gradient
                                factor)
    loss_spike(site, scale)     scale if it fires else 1.0 (a loss and
                                gradient factor)
    should_fire(site)           the bare decision, for custom faults

Everything is stdlib-only.
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
from contextlib import contextmanager

from paddle_tpu_torch import observability

__all__ = [
    "ENABLED", "InjectedFault", "InjectedConnectionDrop", "POINTS",
    "configure", "disable",
    "scoped", "should_fire", "maybe_delay", "maybe_corrupt_file",
    "grad_poison", "loss_spike", "fire_count", "fires", "site_rate",
]

#: Documented injection-point registry (the JAX package's, whole): every
#: literal site name passed to should_fire/maybe_delay anywhere in the
#: package MUST have an entry here — the port's catalogue check
#: (tests/test_torch_observability.py) fails otherwise. Keys ending in
#: "/" are prefixes for dynamically-suffixed sites.
POINTS = {
    "store.client": "TCPStore RPC op (delay, then dropped connection)",
    "collective.dispatch/": "eager collective dispatch delay "
                            "(suffix = op name)",
    "ckpt.write.shards": "corrupt the just-written checkpoint shard "
                         "file (torn write / bit rot)",
    "ckpt.write.table": "corrupt the just-written checkpoint table "
                        "file",
    "ckpt.async.delay": "slow background checkpoint writer (stretches "
                        "the window a save stays in flight — the "
                        "overlap tests' lever)",
    "ckpt.async.fail": "kill the background checkpoint writer after "
                       "its file writes, before the completion marker "
                       "commits (torn async save; recovery must fall "
                       "back to the previous complete checkpoint)",
    "elastic.preempt": "synthetic preemption: SIGTERM to this process",
    "engine.tick.delay": "slow paged-engine scheduler tick (stretches "
                         "request TTFT/ITL — the request-tracing "
                         "tests' pacing lever)",
    "prefix.cache.bypass": "treat a paged-engine prefix-cache hit as "
                           "a miss at admission (the hit-rate lever "
                           "for deterministic cold-vs-warm tests and "
                           "the prefix bench)",
    "kvtier.spill.fail": "drop a host-tier spill capture at eviction "
                         "(the page is destroyed instead of spilled — "
                         "degraded-mode lever: the next hit on that "
                         "prefix must simply be cold, never wrong)",
    "kvtier.restore.delay": "slow host-to-device KV page restore at "
                            "admission (PCIe congestion / huge pages "
                            "— stretches warm TTFT, the tiered-KV "
                            "latency lever)",
    "disagg.transfer.fail": "fail the prefill->decode KV page handoff "
                            "at the router (the decode hop is skipped "
                            "and the request degrades to LOCAL decode "
                            "on the warm prefill replica — slower, "
                            "never wrong)",
    "disagg.transfer.delay": "slow the prefill->decode page handoff "
                             "(NIC/PCIe congestion between pools — "
                             "the disaggregated-TTFT lever)",
    "tenant.storm": "stamp an UNLABELED serving/router request with "
                    "the synthetic storm tenant id (inference/"
                    "tenancy.resolve_tenant) — rate 1.0 turns all "
                    "unlabeled traffic into a deterministic "
                    "noisy-neighbor flood for the starvation soak, "
                    "without touching labeled tenants",
    "serving.batch.delay": "slow DynamicBatcher backend run",
    "serving.batch.fail": "failed DynamicBatcher batch run (error "
                          "must fan out to every waiter)",
    "serving.admit.delay": "slow HTTP admission gate (builds queue "
                           "pressure for shed-path tests)",
    "serving.run.delay": "slow predictor run (stretches deadlines "
                         "toward 504)",
    "serving.run.fail": "failed predictor run (feeds the serving "
                        "circuit breaker toward open)",
    "fleet.heartbeat.delay": "slow fleet-heartbeat publish; the beat "
                             "is stamped BEFORE the delay, so the "
                             "published snapshot AGES — the straggler "
                             "detector's heartbeat-age lever",
    "fleet.heartbeat.drop": "dropped fleet-heartbeat publish (the "
                            "rank's last beat goes stale in the store)",
    "router.probe.delay": "slow replica health probe (stretches the "
                          "router's detection window)",
    "router.probe.flap": "a clean replica probe recorded as failed "
                         "(drives the K-consecutive-probes re-entry "
                         "damping)",
    "router.connect.fail": "injected connection drop from the router "
                           "to its chosen replica at forward time "
                           "(the failover/replay lever)",
    "router.replica.kill": "invoke the router's registered kill_hook "
                           "against the replica currently being "
                           "forwarded to, right after a relayed "
                           "stream chunk (the kill-a-replica fleet "
                           "soak's lever)",
    "router.prefix.scramble": "perturb the router's page-aligned "
                              "prefix routing hash (repeated "
                              "prefixes stop landing on their pinned "
                              "replica — the prefix-routing tests' "
                              "lever)",
    "autopilot.launch.fail": "replica spawn raises from the launcher "
                             "(the supervisor's restart-backoff and "
                             "crash-loop-quarantine lever)",
    "autopilot.replica.hang": "a freshly-launched replica never "
                              "reports alive/ready (launch succeeds "
                              "but the process wedges before serving "
                              "— the pre-warm gate's lever)",
    "trainer.grad": "non-finite (NaN) gradient poisoning in the "
                    "compiled train step",
    "train.grad.nan": "non-finite (NaN) gradient poisoning on the "
                      "sentry's hard-trigger path (an independent "
                      "decision stream from trainer.grad, so sentry "
                      "soaks and the legacy skip tests compose)",
    "train.loss.spike": "finite loss-spike poisoning in the compiled "
                        "train step (loss and grads scaled by the "
                        "spike factor — drives the sentry's EWMA "
                        "z-score detector without any non-finite "
                        "value)",
    "io.prefetch.delay": "slow host input pipeline (delay in the "
                         "device-prefetch worker before placement)",
}


class InjectedFault(RuntimeError):
    """Base of faults raised (not simulated) by an injection point."""


class InjectedConnectionDrop(ConnectionError, InjectedFault):
    """A torn network connection. Subclasses ConnectionError so every
    handler written for the real failure also handles the injected one."""


# the ONE attribute hot paths branch on; everything else lives in _State
ENABLED = False

_lock = threading.Lock()


class _State:
    def __init__(self, seed=0, rates=None, delay_ms=50.0, hang_ms=0.0):
        self.seed = int(seed)
        # {site_prefix: (probability, max_fires | None)}
        self.rates = dict(rates or {})
        self.delay_ms = float(delay_ms)
        self.hang_ms = float(hang_ms)
        self.counters: dict[str, int] = {}   # decisions made per site
        self.fired: dict[str, int] = {}      # faults fired per site


_state = _State()


def configure(seed=0, rates=None, delay_ms=50.0, hang_ms=0.0):
    """Enable chaos with `rates` = {site_prefix: probability} or
    {site_prefix: (probability, max_fires)}. Resets all counters."""
    global ENABLED, _state
    norm = {}
    for k, v in (rates or {}).items():
        norm[k] = tuple(v) if isinstance(v, (tuple, list)) else (float(v),
                                                                 None)
    with _lock:
        _state = _State(seed, norm, delay_ms, hang_ms)
        ENABLED = True


def disable():
    """Back to the zero-cost default; counters are kept for inspection."""
    global ENABLED
    ENABLED = False


@contextmanager
def scoped(seed=0, rates=None, delay_ms=50.0, hang_ms=0.0):
    """Enable chaos for a `with` block (test harness form). Restores the
    previous configuration — including disabled — on exit."""
    global ENABLED, _state
    with _lock:
        prev = (ENABLED, _state)
    configure(seed, rates, delay_ms, hang_ms)
    try:
        yield
    finally:
        with _lock:
            ENABLED, _state = prev


def _rate_for(site: str):
    """Longest-prefix match of `site` against configured rates."""
    rates = _state.rates
    if site in rates:
        return rates[site]
    best = None
    for k, v in rates.items():
        if site.startswith(k) and (best is None or len(k) > len(best[0])):
            best = (k, v)
    return best[1] if best else (0.0, None)


def site_rate(site: str) -> float:
    return _rate_for(site)[0]


def should_fire(site: str) -> bool:
    """One deterministic decision for `site` (advances its counter)."""
    if not ENABLED:
        return False
    with _lock:
        p, cap = _rate_for(site)
        n = _state.counters.get(site, 0)
        _state.counters[site] = n + 1
        if p <= 0.0:
            return False
        if cap is not None and _state.fired.get(site, 0) >= cap:
            return False
        h = hashlib.sha256(
            f"{_state.seed}:{site}:{n}".encode()).digest()
        u = int.from_bytes(h[:8], "big") / 2**64
        if u >= p:
            return False
        _state.fired[site] = _state.fired.get(site, 0) + 1
    _note_fire(site)
    return True


def _note_fire(site: str) -> None:
    """Mirror a fired fault into the port's metrics registry."""
    if observability.ENABLED:
        observability.inc("chaos.injections", site=site)


def fire_count(site: str) -> int:
    with _lock:
        return _state.fired.get(site, 0)


def fires() -> dict:
    """Snapshot {site: fire count} of everything that fired so far."""
    with _lock:
        return dict(_state.fired)


# -- fault actions ----------------------------------------------------------

def maybe_delay(site: str) -> bool:
    """Injected slow op (slow host / congested link). Returns whether it
    fired, so callers can log."""
    if should_fire(site):
        time.sleep((_state.delay_ms + _state.hang_ms) / 1000.0)
        return True
    return False


def maybe_corrupt_file(site: str, path: str) -> bool:
    """Tear or corrupt a just-written file. Odd fires truncate to half
    (a torn write at power loss); even fires flip one mid-file byte
    (silent media corruption). Both must be caught by checkpoint
    checksums/quarantine."""
    if not should_fire(site):
        return False
    size = os.path.getsize(path)
    nth = fire_count(site)
    with open(path, "r+b") as f:
        if nth % 2 == 1 or size < 2:
            f.truncate(max(size // 2, 0))
        else:
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([b[0] ^ 0xFF]))
    return True


def grad_poison(site: str) -> float:
    """1.0 normally; NaN when the site fires. The trainer multiplies
    this into the gradients (parallel/trainer.py: only while chaos is
    enabled and the site has a rate)."""
    return float("nan") if should_fire(site) else 1.0


def loss_spike(site: str, scale: float = 100.0) -> float:
    """1.0 normally; `scale` when the site fires. The trainer multiplies
    this into the loss AND the gradients: a finite blow-up (everything
    stays finite), the failure mode a NaN check cannot see and the
    training sentry's loss cap exists for."""
    return float(scale) if should_fire(site) else 1.0
