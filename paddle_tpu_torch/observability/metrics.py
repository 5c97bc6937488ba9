"""Process-wide metrics: a thread-safe registry of Counter / Gauge /
Histogram instruments with label support, a JSON snapshot, and
Prometheus text exposition (served by PredictorServer's /metrics).

Counterpart of paddle_tpu/observability/metrics.py, copied (the module
is stdlib-only, but importing it would import the JAX package). The
`METRICS` catalogue is the JAX package's whole, letter for letter, so a
name has the same kind and help in both packages and a scrape of either
reads the same families; the exposition keeps the `paddle_tpu_` prefix.

Metric NAMES are a closed catalogue: an instrumentation call with a
name that is not catalogued raises at runtime, and
tests/test_torch_observability.py scans paddle_tpu_torch/ for any
non-literal or unregistered name at a call site.

Everything is stdlib-only.
"""
from __future__ import annotations

import json
import threading

__all__ = ["METRICS", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "REGISTRY", "DEFAULT_BUCKETS_MS",
           "DEFAULT_BUCKETS_S", "DEFAULT_MAX_LABEL_VALUES"]

# latency-ish defaults; histograms may override via the catalogue
DEFAULT_BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0, 10000.0)
DEFAULT_BUCKETS_S = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                     10.0, 30.0, 60.0, 300.0)

#: The metric-name catalogue: every literal name passed to
#: inc/observe/set_gauge anywhere in the package MUST have an entry
#: here — (kind, help[, buckets]). The port's catalogue check
#: (tests/test_torch_observability.py) fails otherwise. Keep names
#: dotted + lowercase; the Prometheus exposition converts to
#: `paddle_tpu_<name with _>` and appends `_total` to counters.
METRICS = {
    # -- store RPC / rendezvous --------------------------------------
    "store.rpc.total": ("counter", "store RPC ops issued (label: op)"),
    "store.rpc.latency_ms": ("histogram",
                             "store RPC round-trip latency (label: op)",
                             DEFAULT_BUCKETS_MS),
    "store.rpc.reconnects": ("counter",
                             "store client reconnects between retries"),
    "store.barrier.rounds": ("counter",
                             "store barrier rounds completed"),
    # -- generic retry policy ----------------------------------------
    "retry.attempts": ("counter",
                       "retry attempts across all RetryPolicy objects"),
    "retry.exhausted": ("counter",
                        "RetryBudgetExceeded raises (op gave up)"),
    # -- checkpoint ---------------------------------------------------
    "ckpt.saves": ("counter", "checkpoint saves completed"),
    "ckpt.loads": ("counter", "checkpoint loads completed"),
    "ckpt.save.seconds": ("histogram", "checkpoint save wall time",
                          DEFAULT_BUCKETS_S),
    "ckpt.load.seconds": ("histogram", "checkpoint load wall time",
                          DEFAULT_BUCKETS_S),
    "ckpt.quarantined_files": ("counter",
                               "corrupt files moved to .quarantine"),
    "ckpt.fallbacks": ("counter",
                       "loads that fell back past a corrupt newest "
                       "checkpoint"),
    "checkpoint.async.pending": ("gauge",
                                 "async saves snapshotted but not yet "
                                 "durably committed (queued + in "
                                 "flight)"),
    "checkpoint.snapshot.seconds": ("histogram",
                                    "device->host snapshot time — the "
                                    "only save stall the TRAINING "
                                    "thread pays on the async path",
                                    DEFAULT_BUCKETS_S),
    "checkpoint.write.seconds": ("histogram",
                                 "background writer time per async "
                                 "save (hash + files + barrier + "
                                 "marker), overlapped with training",
                                 DEFAULT_BUCKETS_S),
    # -- elastic ------------------------------------------------------
    "elastic.restarts": ("counter",
                         "elastic restarts (in-process resume loops + "
                         "supervisor relaunches)"),
    "elastic.preemptions": ("counter",
                            "preemption signals observed"),
    "elastic.store.read_errors": ("counter",
                                  "supervisor heartbeat-key store reads "
                                  "that failed (N consecutive failures "
                                  "presume the rank stale — a down "
                                  "store must not make every rank look "
                                  "healthy forever)"),
    # -- chaos --------------------------------------------------------
    "chaos.injections": ("counter",
                         "chaos faults fired (label: site)"),
    # -- training telemetry -------------------------------------------
    "train.steps": ("counter", "optimizer steps dispatched"),
    "train.step.seconds": ("histogram",
                           "inter-step wall time (dispatch pipelined: "
                           "converges to device step time)",
                           DEFAULT_BUCKETS_S),
    "train.tokens_per_sec": ("gauge",
                             "tokens/sec/chip over the last step"),
    "train.mfu": ("gauge",
                  "model FLOPs utilization estimate (flops-per-token "
                  "x tokens/sec / chip peak)"),
    "train.loss": ("gauge",
                   "loss of a recent step (lagged a few steps so the "
                   "read never blocks dispatch)"),
    "train.grad_norm": ("gauge", "global grad norm, when reported"),
    "train.nonfinite_skips": ("counter",
                              "steps skipped for non-finite grads"),
    # -- training anomaly sentry (distributed/sentry.py) --------------
    "train.sentry.triggers": ("counter",
                              "sentry anomaly triggers (label: reason "
                              "= loss_spike | nonfinite_grad | "
                              "sentry_quarantine)"),
    "train.sentry.skips": ("counter",
                           "updates discarded by the sentry skip "
                           "policy (data cursor still advanced)"),
    "train.sentry.rollbacks": ("counter",
                               "restores onto the last promoted "
                               "known-good checkpoint"),
    "train.sentry.steps_since_good": ("gauge",
                                      "steps since the newest "
                                      "PROMOTED (rollback-eligible) "
                                      "checkpoint — a climbing value "
                                      "on one rank is numeric "
                                      "degradation before quarantine"),
    "train.sentry.probe.seconds": ("histogram",
                                   "host-side sentry overhead per "
                                   "step (probe read + EWMA update + "
                                   "policy decision) — the <1% "
                                   "probe-overhead acceptance is "
                                   "benched in extra.sentry",
                                   DEFAULT_BUCKETS_S),
    "train.recompiles": ("counter",
                         "train-step program (re)builds (label: shape "
                         "= the triggering batch-shape signature — the "
                         "bucket-autotune feed)"),
    "train.phase.seconds": ("histogram",
                            "phase-attributed step wall time (label: "
                            "phase = fwd | bwd | optimizer), from "
                            "Trainer.measure_phase_seconds timing the "
                            "step's own loss machinery fwd-only / "
                            "fwd+bwd / full — the bench evidence for "
                            "WHY MFU moved, not just that it did",
                            DEFAULT_BUCKETS_S),
    "train.loss.logits_bytes_saved": ("gauge",
                                      "per-chip bytes of the [B*S, "
                                      "vocab] logits tensor the "
                                      "blockwise-CE loss path avoids "
                                      "materializing per step (0 / "
                                      "absent on the dense path)"),
    "train.overlap.comm.seconds": ("histogram",
                                   "weight-movement collective seconds "
                                   "per phase (label: phase = fwd | "
                                   "bwd): propagated-twin minus "
                                   "nocomm-twin wall time from "
                                   "measure_phase_seconds — the "
                                   "overlap-fraction denominator",
                                   DEFAULT_BUCKETS_S),
    "train.overlap.fraction": ("gauge",
                               "share of FSDP weight-movement comm "
                               "hidden under compute by the decomposed "
                               "ppermute rings (parallel/overlap.py), "
                               "from the train.overlap.phase trace "
                               "spans: (propagated − overlapped) / "
                               "(propagated − nocomm) over fwd+bwd"),
    # -- input pipeline -----------------------------------------------
    "io.prefetch.queue_depth": ("gauge",
                                "batches already on device, waiting "
                                "for the consumer"),
    "io.prefetch.batches": ("counter",
                            "batches placed on device by prefetch "
                            "workers"),
    "io.h2d.seconds": ("histogram",
                       "host->device batch placement time on the "
                       "prefetch thread (dispatch + ready)",
                       DEFAULT_BUCKETS_S),
    # -- serving ------------------------------------------------------
    "serving.requests": ("counter",
                         "HTTP requests by outcome (label: outcome)"),
    "serving.request.latency_ms": ("histogram",
                                   "successful request latency",
                                   DEFAULT_BUCKETS_MS),
    "serving.in_flight": ("gauge", "admitted requests in flight"),
    "serving.capacity": ("gauge", "admission capacity"),
    "serving.draining": ("gauge", "1 while draining"),
    "serving.warming": ("gauge", "1 while the cold-start readiness "
                                 "gate holds (/readyz 503 \"warming\": "
                                 "model built, first compile not yet "
                                 "paid)"),
    "serving.admission.admitted": ("gauge",
                                   "lifetime admitted (scraped)"),
    "serving.admission.rejected": ("gauge",
                                   "lifetime admission rejections "
                                   "(scraped)"),
    "serving.breaker.state": ("gauge",
                              "circuit breaker state (0 closed, "
                              "1 half-open, 2 open)"),
    "serving.breaker.consecutive_failures": ("gauge",
                                             "consecutive backend "
                                             "failures"),
    "serving.breaker.opens": ("gauge", "lifetime breaker trips"),
    "serving.breaker.recloses": ("gauge", "lifetime breaker recloses"),
    "serving.batcher.queued": ("gauge", "requests buffered for a batch"),
    "serving.batcher.batches_run": ("gauge", "batches executed"),
    "serving.batcher.requests_served": ("gauge",
                                        "requests served via batches"),
    "serving.batcher.expired_in_queue": ("gauge",
                                         "requests expired while "
                                         "buffered"),
    "serving.batcher.shed_full": ("gauge",
                                  "requests shed on a full buffer"),
    "serving.batcher.shed_tenant": ("gauge",
                                    "requests shed on a per-tenant "
                                    "buffer quota (scraped)"),
    # -- multi-tenant QoS (inference/tenancy.py) ----------------------
    "tenant.requests": ("counter",
                        "served-layer requests by tenant and outcome "
                        "(labels: tenant, outcome — the serving /stats "
                        "outcome keys)"),
    "tenant.shed": ("counter",
                    "tenant-quota sheds (labels: tenant, reason = "
                    "admission | queue | engine | rate)"),
    "tenant.admitted": ("counter",
                        "engine slot admissions by tenant (label: "
                        "tenant)"),
    "tenant.decode.slots": ("counter",
                            "decode slot-ticks by tenant — one count "
                            "per live slot per scheduler tick, the "
                            "weighted-fair share evidence (label: "
                            "tenant)"),
    "tenant.queue_wait.seconds": ("histogram",
                                  "engine admission queue wait by "
                                  "tenant (label: tenant) — the "
                                  "starvation-soak SLO",
                                  DEFAULT_BUCKETS_S),
    "tenant.in_flight": ("gauge",
                         "admitted requests in flight by tenant "
                         "(label: tenant, scraped)"),
    # -- registry self-protection -------------------------------------
    "metrics.labels.dropped": ("counter",
                               "label values folded into the literal "
                               "\"_other\" cell because an instrument "
                               "hit its distinct-label-value bound "
                               "(label: metric) — a tenant-id flood "
                               "must not grow the registry without "
                               "bound"),
    # -- per-request serving SLOs (observability/requests.py) ---------
    "request.ttft.seconds": ("histogram",
                             "time to first generated token, from "
                             "request-context creation (HTTP arrival "
                             "or engine submit) — the user-felt SLO",
                             DEFAULT_BUCKETS_S),
    "request.itl.seconds": ("histogram",
                            "inter-token latency: per-token mean gap "
                            "between successive decode emissions "
                            "(one observation per fused tick)",
                            DEFAULT_BUCKETS_S),
    "request.queue_wait.seconds": ("histogram",
                                   "wait between queued and scheduled "
                                   "(batch formed / engine slot "
                                   "assigned)", DEFAULT_BUCKETS_S),
    "request.prefill.seconds": ("histogram",
                                "prompt prefill wall time per request",
                                DEFAULT_BUCKETS_S),
    "request.tokens": ("histogram",
                       "generated tokens per finished request",
                       (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                        256.0, 512.0, 1024.0, 2048.0, 4096.0)),
    "request.outcome": ("counter",
                        "finished requests by outcome (label: reason "
                        "= finished | ok | shed_* | deadline_exceeded "
                        "| expired | cancelled | disconnected | "
                        "client_error | server_error | error)"),
    "request.slow_exemplars": ("counter",
                               "requests breaching the slow-request "
                               "threshold whose lifecycle was dumped "
                               "into the span ring"),
    # -- fleet telemetry plane (observability/fleet.py) ---------------
    "fleet.heartbeats": ("counter",
                         "heartbeat snapshots this rank published into "
                         "the store"),
    "fleet.heartbeat.errors": ("counter",
                               "heartbeat publishes/reads that failed "
                               "(after retries)"),
    "fleet.step.skew": ("gauge",
                        "max-min training step across ranks reporting "
                        "a step"),
    "fleet.step.lag": ("gauge",
                       "slowest rank's step lag vs the fleet median"),
    "fleet.stale_ranks": ("gauge",
                          "ranks whose heartbeat is missing or older "
                          "than stale_after_s"),
    "fleet.stragglers": ("gauge",
                         "ranks currently flagged as stragglers (stale "
                         "or step-lagged past straggler_steps)"),
    "fleet.straggler": ("gauge",
                        "1 while the labeled rank is flagged as a "
                        "straggler (label: rank)"),
    "fleet.tokens_per_sec": ("gauge",
                             "fleet-summed tokens/sec across live "
                             "ranks"),
    "fleet.flight.records": ("counter",
                             "flight-recorder bundles dumped (label: "
                             "reason)"),
    # -- replica fleet router (inference/router.py) -------------------
    "router.requests": ("counter",
                        "routed requests by outcome (label: outcome = "
                        "ok | shed_upstream | shed_tenant | "
                        "no_replicas | failed | deadline_exceeded | "
                        "client_error | server_error | stream_error | "
                        "disconnected)"),
    "router.retries": ("counter",
                       "failover retries (label: kind = shed | "
                       "connect | stream)"),
    "router.probes": ("counter",
                      "replica health probes (label: result = ready | "
                      "saturated | draining | warming | breaker | "
                      "failed | flap)"),
    "router.ejections": ("counter",
                         "replicas ejected from rotation (label: "
                         "reason = draining | warming | probe_failed | "
                         "replica_breaker | breaker_open | "
                         "connect_failed)"),
    "router.reentries": ("counter",
                         "ejected replicas re-admitted after K "
                         "consecutive clean probes"),
    "router.affinity.rebinds": ("counter",
                                "sessions re-pinned after their "
                                "affine replica left rotation"),
    "router.prefix.pins": ("counter",
                           "prefix-hash -> replica pins created or "
                           "re-pointed (one per chain key)"),
    "router.prefix.hits": ("counter",
                           "requests routed to the replica their "
                           "prefix hash is pinned to (KV locality "
                           "preserved)"),
    "router.prefix.rebinds": ("counter",
                              "prefix pins re-bound after every "
                              "pinned replica for the chain left "
                              "rotation"),
    "router.disagg.handoffs": ("counter",
                               "requests routed through the "
                               "disaggregated two-hop path (prefill "
                               "pool, then decode pool with a KV "
                               "page handoff)"),
    "router.disagg.fallbacks": ("counter",
                                "two-hop candidates degraded to "
                                "single-replica decode (label: "
                                "reason = prefill_failed | "
                                "transfer_fail)"),
    "router.replicas.in_rotation": ("gauge",
                                    "replicas currently routable"),
    "router.replicas.ejected": ("gauge",
                                "replicas currently out of rotation"),
    "router.forward.seconds": ("histogram",
                               "router-side request wall time incl. "
                               "failover retries (the added-hop "
                               "budget)", DEFAULT_BUCKETS_S),
    # -- fleet autopilot (inference/autopilot.py) ---------------------
    "autopilot.restarts": ("counter",
                           "replica restarts attempted by the "
                           "supervisor (label: rid)"),
    "autopilot.restart.seconds": ("histogram",
                                  "dead-replica detection to back-in-"
                                  "rotation wall time (the restart-to-"
                                  "ready availability number)",
                                  DEFAULT_BUCKETS_S),
    "autopilot.launch.failures": ("counter",
                                  "replica spawn attempts that raised "
                                  "or never became ready (label: rid)"),
    "autopilot.quarantines": ("counter",
                              "supervised slots quarantined after K "
                              "restarts inside the crash-loop window "
                              "(label: rid)"),
    "autopilot.replicas.quarantined": ("gauge",
                                       "supervised slots currently "
                                       "quarantined (not restarted "
                                       "until released)"),
    "autopilot.replicas.desired": ("gauge",
                                   "autoscaler's current desired "
                                   "replica count"),
    "autopilot.scale.events": ("counter",
                               "autoscaler resizes applied (label: "
                               "direction = out | in)"),
    "autopilot.rollouts": ("counter",
                           "weight rollouts finished (label: outcome "
                           "= completed | aborted)"),
    "autopilot.rollout.steps": ("counter",
                                "per-replica rollout steps (label: "
                                "result = swapped | rolled_back)"),
    # -- paged KV engine ----------------------------------------------
    "inference.decode.kernel": ("counter",
                                "decode ticks by attend path (label: "
                                "path = pallas | jnp)"),
    "inference.kv.bytes_per_slot": ("gauge",
                                    "KV-pool HBM bytes one fully-grown "
                                    "slot pins (all layers, real "
                                    "buffer dtypes incl. int8 scale "
                                    "planes)"),
    "inference.prefix.hits": ("counter",
                              "admissions that shared cached prompt "
                              "prefix pages (prefill ran only the "
                              "tail)"),
    "inference.prefix.misses": ("counter",
                                "admissions of shareable-length "
                                "prompts that found no cached "
                                "prefix"),
    "inference.prefix.hit_tokens": ("counter",
                                    "prompt tokens served from shared "
                                    "prefix pages instead of "
                                    "prefill"),
    "inference.prefix.pages_shared": ("counter",
                                      "prefix-cache pages pointed "
                                      "into admitted slots' block "
                                      "tables"),
    "inference.prefix.evictions": ("counter",
                                   "prefix-cache entries evicted "
                                   "(LRU budget or on-demand when "
                                   "decode needed the page back)"),
    "inference.kvtier.spilled_pages": ("counter",
                                       "KV pages spilled to the "
                                       "host-RAM tier at eviction "
                                       "(D2H)"),
    "inference.kvtier.restored_pages": ("counter",
                                        "host-tier pages uploaded "
                                        "back into device pools on a "
                                        "restore hit (H2D)"),
    "inference.kvtier.spill_bytes": ("counter",
                                     "bytes moved device -> host by "
                                     "spills (int8 pools move ~0.52x "
                                     "the bf16 volume)"),
    "inference.kvtier.restore_bytes": ("counter",
                                       "bytes moved host -> device "
                                       "by restore hits"),
    "inference.kvtier.host_pages": ("gauge",
                                    "KV pages currently resident in "
                                    "the host-RAM tier"),
    "inference.kvtier.suspends": ("counter",
                                  "idle sessions suspended (KV "
                                  "spilled to host, HBM pages "
                                  "freed)"),
    "inference.kvtier.resumes": ("counter",
                                 "suspended sessions resumed on "
                                 "their next turn"),
    # -- disaggregated prefill/decode handoff (inference/disagg.py) ---
    "inference.disagg.handoff_pages": ("counter",
                                       "committed KV pages served to "
                                       "decode-pool pulls (/kv/pull, "
                                       "prefill side)"),
    "inference.disagg.handoff_bytes": ("counter",
                                       "wire bytes of packed page "
                                       "bundles served to pulls "
                                       "(int8 + dedup keep this "
                                       "~2x+ under naive bf16)"),
    "inference.disagg.imported_pages": ("counter",
                                        "pulled pages committed into "
                                        "a decode replica's pools "
                                        "(batched H2D scatter)"),
    "inference.disagg.imported_bytes": ("counter",
                                        "host bytes of pulled pages "
                                        "committed into device "
                                        "pools"),
    "inference.disagg.dedup_skipped_pages": ("counter",
                                             "handoff pages skipped "
                                             "because the chain key "
                                             "was already resident on "
                                             "the decode replica (a "
                                             "warm replica transfers "
                                             "nothing)"),
    "inference.disagg.transfer_seconds": ("histogram",
                                          "decode-side /kv/pull wall "
                                          "time, fetch through "
                                          "unpack (the handoff tax "
                                          "on TTFT)", DEFAULT_BUCKETS_S),
    "inference.disagg.pull_failures": ("counter",
                                       "failed /kv/pull fetches — the "
                                       "request falls back to a cold "
                                       "local prefill, never an "
                                       "error"),
    "engine.ticks": ("gauge", "scheduler ticks run"),
    "engine.prefills": ("gauge", "prompts prefilled"),
    "engine.tokens_out": ("gauge", "tokens emitted"),
    "engine.admitted": ("gauge", "requests admitted to slots"),
    "engine.finished": ("gauge", "requests finished"),
    "engine.cancelled": ("gauge", "requests cancelled"),
    "engine.expired": ("gauge", "requests expired before admission"),
    "engine.overloaded": ("gauge", "submits shed with EngineOverloaded"),
    "engine.pending": ("gauge", "requests queued for admission"),
}


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


#: default bound on DISTINCT values per label key per instrument; the
#: overflow folds into the literal "_other" cell (guard rationale in
#: _Instrument._norm_record_locked)
DEFAULT_MAX_LABEL_VALUES = 64


def _note_dropped(name, n):
    """Count label-value folds into the process registry. The guard's
    own counter is exempt (its `metric` label is bounded by the
    catalogue, and exempting it breaks the recursion by construction)."""
    if name == "metrics.labels.dropped":
        return
    REGISTRY.inc("metrics.labels.dropped", n, metric=name)


class _Instrument:
    """Base: per-label-set cells guarded by one lock. Label VALUES are
    free-form but BOUNDED: past `max_label_values` distinct values per
    label key, new values fold into the literal "_other" cell and the
    `metrics.labels.dropped` counter records the fold — an unbounded
    id flood (e.g. 10k distinct tenant ids) must not grow the registry
    (and every /metrics scrape body) without bound. Label keys+values
    are stringified at record time."""

    kind = "untyped"

    def __init__(self, name, help="",
                 max_label_values=DEFAULT_MAX_LABEL_VALUES):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._cells: dict = {}
        self._max_label_values = int(max_label_values)
        self._label_vals: dict = {}         # label key -> seen values

    def _norm(self, labels):
        """READ-side normalization: no guard, no mutation — a lookup
        of a never-recorded value must not consume cardinality budget
        (it just misses, or hits "_other" if writes folded)."""
        return _label_key({str(k): str(v) for k, v in labels.items()})

    def _norm_record_locked(self, labels):
        """WRITE-side normalization (caller holds self._lock): returns
        (cell key, values folded). A label value past the per-key
        distinct bound becomes "_other"."""
        dropped = 0
        out = {}
        for k, v in labels.items():
            k, v = str(k), str(v)
            vals = self._label_vals.setdefault(k, set())
            if v not in vals:
                if len(vals) >= self._max_label_values:
                    dropped += 1
                    v = "_other"
                else:
                    vals.add(v)
            out[k] = v
        return _label_key(out), dropped

    def labeled(self) -> dict:
        """{label_key_tuple: value} snapshot."""
        with self._lock:
            return dict(self._cells)


class Counter(_Instrument):
    kind = "counter"

    def inc(self, n=1, **labels):
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            key, dropped = self._norm_record_locked(labels)
            self._cells[key] = self._cells.get(key, 0) + n
        if dropped:
            _note_dropped(self.name, dropped)

    def value(self, **labels):
        with self._lock:
            return self._cells.get(self._norm(labels), 0)


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, v, **labels):
        with self._lock:
            key, dropped = self._norm_record_locked(labels)
            self._cells[key] = float(v)
        if dropped:
            _note_dropped(self.name, dropped)

    def value(self, **labels):
        with self._lock:
            return self._cells.get(self._norm(labels))


class _HistCell:
    __slots__ = ("counts", "sum", "count", "ring", "ring_idx")

    def __init__(self, n_buckets, ring_cap):
        self.counts = [0] * (n_buckets + 1)     # +inf bucket last
        self.sum = 0.0
        self.count = 0
        # bounded reservoir of recent raw values, for percentiles
        # (bucket counts alone only bound a percentile to a bucket)
        self.ring = [0.0] * ring_cap
        self.ring_idx = 0


class Histogram(_Instrument):
    """Fixed-bucket histogram (cumulative `le` semantics on export)
    plus a bounded ring of recent raw observations so `percentile()`
    answers exactly over the recent window."""

    kind = "histogram"

    def __init__(self, name, help="", buckets=DEFAULT_BUCKETS_MS,
                 ring_capacity=512,
                 max_label_values=DEFAULT_MAX_LABEL_VALUES):
        super().__init__(name, help, max_label_values=max_label_values)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.ring_capacity = int(ring_capacity)

    def observe(self, v, **labels):
        v = float(v)
        with self._lock:
            key, dropped = self._norm_record_locked(labels)
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = _HistCell(
                    len(self.buckets), self.ring_capacity)
            i = 0
            for b in self.buckets:
                if v <= b:
                    break
                i += 1
            cell.counts[i] += 1
            cell.sum += v
            cell.count += 1
            cell.ring[cell.ring_idx % self.ring_capacity] = v
            cell.ring_idx += 1
        if dropped:
            _note_dropped(self.name, dropped)

    def labeled(self) -> dict:
        """Consistent per-cell copies: exporters read counts/sum/count
        of a cell outside the lock, and a concurrent observe() must
        not let the +Inf cumulative bucket disagree with _count (the
        Prometheus invariant strict parsers check)."""
        with self._lock:
            out = {}
            for key, cell in self._cells.items():
                c = _HistCell(len(self.buckets), 1)
                c.counts = list(cell.counts)
                c.sum = cell.sum
                c.count = cell.count
                out[key] = c
            return out

    def count(self, **labels):
        with self._lock:
            cell = self._cells.get(self._norm(labels))
            return cell.count if cell else 0

    def percentile(self, p, **labels):
        """Nearest-rank percentile over the recent window (None when
        nothing recorded)."""
        with self._lock:
            cell = self._cells.get(self._norm(labels))
            if cell is None or cell.count == 0:
                return None
            n = min(cell.count, self.ring_capacity)
            win = sorted(cell.ring[:n])
        rank = min(n - 1, max(0, int(round(p / 100.0 * (n - 1)))))
        return win[rank]


class MetricsRegistry:
    """Thread-safe, catalogue-validated instrument registry.

    `inc` / `observe` / `set_gauge` are the instrumentation surface
    (audited by the port's catalogue check); `counter` / `gauge` /
    `histogram` hand back the instrument object for readers. Unknown
    names raise — the catalogue, not the call site, is the source of
    truth for what exists."""

    def __init__(self, catalogue=None,
                 max_label_values=DEFAULT_MAX_LABEL_VALUES):
        self._catalogue = catalogue if catalogue is not None else METRICS
        self._lock = threading.Lock()
        self._metrics: dict = {}
        self._max_label_values = int(max_label_values)

    # -- acquisition --------------------------------------------------
    def _get(self, name, expect_kind):
        spec = self._catalogue.get(name)
        if spec is None:
            raise KeyError(
                f"metric {name!r} is not in the METRICS catalogue "
                "(observability/metrics.py) — register it there")
        kind = spec[0]
        if kind != expect_kind:
            raise TypeError(
                f"metric {name!r} is a {kind}, not a {expect_kind}")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                help_ = spec[1] if len(spec) > 1 else ""
                mlv = self._max_label_values
                if kind == "counter":
                    m = Counter(name, help_, max_label_values=mlv)
                elif kind == "gauge":
                    m = Gauge(name, help_, max_label_values=mlv)
                else:
                    buckets = (spec[2] if len(spec) > 2
                               else DEFAULT_BUCKETS_MS)
                    m = Histogram(name, help_, buckets,
                                  max_label_values=mlv)
                self._metrics[name] = m
            return m

    def counter(self, name) -> Counter:
        return self._get(name, "counter")

    def gauge(self, name) -> Gauge:
        return self._get(name, "gauge")

    def histogram(self, name) -> Histogram:
        return self._get(name, "histogram")

    # -- instrumentation surface (audited; names must be literal) -----
    def inc(self, name, n=1, **labels):
        self._get(name, "counter").inc(n, **labels)

    def observe(self, name, v, **labels):
        self._get(name, "histogram").observe(v, **labels)

    def set_gauge(self, name, v, **labels):
        self._get(name, "gauge").set(v, **labels)

    # -- readers ------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able {name: {kind, help, series: [{labels, ...}]}}."""
        with self._lock:
            metrics = list(self._metrics.values())
        out = {}
        for m in sorted(metrics, key=lambda m: m.name):
            series = []
            for key, val in sorted(m.labeled().items()):
                entry = {"labels": dict(key)}
                if isinstance(val, _HistCell):
                    entry.update(count=val.count, sum=val.sum,
                                 buckets=dict(zip(
                                     [*map(str, m.buckets), "+Inf"],
                                     _cumulate(val.counts))))
                else:
                    entry["value"] = val
                series.append(entry)
            out[m.name] = {"kind": m.kind, "help": m.help,
                           "series": series}
        return out

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), indent=1, sort_keys=True)

    def names(self) -> set:
        """Names of the instruments recorded so far."""
        with self._lock:
            return set(self._metrics)

    def prometheus_text(self, exclude=()) -> str:
        """Prometheus text exposition format 0.0.4. `exclude` skips
        metric names another exposition already emitted — a family
        must not appear twice in one scrape body (serving.metrics_text
        concatenates the per-server and global registries)."""
        with self._lock:
            metrics = [m for m in self._metrics.values()
                       if m.name not in exclude]
        lines = []
        for m in sorted(metrics, key=lambda m: m.name):
            pname = _prom_name(m.name, m.kind)
            if m.help:
                lines.append(f"# HELP {pname} {_prom_escape_help(m.help)}")
            lines.append(f"# TYPE {pname} {m.kind}")
            for key, val in sorted(m.labeled().items()):
                labels = dict(key)
                if isinstance(val, _HistCell):
                    cum = _cumulate(val.counts)
                    for b, c in zip([*m.buckets, "+Inf"], cum):
                        le = _prom_float(b) if b != "+Inf" else "+Inf"
                        lines.append(
                            f"{pname}_bucket"
                            f"{_prom_labels({**labels, 'le': le})} {c}")
                    lines.append(f"{pname}_sum{_prom_labels(labels)} "
                                 f"{_prom_float(val.sum)}")
                    lines.append(f"{pname}_count{_prom_labels(labels)} "
                                 f"{val.count}")
                else:
                    lines.append(f"{pname}{_prom_labels(labels)} "
                                 f"{_prom_float(val)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self):
        """Drop every instrument (tests)."""
        with self._lock:
            self._metrics.clear()


def _cumulate(counts):
    out, acc = [], 0
    for c in counts:
        acc += c
        out.append(acc)
    return out


def _prom_name(name: str, kind: str) -> str:
    base = "paddle_tpu_" + name.replace(".", "_").replace("-", "_")
    if kind == "counter" and not base.endswith("_total"):
        base += "_total"
    return base


def _prom_escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _prom_escape_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_prom_escape_label(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _prom_float(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


#: the process-wide default registry every `observability.inc(...)`
#: helper writes to; serving creates per-server registries besides
REGISTRY = MetricsRegistry()
