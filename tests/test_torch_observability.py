"""The port's observability plane (paddle_tpu_torch/observability)
against the JAX package's, on the CPU.

The registry, span and RequestContext units of tests/test_observability.py
and tests/test_request_tracing.py run over both packages (the `P`
fixture): each gives the same results. Beside them, the same operations
on a registry of each package give the same JSON snapshot and the same
Prometheus text, the catalogue is the JAX package's letter for letter,
and a request timeline drives the same request.* instruments in both.

The catalogue check is the port's counterpart of the `metric-names`
and `chaos-points` passes of tools/analyze (which scan only
paddle_tpu/): an AST scan of paddle_tpu_torch/ that every literal name
at an instrumentation site is in the port's METRICS with the kind the
call records, and every literal chaos site in its POINTS.

Everything here is exact: counts, strings and label sets compare
equal; time-valued histograms compare by count and bucket layout only.
"""
import ast
import json
import os
import re
import subprocess
import sys
import threading
import time
import types

import pytest

from paddle_tpu import observability as j_obs
from paddle_tpu_torch import observability as t_obs
from paddle_tpu_torch.distributed import chaos as t_chaos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TP = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
_TRACE_ID = "ab" * 16
PACKAGES = {"jax": j_obs, "port": t_obs}


def _ns(obs):
    return types.SimpleNamespace(obs=obs, M=obs.metrics, trace=obs.trace,
                                 req=obs.requests,
                                 Ctx=obs.requests.RequestContext)


@pytest.fixture(params=sorted(PACKAGES))
def P(request):
    """One package's observability plane."""
    return _ns(PACKAGES[request.param])


def _reset(obs):
    obs.disable()
    obs.REGISTRY.reset()
    obs.trace.clear()
    obs.requests.clear()


@pytest.fixture(autouse=True)
def _clean_slate():
    """Both planes are process-global: every test starts disabled and
    empty, and restores the exemplar config."""
    saved = {}
    for name, obs in PACKAGES.items():
        cfg = obs.requests.CONFIG
        saved[name] = (cfg.slow_ttft_s, cfg.slow_total_s,
                       cfg.live_capacity, cfg.max_events)
        _reset(obs)
    yield
    for name, obs in PACKAGES.items():
        _reset(obs)
        cfg = obs.requests.CONFIG
        (cfg.slow_ttft_s, cfg.slow_total_s, cfg.live_capacity,
         cfg.max_events) = saved[name]


# -- the catalogue -------------------------------------------------------------

def test_metrics_catalogue_is_the_jax_one():
    assert t_obs.METRICS == j_obs.METRICS
    assert list(t_obs.METRICS) == list(j_obs.METRICS)
    assert t_obs.requests.EVENTS == j_obs.requests.EVENTS


def test_separate_switch_and_registry():
    """The port's plane is its own: enabling one package's leaves the
    other's off, and each records into its own registry."""
    t_obs.enable()
    assert t_obs.ENABLED and not j_obs.ENABLED
    t_obs.inc("train.steps")
    assert j_obs.REGISTRY.names() == set()
    assert t_obs.REGISTRY is not j_obs.REGISTRY
    assert t_obs.requests.current is not j_obs.requests.current


_INSTRUMENTS = {"inc": "counter", "observe": "histogram",
                "set_gauge": "gauge"}
_ACQUIRERS = {"counter": "counter", "gauge": "gauge",
              "histogram": "histogram"}
_CHAOS_CALLS = ("should_fire", "maybe_delay", "maybe_corrupt_file",
                "grad_poison", "loss_spike")
# the registry implementation passes `name` variables around, as the
# JAX package's metric-names pass allows for its own
_METRIC_IMPL = {os.path.join("observability", "metrics.py"),
                os.path.join("observability", "__init__.py")}
_CHAOS_IMPL = {os.path.join("distributed", "chaos.py")}


def _port_modules():
    base = os.path.join(ROOT, "paddle_tpu_torch")
    for dirpath, _dirs, files in os.walk(base):
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    yield (os.path.relpath(path, base),
                           ast.parse(fh.read(), path))


def _calls(tree, names):
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args:
            f = node.func
            name = (f.attr if isinstance(f, ast.Attribute)
                    else f.id if isinstance(f, ast.Name) else None)
            if name in names:
                arg = node.args[0]
                lit = (arg.value if isinstance(arg, ast.Constant)
                       and isinstance(arg.value, str) else None)
                yield name, lit, node.lineno


def _point_known(site):
    return site in t_chaos.POINTS or any(
        k.endswith("/") and site.startswith(k) for k in t_chaos.POINTS)


def _scan(modules):
    """(violations, metric names seen, chaos sites seen) over (path,
    AST) pairs."""
    bad, metrics_seen, sites_seen = [], set(), set()
    for rel, tree in modules:
        for name, lit, line in _calls(tree, {**_INSTRUMENTS,
                                             **_ACQUIRERS}):
            if lit is None:
                if name in _INSTRUMENTS and rel not in _METRIC_IMPL:
                    bad.append(f"{rel}:{line}: {name}() with a name that "
                               "is not a string literal")
                continue
            metrics_seen.add(lit)
            want = {**_INSTRUMENTS, **_ACQUIRERS}[name]
            spec = t_obs.METRICS.get(lit)
            if spec is None:
                bad.append(f"{rel}:{line}: {lit!r} is not in METRICS")
            elif spec[0] != want or spec[0] != j_obs.METRICS[lit][0]:
                bad.append(f"{rel}:{line}: {name}({lit!r}) records a "
                           f"{want}, METRICS says {spec[0]}")
        for name, lit, line in _calls(tree, _CHAOS_CALLS):
            if lit is None:
                if rel not in _CHAOS_IMPL:
                    bad.append(f"{rel}:{line}: {name}() with a site that "
                               "is not a string literal")
                continue
            sites_seen.add(lit)
            if not _point_known(lit):
                bad.append(f"{rel}:{line}: chaos site {lit!r} is not in "
                           "POINTS")
    return bad, metrics_seen, sites_seen


def test_port_metric_and_chaos_sites_are_catalogued():
    bad, metrics_seen, sites_seen = _scan(_port_modules())
    assert not bad, "\n".join(bad)
    # the scan saw the engine's, kvtier's, disagg's, serving's, the
    # request tracer's, the router's, the fleet plane's and the
    # autopilot's, the trainer's and the checkpoints' sites, and every
    # chaos site the port wires
    assert {"inference.decode.kernel", "inference.prefix.hits",
            "tenant.decode.slots", "inference.kvtier.spilled_pages",
            "inference.disagg.imported_pages", "engine.pending",
            "request.ttft.seconds", "serving.requests",
            "router.requests", "router.disagg.handoffs",
            "fleet.heartbeats", "fleet.flight.records",
            "autopilot.restarts", "autopilot.quarantines",
            "train.steps", "train.recompiles", "train.nonfinite_skips",
            "ckpt.saves", "checkpoint.async.pending"} <= metrics_seen
    assert sites_seen == {"engine.tick.delay", "prefix.cache.bypass",
                          "kvtier.spill.fail", "kvtier.restore.delay",
                          "tenant.storm", "serving.batch.delay",
                          "serving.batch.fail", "serving.admit.delay",
                          "serving.run.delay", "serving.run.fail",
                          "router.probe.delay", "router.probe.flap",
                          "router.connect.fail", "router.replica.kill",
                          "router.prefix.scramble", "disagg.transfer.fail",
                          "disagg.transfer.delay", "fleet.heartbeat.delay",
                          "fleet.heartbeat.drop", "autopilot.launch.fail",
                          "autopilot.replica.hang", "ckpt.write.shards",
                          "ckpt.write.table", "ckpt.async.delay",
                          "ckpt.async.fail", "trainer.grad",
                          "train.grad.nan", "train.loss.spike"}


def test_catalogue_check_catches_planted_sites():
    """The scan is real: an uncatalogued name, a miskinded call, a
    non-literal name, a non-literal site and an unknown site are each
    reported, and a catalogued site is not."""
    src = ("def f(obs, chaos, name, site):\n"
           "    obs.inc('made.up.metric')\n"
           "    obs.observe('serving.requests', 1.0)\n"
           "    obs.inc(name)\n"
           "    obs.set_gauge('engine.ticks', 1)\n"
           "    chaos.should_fire('no.such.site')\n"
           "    chaos.should_fire(site)\n"
           "    chaos.maybe_delay('serving.run.delay')\n")
    bad, seen, sites = _scan([("planted.py", ast.parse(src))])
    assert [b.split(": ", 1)[0] for b in bad] == [
        "planted.py:2", "planted.py:3", "planted.py:4", "planted.py:6",
        "planted.py:7"]
    assert seen == {"made.up.metric", "serving.requests", "engine.ticks"}
    assert sites == {"no.such.site", "serving.run.delay"}


# -- registry basics (tests/test_observability.py) ----------------------------

def test_disabled_by_default_and_scoped_restores(P):
    obs = P.obs
    assert obs.ENABLED is False
    with obs.scoped() as reg:
        assert obs.ENABLED is True
        assert reg is obs.REGISTRY
    assert obs.ENABLED is False
    obs.enable()
    with obs.scoped():
        pass
    assert obs.ENABLED is True
    obs.disable()


def test_counter_gauge_histogram_and_labels(P):
    reg = P.M.MetricsRegistry()
    reg.inc("serving.requests", outcome="ok")
    reg.inc("serving.requests", 2, outcome="ok")
    reg.inc("serving.requests", outcome="shed")
    assert reg.counter("serving.requests").value(outcome="ok") == 3
    assert reg.counter("serving.requests").value(outcome="shed") == 1
    reg.set_gauge("train.mfu", 0.41)
    assert reg.gauge("train.mfu").value() == 0.41
    reg.observe("store.rpc.latency_ms", 7.0, op="get")
    h = reg.histogram("store.rpc.latency_ms")
    assert h.count(op="get") == 1
    assert h.percentile(50, op="get") == 7.0
    with pytest.raises(ValueError):
        reg.inc("serving.requests", -1)


def test_unknown_and_miskinded_names_raise(P):
    reg = P.M.MetricsRegistry()
    with pytest.raises(KeyError):
        reg.inc("made.up.metric")
    with pytest.raises(TypeError):
        reg.observe("serving.requests", 1.0)


def test_registry_thread_safety(P):
    reg = P.M.MetricsRegistry()
    n_threads, per = 8, 1000

    def worker():
        for _ in range(per):
            reg.inc("train.steps")
            reg.observe("train.step.seconds", 0.01)
    ts = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert reg.counter("train.steps").value() == n_threads * per
    assert reg.histogram("train.step.seconds").count() == n_threads * per


def test_label_values_are_bounded(P):
    """Past max_label_values distinct values a label folds into
    "_other", and the process registry counts the fold."""
    P.obs.enable()
    reg = P.M.MetricsRegistry(max_label_values=3)
    for i in range(5):
        reg.inc("tenant.admitted", tenant=f"t{i}")
    c = reg.counter("tenant.admitted")
    assert c.value(tenant="_other") == 2
    assert {dict(k)["tenant"] for k in c.labeled()} == {
        "t0", "t1", "t2", "_other"}
    assert P.obs.REGISTRY.counter("metrics.labels.dropped").value(
        metric="tenant.admitted") == 2


_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\")*\})?"
    r" [0-9.eE+-]+(\+Inf)?$")


def test_prometheus_text_is_valid_and_complete(P):
    reg = P.M.MetricsRegistry()
    reg.inc("serving.requests", 3, outcome="ok")
    reg.set_gauge("serving.draining", 0)
    reg.observe("serving.request.latency_ms", 12.0)
    reg.observe("serving.request.latency_ms", 9000.0)
    text = reg.prometheus_text()
    assert text.endswith("\n")
    for line in text.strip().split("\n"):
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            continue
        assert _SAMPLE.match(line), line
    assert 'paddle_tpu_serving_requests_total{outcome="ok"} 3' in text
    assert "# TYPE paddle_tpu_serving_requests_total counter" in text
    assert "paddle_tpu_serving_draining 0" in text
    assert re.search(
        r'paddle_tpu_serving_request_latency_ms_bucket\{le="\+Inf"\} 2',
        text)
    assert "paddle_tpu_serving_request_latency_ms_count 2" in text
    les = [int(m.group(1)) for m in re.finditer(
        r'latency_ms_bucket\{le="[^"]+"\} (\d+)', text)]
    assert les == sorted(les)


def test_prometheus_label_escaping(P):
    reg = P.M.MetricsRegistry()
    reg.inc("chaos.injections", site='we"ird\nsite')
    text = reg.prometheus_text()
    assert '\\"' in text and "\\n" in text
    assert "\n\n" not in text


def test_snapshot_is_jsonable(P):
    reg = P.M.MetricsRegistry()
    reg.inc("ckpt.saves")
    reg.observe("ckpt.save.seconds", 0.5)
    snap = json.loads(reg.to_json())
    assert snap["ckpt.saves"]["kind"] == "counter"
    assert snap["ckpt.save.seconds"]["series"][0]["count"] == 1


def _script(reg):
    """One fixed sequence of operations over every kind and labels."""
    reg.inc("serving.requests", 3, outcome="ok")
    reg.inc("serving.requests", outcome="shed_admission")
    reg.inc("request.outcome", reason="finished", tenant="a")
    reg.set_gauge("engine.ticks", 17)
    reg.set_gauge("inference.kv.bytes_per_slot", 1.5e6)
    for v in (0.0004, 0.003, 0.2, 7.0, 400.0):
        reg.observe("request.ttft.seconds", v)
    for v in (1.0, 64.0, 3000.0):
        reg.observe("request.tokens", v)
    reg.observe("serving.request.latency_ms", 12.5)
    reg.inc("chaos.injections", site='we"ird\nsite')


def test_same_operations_same_snapshot_and_prometheus_text():
    regs = {name: obs.metrics.MetricsRegistry()
            for name, obs in PACKAGES.items()}
    for reg in regs.values():
        _script(reg)
    assert regs["port"].snapshot() == regs["jax"].snapshot()
    assert regs["port"].to_json() == regs["jax"].to_json()
    assert regs["port"].prometheus_text() == regs["jax"].prometheus_text()
    assert regs["port"].prometheus_text(exclude={"engine.ticks"}) \
        == regs["jax"].prometheus_text(exclude={"engine.ticks"})
    h = {n: r.histogram("request.ttft.seconds") for n, r in regs.items()}
    for p in (0, 50, 99, 100):
        assert h["port"].percentile(p) == h["jax"].percentile(p)


# -- spans / trace ring ----------------------------------------------------------

def test_span_nesting_and_chrome_export(P):
    P.obs.enable()
    with P.obs.span("outer", step=3):
        with P.obs.span("inner"):
            pass
    evs = P.trace.chrome_events()
    by_name = {e["name"]: e for e in evs}
    assert by_name["inner"]["args"]["depth"] == 1
    assert by_name["outer"]["args"]["depth"] == 0
    assert by_name["outer"]["args"]["step"] == 3
    o, i = by_name["outer"], by_name["inner"]
    assert o["ts"] <= i["ts"]
    assert i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1e-3
    doc = P.trace.export_chrome_trace()
    assert {e["name"] for e in doc["traceEvents"]} == {"outer", "inner"}
    assert doc["displayTimeUnit"] == "ms"


def test_span_ring_is_bounded(P):
    old = P.trace.ring_capacity()
    try:
        P.trace.set_ring_capacity(16)
        P.obs.enable()
        for i in range(100):
            with P.obs.span("s", i=i):
                pass
        spans = P.trace.spans()
        assert len(spans) == 16
        assert spans[-1].attrs["i"] == 99
    finally:
        P.trace.set_ring_capacity(old)


def test_span_records_error_and_disabled_span_is_free(P):
    P.obs.enable()
    with pytest.raises(RuntimeError):
        with P.obs.span("boom"):
            raise RuntimeError("x")
    assert P.trace.spans()[-1].attrs["error"] == "RuntimeError"
    P.obs.disable()
    P.trace.clear()
    assert P.obs.span("a") is P.obs.span("b")
    with P.obs.span("nope"):
        pass
    assert P.trace.spans() == []


def test_export_to_path_and_host_tracer_refused(tmp_path):
    """The port writes the same document to a path; merging the
    profiler's HostTracer events, which the port does not have, raises
    instead of exporting the spans alone."""
    t_obs.enable()
    with t_obs.span("s"):
        pass
    path = tmp_path / "trace.json"
    doc = t_obs.export_chrome_trace(str(path))
    assert json.loads(path.read_text()) == doc
    with pytest.raises(NotImplementedError, match="HostTracer"):
        t_obs.export_chrome_trace(merge_host_tracer=True)


# -- request contexts (tests/test_request_tracing.py) -------------------------

def test_parse_traceparent_valid(P):
    tid, pid, flags = P.req.parse_traceparent(_TP)
    assert tid == _TRACE_ID and pid == "cd" * 8 and flags == 1
    assert P.req.parse_traceparent("  " + _TP + " ") == (tid, pid, 1)


@pytest.mark.parametrize("bad", [
    None, "", "nonsense",
    "00-" + "ab" * 16 + "-" + "cd" * 8,
    "ff-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "0" * 32 + "-" + "cd" * 8 + "-01",
    "00-" + "ab" * 16 + "-" + "0" * 16 + "-01",
    "00-" + "xy" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "ab" * 15 + "-" + "cd" * 8 + "-01",
    _TP + "-extradata",
    _TP.upper(),
])
def test_parse_traceparent_invalid_is_ignored(P, bad):
    assert P.req.parse_traceparent(bad) is None


def test_from_headers_adopts_and_generates(P):
    ctx = P.Ctx.from_headers({"traceparent": _TP,
                              "X-Request-Id": "my-req-7",
                              "X-Tenant-Id": "acme"})
    assert ctx.trace_id == _TRACE_ID
    assert ctx.parent_id == "cd" * 8
    assert ctx.request_id == "my-req-7"
    assert ctx.tenant == "acme"
    out = ctx.traceparent()
    assert out.startswith("00-" + _TRACE_ID + "-")
    assert out.split("-")[2] == ctx.span_id != ctx.parent_id
    fresh = P.Ctx.from_headers({})
    assert fresh.parent_id is None and fresh.tenant is None
    assert len(fresh.trace_id) == 32 and fresh.request_id.startswith(
        "req-")


@pytest.mark.parametrize("bad", [
    "abc\r\nEvil: 1", "abc\rEvil", "abc\nEvil", "abc def",
    "abc\"quoted\"", "x" * 129, "",
])
def test_unsafe_request_id_is_replaced(P, bad):
    ctx = P.Ctx.from_headers({"X-Request-Id": bad})
    assert ctx.request_id.startswith("req-")
    assert P.req.safe_request_id(bad) is None


def test_configure_coerces_thresholds_on_callers_thread(P):
    P.req.configure(slow_ttft_s="0.25", slow_total_s=None)
    assert P.req.CONFIG.slow_ttft_s == 0.25
    assert P.req.CONFIG.slow_total_s is None
    with pytest.raises(ValueError):
        P.req.configure(slow_ttft_s="not-a-number")
    assert P.req.CONFIG.slow_ttft_s == 0.25


def test_the_jax_environment_switches_nothing_in_the_port():
    """The JAX package reads PADDLE_TPU_OBS, PADDLE_TPU_CHAOS* and
    PADDLE_TPU_SLOW_* at import; the port is switched only in-process,
    so a fresh interpreter with all of them set starts with its plane
    and its faults off and no slow-request threshold armed."""
    env = dict(os.environ, PADDLE_TPU_OBS="1", PADDLE_TPU_CHAOS="1",
               PADDLE_TPU_CHAOS_RATES="serving=1", PADDLE_TPU_CHAOS_SEED="3",
               PADDLE_TPU_SLOW_TTFT_S="0.5", PADDLE_TPU_SLOW_TOTAL_S="1.5")
    code = ("from paddle_tpu_torch import observability as o\n"
            "from paddle_tpu_torch.distributed import chaos as c\n"
            "cfg = o.requests.CONFIG\n"
            "print(o.ENABLED, c.ENABLED, c.should_fire('serving.run.fail'),"
            " cfg.slow_ttft_s, cfg.slow_total_s)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False", "False", "None", "None"]


def test_record_rejects_uncatalogued_events(P):
    ctx = P.Ctx.new()
    with pytest.raises(KeyError, match="EVENTS"):
        ctx.record("totally_new_event")


def test_phase_instruments_derive_from_timeline(P):
    ctx = P.Ctx.new()
    ctx.record("queued")
    ctx.record("scheduled")
    ctx.record("prefill_start")
    ctx.record("prefill_end")
    ctx.record_tokens(2)
    ctx.record_tokens(3)
    reg = P.obs.REGISTRY
    for name in ("request.queue_wait.seconds", "request.prefill.seconds",
                 "request.ttft.seconds", "request.itl.seconds"):
        assert reg.histogram(name).count() == 1, name
    assert ctx.tokens == 5
    assert [e[0] for e in ctx.timeline()] == [
        "queued", "scheduled", "prefill_start", "prefill_end",
        "first_token", "tokens", "tokens"]


def test_queue_wait_clock_is_per_row(P):
    ctx = P.Ctx.new()
    t0 = ctx.record("queued", rid=0)
    time.sleep(0.05)
    ctx.record("queued", rid=1)
    time.sleep(0.01)
    t_sched = ctx.record("scheduled", rid=0)
    assert t_sched - t0 >= 0.05
    h = P.obs.REGISTRY.histogram("request.queue_wait.seconds")
    assert h.count() == 1
    assert h.percentile(50) >= 0.05
    ctx.record("scheduled", rid=1)
    assert h.count() == 2
    ctx.record("scheduled", rid=1)
    assert h.count() == 2
    ctx.record("prefill_start", rid=0)
    ctx.record("prefill_start", rid=1)
    ctx.record("prefill_end", rid=0)
    ctx.record("prefill_end", rid=1)
    hp = P.obs.REGISTRY.histogram("request.prefill.seconds")
    assert hp.count() == 2
    ctx.record("prefill_end", rid=1)
    assert hp.count() == 2


def test_itl_gap_clock_is_per_stream(P):
    ctx = P.Ctx.new()
    ctx.record_tokens(1, stream="a")
    ctx.record_tokens(1, stream="b")
    h = P.obs.REGISTRY.histogram("request.itl.seconds")
    assert h.count() == 0
    time.sleep(0.012)
    ctx.record_tokens(1, stream="a")
    ctx.record_tokens(1, stream="b")
    assert h.count() == 2
    assert h.percentile(0) >= 0.01


def test_terminal_event_survives_a_full_timeline(P):
    P.req.configure(max_events=4)
    ctx = P.Ctx.new()
    for _ in range(10):
        ctx.record_tokens(1)
    assert len(ctx.timeline()) == 4 and ctx.dropped_events == 6
    ctx.finish("finished")
    assert ctx.timeline()[-1][0] == "finished"
    assert ctx.stage() == "finished"


def test_finish_is_idempotent_first_reason_wins(P):
    ctx = P.req.register(P.Ctx.new())
    ctx.record_tokens(4)
    assert P.req.live_count() == 1
    assert ctx.finish("finished") is True
    assert ctx.finish("server_error") is False
    assert ctx.outcome == "finished"
    assert P.req.live_count() == 0
    reg = P.obs.REGISTRY
    assert reg.counter("request.outcome").value(reason="finished") == 1
    assert reg.counter("request.outcome").value(reason="server_error") == 0
    assert reg.histogram("request.tokens").percentile(50) == 4


@pytest.mark.parametrize("reason,event", [
    ("ok", "finished"), ("finished", "finished"),
    ("deadline_exceeded", "expired"), ("expired", "expired"),
    ("shed_engine", "shed"), ("shed_tenant", "shed"),
    ("cancelled", "cancelled"), ("disconnected", "disconnected"),
    ("server_error", "error"), ("error", "error")])
def test_terminal_event_of_each_outcome(P, reason, event):
    ctx = P.Ctx.new()
    ctx.tenant_key = "t"
    ctx.finish(reason)
    assert ctx.timeline()[-1][0] == event
    assert P.obs.REGISTRY.counter("request.outcome").value(
        reason=reason, tenant="t") == 1


def test_no_recording_past_the_terminal_event(P):
    ctx = P.Ctx.new()
    ctx.record("queued")
    ctx.finish("deadline_exceeded")
    ctx.record("scheduled")
    ctx.record_tokens(5)
    assert [e[0] for e in ctx.timeline()] == ["queued", "expired"]
    assert ctx.tokens == 0
    reg = P.obs.REGISTRY
    assert reg.histogram("request.queue_wait.seconds").count() == 0
    assert reg.histogram("request.ttft.seconds").count() == 0


def test_engine_refcount_last_row_finishes_abnormal_reason_wins(P):
    ctx = P.req.register(P.Ctx.new())
    ctx.adopt_engine()
    ctx.adopt_engine()
    assert ctx.engine_finish("expired") is False
    assert not ctx.finished
    assert P.req.live_count() == 1
    assert ctx.engine_finish("finished") is True
    assert ctx.outcome == "expired"
    assert P.req.live_count() == 0


def test_live_registry_and_timeline_are_bounded(P):
    P.req.configure(live_capacity=4, max_events=8)
    ctxs = [P.req.register(P.Ctx.new()) for _ in range(7)]
    assert P.req.live_count() == 4
    live_ids = {r["request_id"] for r in P.req.live_requests()}
    assert live_ids == {c.request_id for c in ctxs[3:]}
    ctx = ctxs[-1]
    for _ in range(20):
        ctx.record("queued")
    assert len(ctx.timeline()) == 8
    assert ctx.dropped_events == 12


def test_slow_request_exemplar_dumps_nested_spans(P):
    P.req.configure(slow_ttft_s=0.0)
    ctx = P.req.register(P.Ctx.from_headers({"traceparent": _TP}))
    ctx.record("queued")
    ctx.record("scheduled")
    ctx.record_tokens(1)
    ctx.record_tokens(1)
    ctx.finish("finished")
    assert P.obs.REGISTRY.counter("request.slow_exemplars").value() == 1
    evs = P.trace.chrome_events()
    by_name = {e["name"]: e for e in evs}
    root = by_name["request"]
    assert root["args"]["request_id"] == ctx.request_id
    assert root["args"]["trace_id"] == _TRACE_ID
    assert root["args"]["outcome"] == "finished"
    assert by_name["queue_wait"]["args"]["depth"] == 1
    assert by_name["decode"]["args"]["depth"] == 1
    assert by_name["ev.first_token"]["args"]["depth"] == 2
    assert len({e["tid"] for e in evs}) == 1
    P.trace.clear()
    P.req.configure(slow_ttft_s=1e9)
    c2 = P.Ctx.new()
    c2.record_tokens(1)
    c2.finish("finished")
    assert P.trace.spans() == []


def test_contextvar_binding_and_reset(P):
    """current() is None until a context is bound; a copied contextvars
    context carries the binding into another thread."""
    import contextvars
    assert P.req.current() is None
    ctx = P.Ctx.new()
    token = P.req.set_current(ctx)
    try:
        seen = []
        run = contextvars.copy_context()
        t = threading.Thread(target=run.run,
                             args=(lambda: seen.append(P.req.current()),))
        t.start()
        t.join(timeout=10)
        assert seen == [ctx]
    finally:
        P.req.reset_current(token)
    assert P.req.current() is None


def test_same_timeline_same_instruments():
    """One request timeline recorded into each package's context drives
    the same request.* cells: the same counts, outcome labels, token
    histogram and event sequence."""
    out = {}
    for name, obs in PACKAGES.items():
        obs.enable()
        ctx = obs.requests.register(obs.requests.RequestContext.from_headers(
            {"traceparent": _TP, "X-Request-Id": "r-1"}))
        ctx.tenant_key = "acme"
        ctx.adopt_engine()
        ctx.adopt_engine()
        for rid in (0, 1):
            ctx.record("queued", rid=rid)
        for rid in (0, 1):
            ctx.record("scheduled", rid=rid, slot=rid)
            ctx.record("prefill_start", rid=rid)
            ctx.record("prefill_end", rid=rid)
        for n in (1, 4, 4, 2):
            for rid in (0, 1):
                ctx.record_tokens(n, stream=rid)
        ctx.engine_finish("finished")
        ctx.engine_finish("expired")
        snap = obs.REGISTRY.snapshot()
        out[name] = (
            [e[0] for e in ctx.timeline()], ctx.tokens, ctx.outcome,
            {k: [(s["labels"], s.get("count", s.get("value")))
                 for s in v["series"]] for k, v in snap.items()},
            snap["request.tokens"], obs.requests.live_count())
    assert out["port"] == out["jax"]
    assert out["port"][1] == 22 and out["port"][2] == "expired"
