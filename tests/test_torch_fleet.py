"""The port's fleet plane and flight recorder
(paddle_tpu_torch/observability/fleet.py) and its wiring into the port's
server and router, against the JAX package's, on the CPU.

The cases of tests/test_fleet_telemetry.py that cover fleet.py and the
serving wiring run over both packages (the `P` fixture: one package's
observability, chaos, fleet module and server). The JAX side runs over
its own TCPStore, the port side over `torch.distributed.TCPStore`, whose
`check` takes a list of keys. Beside them: the port's aggregator scans
beats that the JAX heartbeat published into one torch store and gives the
JAX aggregator's view apart from times; the port's flight config reads
no environment variable; a tensor off the CPU is never read by the
heartbeat. Trainer.fleet_heartbeat and run_resilient wait for the port's
telemetry and elastic modules (ROADMAP). Every publisher, aggregator and
server is stopped in a `finally`; probes and scans are explicit calls.
"""
import ast
import datetime
import json
import os
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
import torch
import torch.distributed as tdist

import paddle_tpu.inference.serving as j_serving
import paddle_tpu_torch.inference.serving as t_serving
from paddle_tpu import observability as j_obs
from paddle_tpu.distributed import chaos as j_chaos
from paddle_tpu.distributed.store import TCPStore as JaxStore
from paddle_tpu.observability import fleet as j_fleet
from paddle_tpu_torch import observability as t_obs
from paddle_tpu_torch.distributed import chaos as t_chaos
from paddle_tpu_torch.observability import fleet as t_fleet

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _torch_store(world_size=4):
    return tdist.TCPStore("127.0.0.1", 0, world_size, True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=5))


PACKAGES = {
    "jax": types.SimpleNamespace(
        name="jax", obs=j_obs, chaos=j_chaos, fleet=j_fleet, srv=j_serving,
        new_store=lambda ws=4: JaxStore(is_master=True, world_size=ws,
                                        timeout=5.0),
        has=lambda store, key: store.check(key),
        src=os.path.join(_ROOT, "paddle_tpu", "observability", "fleet.py")),
    "port": types.SimpleNamespace(
        name="port", obs=t_obs, chaos=t_chaos, fleet=t_fleet, srv=t_serving,
        new_store=_torch_store,
        has=lambda store, key: store.check([key]),
        src=os.path.join(_ROOT, "paddle_tpu_torch", "observability",
                         "fleet.py"))}


def _close(store):
    """The JAX store closes; torch's has no close (its server goes with
    the object)."""
    close = getattr(store, "close", None)
    if close is not None:
        close()


@pytest.fixture(params=sorted(PACKAGES))
def P(request):
    return PACKAGES[request.param]


@pytest.fixture
def store(P):
    s = P.new_store()
    yield s
    _close(s)


@pytest.fixture(autouse=True)
def _clean_slate():
    """Observability, chaos and the flight recorders are process-global;
    every test starts disabled/disarmed and leaves the process the same
    way."""
    def reset():
        for p in PACKAGES.values():
            p.obs.disable()
            p.obs.REGISTRY.reset()
            p.chaos.disable()
            p.fleet.clear()
            p.fleet.configure_flight_recorder(dir=None, max_keep=5)
    reset()
    yield
    reset()


def _beat(P, store, rank, step, tokens_per_sec=10.0, ws=3):
    """Publish one synthetic heartbeat for `rank` (no thread)."""
    hb = P.fleet.FleetHeartbeat(
        store, rank, ws, interval=60.0,
        sample_fn=lambda: {"step": step,
                           "tokens_per_sec": tokens_per_sec})
    hb.publish()
    hb.stop()
    return hb


# -- heartbeats + aggregation (tests/test_fleet_telemetry.py) -----------------

def test_multi_rank_aggregation_over_a_real_store_server(P, monkeypatch):
    """Three publisher threads beating into a real store server (the JAX
    side with its native client/server forced off, the port side over
    torch's TCPStore), one aggregator scanning them into a clean
    healthy-fleet view with summed throughput and no stragglers."""
    if P.name == "jax":
        import paddle_tpu._native as native
        from paddle_tpu.distributed.store import _PyStoreServer
        monkeypatch.setattr(native, "load", lambda: None)
        master = JaxStore(is_master=True, world_size=3, timeout=5.0)
        assert isinstance(master._server, _PyStoreServer)
    else:
        master = _torch_store(3)
    obs, fleet = P.obs, P.fleet
    obs.enable(reset=True)
    hbs = [fleet.FleetHeartbeat(
        master, r, 3, interval=0.05,
        sample_fn=lambda r=r: {"step": 200, "tokens_per_sec": 5.0})
        for r in range(3)]
    try:
        for hb in hbs:
            hb.start()          # first beat is synchronous
        agg = fleet.FleetAggregator(master, 3, stale_after_s=30.0,
                                    straggler_steps=50)
        deadline = time.time() + 5.0
        while time.time() < deadline and any(hb.beats < 2 for hb in hbs):
            time.sleep(0.02)
        assert all(hb.beats >= 2 for hb in hbs)
        view = agg.scan()
    finally:
        for hb in hbs:
            hb.stop()
        _close(master)
    s = view["summary"]
    assert s["present"] == 3 and s["stale_ranks"] == 0
    assert s["stragglers"] == [] and s["step_skew"] == 0.0
    assert s["fleet_tokens_per_sec"] == pytest.approx(15.0)
    assert obs.REGISTRY.gauge("fleet.stragglers").value() == 0.0
    assert obs.REGISTRY.counter("fleet.heartbeats").value() >= 6
    assert fleet.last_view() is view


def test_straggler_flagged_on_step_lag(P, store):
    P.obs.enable(reset=True)
    for r, step in ((0, 500), (1, 120), (2, 505)):
        _beat(P, store, r, step)
    view = P.fleet.FleetAggregator(store, 3, stale_after_s=30.0,
                                   straggler_steps=100).scan()
    rows = {r["rank"]: r for r in view["ranks"]}
    assert rows[1]["straggler"] and rows[1]["lag"] == 380.0
    assert not rows[0]["straggler"] and not rows[2]["straggler"]
    assert view["summary"]["stragglers"] == [1]
    assert view["summary"]["step_skew"] == 385.0
    assert view["summary"]["step_lag"] == 380.0
    g = P.obs.REGISTRY.gauge("fleet.straggler")
    assert g.value(rank=1) == 1.0
    assert g.value(rank=0) == 0.0 and g.value(rank=2) == 0.0


def test_straggler_stale_rank_deterministic_under_chaos_drop(P, store):
    """`fleet.heartbeat.drop` at rate 1.0 suppresses every publish of the
    victim rank: its last beat ages past stale_after_s while peers stay
    fresh, and the detector flags exactly that rank."""
    P.obs.enable(reset=True)
    for r in range(3):
        _beat(P, store, r, 300)
    victim = P.fleet.FleetHeartbeat(
        store, 1, 3, interval=60.0,
        sample_fn=lambda: {"step": 300, "tokens_per_sec": 1.0})
    time.sleep(0.15)
    with P.chaos.scoped(seed=7, rates={"fleet.heartbeat.drop": 1.0}):
        for _ in range(3):
            assert victim.publish() is False
        assert P.chaos.fire_count("fleet.heartbeat.drop") == 3
    victim.stop()
    _beat(P, store, 0, 303)
    _beat(P, store, 2, 303)
    view = P.fleet.FleetAggregator(store, 3, stale_after_s=0.1,
                                   straggler_steps=1000).scan()
    rows = {r["rank"]: r for r in view["ranks"]}
    assert rows[1]["stale"] and rows[1]["straggler"]
    assert not rows[0]["stale"] and not rows[2]["stale"]
    assert view["summary"]["stale_ranks"] == 1
    assert view["summary"]["stragglers"] == [1]
    assert P.obs.REGISTRY.gauge("fleet.stale_ranks").value() == 1.0


def test_chaos_delay_ages_the_published_beat(P, store):
    P.obs.enable(reset=True)
    hb = P.fleet.FleetHeartbeat(store, 0, 1, interval=60.0,
                                sample_fn=lambda: {"step": 1})
    with P.chaos.scoped(seed=0, rates={"fleet.heartbeat.delay": 1.0},
                        delay_ms=80):
        assert hb.publish() is True
        assert P.chaos.fire_count("fleet.heartbeat.delay") == 1
    hb.stop()
    snap = json.loads(store.get("fleet/hb/0").decode())
    assert time.time() - snap["time"] >= 0.07


def test_missing_rank_counts_stale_and_straggler(P, store):
    P.obs.enable(reset=True)
    _beat(P, store, 0, 50)                  # rank 1 never beats
    t0 = time.monotonic()
    view = P.fleet.FleetAggregator(store, 2, stale_after_s=30.0).scan()
    # check() first: the missing key costs no blocking get()
    assert time.monotonic() - t0 < 2.0
    rows = {r["rank"]: r for r in view["ranks"]}
    assert rows[1]["present"] is False and rows[1]["stale"]
    assert rows[1]["straggler"]
    assert view["summary"]["present"] == 1
    assert P.obs.REGISTRY.counter("fleet.heartbeat.errors").value() == 0


def test_registry_sample_reads_shared_instruments(P):
    obs = P.obs
    obs.enable(reset=True)
    obs.inc("train.steps", 7)
    obs.set_gauge("train.tokens_per_sec", 123.0)
    obs.set_gauge("train.mfu", 0.41)
    obs.inc("train.recompiles", shape="a")
    obs.inc("train.recompiles", shape="b")
    obs.set_gauge("checkpoint.async.pending", 1.0)
    assert P.fleet.registry_sample() == {
        "step": 7, "tokens_per_sec": 123.0, "mfu": 0.41, "recompiles": 2,
        "ckpt_async_pending": 1.0}


def test_registry_sample_carries_sentry_health(P):
    obs = P.obs
    obs.enable(reset=True)
    assert "steps_since_good" not in P.fleet.registry_sample()
    obs.set_gauge("train.sentry.steps_since_good", 37.0)
    obs.inc("train.sentry.triggers", reason="loss_spike")
    obs.inc("train.sentry.triggers", reason="nonfinite_grad")
    s = P.fleet.registry_sample()
    assert s["steps_since_good"] == 37.0
    assert s["sentry_triggers"] == 2


def test_snapshot_is_compact_and_bounded(P, store):
    P.obs.enable(reset=True)
    big = {f"k{i:03d}": float(i) + 0.123456 for i in range(100)}
    hb = P.fleet.FleetHeartbeat(store, 0, 1, interval=60.0,
                                sample_fn=lambda: big)
    hb.publish()
    hb.stop()
    raw = store.get("fleet/hb/0")
    snap = json.loads(raw.decode())
    assert len(snap) <= 24
    assert snap["k000"] == 0.1235
    assert b" " not in raw


def test_snapshot_coerces_numpy_scalars(P, store):
    P.obs.enable(reset=True)
    hb = P.fleet.FleetHeartbeat(
        store, 0, 1, interval=60.0,
        sample_fn=lambda: {"step": np.int64(7),
                           "tokens_per_sec": np.float32(2.5),
                           "weird": object()})
    assert hb.publish() is True
    hb.stop()
    snap = json.loads(store.get("fleet/hb/0").decode())
    assert snap["step"] == 7 and snap["tokens_per_sec"] == 2.5
    assert isinstance(snap["weird"], str)


def test_port_snapshot_takes_cpu_tensors_and_never_reads_a_device_one():
    """0-d CPU tensors coerce like numbers; a tensor on another device is
    shipped as a string without being read (reading a CUDA tensor would
    synchronise the device from the heartbeat thread: a meta tensor,
    which cannot be read at all, stands in for it here)."""
    store = _torch_store(1)
    t_obs.enable(reset=True)
    try:
        hb = t_fleet.FleetHeartbeat(
            store, 0, 1, interval=60.0,
            sample_fn=lambda: {
                "step": torch.tensor(9), "tokens_per_sec": torch.tensor(1.5),
                "queue_depth": torch.tensor(3.0, device="meta")})
        assert hb.publish() is True
        hb.stop()
        snap = json.loads(store.get("fleet/hb/0").decode())
    finally:
        _close(store)
    assert snap["step"] == 9 and snap["tokens_per_sec"] == 1.5
    assert snap["queue_depth"] == "<tensor on meta>"


def test_scan_max_age_serves_cached_view(P, store):
    P.obs.enable(reset=True)
    _beat(P, store, 0, 10, ws=1)
    agg = P.fleet.FleetAggregator(store, 1, stale_after_s=30.0)
    v1 = agg.scan()
    _beat(P, store, 0, 99, ws=1)
    assert agg.scan(max_age_s=60.0) is v1
    v2 = agg.scan()
    assert v2["ranks"][0]["step"] == 99


def _strip_times(view):
    """A view without its wall-clock fields (scan time, beat stamps and
    ages)."""
    out = dict(view, time=None)
    out["ranks"] = [{k: v for k, v in r.items() if k not in ("time",
                                                               "age_s")}
                    for r in view["ranks"]]
    return out


class _KeyCheck:
    """The JAX duck-typed store contract (`check(key)`) over torch's
    Store, whose `check` takes a list of keys."""

    def __init__(self, store):
        self._s = store

    def check(self, key):
        return self._s.check([key])

    def get(self, key):
        return self._s.get(key)


def test_port_aggregator_reads_jax_beats_in_one_torch_store():
    """The JAX heartbeat publishes into a torch TCPStore; the port's
    aggregator scans it into the view the JAX aggregator gives over the
    same beats, apart from times; and the two heartbeat classes publish
    the same snapshot for the same sample."""
    store = _torch_store(3)
    j_obs.enable(reset=True)
    t_obs.enable(reset=True)
    try:
        for r, step in ((0, 500), (1, 120), (2, 505)):
            _beat(PACKAGES["jax"], store, r, step, tokens_per_sec=2.5)
        kw = dict(stale_after_s=30.0, straggler_steps=100)
        port_view = t_fleet.FleetAggregator(store, 4, **kw).scan()
        jax_view = j_fleet.FleetAggregator(_KeyCheck(store), 4,
                                           **kw).scan()
        assert port_view["summary"]["stragglers"] == [1, 3]
        assert port_view["ranks"][3]["present"] is False
        assert _strip_times(port_view) == _strip_times(jax_view)
        snaps = []
        for fleet in (j_fleet, t_fleet):
            hb = fleet.FleetHeartbeat(
                store, 0, 1, interval=60.0,
                sample_fn=lambda: {"step": np.int64(3), "q": 1.25,
                                   "n": np.float32(4.0)})
            assert hb.publish() is True
            hb.stop()
            snaps.append(json.loads(store.get("fleet/hb/0").decode()))
            snaps[-1].pop("time")
        assert snaps[0] == snaps[1]
    finally:
        _close(store)
        j_obs.disable()
        t_obs.disable()


# -- serving: GET /debug/fleet --------------------------------------------------

def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def test_debug_fleet_endpoint(P, store):
    P.obs.enable(reset=True)
    for r, step in ((0, 200), (1, 10)):
        _beat(P, store, r, step, ws=2)      # median 105; rank 1 lags 95
    agg = P.fleet.FleetAggregator(store, 2, stale_after_s=30.0,
                                  straggler_steps=50)
    srv = P.srv.PredictorServer(lambda d: d, fleet=agg).start()
    try:
        status, body = _get(srv.port, "/debug/fleet")
        assert status == 200 and body["enabled"] is True
        view = body["view"]
        assert view["world_size"] == 2
        assert {r["rank"] for r in view["ranks"]} == {0, 1}
        assert view["summary"]["stragglers"] == [1]
        P.obs.disable()
        status, body = _get(srv.port, "/debug/fleet")
        assert status == 200 and body == {"enabled": False, "view": None}
    finally:
        srv.stop()


def test_debug_fleet_without_aggregator(P):
    P.obs.enable(reset=True)
    srv = P.srv.PredictorServer(lambda d: d).start()
    try:
        status, body = _get(srv.port, "/debug/fleet")
        assert status == 200 and body == {"enabled": False, "view": None}
    finally:
        srv.stop()


# -- flight recorder ------------------------------------------------------------

def test_flight_bundle_schema(P, tmp_path, store):
    obs, fleet = P.obs, P.fleet
    obs.enable(reset=True)
    _beat(P, store, 0, 42, ws=1)
    fleet.FleetAggregator(store, 1).scan()
    obs.inc("train.steps")
    fleet.configure_flight_recorder(dir=str(tmp_path), max_keep=5)
    try:
        raise ValueError("engine on fire")
    except ValueError as e:
        path = fleet.record_crash("unit_test", exc=e, extra={"note": 7})
    assert path is not None and os.path.isdir(path)
    assert sorted(os.listdir(path)) == sorted(fleet.BUNDLE_FILES)
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["version"] == 1 and man["reason"] == "unit_test"
    assert man["exception"] == {"type": "ValueError",
                                "message": "engine on fire"}
    assert man["extra"] == {"note": 7}
    assert sorted(man["files"]) == sorted(fleet.BUNDLE_FILES)
    with open(os.path.join(path, "metrics.json")) as f:
        assert json.load(f)["train.steps"]["series"][0]["value"] == 1
    with open(os.path.join(path, "fleet.json")) as f:
        fl = json.load(f)
    assert fl["available"] and fl["view"]["ranks"][0]["step"] == 42
    with open(os.path.join(path, "traceback.txt")) as f:
        tb = f.read()
    assert "engine on fire" in tb and "all thread stacks" in tb
    with open(os.path.join(path, "requests.json")) as f:
        assert json.load(f) == {"count": 0, "requests": []}
    assert obs.REGISTRY.counter("fleet.flight.records").value(
        reason="unit_test") == 1


def test_flight_retention_keeps_newest(P, tmp_path):
    P.obs.enable(reset=True)
    P.fleet.configure_flight_recorder(dir=str(tmp_path), max_keep=3)
    paths = [P.fleet.record_crash(f"r{i}") for i in range(5)]
    kept = P.fleet.flight_records(str(tmp_path))
    assert len(kept) == 3 and kept == sorted(paths[-3:])
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_flight_disarmed_is_noop(P):
    P.obs.enable(reset=True)
    assert P.fleet.FLIGHT.dir is None
    assert P.fleet.record_crash("nothing") is None
    assert P.fleet.flight_records() == []


def test_obs_dump_round_trip(P, tmp_path, store):
    """tools/obs_dump.py parses a real bundle back (load) and renders the
    straggler + exception story (render); the CLI resolves a flight dir
    to its newest bundle."""
    P.obs.enable(reset=True)
    for r, step in ((0, 900), (1, 100)):
        _beat(P, store, r, step, ws=2)
    P.fleet.FleetAggregator(store, 2, straggler_steps=50,
                            stale_after_s=30.0).scan()
    P.fleet.configure_flight_recorder(dir=str(tmp_path))
    try:
        raise RuntimeError("watchdog says no")
    except RuntimeError as e:
        bundle = P.fleet.record_crash("watchdog_abort", exc=e)
    from tools import obs_dump
    doc = obs_dump.load(bundle)
    assert doc["manifest"]["reason"] == "watchdog_abort"
    assert doc["fleet"]["view"]["summary"]["stragglers"] == [1]
    text = obs_dump.render(bundle)
    assert "watchdog_abort" in text
    assert "RuntimeError: watchdog says no" in text
    assert "STRAGGLER" in text and "rank 1" in text
    assert obs_dump.resolve(str(tmp_path)) == bundle
    assert obs_dump.main([str(tmp_path)]) == 0
    assert obs_dump.main([bundle, "--json"]) == 0
    assert obs_dump.main([str(tmp_path / "nope")]) == 1


def test_serving_drain_dumps_bundle(P, tmp_path):
    P.obs.enable(reset=True)
    P.fleet.configure_flight_recorder(dir=str(tmp_path))
    srv = P.srv.PredictorServer(lambda d: d).start()
    assert srv.drain(timeout=1.0)
    bundles = P.fleet.flight_records(str(tmp_path))
    assert len(bundles) == 1 and bundles[0].endswith("serving_drain")
    with open(os.path.join(bundles[0], "manifest.json")) as f:
        assert json.load(f)["extra"]["stats"]["draining"] is True


def test_serving_drain_survives_a_failing_recorder(P, tmp_path,
                                                   monkeypatch, capsys):
    """Recording never breaks the drain: a raising record_crash is
    reported on stderr and the server still drains and stops."""
    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(P.fleet, "record_crash", boom)
    P.obs.enable(reset=True)
    srv = P.srv.PredictorServer(lambda d: d).start()
    assert srv.drain(timeout=1.0)
    assert "flight-recorder dump failed" in capsys.readouterr().err


# -- disabled path: one attribute check, no threads, no store keys ------------

def test_disabled_path_zero_side_effects(P, tmp_path, store, monkeypatch):
    """With observability disabled: serving drain never reaches the
    flight recorder, no thread appears, and the store carries no fleet
    keys; on the JAX side Trainer.fleet_heartbeat also never constructs
    a FleetHeartbeat (the port's Trainer gains it with telemetry.py)."""
    assert P.obs.ENABLED is False
    before_threads = set(threading.enumerate())

    def _boom(*a, **k):
        raise AssertionError("FleetHeartbeat constructed while "
                             "observability is disabled")
    monkeypatch.setattr(P.fleet.FleetHeartbeat, "__init__", _boom)
    if P.name == "jax":
        from paddle_tpu.parallel.trainer import Trainer
        t = object.__new__(Trainer)
        assert Trainer.fleet_heartbeat(t, store, 0, 1) is None
    P.fleet.configure_flight_recorder(dir=str(tmp_path))
    srv = P.srv.PredictorServer(lambda d: d).start()
    assert srv.drain(timeout=1.0)
    assert P.fleet.flight_records(str(tmp_path)) == []
    assert not P.has(store, "fleet/hb/0")
    leaked = [th for th in threading.enumerate()
              if th not in before_threads and th.is_alive()
              and th.name.startswith("fleet-")]
    assert leaked == []


# -- satellites -----------------------------------------------------------------

def test_fleet_catalogue_and_call_sites_agree_both_directions(P):
    """Every inc/observe/set_gauge literal in the package's fleet.py is
    catalogued, and every catalogued fleet.* instrument is recorded by a
    literal call site there."""
    with open(P.src) as f:
        tree = ast.parse(f.read())
    seen = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("inc", "observe", "set_gauge"):
            arg = node.args[0]
            assert isinstance(arg, ast.Constant) and \
                isinstance(arg.value, str), \
                f"non-literal metric name at fleet.py:{node.lineno}"
            assert arg.value in P.obs.METRICS, arg.value
            seen.add(arg.value)
    missing = {n for n in P.obs.METRICS if n.startswith("fleet.")} - seen
    assert not missing, f"catalogued but never recorded: {missing}"


def test_fleet_chaos_sites_registered(P):
    assert "fleet.heartbeat.delay" in P.chaos.POINTS
    assert "fleet.heartbeat.drop" in P.chaos.POINTS


def test_store_clone_is_independent_connection(P, store):
    c = store.clone()
    try:
        c.set("via-clone", b"1")
        assert store.get("via-clone") == b"1"
        assert c is not store
        if P.name == "jax":
            assert c._server is None        # never server-owning
    finally:
        _close(c)
    store.set("after-clone-close", b"1")
    assert store.get("after-clone-close") == b"1"


def test_port_heartbeat_publishes_on_a_clone_of_a_torch_store():
    """torch's TCPStore has clone() and no close(): the heartbeat
    publishes on its own connection and stop() treats the missing close
    as best effort."""
    store = _torch_store(1)
    try:
        hb = t_fleet.FleetHeartbeat(store, 0, 1, interval=60.0,
                                    sample_fn=lambda: {"step": 1})
        assert hb._pub_store is not store
        assert hasattr(hb._pub_store, "clone")
        assert not hasattr(hb._pub_store, "close")
        assert hb.publish() is True
        hb.stop()
        assert store.check([hb.key])
    finally:
        _close(store)


def test_port_flight_config_reads_no_environment(monkeypatch, tmp_path):
    """The JAX recorder arms itself from PADDLE_TPU_FLIGHT_DIR /
    PADDLE_TPU_FLIGHT_KEEP at import; the port's starts disarmed with
    max_keep 5 whatever the environment says, and only
    configure_flight_recorder arms it."""
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_KEEP", "2")
    jcfg = j_fleet._FlightConfig()
    assert (jcfg.dir, jcfg.max_keep) == (str(tmp_path), 2)
    tcfg = t_fleet._FlightConfig()
    assert (tcfg.dir, tcfg.max_keep) == (None, 5)
    with open(t_fleet.__file__) as f:
        tree = ast.parse(f.read())
    names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    assert not ({"environ", "getenv", "putenv"} & names)
    t_obs.enable(reset=True)
    assert t_fleet.record_crash("unarmed") is None
    assert os.listdir(tmp_path) == []
