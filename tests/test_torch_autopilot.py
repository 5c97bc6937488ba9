"""The port's fleet autopilot (paddle_tpu_torch/inference/autopilot.py)
against the JAX package's, on the CPU.

Every case of tests/test_autopilot.py runs over both packages (the `pkg`
fixture: one package's router, servers, autopilot, chaos, retries,
observability and flight recorder) with the JAX tests' assertions:
kill -> restart -> serving under live traffic with zero hangs, a rolling
swap with zero failed requests that never drops below N-1, crash-loop
quarantine after exactly K spawns with its `replica_crash_loop` bundle,
the chaos launch levers, the probation gate, the autoscaler's hysteresis,
cooldown and bounds, rollout abort and rollback, /debug/autopilot and
the /stats rollout block, and the loops' threads joined by stop().
Backoff delays come from the un-jittered RetryPolicy exponential and
every wait drives the real control loops (`router.probe_all()` +
`supervisor.tick()`) instead of sleeping.

Beside them, one engine-backed case: two f32 tiny-Llama port engines
loaded from one numpy state dict (`from_paddle_tpu_state`) as supervised
replicas behind the port's router. A killed replica is relaunched and
its greedy tokens equal the JAX engine's; a rollout to a second state
dict gives the JAX engine's tokens over that one.
"""
import ast
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu.distributed.retries as j_retries
import paddle_tpu.inference.autopilot as j_autopilot
import paddle_tpu.inference.router as j_router
import paddle_tpu.inference.serving as j_serving
import paddle_tpu_torch.distributed.retries as t_retries
import paddle_tpu_torch.inference.autopilot as t_autopilot
import paddle_tpu_torch.inference.router as t_router
import paddle_tpu_torch.inference.serving as t_serving
from paddle_tpu import observability as j_obs
from paddle_tpu.distributed import chaos as j_chaos
from paddle_tpu.inference.paged import PagedKVEngine as JEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu.observability import fleet as j_fleet
from paddle_tpu_torch import observability as t_obs
from paddle_tpu_torch.distributed import chaos as t_chaos
from paddle_tpu_torch.inference.paged import PagedKVEngine as TEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import from_paddle_tpu_state
from paddle_tpu_torch.observability import fleet as t_fleet

from conftest import wait_for

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BODY = {"inputs": {"x": [[1.0, 2.0]]}}
PACKAGES = {
    "jax": types.SimpleNamespace(
        name="jax", obs=j_obs, chaos=j_chaos, fleet=j_fleet,
        retries=j_retries, rt=j_router, srv=j_serving, ap=j_autopilot,
        src=os.path.join(_ROOT, "paddle_tpu", "inference",
                         "autopilot.py")),
    "port": types.SimpleNamespace(
        name="port", obs=t_obs, chaos=t_chaos, fleet=t_fleet,
        retries=t_retries, rt=t_router, srv=t_serving, ap=t_autopilot,
        src=os.path.join(_ROOT, "paddle_tpu_torch", "inference",
                         "autopilot.py"))}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture(autouse=True)
def _clean_slate():
    def reset():
        for p in PACKAGES.values():
            p.obs.disable()
            p.obs.REGISTRY.reset()
            p.chaos.disable()
            p.fleet.configure_flight_recorder(dir=None, max_keep=5)
    reset()
    yield
    reset()


# -- helpers (tests/test_autopilot.py) ------------------------------------------

def _pred(inputs):
    return {"y": np.asarray([[2.0]], np.float32)}


def _factory(p):
    return lambda slot, version: p.srv.PredictorServer(
        _pred, model_name=f"{slot}@{version}")


def _fast_policy(p):
    """Un-jittered exponential starting tiny: restarts are fast AND the
    schedule is exactly reproducible."""
    return p.retries.RetryPolicy(base_delay=0.01, max_delay=0.05)


def _pump(router, sup):
    return lambda: (router.probe_all(), sup.tick())


def _mk_supervised_fleet(p, n=3, version="v1", factory=None, **sup_kw):
    """(router, launcher, supervisor) with n supervised slots serving;
    the router's HTTP front end is up, probing is manual."""
    router = p.rt.ReplicaRouter()
    launcher = p.ap.InProcessLauncher(factory or _factory(p),
                                      drain_timeout_s=5.0)
    sup = p.ap.ReplicaSupervisor(router, launcher,
                                 retry_policy=_fast_policy(p),
                                 ready_timeout_s=10.0, **sup_kw)
    for i in range(n):
        sup.add_slot(f"r{i}", version=version)
    router.start(probe=False)
    wait_for(lambda: router.in_rotation_count() == n,
             what="supervised fleet in rotation", tick=_pump(router, sup))
    return router, launcher, sup


def _teardown(router, sup):
    for name in list(sup.slot_names()):
        sup.remove_slot(name)
    router.stop()


def _req(port, path, obj=None, headers=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = None if obj is None else json.dumps(obj).encode()
    r = urllib.request.Request(url, data=data,
                               headers={"Content-Type": "application/json",
                                        **(headers or {})})
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, json.loads(body) if body else {}, dict(e.headers)


class _Traffic:
    """Background request loop against the router: every request's
    status (or raised exception) is recorded, so 'zero client hangs' and
    'zero failed requests' are direct assertions on the log."""

    def __init__(self, port, n_threads=2):
        self.port = port
        self.statuses = []
        self.errors = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, daemon=True)
                         for _ in range(n_threads)]

    def _run(self):
        while not self._stop.is_set():
            try:
                code, _b, _h = _req(self.port, "/predict", _BODY)
                with self._lock:
                    self.statuses.append(code)
            except Exception as e:      # noqa: BLE001 — the soak asserts on what arrived
                with self._lock:
                    self.errors.append(repr(e))
            time.sleep(0.002)

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30)      # a join timeout IS the hang detector
        assert not any(t.is_alive() for t in self._threads), \
            "traffic client hung"


# -- registry pins ----------------------------------------------------------------

def test_autopilot_chaos_sites_registered(pkg):
    for site in ("autopilot.launch.fail", "autopilot.replica.hang"):
        assert site in pkg.chaos.POINTS, site


def test_autopilot_metrics_catalogued_both_directions(pkg):
    """Every inc/observe/set_gauge literal in the package's autopilot.py
    is catalogued, and every catalogued autopilot.* instrument is
    recorded by a literal call site there."""
    with open(pkg.src) as f:
        tree = ast.parse(f.read())
    seen = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("inc", "observe", "set_gauge",
                                       "counter", "gauge", "histogram"):
            arg = node.args[0]
            if node.func.attr in ("inc", "observe", "set_gauge"):
                assert isinstance(arg, ast.Constant) and \
                    isinstance(arg.value, str), \
                    f"non-literal metric name at autopilot.py:{node.lineno}"
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                assert arg.value in pkg.obs.METRICS, arg.value
                seen.add(arg.value)
    names = {n for n in pkg.obs.METRICS if n.startswith("autopilot.")}
    missing = names - seen
    assert not missing, f"catalogued but never recorded: {missing}"


# -- headline soak (a): kill -> restart -> serving, zero hangs ------------------

def test_killed_replica_restarted_under_live_traffic(pkg):
    router, launcher, sup = _mk_supervised_fleet(pkg, 3)
    try:
        with _Traffic(router.port) as traffic:
            launcher.server("r1").stop()
            wait_for(lambda: sup.slot_state("r1") == "serving"
                     and router.in_rotation_count() == 3,
                     what="r1 restarted and back in rotation",
                     tick=_pump(router, sup))
        assert not traffic.errors, traffic.errors
        assert traffic.statuses and all(c == 200
                                        for c in traffic.statuses), \
            [c for c in traffic.statuses if c != 200]
        m = router.metrics
        assert m.counter("autopilot.restarts").value(rid="r1") == 2
        assert m.histogram("autopilot.restart.seconds").count() == 1
        srv = launcher.server("r1")
        code, body, _h = _req(srv.port, "/predict", _BODY)
        assert code == 200 and "outputs" in body
    finally:
        _teardown(router, sup)


# -- headline soak (b): rolling swap, zero failed, never below N-1 -------------

def test_rolling_swap_zero_downtime_under_live_traffic(pkg):
    router, launcher, sup = _mk_supervised_fleet(pkg, 3, version="v1")
    try:
        rotation_samples = []

        def pump():
            router.probe_all()
            sup.tick()
            rotation_samples.append(router.in_rotation_count())

        rc = pkg.ap.RolloutController(router, sup, step_timeout_s=15.0,
                                      probe_fn=pump)
        with _Traffic(router.port) as traffic:
            assert rc.run("v2") is True
        assert not traffic.errors, traffic.errors
        assert traffic.statuses and all(c == 200
                                        for c in traffic.statuses), \
            [c for c in traffic.statuses if c != 200]
        assert rotation_samples and min(rotation_samples) == 2
        st = rc.state()
        assert st["state"] == "completed"
        assert st["done"] == ["r0", "r1", "r2"]
        assert st["rolled_back"] == []
        for i in range(3):
            assert sup.slot_version(f"r{i}") == "v2"
        m = router.metrics
        assert m.counter("autopilot.rollout.steps").value(
            result="swapped") == 3
        assert m.counter("autopilot.rollouts").value(
            outcome="completed") == 1
        assert rc.run("v2") is True             # idempotent re-run
        assert m.counter("autopilot.rollout.steps").value(
            result="swapped") == 3
    finally:
        _teardown(router, sup)


# -- headline soak (c): crash loop -> quarantine after exactly K ----------------

def test_crash_loop_quarantined_after_exactly_k_with_bundle(pkg, tmp_path):
    class _BoomLauncher(pkg.ap.InProcessLauncher):
        def __init__(self):
            super().__init__(None)
            self.spawns = 0

        def spawn(self, slot, version=None):
            self.spawns += 1
            raise pkg.ap.LaunchError("boom")

    pkg.obs.enable(reset=True)
    pkg.fleet.configure_flight_recorder(dir=str(tmp_path))
    router = pkg.rt.ReplicaRouter()
    launcher = _BoomLauncher()
    sup = pkg.ap.ReplicaSupervisor(router, launcher,
                                   retry_policy=_fast_policy(pkg),
                                   crash_loop_restarts=3,
                                   crash_loop_window_s=60.0)
    try:
        sup.add_slot("bad")
        wait_for(lambda: sup.slot_state("bad") == "quarantined",
                 what="quarantine", tick=sup.tick)
        assert launcher.spawns == 3
        m = router.metrics
        assert m.counter("autopilot.quarantines").value(rid="bad") == 1
        assert m.counter("autopilot.launch.failures").value(rid="bad") == 3
        assert m.gauge("autopilot.replicas.quarantined").value() == 1.0
        bundles = pkg.fleet.flight_records(str(tmp_path))
        manifests = []
        for b in bundles:
            assert sorted(os.listdir(b)) == sorted(pkg.fleet.BUNDLE_FILES)
            with open(os.path.join(b, "manifest.json")) as f:
                manifests.append(json.load(f))
        crash = [mf for mf in manifests
                 if mf["reason"] == "replica_crash_loop"]
        assert len(crash) == 1
        extra = crash[0]["extra"]
        assert extra["slot"] == "bad"
        assert extra["attempts_in_window"] == 3
        assert extra["last_error"] is not None
        for _ in range(5):
            sup.tick()
        assert launcher.spawns == 3
        assert sup.release("bad") is True
        assert sup.slot_state("bad") == "backoff"
        assert m.gauge("autopilot.replicas.quarantined").value() == 0.0
        sup.tick()
        assert launcher.spawns == 4
    finally:
        sup.remove_slot("bad", stop=False)
        router.stop()


# -- chaos drives the launch path -----------------------------------------------

def test_chaos_launch_fail_backs_off_then_recovers(pkg):
    router = pkg.rt.ReplicaRouter()
    launcher = pkg.ap.InProcessLauncher(_factory(pkg))
    sup = pkg.ap.ReplicaSupervisor(router, launcher,
                                   retry_policy=_fast_policy(pkg),
                                   crash_loop_restarts=10,
                                   crash_loop_window_s=60.0)
    try:
        with pkg.chaos.scoped(seed=7,
                              rates={"autopilot.launch.fail": (1.0, 2)}):
            sup.add_slot("c0")
            wait_for(lambda: sup.slot_state("c0") == "serving",
                     what="c0 serving after chaos launch failures",
                     tick=_pump(router, sup))
            assert pkg.chaos.fire_count("autopilot.launch.fail") == 2
        m = router.metrics
        assert m.counter("autopilot.launch.failures").value(rid="c0") == 2
        assert m.counter("autopilot.restarts").value(rid="c0") == 3
    finally:
        sup.remove_slot("c0")
        router.stop()


def test_chaos_replica_hang_wedges_warming_then_ready_timeout(pkg):
    router = pkg.rt.ReplicaRouter()
    launcher = pkg.ap.InProcessLauncher(_factory(pkg))
    sup = pkg.ap.ReplicaSupervisor(router, launcher,
                                   retry_policy=_fast_policy(pkg),
                                   crash_loop_restarts=10,
                                   crash_loop_window_s=60.0,
                                   ready_timeout_s=0.3)
    try:
        with pkg.chaos.scoped(seed=7,
                              rates={"autopilot.replica.hang": (1.0, 1)}):
            sup.add_slot("h0")
            srv = launcher.server("h0")
            assert launcher.is_alive("h0")      # wedged, not dead
            code, body, _h = _req(srv.port, "/readyz")
            assert code == 503 and body["reason"] == "warming"
            wait_for(lambda: sup.slot_state("h0") == "serving",
                     what="h0 recovered from hang", tick=_pump(router, sup))
            assert pkg.chaos.fire_count("autopilot.replica.hang") == 1
        assert router.metrics.counter("autopilot.launch.failures").value(
            rid="h0") == 1
    finally:
        sup.remove_slot("h0")
        router.stop()


# -- probation: relaunches re-enter through the flap-damped gate ----------------

def test_relaunch_reenters_through_probation_gate(pkg):
    router = pkg.rt.ReplicaRouter(reenter_probes=3)
    launcher = pkg.ap.InProcessLauncher(_factory(pkg))
    sup = pkg.ap.ReplicaSupervisor(router, launcher,
                                   retry_policy=_fast_policy(pkg))
    try:
        sup.add_slot("p0")
        router.probe_all()
        sup.tick()
        assert router.in_rotation_count() == 0
        assert sup.slot_state("p0") == "warming"
        for _ in range(2):
            router.probe_all()
        sup.tick()
        assert router.in_rotation_count() == 1
        assert sup.slot_state("p0") == "serving"
    finally:
        sup.remove_slot("p0")
        router.stop()


# -- autoscaler ---------------------------------------------------------------------

def test_autoscaler_hysteresis_cooldown_and_bounds(pkg):
    router, launcher, sup = _mk_supervised_fleet(pkg, 1)
    try:
        sig = {"ttft_p95_s": None, "queue_depth": 0.0, "shed_rate": 0.0}
        clock = [0.0]
        asc = pkg.ap.Autoscaler(router, sup, min_replicas=1, max_replicas=2,
                                queue_high=5.0, queue_low=1.0, burn_ticks=2,
                                idle_ticks=3, cooldown_s=100.0,
                                signals=lambda: dict(sig),
                                clock=lambda: clock[0])

        def step():
            clock[0] += 1.0
            return asc.tick()

        assert [step() for _ in range(3)] == ["none"] * 3
        sig["queue_depth"] = 10.0
        acts = [step() for _ in range(6)]
        assert acts.count("out") == 1 and set(acts) <= {"out", "none"}
        wait_for(lambda: sup.slot_state("auto-1") == "serving",
                 what="scale-out slot serving", tick=_pump(router, sup))
        assert sup.active_slot_count() == 2
        clock[0] += 200.0
        assert [step() for _ in range(3)] == ["none"] * 3
        assert sup.active_slot_count() == 2
        m = router.metrics
        assert m.counter("autopilot.scale.events").value(
            direction="out") == 1
        sig["queue_depth"] = 0.0
        clock[0] += 200.0
        acts = [step() for _ in range(4)]
        assert acts.count("in") == 1
        assert sup.active_slot_count() == 1
        assert sup.slot_state("auto-1") is None
        assert m.counter("autopilot.scale.events").value(
            direction="in") == 1
        clock[0] += 200.0
        assert [step() for _ in range(6)] == ["none"] * 6
        assert sup.active_slot_count() == 1
        dbg = asc.debug()
        assert dbg["bounds"] == [1, 2]
        assert dbg["last_action"] == "none"
    finally:
        _teardown(router, sup)


# -- rollout gating, rollback, abort -----------------------------------------------

def test_rollout_aborts_when_floor_unreachable(pkg):
    router, launcher, sup = _mk_supervised_fleet(pkg, 2)
    try:
        rc = pkg.ap.RolloutController(router, sup, min_in_rotation=2,
                                      step_timeout_s=0.3,
                                      probe_fn=_pump(router, sup))
        assert rc.run("v2") is False
        st = rc.state()
        assert st["state"] == "aborted"
        assert st["reason"] == "fleet_below_floor"
        assert st["done"] == []
        assert all(sup.slot_version(f"r{i}") == "v1" for i in range(2))
        assert router.in_rotation_count() == 2
        assert router.metrics.counter("autopilot.rollouts").value(
            outcome="aborted") == 1
    finally:
        _teardown(router, sup)


def test_rollout_slo_burn_rolls_back_current_replica_only(pkg):
    router, launcher, sup = _mk_supervised_fleet(pkg, 3)
    try:
        burns = iter([False, False, False, True])
        rc = pkg.ap.RolloutController(router, sup, step_timeout_s=15.0,
                                      slo_burning=lambda: next(burns, True),
                                      probe_fn=_pump(router, sup))
        assert rc.run("v2") is False
        st = rc.state()
        assert st["state"] == "aborted" and st["reason"] == "slo_burn"
        assert st["done"] == ["r0"]
        assert st["rolled_back"] == ["r1"]
        assert sup.slot_version("r0") == "v2"
        assert sup.slot_version("r1") == "v1"
        assert sup.slot_version("r2") == "v1"
        m = router.metrics
        assert m.counter("autopilot.rollout.steps").value(
            result="swapped") == 1
        assert m.counter("autopilot.rollout.steps").value(
            result="rolled_back") == 1
        wait_for(lambda: router.in_rotation_count() == 3,
                 what="rolled-back replica rejoined",
                 tick=_pump(router, sup))
    finally:
        _teardown(router, sup)


# -- debug surfaces ---------------------------------------------------------------

def test_debug_autopilot_route_and_stats_rollout_block(pkg):
    router, launcher, sup = _mk_supervised_fleet(pkg, 2)
    try:
        code, body, _h = _req(router.port, "/debug/autopilot")
        assert code == 404 and "no autopilot attached" in body["error"]
        assert "rollout" not in router.stats()
        rc = pkg.ap.RolloutController(router, sup,
                                      probe_fn=_pump(router, sup))
        ap = pkg.ap.FleetAutopilot(sup, rollout=rc)
        router.attach_autopilot(ap)
        assert rc.run("v2") is True
        wait_for(lambda: all(sup.slot_state(f"r{i}") == "serving"
                             for i in range(2)),
                 what="post-rollout fleet serving", tick=_pump(router, sup))
        code, body, _h = _req(router.port, "/debug/autopilot")
        assert code == 200
        assert body["supervisor"]["summary"]["slots"] == 2
        assert body["supervisor"]["summary"]["serving"] == 2
        assert body["autoscaler"] is None
        assert body["rollout"]["state"] == "completed"
        assert router.stats()["rollout"]["version"] == "v2"
    finally:
        _teardown(router, sup)


# -- lifecycle ------------------------------------------------------------------------

def test_autopilot_loops_start_stop_join_threads(pkg):
    router = pkg.rt.ReplicaRouter(probe_interval_s=0.05)
    launcher = pkg.ap.InProcessLauncher(_factory(pkg))
    sup = pkg.ap.ReplicaSupervisor(router, launcher,
                                   retry_policy=_fast_policy(pkg),
                                   tick_interval_s=0.01)
    asc = pkg.ap.Autoscaler(router, sup, tick_interval_s=0.01,
                            signals=lambda: {"ttft_p95_s": None,
                                             "queue_depth": 0.0,
                                             "shed_rate": 0.0})
    ap = pkg.ap.FleetAutopilot(sup, autoscaler=asc)
    router.start()
    ap.start()
    try:
        sup.add_slot("r0")
        wait_for(lambda: sup.slot_state("r0") == "serving",
                 what="background loops bring r0 to serving")
    finally:
        ap.stop()
        assert sup._thread is None and asc._thread is None
        sup.remove_slot("r0")
        router.stop()


def test_port_autopilot_reads_no_environment():
    with open(t_autopilot.__file__) as f:
        tree = ast.parse(f.read())
    names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    imported = {a.name for n in ast.walk(tree)
                if isinstance(n, (ast.Import, ast.ImportFrom))
                for a in n.names}
    assert not ({"environ", "getenv", "putenv", "os"} & (names | imported))


# -- engine-backed replicas ---------------------------------------------------------

TINY = dict(num_hidden_layers=2, vocab_size=97, hidden_size=64,
            num_attention_heads=4, num_key_value_heads=2,
            fused_norm=True, fused_rope=True)
GEOM = dict(max_slots=2, page_size=4, num_pages=32, max_pages_per_slot=8,
            steps_per_tick=2)
PROBE = [5, 9, 2, 14, 17, 3, 11]
PROBE_NEW = 6


class _EngineReplica:
    """A supervised replica: a port engine behind a PredictorServer. Its
    stop and drain also stop the engine and drop it (the server's own stop
    leaves its generator running)."""

    def __init__(self, model):
        self.engine = TEngine(model, device="cpu", **GEOM)
        self.server = t_serving.PredictorServer(lambda d: d,
                                                generator=self.engine)
        self.host = self.server.host
        self.port = self.server.port

    def start(self):
        self.server.start()
        return self

    def mark_warming(self):
        self.server.mark_warming()

    def kill(self):
        """Die as a crashed replica does: listener gone, engine loop
        stopped, every waiter failed."""
        self.server.stop()
        self.engine.stop()
        self.engine._fail_all(RuntimeError("replica killed"))

    def drain(self, timeout=30.0):
        try:
            return self.server.drain(timeout=timeout)
        finally:
            self._drop()

    def stop(self):
        self.server.stop()
        self._drop()

    def _drop(self):
        if self.engine is not None:
            self.engine.stop()
            self.server.generator = None
            self.engine = None


def _gen(port, ids, n):
    body = json.dumps({"ids": [ids], "max_new_tokens": n}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())["sequences"][0]


def test_engine_replicas_relaunch_and_roll_to_the_jax_engines_tokens():
    """Two supervised port engines (f32, one numpy state dict each
    version): a killed replica relaunches through probation and answers
    the JAX engine's greedy tokens; a rollout to the second state dict
    completes and every replica answers the JAX engine's tokens over
    it."""
    jm, tm, want = {}, {}, {}
    for seed, version in ((0, "v1"), (1, "v2")):
        paddle_tpu.seed(seed)
        jm[version] = jllama.LlamaForCausalLM(
            jllama.tiny_llama_config(**TINY))
        cfg = tllama.tiny_llama_config(**TINY)
        tm[version] = tllama.LlamaForCausalLM(cfg, device="cpu")
        tm[version].load_state_dict(from_paddle_tpu_state(
            {k: np.asarray(v._value)
             for k, v in jm[version].state_dict().items()}, cfg))
        jeng = JEngine(jm[version], kernel="jnp", **GEOM)
        want[version] = jeng.generate([PROBE], max_new_tokens=PROBE_NEW)[0]
        jeng.stop()
    assert want["v1"] != want["v2"]
    built = []

    def factory(slot, version):
        built.append((slot, version))
        return _EngineReplica(tm[version])

    router, launcher, sup = _mk_supervised_fleet(PACKAGES["port"], 2,
                                                 factory=factory)
    try:
        for slot in ("r0", "r1"):
            assert _gen(launcher.server(slot).port, PROBE,
                        PROBE_NEW) == want["v1"]
        dead = launcher.server("r0")
        dead.kill()
        wait_for(lambda: sup.slot_state("r0") == "serving"
                 and router.in_rotation_count() == 2
                 and launcher.server("r0") is not dead,
                 what="r0 relaunched and back in rotation",
                 tick=_pump(router, sup))
        assert dead.engine is None              # stopped and dropped
        assert built.count(("r0", "v1")) == 2
        assert router.metrics.counter("autopilot.restarts").value(
            rid="r0") == 2
        assert _gen(launcher.server("r0").port, PROBE,
                    PROBE_NEW) == want["v1"]
        rc = t_autopilot.RolloutController(router, sup, min_in_rotation=1,
                                           step_timeout_s=15.0,
                                           probe_fn=_pump(router, sup))
        assert rc.run("v2") is True
        assert rc.state()["done"] == ["r0", "r1"]
        for slot in ("r0", "r1"):
            assert sup.slot_version(slot) == "v2"
            assert _gen(launcher.server(slot).port, PROBE,
                        PROBE_NEW) == want["v2"]
    finally:
        _teardown(router, sup)
