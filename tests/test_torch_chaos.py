"""The port's chaos module (paddle_tpu_torch/distributed/chaos.py)
against the JAX package's, on the CPU.

Decisions are sha256(f"{seed}:{site}:{n}") in both packages, so the same
seed, rates and call sequence fire the same faults: the fire sequences,
counters and caps compare equal, exactly. Also the catalogue, prefix
matching, `scoped`, the fired-fault counter in each package's own
registry, and the `tenant.storm` stamp in `tenancy.resolve_tenant`.
"""
import time

import pytest

import paddle_tpu.inference.tenancy as j_tenancy
import paddle_tpu_torch.inference.tenancy as t_tenancy
from paddle_tpu import observability as j_obs
from paddle_tpu.distributed import chaos as j_chaos
from paddle_tpu_torch import observability as t_obs
from paddle_tpu_torch.distributed import chaos as t_chaos

PACKAGES = {"jax": (j_chaos, j_obs, j_tenancy),
            "port": (t_chaos, t_obs, t_tenancy)}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """(chaos, observability, tenancy) of one package."""
    return PACKAGES[request.param]


@pytest.fixture(autouse=True)
def _off():
    for ch, obs, _ in PACKAGES.values():
        ch.disable()
        obs.disable()
        obs.REGISTRY.reset()
    yield
    for ch, obs, _ in PACKAGES.values():
        ch.disable()
        obs.disable()
        obs.REGISTRY.reset()


def _sequence(ch, seed, rates, sites, n):
    """The decisions of `n` rounds over `sites`, then the fire counts."""
    with ch.scoped(seed=seed, rates=rates):
        seq = [[ch.should_fire(s) for s in sites] for _ in range(n)]
        return seq, ch.fires(), {s: ch.fire_count(s) for s in sites}


def test_points_are_the_jax_catalogue():
    assert t_chaos.POINTS == j_chaos.POINTS
    for site in ("engine.tick.delay", "prefix.cache.bypass",
                 "kvtier.spill.fail", "kvtier.restore.delay",
                 "tenant.storm", "serving.admit.delay",
                 "serving.run.delay", "serving.run.fail",
                 "serving.batch.delay", "serving.batch.fail"):
        assert site in t_chaos.POINTS


@pytest.mark.parametrize("seed,rates", [
    (0, {"engine.tick.delay": 0.3}),
    (1234, {"engine.tick.delay": 0.5, "serving.run.fail": (0.7, 3)}),
    (7, {"serving": 0.4, "serving.run": 0.9}),       # prefixes
    (99, {"kvtier.spill.fail": 1.0, "prefix.cache.bypass": (1.0, 2)}),
    (5, {"tenant.storm": 0.25, "kvtier": 0.6}),
])
def test_fire_sequences_equal_the_jax_module(seed, rates):
    sites = ["engine.tick.delay", "serving.run.fail", "serving.run.delay",
             "serving.admit.delay", "kvtier.spill.fail",
             "kvtier.restore.delay", "prefix.cache.bypass", "tenant.storm"]
    got = _sequence(t_chaos, seed, rates, sites, 64)
    want = _sequence(j_chaos, seed, rates, sites, 64)
    assert got == want
    assert any(any(r) for r in got[0])      # something fired


def test_disabled_is_inert_and_advances_nothing(pkg):
    ch, _, _ = pkg
    assert ch.ENABLED is False
    assert ch.should_fire("engine.tick.delay") is False
    assert ch.maybe_delay("engine.tick.delay") is False
    with ch.scoped(seed=3, rates={"engine.tick.delay": 1.0}):
        assert ch.should_fire("engine.tick.delay") is True
    assert ch.ENABLED is False
    assert ch.should_fire("engine.tick.delay") is False


def test_scoped_restores_previous_configuration(pkg):
    ch, _, _ = pkg
    ch.configure(seed=1, rates={"a.site": 1.0})
    with ch.scoped(seed=2, rates={"b.site": 1.0}):
        assert ch.site_rate("a.site") == 0.0
        assert ch.site_rate("b.site") == 1.0
    assert ch.ENABLED is True
    assert ch.site_rate("a.site") == 1.0
    ch.disable()


def test_cap_limits_fires(pkg):
    ch, _, _ = pkg
    with ch.scoped(rates={"serving.run.fail": (1.0, 2)}):
        fired = [ch.should_fire("serving.run.fail") for _ in range(5)]
        assert fired == [True, True, False, False, False]
        assert ch.fire_count("serving.run.fail") == 2


def test_longest_prefix_wins(pkg):
    ch, _, _ = pkg
    with ch.scoped(rates={"serving": 0.1, "serving.run": 0.9,
                          "serving.run.fail": 0.0}):
        assert ch.site_rate("serving.admit.delay") == 0.1
        assert ch.site_rate("serving.run.delay") == 0.9
        assert ch.site_rate("serving.run.fail") == 0.0
        assert ch.site_rate("engine.tick.delay") == 0.0


def test_capped_and_prefix_rates_fire_like_the_jax_module():
    rates = {"engine.tick.delay": 0.3, "serving.run.fail": (1.0, 1),
             "kvtier": (0.5, 4)}
    sites = ("engine.tick.delay", "serving.run.fail", "kvtier.spill.fail",
             "kvtier.restore.delay", "serving.admit.delay")
    j = _sequence(j_chaos, 21, rates, sites, 12)
    assert _sequence(t_chaos, 21, rates, sites, 12) == j
    _seq, fires, counts = j
    assert counts["serving.run.fail"] == 1
    assert counts["kvtier.spill.fail"] + counts["kvtier.restore.delay"] \
        <= 8 and counts["serving.admit.delay"] == 0
    assert fires == {s: n for s, n in counts.items() if n}


def test_maybe_delay_sleeps_delay_plus_hang(pkg):
    ch, _, _ = pkg
    with ch.scoped(rates={"engine.tick.delay": 1.0}, delay_ms=20.0,
                   hang_ms=10.0):
        t0 = time.perf_counter()
        assert ch.maybe_delay("engine.tick.delay") is True
        assert time.perf_counter() - t0 >= 0.03


def test_fires_count_into_the_own_registry_only():
    """A fault fired by the port counts `chaos.injections` in the
    port's registry (when its plane is on) and never in the JAX one."""
    t_obs.enable()
    with t_chaos.scoped(rates={"serving.run.fail": 1.0}):
        assert t_chaos.should_fire("serving.run.fail")
    assert t_obs.REGISTRY.counter("chaos.injections").value(
        site="serving.run.fail") == 1
    assert "chaos.injections" not in j_obs.REGISTRY.names()
    t_obs.disable()
    with t_chaos.scoped(rates={"serving.run.fail": 1.0}):
        assert t_chaos.should_fire("serving.run.fail")
    assert t_obs.REGISTRY.counter("chaos.injections").value(
        site="serving.run.fail") == 1


def test_tenant_storm_stamps_only_unlabeled_requests(pkg):
    ch, _, ten = pkg
    with ch.scoped(rates={"tenant.storm": 1.0}):
        assert ten.resolve_tenant({}) == ten.STORM_TENANT
        assert ten.resolve_tenant(None) == ten.STORM_TENANT
        assert ten.resolve_tenant({"X-Tenant-Id": "acme"}) == "acme"
        # an unsafe id counts as unlabeled
        assert ten.resolve_tenant({"X-Tenant-Id": "a b"}) \
            == ten.STORM_TENANT
        # labeled requests take no decision from the site
        assert ch.fire_count("tenant.storm") == 3
    assert ten.resolve_tenant({}) is None


def test_tenant_storm_decisions_equal_the_jax_module():
    heads = [{}, {"X-Tenant-Id": "a"}, None, {}, {"X-Tenant-Id": "b"},
             {}] * 8
    got = {}
    for name, (ch, _, ten) in PACKAGES.items():
        with ch.scoped(seed=11, rates={"tenant.storm": 0.5}):
            got[name] = [ten.resolve_tenant(h) for h in heads]
    assert got["port"] == got["jax"]
    assert "storm" in got["port"] and None in got["port"]
