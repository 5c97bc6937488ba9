"""Test config: run everything on a virtual 8-device CPU mesh.

This replaces the reference's multi-process distributed test harness
(reference: test/legacy_test/test_dist_base.py:959 subprocess forking) with
XLA host-device virtualization — single process, deterministic
(SURVEY.md §4 'fake backends').
"""
import os

# XLA_FLAGS is read from the environment when the backend is created, but
# JAX_PLATFORMS is captured by jax's config at *import* time — and jax._src
# is pre-imported in this image — so the platform must go through
# jax.config.update, not the environment.
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Test tiers (reference: tools/gen_ut_cmakelists.py run_type tiers):
# `-m quick` must stay green in <3 min so the round driver can always
# run it; the full suite's runtime is documented in tests/README.md.
# Modules dominated by jit-compile-heavy model/e2e runs are `slow`.
_SLOW_MODULES = {
    "test_models_llama", "test_models_bert_gpt_dit", "test_pipeline",
    "test_context_parallel", "test_flash_attention",
    "test_native_and_profiler", "test_quantization_depth",
    "test_distributed_sharding", "test_hapi", "test_audio_text_debugging",
    "test_vision_ops_models", "test_vision", "test_incubate",
    "test_op_harness", "test_dist_checkpoint", "test_static_inference",
    "test_moe", "test_sparse", "test_geometric", "test_rnn",
    "test_watchdog_elastic", "test_auto_parallel_engine",
    "test_nn_optimizer", "test_op_bench_tool", "test_distribution",
    "test_fleet",
}


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: compile-heavy/e2e tests")
    config.addinivalue_line("markers", "quick: fast tier (<3 min total)")
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        if mod in _SLOW_MODULES:
            item.add_marker(pytest.mark.slow)
        else:
            item.add_marker(pytest.mark.quick)


@pytest.fixture(autouse=True)
def _seed_everything():
    import paddle_tpu
    paddle_tpu.seed(1234)
    np.random.seed(1234)
    yield


def wait_for(cond, timeout=10.0, what="condition", tick=None):
    """Poll ``cond()`` until truthy or ``timeout`` seconds elapse.

    Shared by the serving/router/QoS/autopilot suites (previously four
    private copies). ``tick``, when given, is invoked each poll — soak
    tests pass ``lambda: (router.probe_all(), supervisor.tick())`` so
    the condition can only become true through the real control loops.
    """
    import time

    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if tick is not None:
            tick()
        if cond():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture
def no_leaked_threads():
    """Fail any test that leaks a NON-daemon thread. The repo now has
    four thread-owning subsystems (async checkpoint writer, device
    prefetcher, serving batcher/server, paged engine driver); a
    non-daemon leak hangs interpreter exit and is invisible in a
    passing test. Daemon workers are exempt: their contract is join-on-
    close but die-with-the-process as the backstop. Opt in per module:

        pytestmark = pytest.mark.usefixtures("no_leaked_threads")
    """
    import threading
    import time

    before = set(threading.enumerate())
    yield
    deadline = time.time() + 5.0
    while True:
        leaked = [t for t in threading.enumerate()
                  if t not in before and t.is_alive() and not t.daemon]
        if not leaked:
            return
        if time.time() > deadline:
            raise AssertionError(
                "non-daemon thread(s) outlived the test (missing "
                f"close()/stop()/join?): {[t.name for t in leaked]}")
        time.sleep(0.05)
