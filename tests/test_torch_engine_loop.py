"""The port engine's tick program and serving loop, on the CPU.

On the CPU the tick program is its body (`PagedKVEngine._tick_body`)
run eagerly over the engine's static buffers; on the card the same body
is captured in a CUDA graph (tests/test_torch_cuda.py holds the two
against each other). Here the body is held against the JAX engine's
compiled `_tick_fn`: identical greedy tokens with a mid-decode join, an
eos stop, a queued request and a request on recycled pages, over f32 KV
and over int8 KV with a W8A16 model (the JAX side as
tests/test_torch_paged_engine.py runs it: the interpret-mode Pallas
kernels, `_weight_only_matmul` routed through the W8A16 kernel, under
`paddle_tpu.no_grad()`). The port's `stream()` yields the JAX engine's
`stream()` rows at the same weights.

The serving loop's contract, ported from tests/test_paged_engine.py:
the stall guard of `result()`, cancel (and closing a `stream()`
iterator) returning the slot, its pages and its reservation, a later
row's failed submit cancelling the rows already submitted, and an
exception inside a tick failing every waiter and returning every page.
Every test that starts a ticker stops it in `finally`, and every wait is
bounded.
"""
import threading
import time
import warnings

import numpy as np
import pytest

import jax.numpy as jnp

import paddle_tpu
import paddle_tpu.quantization as jq
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.inference.paged import PagedKVEngine as JEngine
from paddle_tpu.kernels.quant_matmul import \
    weight_only_int8_matmul as j_w8a16
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference.paged import PagedKVEngine as TEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import from_paddle_tpu_state
from paddle_tpu_torch.quantization import quantize_weight_only

TINY = dict(num_hidden_layers=2, vocab_size=97, hidden_size=64,
            num_attention_heads=4, num_key_value_heads=2,
            fused_norm=True, fused_rope=True)
# multiples of 128, as the TPU W8A16 kernel's blocks need
TINY8 = dict(num_hidden_layers=2, vocab_size=256, hidden_size=256,
             intermediate_size=512, num_attention_heads=4,
             num_key_value_heads=2, fused_norm=True, fused_rope=True)
GEOM = dict(max_slots=2, page_size=4, num_pages=24, max_pages_per_slot=6,
            steps_per_tick=2)
# 11 allocatable pages for two slots of up to 6: later requests recycle
# the pages of earlier ones
RECYCLE = dict(max_slots=2, page_size=4, num_pages=12, max_pages_per_slot=6,
               steps_per_tick=3)
WAIT_S = 60.0


def _state(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model with its weights), f32."""
    paddle_tpu.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.tiny_llama_config(**TINY))
    cfg = tllama.tiny_llama_config(**TINY)
    tm = tllama.LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(from_paddle_tpu_state(_state(jm), cfg))
    return jm, tm


@pytest.fixture(scope="module")
def models8():
    """(JAX weight-only int8 model, port model holding its int8 state)."""
    paddle_tpu.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.tiny_llama_config(**TINY8))
    jm.eval()
    ptq = jq.PTQ(jq.QuantConfig(
        activation=None, weight=jq.AbsMaxChannelWiseWeightObserver()))
    qm = ptq.quantize(jm)
    qm(JTensor(jnp.asarray(np.array([[1, 2, 3, 4]], np.int32))))
    jconv = ptq.convert(qm, execute="weight_only_int8")
    cfg = tllama.tiny_llama_config(**TINY8)
    tm = quantize_weight_only(tllama.LlamaForCausalLM(cfg, device="cpu"))
    tm.load_state_dict(from_paddle_tpu_state(_state(jconv), cfg))
    return jconv, tm


def _jax_kernel_matmul(xv, qwv, eff_scale):
    return j_w8a16(xv, qwv, eff_scale.astype(jnp.float32), block_m=None,
                   block_n=128, block_k=128, out_dtype=xv.dtype,
                   interpret=True).astype(xv.dtype)


@pytest.fixture(params=["f32", "int8"])
def engines(request, monkeypatch):
    """make(**geom) -> (JAX engine, port engine) at one set of weights:
    f32 KV, or int8 KV over the W8A16 model. The JAX engine's step runs
    under `paddle_tpu.no_grad()` (Pallas calls have no JVP rule), on
    whichever thread drives it."""
    if request.param == "f32":
        jm, tm = request.getfixturevalue("models")
        kv = {}
    else:
        jm, tm = request.getfixturevalue("models8")
        monkeypatch.setattr(jq, "_weight_only_matmul", _jax_kernel_matmul)
        kv = dict(kv_dtype="int8")

    def make(**geom):
        je = JEngine(jm, kernel="pallas", **kv, **geom)
        step = je.step

        def step_no_grad():
            with paddle_tpu.no_grad():
                return step()
        je.step = step_no_grad
        return je, TEngine(tm, device="cpu", **kv, **geom)
    make.kind = request.param
    return make


def _scenario(eng, eos):
    """A mid-decode join, an eos stop, a queued request and, after a
    drain, a request on recycled pages."""
    ra = eng.submit([5, 9, 2, 14], max_new_tokens=10)
    eng.step()
    rb = eng.submit([17, 3, 11], max_new_tokens=6)          # joins
    rc = eng.submit([40, 41], max_new_tokens=8, eos_token_id=eos)
    eng.run_until_idle()
    rd = eng.submit([7, 8, 9], max_new_tokens=9)
    eng.run_until_idle()
    return [r.result(stall_timeout=WAIT_S) for r in (ra, rb, rc, rd)]


def test_tick_body_gives_the_jax_engines_greedy_tokens(engines):
    je, te = engines(**RECYCLE)
    probe = engines(**RECYCLE)[1]
    eos = probe.generate([[40, 41]], max_new_tokens=3)[0][-1]
    want = _scenario(je, eos)
    got = _scenario(te, eos)
    assert got == want
    assert [len(t) for t in got] == [10, 6, len(got[2]), 9]
    assert got[2][-1] == eos and len(got[2]) <= 3
    # the CPU runs the body eagerly: nothing captured, no warm-up
    assert te.stats["ticks"] > 0 and not te._programs
    assert te.stats["warmup_ticks"] == 0
    assert sorted(te._free) == list(range(1, te.num_pages))
    assert te._reserved_unalloc == 0
    assert te.stats["finished"] == 4
    if engines.kind == "int8":
        assert float(te._scales[:, :, 1:-1].abs().sum()) == 0.0


def _stream_rows(eng, prompts, **kw):
    ids = np.zeros((len(prompts), max(map(len, prompts))), np.int32)
    mask = np.zeros(ids.shape, bool)
    for i, p in enumerate(prompts):
        ids[i, :len(p)], mask[i, :len(p)] = p, True
    try:
        return [r.tolist() for r in eng.stream(ids, attention_mask=mask,
                                               **kw)]
    finally:
        eng.stop()


def test_stream_rows_equal_the_jax_engines(engines):
    """Two rows in different prefill buckets (each prefills alone
    whenever the ticker admits it); row 0 stops at eos and is padded."""
    je, te = engines(**GEOM)
    prompts = [[5, 9, 2, 14], [17, 3, 11, 4, 8, 1, 2, 7, 6]]
    eos = engines(**GEOM)[1].generate([prompts[0]], max_new_tokens=3)[0][-1]
    kw = dict(max_new_tokens=7, eos_token_id=eos, pad_token_id=-1)
    want = _stream_rows(je, prompts, **kw)
    got = _stream_rows(te, prompts, **kw)
    assert got == want
    assert len(got) == 7 and -1 in [r[0] for r in got]
    assert not te._ticker.is_alive()


def _engine(models, **geom):
    return TEngine(models[1], device="cpu", **dict(GEOM, **geom))


def test_result_with_nothing_stepping_raises_naming_run_until_idle(models):
    eng = _engine(models, max_slots=1)
    r = eng.submit([1, 2, 3], max_new_tokens=2)
    with pytest.raises(RuntimeError, match="run_until_idle"):
        r.result(stall_timeout=0.4)
    eng.run_until_idle()
    assert len(r.result(stall_timeout=WAIT_S)) == 2


def _wait_idle(eng):
    deadline = time.monotonic() + WAIT_S
    while eng.has_work() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not eng.has_work()


def test_cancel_frees_the_slot_its_pages_and_reservation(models):
    eng = _engine(models, num_pages=48, max_pages_per_slot=16)
    r = eng.submit([5, 9, 2], max_new_tokens=50)
    eng.step()
    assert any(eng._slots)
    r.cancel()
    eng.step()
    assert not any(eng._slots)
    assert sorted(eng._free) == list(range(1, eng.num_pages))
    assert eng._reserved_unalloc == 0
    assert eng.stats["cancelled"] == 1
    assert r.done.wait(timeout=WAIT_S)
    # closing a stream() iterator cancels its requests too
    it = eng.stream(np.asarray([[5, 9, 2]], np.int32), max_new_tokens=50)
    try:
        next(it)
        it.close()
        _wait_idle(eng)
        assert sorted(eng._free) == list(range(1, eng.num_pages))
        assert eng._reserved_unalloc == 0
        assert eng.stats["cancelled"] == 2
    finally:
        eng.stop()
    assert not eng._ticker.is_alive()


def test_stream_cancels_submitted_rows_when_a_later_row_fails(models):
    eng = _engine(models, num_pages=16, max_pages_per_slot=3)
    ids = np.tile(np.arange(1, 11, dtype=np.int32), (2, 1))
    mask = np.ones_like(ids, bool)
    mask[0, 2:] = False     # row 0: 2 tokens + 8 new -> fits (3 pages)
    #                         row 1: 10 tokens + 8 new -> needs 5 > 3
    it = eng.stream(ids, max_new_tokens=8, attention_mask=mask)
    try:
        with pytest.raises(ValueError, match="max_pages_per_slot"):
            next(it)
        _wait_idle(eng)
        assert eng.stats["cancelled"] == 1
        assert sorted(eng._free) == list(range(1, eng.num_pages))
        assert eng._reserved_unalloc == 0
    finally:
        eng.stop()


def test_an_exception_in_a_tick_fails_every_waiter_and_returns_pages(
        models, monkeypatch):
    eng = _engine(models)
    seen = []
    monkeypatch.setattr(threading, "excepthook", seen.append)
    calls = []

    def broken(any_sample):
        calls.append(any_sample)
        raise RuntimeError("planted tick fault")

    monkeypatch.setattr(eng, "_tick_body", broken)
    # two live slots and one request still queued behind them
    reqs = [eng.submit(p, max_new_tokens=6) for p in ([5, 9], [3, 4], [7])]
    eng.start()
    try:
        for r in reqs:
            assert r.done.wait(timeout=WAIT_S)
            with pytest.raises(RuntimeError, match="planted tick fault"):
                r.result(stall_timeout=WAIT_S)
        eng._ticker.join(timeout=WAIT_S)
        assert not eng._ticker.is_alive()
    finally:
        eng.stop()
    assert calls == [False]
    assert [type(a.exc_value) for a in seen] == [RuntimeError]
    assert not eng.has_work()
    assert sorted(eng._free) == list(range(1, eng.num_pages))
    assert eng._reserved_unalloc == 0
    assert eng.stats["finished"] == 0
    # a restarted ticker serves on the returned capacity
    monkeypatch.undo()
    eng.start()
    try:
        r = eng.submit([5, 9], max_new_tokens=4)
        assert len(r.result(stall_timeout=WAIT_S)) == 4
    finally:
        eng.stop()


class _StickyScales:
    """Stands in for an int8 engine's scale planes after a sticky CUDA
    error: the scale reset of `_retire` raises."""

    def __setitem__(self, key, value):
        raise RuntimeError("planted device fault")


def test_a_raising_scale_reset_still_fails_every_waiter(models,
                                                         monkeypatch):
    """A tick fault with two live int8 slots whose scale resets raise:
    every waiter still fails with the tick's error and every page and
    reservation comes back."""
    eng = _engine(models, kv_dtype="int8")
    seen = []
    monkeypatch.setattr(threading, "excepthook", seen.append)

    def broken(any_sample):
        monkeypatch.setattr(eng, "_scales", _StickyScales())
        raise RuntimeError("planted tick fault")

    monkeypatch.setattr(eng, "_tick_body", broken)
    reqs = [eng.submit(p, max_new_tokens=6) for p in ([5, 9], [3, 4], [7])]
    eng.start()
    try:
        for r in reqs:
            assert r.done.wait(timeout=WAIT_S)
            with pytest.raises(RuntimeError, match="planted tick fault"):
                r.result(stall_timeout=WAIT_S)
        eng._ticker.join(timeout=WAIT_S)
        assert not eng._ticker.is_alive()
    finally:
        eng.stop()
    assert [str(a.exc_value) for a in seen] == ["planted device fault"]
    assert not eng.has_work() and not any(eng._slots)
    assert sorted(eng._free) == list(range(1, eng.num_pages))
    assert eng._reserved_unalloc == 0


def test_a_raising_scale_reset_still_sweeps_every_cancelled_slot(models,
                                                                 monkeypatch):
    eng = _engine(models, kv_dtype="int8", num_pages=48,
                  max_pages_per_slot=16)
    reqs = [eng.submit(p, max_new_tokens=50) for p in ([5, 9, 2], [3, 4])]
    eng.step()
    assert all(eng._slots)
    for r in reqs:
        r.cancel()
    monkeypatch.setattr(eng, "_scales", _StickyScales())
    with pytest.raises(RuntimeError, match="planted device fault"):
        eng.step()
    assert all(r.done.is_set() for r in reqs)
    assert not eng.has_work() and not any(eng._slots)
    assert eng.stats["cancelled"] == 2
    assert sorted(eng._free) == list(range(1, eng.num_pages))
    assert eng._reserved_unalloc == 0


def test_has_work_holds_while_admit_holds_the_popped_queue(models,
                                                           monkeypatch):
    """Between _admit taking the queue and filling a slot, neither holds
    the request; has_work() must not read idle there (run_until_idle
    would stop waiting on a live ticker)."""
    eng = _engine(models)
    seen = []
    headroom = eng.admission_headroom

    def probe():
        seen.append((bool(eng._pending), any(eng._slots), eng.has_work()))
        return headroom()

    monkeypatch.setattr(eng, "admission_headroom", probe)
    r = eng.submit([5, 9, 2], max_new_tokens=2)
    eng.run_until_idle()
    assert seen[0] == (False, False, True)
    assert len(r.result(stall_timeout=WAIT_S)) == 2
    assert not eng.has_work()


def test_run_until_idle_waits_on_a_live_ticker(models, monkeypatch):
    prompts = [[5, 9, 2, 14], [17, 3, 11]]
    want = _engine(models).generate(prompts, max_new_tokens=6)
    eng = _engine(models)
    steppers = set()
    step = eng.step

    def recorded():
        steppers.add(threading.current_thread())
        return step()

    monkeypatch.setattr(eng, "step", recorded)
    eng.start()
    try:
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        waiter = threading.Thread(target=eng.run_until_idle, daemon=True)
        waiter.start()
        waiter.join(timeout=WAIT_S)
        assert not waiter.is_alive()
        assert [r.result(stall_timeout=WAIT_S) for r in reqs] == want
        # the ticker did the stepping: run_until_idle only waited
        assert eng._ticker.is_alive()
        assert steppers == {eng._ticker}
    finally:
        eng.stop()
    assert not eng._ticker.is_alive()


def test_stream_refuses_unported_arguments_and_warns_on_seed(models):
    # stream() takes tenant= and session= since the tenancy and host-tier
    # slice; without a TenantTable or a prefix cache both are inert, so
    # the rows equal those without them
    eng = _engine(models)
    try:
        ids = np.asarray([[1, 2]], np.int32)
        want = [r.tolist() for r in eng.stream(ids, max_new_tokens=2)]
        for kw in (dict(tenant="a"), dict(session="s")):
            assert [r.tolist() for r in eng.stream(
                ids, max_new_tokens=2, **kw)] == want
        assert eng.tenant_snapshot() == {} and eng._sessions == {}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rows = list(eng.stream(np.asarray([[1, 2]], np.int32),
                                   max_new_tokens=3, do_sample=True,
                                   seed=5))
        assert any("seed" in str(w.message) for w in caught)
        assert len(rows) == 3
    finally:
        eng.stop()
