"""The port's training telemetry (observability/telemetry.py) and the
Trainer's observability against the JAX package's, on the CPU.

- Both `TrainingTelemetry`s fed the same `step()` sequence publish equal
  registry snapshots (the same float expressions: exact).
- `flops_per_token_for` gives the JAX helper's number on the tiny Llama
  config with recompute on and off, and on a model without a config.
- The peak table is the card's: an H100 SXM reads 989e12, a TPU kind and
  the CPU read None (MFU 0), where the JAX table would assume a v5p.
- The Trainer: telemetry from the second step on, intervals not calls
  (tests/test_observability.py:292); `fleet_heartbeat` builds nothing
  with observability off (tests/test_fleet_telemetry.py:483-509, the
  Trainer half); `train.recompiles` labelled with the batch signature,
  the JAX labels letter for letter, a shape warmed while observability
  was off never counted (:568); the blockwise loss's
  `train.loss.logits_bytes_saved` equal to the JAX trainer's;
  `train.nonfinite_skips` counting each skipped step, as the JAX
  trainer's does.
"""
import datetime
import threading
import types

import numpy as np
import pytest
import torch
import torch.distributed as tdist

import paddle_tpu
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu import observability as j_obs
from paddle_tpu.distributed import chaos as j_chaos
from paddle_tpu.distributed.store import TCPStore as JaxStore
from paddle_tpu.jit.functional import state_arrays
from paddle_tpu.models import llama as jllama
from paddle_tpu.observability import fleet as j_fleet
from paddle_tpu.observability import metrics as j_metrics
from paddle_tpu.observability import telemetry as j_tel
from paddle_tpu.parallel import Trainer as JTrainer
from paddle_tpu.parallel import TrainStepConfig as JStepConfig
from paddle_tpu_torch import observability as t_obs
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import from_paddle_tpu_state
from paddle_tpu_torch.observability import fleet as t_fleet
from paddle_tpu_torch.observability import metrics as t_metrics
from paddle_tpu_torch.observability import telemetry as t_tel
from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

TINY = dict(num_hidden_layers=2, vocab_size=97, hidden_size=64,
            num_attention_heads=2, num_key_value_heads=1)


def _ids(b, s, seed=0, vocab=97):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


def _pair(seed=0, **overrides):
    """(JAX Trainer, port Trainer) over the same tiny Llama weights."""
    kw = dict(TINY, **overrides)
    compute = kw.pop("compute_dtype", None)
    step_kw = {k: kw.pop(k) for k in ("skip_nonfinite_grads",
                                      "health_probe") if k in kw}
    paddle_tpu.seed(seed)
    jm = jllama.LlamaForCausalLM(jllama.tiny_llama_config(**kw))
    state = {k: np.asarray(v) for k, v in state_arrays(jm).items()}
    jtr = JTrainer(jm, jopt.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters()),
                   config=JStepConfig(compute_dtype=compute, **step_kw))
    cfg = tllama.tiny_llama_config(**kw)
    tm = tllama.LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(from_paddle_tpu_state(state, cfg))
    ttr = Trainer(tm, topt.AdamW(learning_rate=1e-3,
                                 parameters=tm.named_parameters()),
                  TrainStepConfig(compute_dtype=compute, **step_kw))
    return jtr, ttr


# -- the reporter -----------------------------------------------------------

STEPS = [(1000, 0.1, 2.5, None), (1000, 0.125, 2.25, 1.5),
         (512, 0.05, 2.0, None), (2048, 0.2, 1.75, 0.75),
         (1000, 0.0, 1.5, None)]


def test_reporters_publish_equal_registries():
    """The same step() sequence (a zero interval among them) through both
    reporters, loss_lag 2: equal snapshots after every step, after the
    flush and in snapshot()."""
    jreg, treg = j_metrics.MetricsRegistry(), t_metrics.MetricsRegistry()
    jt = j_tel.TrainingTelemetry(flops_per_token=lambda s: 6.0 * s,
                                 peak_flops=1e6, registry=jreg, loss_lag=2)
    tt = t_tel.TrainingTelemetry(flops_per_token=lambda s: 6.0 * s,
                                 peak_flops=1e6, registry=treg, loss_lag=2)
    for tokens, dt, loss, gnorm in STEPS:
        jt.step(tokens, dt, seq_len=tokens // 2,
                loss=paddle_tpu.to_tensor(np.float32(loss)),
                grad_norm=gnorm)
        tt.step(tokens, dt, seq_len=tokens // 2,
                loss=torch.tensor(loss, dtype=torch.float32),
                grad_norm=gnorm)
        assert treg.snapshot() == jreg.snapshot()
    assert treg.gauge("train.loss").value() == 2.0     # lag 2 of 5
    assert tt.snapshot() == jt.snapshot()
    assert treg.snapshot() == jreg.snapshot()
    assert tt.last_loss == 1.5 and tt.steps == 5


@pytest.mark.parametrize("recompute", [False, True])
def test_flops_per_token_matches_jax(recompute):
    cfg_kw = dict(TINY, recompute=recompute)
    paddle_tpu.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.tiny_llama_config(**cfg_kw))
    tm = tllama.LlamaForCausalLM(tllama.tiny_llama_config(**cfg_kw),
                                 device="cpu")
    for seq in (16, 2048):
        want = j_tel.flops_per_token_for(jm, seq)
        assert t_tel.flops_per_token_for(tm, seq) == want
    # no config: 6 x the trainable parameters
    jl, tl = jnn.Linear(4, 5), torch.nn.Linear(4, 5)
    assert t_tel.flops_per_token_for(tl, 7) == \
        j_tel.flops_per_token_for(jl, 7) == 6.0 * 25
    tl.bias.requires_grad_(False)
    assert t_tel.flops_per_token_for(tl, 7) == 6.0 * 20


def test_peak_table_is_the_cards():
    assert t_tel.peak_flops_for_kind("NVIDIA H100 80GB HBM3") == 989e12
    assert t_tel.peak_flops_for_kind("TPU v5") is None
    assert t_tel.peak_flops_for_kind("") is None
    assert j_tel.peak_flops_for_kind("") == 459e12    # the JAX default
    assert t_tel.detect_peak_flops("cpu") is None
    if not torch.cuda.is_available():
        assert t_tel.detect_peak_flops() is None
    assert t_tel.TrainingTelemetry(peak_flops=None).mfu(1e4, 16) == 0.0


# -- the Trainer --------------------------------------------------------------

def test_trainer_step_drives_telemetry():
    """tests/test_observability.py:292 on the port: no reporter while
    disabled; with observability on, 3 steps report 2 intervals; the
    lagged loss materializes on flush; MFU is 0 on the CPU."""
    _, tr = _pair()
    ids = _ids(2, 16)
    batch = {"input_ids": ids, "labels": ids}
    tr.step(batch)
    assert tr.telemetry is None
    with t_obs.scoped() as reg:
        losses = [float(tr.step(batch)) for _ in range(3)]
        tel = tr.telemetry
        assert tel is not None and tel.steps == 2
        assert reg.counter("train.steps").value() == 2
        assert reg.gauge("train.tokens_per_sec").value() > 0
        assert reg.histogram("train.step.seconds").count() == 2
        tel.flush()
        # the second call's loss: the third is reported at a fourth
        assert tel.last_loss == losses[1]
        assert reg.gauge("train.loss").value() == losses[1]
        assert reg.gauge("train.mfu").value() == 0.0
    # disabled mid-run: the stale stamp is dropped, nothing is reported
    tr.step(batch)
    assert tr._tel_last_t is None and tel.steps == 2


def _jax_store():
    return JaxStore(is_master=True, world_size=1, timeout=5.0)


def _torch_store():
    return tdist.TCPStore("127.0.0.1", 0, 1, True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=5))


HEARTBEAT = {
    "jax": types.SimpleNamespace(trainer=JTrainer, fleet=j_fleet,
                                 obs=j_obs, store=_jax_store,
                                 has=lambda s, k: s.check(k)),
    "port": types.SimpleNamespace(trainer=Trainer, fleet=t_fleet,
                                  obs=t_obs, store=_torch_store,
                                  has=lambda s, k: s.check([k]))}


@pytest.mark.parametrize("pkg", sorted(HEARTBEAT))
def test_disabled_heartbeat_zero_side_effects(pkg, monkeypatch):
    """tests/test_fleet_telemetry.py:483-509, the Trainer half, on both
    packages: with observability off, fleet_heartbeat never constructs a
    FleetHeartbeat, starts no thread and writes no store key."""
    P = HEARTBEAT[pkg]
    assert P.obs.ENABLED is False
    store = P.store()
    before = set(threading.enumerate())

    def _boom(*a, **k):
        raise AssertionError("FleetHeartbeat constructed while "
                             "observability is disabled")

    monkeypatch.setattr(P.fleet.FleetHeartbeat, "__init__", _boom)
    try:
        t = object.__new__(P.trainer)       # no model needed for the gate
        assert P.trainer.fleet_heartbeat(t, store, 0, 1) is None
        assert not P.has(store, "fleet/hb/0")
        leaked = [th for th in threading.enumerate()
                  if th not in before and th.is_alive()
                  and th.name.startswith("fleet-")]
        assert leaked == []
    finally:
        close = getattr(store, "close", None)
        if close is not None:
            close()


def test_heartbeat_publishes_the_trainers_telemetry():
    """With observability on, the port Trainer's heartbeat carries the
    registry's step, tokens/s and MFU, and its thread ends with stop()."""
    _, tr = _pair()
    ids = _ids(2, 16)
    store = _torch_store()
    with t_obs.scoped() as reg:
        hb = tr.fleet_heartbeat(store, 0, 1, interval=30.0)
        try:
            for _ in range(3):
                tr.step({"input_ids": ids, "labels": ids})
            hb.publish()
            agg = t_fleet.FleetAggregator(store, 1)
            row = agg.scan()["ranks"][0]
        finally:
            hb.stop()
        assert row["step"] == reg.counter("train.steps").value() == 2
        assert row["tokens_per_sec"] == round(
            reg.gauge("train.tokens_per_sec").value(), 4)
        assert row["mfu"] == 0
        assert row["recompiles"] == 1
    assert not [th for th in threading.enumerate()
                if th.name.startswith("fleet-") and th.is_alive()]


def _recompile_cells(pkg):
    paddle_tpu.seed(0)
    jtr, ttr = _pair()
    tr, obs = (jtr, j_obs) if pkg == "jax" else (ttr, t_obs)
    rng = np.random.RandomState(0)

    def batch(b, s):
        ids = rng.randint(0, 97, (b, s)).astype(np.int32)
        return {"input_ids": ids, "labels": ids}

    # a shape warmed with observability DISABLED is never counted
    tr.step(batch(2, 8))
    with obs.scoped() as reg:
        tr.step(batch(2, 8))            # warm shape: no count
        tr.step(batch(2, 16))           # new signature: counted
        tr.step(batch(2, 16))           # same signature: no new count
        tr.step(batch(2, 24))           # new sequence length: counted
        c = reg.counter("train.recompiles")
        return {dict(k)["shape"]: v for k, v in c.labeled().items()}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_recompile_counter_labeled_with_batch_shape(pkg):
    """tests/test_fleet_telemetry.py:568 on both packages: one count per
    new batch signature, the same label strings (numpy dtype names)."""
    assert _recompile_cells(pkg) == {
        "input_ids:2x16:int32,labels:2x16:int32": 1,
        "input_ids:2x24:int32,labels:2x24:int32": 1,
    }


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_logits_bytes_saved_matches_jax(compute_dtype):
    """A blockwise-loss model (loss_chunk 8) publishes the JAX trainer's
    train.loss.logits_bytes_saved; a dense one publishes none."""
    jtr, ttr = _pair(loss_chunk=8, compute_dtype=compute_dtype)
    ids = _ids(2, 16)
    batch = {"input_ids": ids, "labels": ids}
    with j_obs.scoped() as jreg:
        jtr.step(batch)
        want = jreg.gauge("train.loss.logits_bytes_saved").value()
    with t_obs.scoped() as treg:
        ttr.step(batch)
        assert treg.gauge("train.loss.logits_bytes_saved").value() == want
    assert want == (32 * 97 - 8 * 97) * (2 if compute_dtype else 4)
    _, dense = _pair()
    with t_obs.scoped() as treg:
        dense.step(batch)
        assert "train.loss.logits_bytes_saved" not in treg.names()


def test_nonfinite_skips_counted_as_the_jax_trainer_counts():
    """The same two poisoned steps of three under skip_nonfinite_grads:
    both trainers skip them, and both registries count
    train.nonfinite_skips 2 (the JAX trainer poisons through its chaos
    site, the port's gradient is set to NaN directly)."""
    jtr, ttr = _pair(skip_nonfinite_grads=True)
    ids = _ids(2, 16)
    batch = {"input_ids": ids, "labels": ids}
    with j_obs.scoped() as jreg:
        with j_chaos.scoped(seed=0, rates={"trainer.grad": (1.0, 2)}):
            for _ in range(3):
                jtr.step(batch)
        jcount = jreg.counter("train.nonfinite_skips").value()
    run = ttr._forward_backward
    calls = []

    def poisoned(b, backward=True):
        loss = run(b, backward)
        calls.append(1)
        if len(calls) <= 2:
            next(ttr.model.parameters()).grad.view(-1)[0] = float("nan")
        return loss

    ttr._forward_backward = poisoned
    with t_obs.scoped() as treg:
        for _ in range(3):
            ttr.step(batch)
        tcount = treg.counter("train.nonfinite_skips").value()
    assert jtr.nonfinite_skipped == ttr.nonfinite_skipped == 2
    assert tcount == jcount == 2
