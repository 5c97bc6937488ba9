"""The port Trainer's checkpoints and training chaos sites against the
JAX Trainer's, on the CPU.

- Both Trainers start from the same numpy weights (models/convert.py),
  take 3 steps, save, load into fresh trainers (other weights) and take
  3 more: the 6 losses within 1e-5 relative across the packages, as
  slice 3's trajectory test holds them (the same f32 expressions,
  summed in other orders).
- The port's resumed run is bit-equal to its uninterrupted run (losses,
  parameters, moments), from a sync save, from an async save
  (tests/test_async_checkpoint.py:192) and with bf16 parameters and f32
  master copies (multi_precision); `checkpoint_state` before any step
  holds zero moments for every parameter.
- `train.grad.nan` and `train.loss.spike` under `health_probe`, and
  `trainer.grad` under `skip_nonfinite_grads`, fire on the same steps in
  both packages (one seeded decision stream a site) and give the JAX
  trainer's applied flags and `nonfinite_skipped`; a suppressed step
  leaves every parameter and moment bit-identical
  (tests/test_chaos_resilience.py:351-403). With chaos off the port
  consults no site.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed import chaos as j_chaos
from paddle_tpu.jit.functional import state_arrays
from paddle_tpu.models import llama as jllama
from paddle_tpu.parallel import Trainer as JTrainer
from paddle_tpu.parallel import TrainStepConfig as JStepConfig
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import chaos as t_chaos
from paddle_tpu_torch.distributed.async_checkpoint import AsyncCheckpointer
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import from_paddle_tpu_state
from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

TINY = dict(num_hidden_layers=2, vocab_size=97, hidden_size=64,
            num_attention_heads=2, num_key_value_heads=1)


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, 97, (2, 16)).astype(np.int32)
        out.append({"input_ids": ids, "labels": ids})
    return out


def _jax_trainer(seed, **step_kw):
    paddle_tpu.seed(seed)
    jm = jllama.LlamaForCausalLM(jllama.tiny_llama_config(**TINY))
    init = {k: np.asarray(v) for k, v in state_arrays(jm).items()}
    tr = JTrainer(jm, jopt.AdamW(learning_rate=1e-2,
                                 parameters=jm.parameters()),
                  config=JStepConfig(compute_dtype=None, **step_kw))
    return tr, init


def _port_trainer(init=None, seed=0, dtype=torch.float32,
                  multi_precision=False, **step_kw):
    cfg = tllama.tiny_llama_config(**TINY)
    tm = tllama.LlamaForCausalLM(cfg, device="cpu", seed=seed)
    if init is not None:
        tm.load_state_dict(from_paddle_tpu_state(init, cfg))
    tm.to(dtype)
    return Trainer(tm, topt.AdamW(learning_rate=1e-2,
                                  parameters=tm.named_parameters(),
                                  multi_precision=multi_precision),
                   TrainStepConfig(compute_dtype=None, **step_kw))


def _state(tr):
    """A copy of every parameter and optimizer-state tensor (the state
    made first where no step has made it yet)."""
    tr.checkpoint_state()
    out = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    for n, st in tr.optimizer.state.items():
        out.update({f"{n}/{k}": v.clone() for k, v in st.items()})
    return out


def _assert_bits_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _jax_state(tr):
    out = {n: np.asarray(v).copy() for n, v in tr.params.items()}
    for n, st in tr.opt_state.items():
        out.update({f"{n}/{k}": np.asarray(v).copy() for k, v in st.items()})
    return out


def _assert_jax_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


# -- resume -----------------------------------------------------------------

def test_resumed_trajectory_matches_jax(tmp_path):
    batches = _batches(6)
    jtr, init = _jax_trainer(0)
    ttr = _port_trainer(init)
    jl = [float(jtr.step(b).numpy()) for b in batches[:3]]
    tl = [float(ttr.step(b)) for b in batches[:3]]
    jtr.save_checkpoint(str(tmp_path / "jax"))
    ttr.save_checkpoint(str(tmp_path / "port"))
    jtr2, _ = _jax_trainer(5)           # other weights, then the load
    ttr2 = _port_trainer(seed=5)
    jtr2.load_checkpoint(str(tmp_path / "jax"))
    ttr2.load_checkpoint(str(tmp_path / "port"))
    jl += [float(jtr2.step(b).numpy()) for b in batches[3:]]
    tl += [float(ttr2.step(b)) for b in batches[3:]]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    # the checkpoints hold the same names: the JAX package's layout
    # ({params, opt.{name}.{moment1, moment2, beta1_pow, beta2_pow}})
    import json
    jt = json.loads((tmp_path / "jax" / "table_0.json").read_text())
    tt = json.loads((tmp_path / "port" / "table_0.json").read_text())
    assert sorted(jt) == sorted(tt)


@pytest.mark.parametrize("mode", ["sync", "async", "bf16_master"])
def test_resume_is_bit_equal_to_the_uninterrupted_run(mode, tmp_path):
    kw = (dict(dtype=torch.bfloat16, multi_precision=True)
          if mode == "bf16_master" else {})
    batches = _batches(6, seed=1)
    whole = _port_trainer(**kw)
    want = [whole.step(b) for b in batches]
    cp = AsyncCheckpointer() if mode == "async" else None
    try:
        first = _port_trainer(**kw)
        first.checkpointer = cp
        got = [first.step(b) for b in batches[:3]]
        first.save_checkpoint(str(tmp_path / "c"))
        saved = _state(first)
        if cp is not None:
            first.step(batches[3])      # in place, right after save()
            cp.flush()
        second = _port_trainer(seed=9, **kw)
        second.checkpointer = cp
        second.load_checkpoint(str(tmp_path / "c"))
        _assert_bits_equal(_state(second), saved)
        got += [second.step(b) for b in batches[3:]]
    finally:
        if cp is not None:
            cp.close()
    assert [float(x) for x in got] == [float(x) for x in want]
    _assert_bits_equal(_state(second), _state(whole))


def test_checkpoint_state_before_any_step_holds_zero_moments(tmp_path):
    tr = _port_trainer()
    sd = tr.checkpoint_state()
    names = [n for n, _ in tr.model.named_parameters()]
    assert sorted(sd["params"]) == sorted(sd["opt"]) == sorted(names)
    for n, st in sd["opt"].items():
        assert sorted(st) == ["beta1_pow", "beta2_pow", "moment1",
                              "moment2"]
        assert not st["moment1"].any() and float(st["beta1_pow"]) == 1.0
    tr.save_checkpoint(str(tmp_path / "c"))
    fresh = _port_trainer(seed=3)
    fresh.load_checkpoint(str(tmp_path / "c"))
    _assert_bits_equal(_state(fresh), _state(tr))


# -- chaos ------------------------------------------------------------------

def _probe_run(site, rates, steps, cap=None):
    """Both trainers (health_probe) from the same weights through the
    same chaos configuration: their losses, probes, and whether each
    suppressed step left the state bit-identical."""
    batches = _batches(steps, seed=2)
    out = {}
    jtr, init = _jax_trainer(0, health_probe=True)
    ttr = _port_trainer(init, health_probe=True)
    for name, tr in (("jax", jtr), ("port", ttr)):
        chaos = j_chaos if name == "jax" else t_chaos
        rows = []
        with chaos.scoped(seed=3, rates=rates):
            if cap is not None:
                tr.set_loss_cap(cap)
            for b in batches:
                before = (_jax_state(tr) if name == "jax" else _state(tr))
                loss = tr.step(b)
                probe = np.asarray(tr.last_probe, np.float32)
                if probe[1] == 0.0:     # suppressed: nothing moved
                    if name == "jax":
                        _assert_jax_equal(_jax_state(tr), before)
                    else:
                        _assert_bits_equal(_state(tr), before)
                rows.append((float(np.asarray(loss)), probe))
            fired = chaos.fire_count(site)
        out[name] = (rows, fired)
    return out


def test_grad_nan_under_the_health_probe_matches_jax():
    out = _probe_run("train.grad.nan", {"train.grad.nan": 0.5}, 6)
    (jrows, jfired), (trows, tfired) = out["jax"], out["port"]
    assert tfired == jfired and 0 < tfired < 6
    for (jl, jp), (tl, tp) in zip(jrows, trows):
        assert tp[1] == jp[1]                       # applied or not
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        if jp[1]:
            np.testing.assert_allclose(tp[0], jp[0], rtol=1e-5)
        else:
            assert np.isnan(tp[0]) and np.isnan(jp[0])


def test_loss_spike_under_a_loss_cap_matches_jax():
    out = _probe_run("train.loss.spike", {"train.loss.spike": (1.0, 2)},
                     4, cap=50.0)
    (jrows, jfired), (trows, tfired) = out["jax"], out["port"]
    assert tfired == jfired == 2
    assert [p[1] for _, p in trows] == [p[1] for _, p in jrows] == \
        [0.0, 0.0, 1.0, 1.0]
    for (jl, jp), (tl, tp) in zip(jrows, trows):
        np.testing.assert_allclose(tl, jl, rtol=1e-5)   # spiked x100 too
        np.testing.assert_allclose(tp[0], jp[0], rtol=1e-5)
    assert trows[0][0] > 50.0 > trows[2][0]


def test_grad_poison_under_skip_nonfinite_matches_jax():
    batches = _batches(4, seed=4)
    jtr, init = _jax_trainer(0, skip_nonfinite_grads=True)
    ttr = _port_trainer(init, skip_nonfinite_grads=True)
    with j_chaos.scoped(seed=2, rates={"trainer.grad": (1.0, 2)}):
        j0 = _jax_state(jtr)
        jtr.step(batches[0])
        _assert_jax_equal(_jax_state(jtr), j0)
        for b in batches[1:]:
            jtr.step(b)
    with t_chaos.scoped(seed=2, rates={"trainer.grad": (1.0, 2)}):
        t0 = _state(ttr)
        ttr.step(batches[0])
        _assert_bits_equal(_state(ttr), t0)
        for b in batches[1:]:
            ttr.step(b)
    assert ttr.nonfinite_skipped == jtr.nonfinite_skipped == 2
    assert ttr.nonfinite_streak == jtr.nonfinite_streak == 0


def test_chaos_off_consults_no_site(monkeypatch):
    """With chaos disabled the step reads one flag: no site decision."""
    tr = _port_trainer()
    calls = []
    monkeypatch.setattr(t_chaos, "site_rate",
                        lambda s: calls.append(s) or 0.0)
    tr.step(_batches(1)[0])
    assert calls == []
    with t_chaos.scoped(seed=0, rates={}):
        tr.step(_batches(1)[0])
    assert calls == ["trainer.grad", "train.grad.nan", "train.loss.spike"]
