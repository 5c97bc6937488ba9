"""The port's training path against the JAX package's, on the CPU.

Weights are made by the JAX model (seeded), exported to numpy and carried
into the port by `from_paddle_tpu_state`; the same numpy token ids go to
both packages. The port runs on the CPU, where its kernel wrappers take
their plain twins inside the same autograd Functions the card runs.

Tolerances, f32 throughout unless stated:
- loss and gradients of the tiny model: 1e-5 relative to each
  gradient's largest entry (sums over the same products in other orders
  through a 2-layer model);
- AdamW: parameters and moments within 1e-6 relative (the same f32
  expressions, rounded in the same places);
- the Trainer's 3-step trajectory: losses within 1e-5 relative,
  parameters within 1e-5 absolute, 1% of one step's learning rate
  (Adam divides each gradient entry by its own root mean square, so an
  entry whose gradient is near the f32 noise of the sums can move by up
  to the learning rate either way);
- the bf16-compute trajectory: losses within 1e-3 relative. The two
  frameworks round the bf16 activations at other places; over seeds 6-8
  the gap measured up to 1.9e-4 relative, as large as the gap between
  bf16 and f32 compute, so the test also checks that the attention ran
  on bf16 tensors;
- the blockwise loss (loss_chunk > 0): as the dense model, loss within
  1e-5 relative and every gradient within 1e-5 of its largest entry;
- the Trainer with ClipGradByGlobalNorm and a LinearWarmup schedule: as
  the f32 trajectory above; the health probe's gradient norm within 1e-5
  relative; a suppressed step leaves the state bit-identical; the LR
  schedules equal the JAX package's exactly (the same Python floats).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.jit.functional import functional_call, state_arrays
from paddle_tpu.models import llama as jllama
from paddle_tpu.nn import functional as jF
from paddle_tpu.parallel import Trainer as JTrainer
from paddle_tpu.parallel import TrainStepConfig as JStepConfig
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed.recompute import recompute
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import from_paddle_tpu_state
from paddle_tpu_torch.nn import (ClipGradByGlobalNorm, ClipGradByNorm,
                                 ClipGradByValue)
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.optimizer import global_grad_norm
from paddle_tpu_torch.parallel.trainer import (NonFiniteGradError, Trainer,
                                               TrainStepConfig)

TRAIN = dict(num_hidden_layers=2, vocab_size=97, hidden_size=128,
             num_attention_heads=2, num_key_value_heads=1,
             use_flash_attention=True, fused_norm=True, fused_rope=True,
             recompute=True)


def _pair(seed=0, **overrides):
    """(JAX model, port model with the same weights, port config)."""
    kw = dict(TRAIN, **overrides)
    paddle_tpu.seed(seed)
    jm = jllama.LlamaForCausalLM(jllama.tiny_llama_config(**kw))
    state = {k: np.asarray(v) for k, v in state_arrays(jm).items()}
    cfg = tllama.tiny_llama_config(**kw)
    tm = tllama.LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(from_paddle_tpu_state(state, cfg))
    return jm, tm, cfg


def _ids(b=2, s=16, seed=0, vocab=97):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


def _assert_rel(got, want, tol, name=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * scale, f"{name}: |err| {err} > {tol} x {scale}"


def test_model_loss_and_gradients_match_jax():
    jm, tm, cfg = _pair()
    ids = _ids()
    jstate = state_arrays(jm)

    def jloss(params):
        out = functional_call(jm, params, input_ids=JTensor(jnp.asarray(ids)),
                              labels=JTensor(jnp.asarray(ids)))
        return out[0]._value.astype(jnp.float32)

    jl, jgrads = jax.value_and_grad(jloss)(jstate)
    tm.requires_grad_(True).train()
    loss, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    assert logits.shape == (2, 16, 97) and loss.dtype == torch.float32
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = from_paddle_tpu_state({k: np.asarray(v)
                                  for k, v in jgrads.items()}, cfg)
    for name, p in tm.named_parameters():
        _assert_rel(p.grad.numpy(), want[name].numpy(), 1e-5, name)


@pytest.mark.parametrize("ignored", [0, 5])
def test_cross_entropy_matches_jax(ignored):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(12, 31)).astype(np.float32) * 3
    labels = rng.integers(0, 31, size=12).astype(np.int32)
    labels[:ignored] = -100
    jl, jg = jax.value_and_grad(lambda x: jF.cross_entropy(
        JTensor(x), JTensor(jnp.asarray(labels)))._value)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    tl = tF.cross_entropy(x, torch.from_numpy(labels))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    xb = x.detach().bfloat16().requires_grad_(True)
    tF.cross_entropy(xb, torch.from_numpy(labels)).backward()
    assert xb.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("multi_precision", [False, True])
def test_adamw_three_steps_match_jax(multi_precision):
    rng = np.random.default_rng(4)
    shapes = {"a.weight": (5, 7), "b.bias": (7,), "norm.weight": (3,)}
    params = {n: rng.normal(size=s).astype(np.float32)
              for n, s in shapes.items()}
    grads = [{n: rng.normal(size=s).astype(np.float32)
              for n, s in shapes.items()} for _ in range(3)]
    dtype_j = jnp.bfloat16 if multi_precision else jnp.float32
    dtype_t = torch.bfloat16 if multi_precision else torch.float32

    def decay(name):
        return "norm" not in name

    jo = jopt.AdamW(learning_rate=1e-2, parameters=[], weight_decay=0.1,
                    apply_decay_param_fun=decay,
                    multi_precision=multi_precision)
    jp = {n: jnp.asarray(v, dtype_j) for n, v in params.items()}
    jstate = jo.init_state_arrays(jp)
    tp = {n: torch.from_numpy(v).to(dtype_t) for n, v in params.items()}
    to = topt.AdamW(learning_rate=1e-2, parameters=tp.items(),
                    weight_decay=0.1, apply_decay_param_fun=decay,
                    multi_precision=multi_precision)
    for g in grads:
        jp, jstate = jo.apply_gradients_arrays(
            jp, {n: jnp.asarray(v, dtype_j) for n, v in g.items()}, jstate,
            jnp.asarray(1e-2, jnp.float32))
        for n, p in tp.items():
            p.grad = torch.from_numpy(g[n]).to(dtype_t)
        to.step()
    for n, p in tp.items():
        np.testing.assert_allclose(p.float().numpy(),
                                   np.asarray(jp[n], np.float32),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
        for key in ("moment1", "moment2") + (("master",) if multi_precision
                                             else ()):
            np.testing.assert_allclose(to.state[n][key].numpy(),
                                       np.asarray(jstate[n][key]),
                                       rtol=1e-6, atol=1e-9,
                                       err_msg=f"{n} {key}")


def _jax_trajectory(ids, compute_dtype, accum, steps=3):
    paddle_tpu.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.tiny_llama_config(**TRAIN))
    init = {k: np.asarray(v) for k, v in state_arrays(jm).items()}
    tr = JTrainer(jm, jopt.AdamW(learning_rate=1e-3,
                                 parameters=jm.parameters()),
                  config=JStepConfig(compute_dtype=compute_dtype,
                                     grad_accum_steps=accum))
    losses = [float(np.asarray(tr.step({"input_ids": ids, "labels": ids})
                               .numpy())) for _ in range(steps)]
    final = {k: np.asarray(v) for k, v in tr.params.items()}
    return init, losses, final


def _port_trajectory(init, ids, compute_dtype, accum, steps=3):
    cfg = tllama.tiny_llama_config(**TRAIN)
    tm = tllama.LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(from_paddle_tpu_state(init, cfg))
    tr = Trainer(tm, topt.AdamW(learning_rate=1e-3,
                                parameters=tm.named_parameters()),
                 TrainStepConfig(compute_dtype=compute_dtype,
                                 grad_accum_steps=accum))
    losses = []
    for _ in range(steps):
        loss = tr.step({"input_ids": ids, "labels": ids})
        assert loss.shape == () and loss.dtype == torch.float32
        losses.append(float(loss))
    return cfg, tm, losses


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_f32_trajectory_matches_jax(accum):
    ids = _ids(b=4, s=16, seed=5)
    init, jlosses, jfinal = _jax_trajectory(ids, None, accum)
    cfg, tm, tlosses = _port_trajectory(init, ids, None, accum)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    want = from_paddle_tpu_state(jfinal, cfg)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_trainer_bf16_compute_trajectory_matches_jax(monkeypatch):
    ids = _ids(b=2, s=16, seed=6)
    init, jlosses, _ = _jax_trajectory(ids, "bfloat16", 1)
    seen = []
    fwd = tfa.flash_attention_fwd

    def recording(q, *args):
        seen.append(q.dtype)
        return fwd(q, *args)

    # _FlashAttention.forward calls the module's wrapper by name
    monkeypatch.setattr(tfa, "flash_attention_fwd", recording)
    _, tm, tlosses = _port_trajectory(init, ids, "bfloat16", 1)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-3)
    # the loss's bf16 rounding is of the size of the two frameworks' gap,
    # so the losses alone cannot show that bf16 ran: the attention did,
    # on every layer's forward and its recomputation in every step
    assert seen == [torch.bfloat16] * (3 * 2 * TRAIN["num_hidden_layers"])
    # the f32 parameters stay f32 and were updated from f32 gradients
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in tm.parameters())


def test_recompute_reruns_the_layer_and_keeps_gradients():
    """Recompute gives the gradients of the plain call, and the flash
    Function runs again inside the recomputation."""
    _, tm, _ = _pair()
    layer = tm.model.layers[0]
    layer.requires_grad_(True)
    x = torch.randn(2, 16, 128, generator=torch.Generator().manual_seed(0))
    calls = []
    fwd = tfa._FlashAttention.forward

    def counting(ctx, *args):
        calls.append(1)
        return fwd(ctx, *args)

    grads = []
    for use in (False, True):
        xi = x.clone().requires_grad_(True)
        tfa._FlashAttention.forward = staticmethod(counting)
        try:
            out = recompute(layer, xi) if use else layer(xi)
            n_fwd = len(calls)
            out.square().sum().backward()
        finally:
            tfa._FlashAttention.forward = staticmethod(fwd)
        grads.append([xi.grad] + [p.grad.clone() for p in layer.parameters()])
        layer.zero_grad()
        if use:
            assert len(calls) == n_fwd + 1      # the recomputation
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_guards():
    _, tm, _ = _pair(loss_chunk=8)
    ids = torch.from_numpy(_ids())
    assert not any(p.requires_grad for p in tm.parameters())
    assert not tm.training
    with torch.no_grad():
        assert tm(ids).shape == (2, 16, 97)     # serving forward still works
        # the blockwise loss builds no logits to return
        loss, logits = tm(ids, labels=ids)
    assert logits is None and loss.shape == () and torch.isfinite(loss)
    # a serving-built model's forward records no autograd graph
    _, served, _ = _pair()
    assert served(ids).grad_fn is None
    # no kernel takes f16, so the Trainer does not offer it
    with pytest.raises(ValueError, match="compute_dtype"):
        Trainer(served, topt.AdamW(parameters=served.named_parameters()),
                TrainStepConfig(compute_dtype="float16"))



# -- slice 3: the blockwise loss and the Trainer's features ---------------

@pytest.mark.parametrize("tied", [False, True])
def test_blockwise_model_loss_and_gradients_match_jax(tied):
    """loss_chunk 8 and loss_vocab_block 32 over 33 rows and a vocab of
    97: a partial last row chunk and vocab block; tied and untied head."""
    jm, tm, cfg = _pair(loss_chunk=8, loss_vocab_block=32,
                        tie_word_embeddings=tied)
    ids = _ids(b=3, s=11, seed=2)
    jstate = state_arrays(jm)

    def jloss(params):
        out = functional_call(jm, params, input_ids=JTensor(jnp.asarray(ids)),
                              labels=JTensor(jnp.asarray(ids)))
        assert out[1] is None
        return out[0]._value.astype(jnp.float32)

    jl, jgrads = jax.value_and_grad(jloss)(jstate)
    tm.requires_grad_(True).train()
    loss, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    assert logits is None and loss.dtype == torch.float32
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = from_paddle_tpu_state({k: np.asarray(v)
                                  for k, v in jgrads.items()}, cfg)
    assert ("lm_head.weight" in want) != tied
    for name, p in tm.named_parameters():
        _assert_rel(p.grad.numpy(), want[name].numpy(), 1e-5, name)


def _schedule(module):
    return module.lr.LinearWarmup(learning_rate=1e-3, warmup_steps=2,
                                  start_lr=1e-4, end_lr=1e-3)


def test_trainer_clip_and_schedule_match_jax():
    """Three f32 Trainer steps with the blockwise loss, AdamW under
    ClipGradByGlobalNorm(0.5) (which clips: the gradient norm is larger)
    and a LinearWarmup schedule stepped after each step, against the JAX
    Trainer."""
    kw = dict(TRAIN, loss_chunk=8)
    ids = _ids(b=4, s=16, seed=5)
    paddle_tpu.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.tiny_llama_config(**kw))
    init = {k: np.asarray(v) for k, v in state_arrays(jm).items()}
    jsched = _schedule(jopt)
    jtr = JTrainer(jm, jopt.AdamW(learning_rate=jsched,
                                  parameters=jm.parameters(),
                                  grad_clip=jnn.ClipGradByGlobalNorm(0.5)),
                   config=JStepConfig(compute_dtype=None))
    cfg = tllama.tiny_llama_config(**kw)
    tm = tllama.LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(from_paddle_tpu_state(init, cfg))
    tsched = _schedule(topt)
    ttr = Trainer(tm, topt.AdamW(learning_rate=tsched,
                                 parameters=tm.named_parameters(),
                                 grad_clip=ClipGradByGlobalNorm(0.5)),
                  TrainStepConfig(compute_dtype=None))
    jlosses, tlosses, lrs = [], [], []
    for _ in range(3):
        jlosses.append(float(np.asarray(
            jtr.step({"input_ids": ids, "labels": ids}).numpy())))
        tlosses.append(float(ttr.step({"input_ids": ids, "labels": ids})))
        lrs.append(ttr.optimizer.get_lr())
        # the gradients the clip saw (p.grad keeps them unclipped)
        assert float(global_grad_norm(
            [p.grad for p in tm.parameters()])) > 0.5
        jsched.step()
        tsched.step()
    assert lrs == [1e-4, 5.5e-4, 1e-3]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    want = from_paddle_tpu_state({k: np.asarray(v)
                                  for k, v in jtr.params.items()}, cfg)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("policy", [ClipGradByNorm(0.3),
                                    ClipGradByValue(0.05)])
def test_per_tensor_clip_policies(policy):
    """ClipGradByNorm and ClipGradByValue equal AdamW fed the gradients
    clipped by hand (the JAX package's eager `Optimizer.step` rules)."""
    rng = np.random.default_rng(9)
    shapes = {"a": (5, 7), "b": (7,)}
    init = {n: rng.normal(size=sh).astype(np.float32)
            for n, sh in shapes.items()}
    grads = {n: rng.normal(size=sh).astype(np.float32)
             for n, sh in shapes.items()}

    def clipped(g):
        if isinstance(policy, ClipGradByValue):
            return np.clip(g, policy.min, policy.max)
        return g * min(1.0, policy.clip_norm / max(np.linalg.norm(g), 1e-12))

    out = []
    for clip in (policy, None):
        ps = {n: torch.from_numpy(v.copy()) for n, v in init.items()}
        opt = topt.AdamW(learning_rate=1e-2, parameters=ps.items(),
                         grad_clip=clip)
        for n, pt in ps.items():
            pt.grad = torch.from_numpy(grads[n] if clip is not None
                                       else clipped(grads[n]))
        opt.step()
        out.append(ps)
    for n in shapes:
        torch.testing.assert_close(out[0][n], out[1][n], rtol=1e-6,
                                   atol=1e-7)


def _tiny_trainer(seed=0, **config):
    cfg = tllama.tiny_llama_config(**TRAIN)
    tm = tllama.LlamaForCausalLM(cfg, device="cpu", seed=seed)
    return Trainer(tm, topt.AdamW(learning_rate=1e-3,
                                  parameters=tm.named_parameters()),
                   TrainStepConfig(compute_dtype=None, **config))


def _state(tr):
    """A copy of every parameter and optimizer-state tensor."""
    out = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    for n, st in tr.optimizer.state.items():
        out.update({f"{n}/{k}": v.clone() for k, v in st.items()})
    return out


def _assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _poison(monkeypatch, tr):
    """The trainer's next steps get a NaN in one gradient."""
    run = tr._forward_backward

    def poisoned(batch, backward=True):
        loss = run(batch, backward)
        if backward:
            next(tr.model.parameters()).grad.view(-1)[0] = float("nan")
        return loss

    monkeypatch.setattr(tr, "_forward_backward", poisoned)


def test_nonfinite_step_is_skipped_with_state_bit_identical(monkeypatch):
    batch = {"input_ids": _ids(seed=4), "labels": _ids(seed=4)}
    clean = _tiny_trainer(skip_nonfinite_grads=True)
    clean.step(batch)
    tr = _tiny_trainer(skip_nonfinite_grads=True,
                       max_consecutive_nonfinite=3)
    tr.step(batch)
    before = _state(tr)
    with monkeypatch.context() as m:
        _poison(m, tr)
        loss = tr.step(batch)
    assert torch.isfinite(loss)
    assert tr.nonfinite_skipped == 1 and tr.nonfinite_streak == 1
    _assert_state_equal(_state(tr), before)    # parameters, moments, pows
    tr.step(batch)                             # healthy again
    assert tr.nonfinite_skipped == 1 and tr.nonfinite_streak == 0
    # the skipped step left no trace: the same as never taking it
    clean.step(batch)
    _assert_state_equal(_state(tr), _state(clean))
    with monkeypatch.context() as m:
        _poison(m, tr)
        tr.step(batch)
        tr.step(batch)
        with pytest.raises(NonFiniteGradError):
            tr.step(batch)


def test_skip_flags_are_read_in_batches(monkeypatch):
    """nonfinite_check_every 2: the host reads the flags every second
    step, so the streak shows after the second poisoned step."""
    batch = {"input_ids": _ids(seed=4), "labels": _ids(seed=4)}
    tr = _tiny_trainer(skip_nonfinite_grads=True, nonfinite_check_every=2)
    _poison(monkeypatch, tr)
    tr.step(batch)
    assert tr.nonfinite_skipped == 0 and len(tr._pending_skips) == 1
    tr.step(batch)
    assert tr.nonfinite_skipped == 2 and not tr._pending_skips


def test_health_probe_matches_jax_and_suppresses(monkeypatch):
    ids = _ids(seed=6)
    paddle_tpu.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.tiny_llama_config(**TRAIN))
    init = {k: np.asarray(v) for k, v in state_arrays(jm).items()}
    jtr = JTrainer(jm, jopt.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters()),
                   config=JStepConfig(compute_dtype=None, health_probe=True))
    jtr.step({"input_ids": ids, "labels": ids})
    jprobe = np.asarray(jtr.last_probe)
    tr = _tiny_trainer(health_probe=True)
    tr.model.load_state_dict(from_paddle_tpu_state(init, tr.model.config))
    batch = {"input_ids": ids, "labels": ids}
    tr.step(batch)
    probe = tr.last_probe
    assert probe.shape == (2,) and probe.dtype == torch.float32
    assert float(probe[1]) == 1.0 == float(jprobe[1])
    np.testing.assert_allclose(float(probe[0]), float(jprobe[0]), rtol=1e-5)
    before = _state(tr)
    tr.set_loss_cap(1e-9)                      # every loss is a spike
    tr.step(batch)
    assert float(tr.last_probe[1]) == 0.0
    _assert_state_equal(_state(tr), before)
    tr.set_loss_cap(float("inf"))
    with monkeypatch.context() as m:
        _poison(m, tr)
        tr.step(batch)
    assert float(tr.last_probe[1]) == 0.0 and not np.isfinite(
        float(tr.last_probe[0]))
    _assert_state_equal(_state(tr), before)
    tr.step(batch)
    assert float(tr.last_probe[1]) == 1.0
    with pytest.raises(ValueError, match="health_probe"):
        _tiny_trainer(health_probe=True, skip_nonfinite_grads=True)


def test_lr_scale_scales_the_update():
    batch = {"input_ids": _ids(seed=7), "labels": _ids(seed=7)}
    a, b = _tiny_trainer(), _tiny_trainer()
    b.set_lr_scale(0.5)
    w0 = a.model.lm_head.weight.detach().clone()
    a.step(batch)
    b.step(batch)
    da = a.model.lm_head.weight.detach() - w0
    db = b.model.lm_head.weight.detach() - w0
    torch.testing.assert_close(db, 0.5 * da, rtol=1e-5, atol=1e-8)


_SCHEDULES = {
    "Noam": lambda m: m.NoamDecay(d_model=64, warmup_steps=4,
                                  learning_rate=1.0),
    "Piecewise": lambda m: m.PiecewiseDecay(boundaries=[3, 6],
                                            values=[0.1, 0.05, 0.01]),
    "NaturalExp": lambda m: m.NaturalExpDecay(0.1, gamma=0.3),
    "InverseTime": lambda m: m.InverseTimeDecay(0.1, gamma=0.3),
    "Polynomial": lambda m: m.PolynomialDecay(0.1, decay_steps=5,
                                              cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(0.1, warmup_steps=3,
                                             start_lr=0.0, end_lr=0.1),
    "LinearWarmupOverCosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, T_max=6), warmup_steps=3, start_lr=0.0,
        end_lr=0.1),
    "Exponential": lambda m: m.ExponentialDecay(0.1, gamma=0.8),
    "MultiStep": lambda m: m.MultiStepDecay(0.1, milestones=[2, 5]),
    "Step": lambda m: m.StepDecay(0.1, step_size=3),
    "Lambda": lambda m: m.LambdaDecay(0.1, lambda e: 0.9 ** e),
    "Multiplicative": lambda m: m.MultiplicativeDecay(0.1, lambda e: 0.9),
    "Cosine": lambda m: m.CosineAnnealingDecay(0.1, T_max=5, eta_min=0.01),
    "CosineWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=3, T_mult=2),
    "OneCycle": lambda m: m.OneCycleLR(0.1, total_steps=10),
    "Cyclic": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=3,
                                   mode="triangular2"),
    "LinearLR": lambda m: m.LinearLR(0.1, total_steps=5),
}


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_lr_schedule_matches_jax(name):
    js, ts = _SCHEDULES[name](jopt.lr), _SCHEDULES[name](topt.lr)
    for _ in range(12):
        assert ts() == js()
        js.step()
        ts.step()


def test_reduce_on_plateau_matches_jax():
    js = jopt.lr.ReduceOnPlateau(0.1, patience=1, cooldown=1)
    ts = topt.lr.ReduceOnPlateau(0.1, patience=1, cooldown=1)
    for metric in (1.0, 0.9, 0.95, 0.97, 0.99, 0.5, 0.6, 0.7, 0.8):
        js.step(metric)
        ts.step(torch.tensor(metric))
        assert ts() == js()
    assert ts() < 0.1


def test_optimizer_learning_rate_api():
    p = torch.zeros(3)
    opt = topt.AdamW(learning_rate=0.1, parameters=[("p", p)])
    assert opt.get_lr() == 0.1
    opt.set_lr(0.05)
    assert opt.get_lr() == 0.05
    sched = topt.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    opt = topt.AdamW(learning_rate=sched, parameters=[("p", p)])
    sched.step()
    assert opt.get_lr() == 0.05
    with pytest.raises(RuntimeError, match="scheduler"):
        opt.set_lr(0.2)


def test_measure_phase_seconds_returns_its_four_keys():
    tr = _tiny_trainer()
    batch = {"input_ids": _ids(seed=8), "labels": _ids(seed=8)}
    phases = tr.measure_phase_seconds(batch, iters=1)
    assert set(phases) == {"fwd", "bwd", "optimizer", "step"}
    assert all(v >= 0.0 for v in phases.values()) and phases["step"] > 0
    # the full-step timing drove real steps: the state exists and moved
    assert float(tr.optimizer.state["lm_head.weight"]["beta1_pow"]) < 1.0
