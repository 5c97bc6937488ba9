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
  on bf16 tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
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
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig

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
    with pytest.raises(NotImplementedError, match="blockwise"):
        tm(ids, labels=ids)
    # a serving-built model's forward records no autograd graph
    _, served, _ = _pair()
    assert served(ids).grad_fn is None
    # no kernel takes f16, so the Trainer does not offer it
    with pytest.raises(ValueError, match="compute_dtype"):
        Trainer(served, topt.AdamW(parameters=served.named_parameters()),
                TrainStepConfig(compute_dtype="float16"))
