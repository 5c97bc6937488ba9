"""The port's Llama model against the JAX package's, on the CPU.

Weights are made by the JAX model (seeded), exported to numpy and carried
into the port by `from_paddle_tpu_state`; the same numpy token ids go to
both. Logits agree at f32 within 1e-4 (the sums of a 2-layer model run
in other orders in the two frameworks).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.inference import paged as jpaged
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference import paged as tpaged
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import from_paddle_tpu_state

TINY = dict(num_hidden_layers=2, vocab_size=97, hidden_size=64,
            num_attention_heads=4, num_key_value_heads=2)
TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(seed=0, **overrides):
    """(JAX model, port model with the same weights, numpy state)."""
    kw = dict(TINY, **overrides)
    paddle_tpu.seed(seed)
    jm = jllama.LlamaForCausalLM(jllama.tiny_llama_config(**kw))
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    cfg = tllama.tiny_llama_config(**kw)
    tm = tllama.LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(from_paddle_tpu_state(state, cfg))
    return jm, tm, state


def test_convert_round_trip():
    _, tm, state = _pair(fuse_attention_qkv=True, fuse_attention_ffn=True)
    back = tm.state_dict()
    assert set(back) == set(state)
    for name, arr in state.items():
        got = back[name].numpy()
        if name.endswith("_proj.weight") or name == "lm_head.weight":
            got = got.T                  # torch (out, in) -> paddle (in, out)
        np.testing.assert_array_equal(got, arr, err_msg=name)


def test_convert_rejects_a_state_of_another_config():
    _, _, state = _pair()
    cfg = tllama.tiny_llama_config(**dict(TINY, num_hidden_layers=3))
    with pytest.raises(ValueError, match="missing"):
        from_paddle_tpu_state(state, cfg)
    bad = dict(state)
    bad["model.norm.weight"] = np.ones(65, np.float32)
    with pytest.raises(ValueError, match="model.norm.weight"):
        from_paddle_tpu_state(bad, tllama.tiny_llama_config(**TINY))


@pytest.mark.parametrize("overrides", [
    dict(fused_norm=True, fused_rope=True),
    dict(),
    dict(fuse_attention_qkv=True, fuse_attention_ffn=True, fused_rope=True),
])
def test_no_cache_logits_match(overrides):
    jm, tm, _ = _pair(**overrides)
    ids = np.random.default_rng(0).integers(0, 97, size=(2, 9)).astype(
        np.int32)
    jl = np.asarray(jm(JTensor(jnp.asarray(ids)))._value)
    tl = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(tl, jl, **TOL)


def test_paged_prefill_logits_match():
    jm, tm, _ = _pair(fused_norm=True, fused_rope=True)
    rng = np.random.default_rng(1)
    b, s, ps, npages, mp, hk, hd = 2, 7, 4, 12, 3, 2, 16
    ids = rng.integers(0, 97, size=(b, s)).astype(np.int32)
    bt = np.array([[3, 1, 5], [2, 4, 6]], np.int32)
    lens = np.zeros(b, np.int32)
    nv = np.array([7, 5], np.int32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    shape = (npages, hk, ps, hd)
    jcaches = [(JTensor(jnp.zeros(shape)), JTensor(jnp.zeros(shape)))
               for _ in range(2)]
    jl, jnew = jm(JTensor(jnp.asarray(ids)), position_ids=JTensor(
        jnp.asarray(pos)), caches=jcaches, cache_index=jpaged.PagedState(
            jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(nv)))
    # the port's pools hold one more page: the sink for dropped writes
    tshape = (npages + 1,) + shape[1:]
    tcaches = [(torch.zeros(tshape), torch.zeros(tshape)) for _ in range(2)]
    tl = tm(torch.from_numpy(ids), torch.from_numpy(pos), tcaches,
            tpaged.PagedState(torch.from_numpy(bt), torch.from_numpy(lens),
                              torch.from_numpy(nv)))
    jl = np.asarray(jl._value)
    for i, n in enumerate(nv):
        np.testing.assert_allclose(tl.numpy()[i, :n], jl[i, :n], **TOL)
    for (tk, tv), (jk, jv) in zip(tcaches, jnew):
        np.testing.assert_allclose(tk.numpy()[:-1], np.asarray(jk._value),
                                   **TOL)
        np.testing.assert_allclose(tv.numpy()[:-1], np.asarray(jv._value),
                                   **TOL)


def test_paged_forward_equals_no_cache_forward():
    """Port-internal: prefill through the pages then one decode step
    gives the no-cache logits of the same sequence."""
    _, tm, _ = _pair(fused_norm=True, fused_rope=True)
    ids = torch.tensor([[5, 9, 2, 14, 7, 3]], dtype=torch.int32)
    ref = tm(ids)
    shape = (8, 2, 4, 16)
    caches = [(torch.zeros(shape), torch.zeros(shape)) for _ in range(2)]
    bt = torch.tensor([[2, 5]], dtype=torch.int32)
    pre = tm(ids[:, :5], torch.arange(5)[None], caches, tpaged.PagedState(
        bt, torch.zeros(1, dtype=torch.int32),
        torch.tensor([5], dtype=torch.int32)))
    dec = tm(ids[:, 5:], torch.tensor([[5]]), caches, tpaged.PagedState(
        bt, torch.tensor([5], dtype=torch.int32),
        torch.tensor([1], dtype=torch.int32)))
    torch.testing.assert_close(pre, ref[:, :5], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dec, ref[:, 5:], rtol=1e-5, atol=1e-5)


def test_model_initialises_from_a_seed():
    cfg = tllama.tiny_llama_config(**TINY)
    a = tllama.LlamaForCausalLM(cfg, device="cpu", seed=3)
    b = tllama.LlamaForCausalLM(cfg, device="cpu", seed=3)
    c = tllama.LlamaForCausalLM(cfg, device="cpu", seed=4)
    wa, wb, wc = (m.model.layers[0].self_attn.q_proj.weight for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert abs(float(wa.std()) - cfg.initializer_range) < 0.005
    assert torch.equal(a.model.norm.weight, torch.ones(64))
    bf = tllama.LlamaForCausalLM(cfg, device="cpu", dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in bf.parameters())
