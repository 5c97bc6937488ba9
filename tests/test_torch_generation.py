"""The port's static-cache generation (paddle_tpu_torch/models/generation.py)
against the JAX module's, on the CPU.

Templates: tests/test_generation.py. Both packages hold the same 2-layer
f32 tiny Llama (fused norm and RoPE), the JAX model's state carried into
the port by `from_paddle_tpu_state`, and take the same numpy ids. Greedy
tokens, padded rows, eos, block decode and the recompute path must give
the JAX module's tokens. Sampled per-token decode draws its Gumbel noise
on the host from np.random.RandomState(seed) in both packages, in the
same order, so seeded sampled tokens must be equal too. Sampled block
decode draws on the device (jax.random against a torch.Generator), so
it is held to its own properties: the same seed repeats, another seed
differs, top_k=1 is greedy. The logits pipeline agrees within 1e-6 and
cached logits with the full forward within 1e-5; the module-1 attention
(`nn.functional.scaled_dot_product_attention`) within 1e-5 of the JAX
`_sdpa_ref`, with 0 for rows a mask hides entirely.
"""
import gc
import threading
import weakref

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu
import paddle_tpu.quantization as jq
from paddle_tpu import tensor as JT
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.kernels.quant_matmul import \
    weight_only_int8_matmul as j_w8a16
from paddle_tpu.models import generation as jgen
from paddle_tpu.models import llama as jllama
from paddle_tpu.nn.functional.attention import _sdpa_ref
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.inference import paged as tpaged
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import from_paddle_tpu_state
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.quantization import quantize_weight_only

TINY = dict(num_hidden_layers=2, fused_norm=True, fused_rope=True)


def _carry(jm, **overrides):
    cfg = tllama.tiny_llama_config(**dict(TINY, **overrides))
    tm = tllama.LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(from_paddle_tpu_state(
        {k: np.asarray(v._value) for k, v in jm.state_dict().items()}, cfg))
    return tm


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model with its weights)."""
    paddle_tpu.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.tiny_llama_config(**TINY))
    jm.eval()
    return jm, _carry(jm)


def _ids(b=2, s=8, seed=0, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)) \
        .astype("int32")


def _both(pair, ids, n, **kw):
    jm, tm = pair
    j = jgen.generate(jm, ids, max_new_tokens=n, **kw).numpy()
    t = tgen.generate(tm, ids, max_new_tokens=n, **kw)
    assert t.dtype == torch.int32
    return j, t.numpy()


def _padded():
    """Two rows, the second left-padded by 3 junk tokens, and its mask."""
    r1, r2 = _ids(b=1, s=8, seed=1), _ids(b=1, s=5, seed=2)
    batch = np.concatenate(
        [r1, np.concatenate([np.full((1, 3), 7, "int32"), r2], 1)], 0)
    mask = np.ones((2, 8), "int32")
    mask[1, :3] = 0
    return batch, mask, r1, r2


# -- module 1: the masked attention --

@pytest.mark.parametrize("case", ["causal", "bool", "float", "hidden_rows",
                                  "mha"])
def test_sdpa_matches_the_jax_reference(case):
    rng = np.random.default_rng(3)
    b, s, kl, hq, d = 2, 5, 7, 4, 16
    hk = hq if case == "mha" else 2
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, kl, hk, d)).astype(np.float32)
    v = rng.normal(size=(b, kl, hk, d)).astype(np.float32)
    mask, causal = None, case == "causal"
    if case in ("bool", "mha"):
        mask = rng.random((b, 1, s, kl)) > 0.3
        mask[..., 0] = True
    elif case == "float":
        mask = np.where(rng.random((b, hq, s, kl)) > 0.3, 0.0,
                        -np.inf).astype(np.float32)
        mask[..., 0] = -0.5
    elif case == "hidden_rows":
        # left padding: query rows 0 and 1 of batch row 1 see nothing
        mask = np.ones((b, 1, s, kl), bool)
        mask[1, :, :2] = False
    jm = None if mask is None else jnp.asarray(mask)
    ref = np.asarray(_sdpa_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jm, is_causal=causal))
    tm = None if mask is None else torch.from_numpy(mask)
    got = tF.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=tm, is_causal=causal).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    if case == "hidden_rows":
        assert (got[1, :2] == 0).all()


# -- the dense-cache forward --------------------------------------------------

def test_cached_logits_match_full_forward(pair):
    """Prefill and one decode step through the dense cache give the full
    forward's logits (1e-5), and the JAX cached logits (1e-4)."""
    jm, tm = pair
    ids = _ids(b=1, s=6)
    full = tm(torch.from_numpy(ids))
    caches = tgen.init_kv_cache(tm, 1, 8)
    pos = torch.arange(6, dtype=torch.int32)[None]
    logits, out = tm(torch.from_numpy(ids), position_ids=pos, caches=caches,
                     cache_index=torch.tensor(0, dtype=torch.int32))
    assert out is caches
    torch.testing.assert_close(logits, full, rtol=1e-5, atol=1e-5)
    nxt = full[:, -1].argmax(-1).to(torch.int32)
    full7 = tm(torch.cat([torch.from_numpy(ids), nxt[:, None]], 1))[:, -1]
    dec, _ = tm(nxt[:, None], position_ids=torch.tensor([[6]]),
                caches=caches, cache_index=6)
    torch.testing.assert_close(dec[:, -1], full7, rtol=1e-5, atol=1e-5)
    jcaches = jgen.init_kv_cache(jm, 1, 8)
    jl, jcaches = jm(paddle_tpu.to_tensor(ids), position_ids=JT.unsqueeze(
        JT.arange(0, 6, dtype="int32"), 0), caches=jcaches,
        cache_index=paddle_tpu.to_tensor(0, "int32"))
    np.testing.assert_allclose(logits.numpy(), jl.numpy(), rtol=1e-4,
                               atol=1e-4)
    for (tk, tv), (jk, jv) in zip(caches, jcaches):
        np.testing.assert_allclose(tk.numpy()[:, :6], jk.numpy()[:, :6],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tv.numpy()[:, :6], jv.numpy()[:, :6],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["bool", "float"])
def test_cache_decode_honors_a_padding_mask(pair, kind):
    """A user mask joins the position mask: hiding key slots 0 and 1
    gives the logits of the tail alone at positions 2..5 (the JAX test of
    the same name), and the JAX package's masked cached logits."""
    jm, tm = pair
    ids = _ids(b=1, s=6)
    keep = np.ones((1, 1, 1, 6), bool)
    keep[..., :2] = False
    mask = keep if kind == "bool" else np.where(keep, 0.0, -np.inf) \
        .astype(np.float32)
    pos = torch.arange(6, dtype=torch.int32)[None]
    lm, _ = tm(torch.from_numpy(ids), position_ids=pos,
               caches=tgen.init_kv_cache(tm, 1, 6), cache_index=0,
               attn_mask=torch.from_numpy(mask))
    lt, _ = tm(torch.from_numpy(ids[:, 2:]), position_ids=pos[:, 2:],
               caches=tgen.init_kv_cache(tm, 1, 6), cache_index=2,
               attn_mask=torch.from_numpy(mask))
    assert torch.isfinite(lm).all()
    torch.testing.assert_close(lm[:, 2:], lt, rtol=1e-5, atol=1e-5)
    jl, _ = jm(paddle_tpu.to_tensor(ids), position_ids=paddle_tpu.to_tensor(
        pos.numpy()), caches=jgen.init_kv_cache(jm, 1, 6),
        cache_index=paddle_tpu.to_tensor(0, "int32"),
        attn_mask=paddle_tpu.to_tensor(mask))
    np.testing.assert_allclose(lm.numpy(), jl.numpy(), rtol=1e-4, atol=1e-4)


def test_cache_decode_is_inference_only(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="inference-only"):
        tm(torch.from_numpy(_ids()), labels=torch.from_numpy(_ids()).long(),
           caches=tgen.init_kv_cache(tm, 2, 10), cache_index=0)


def test_kv_cache_update_writes_in_place_at_a_device_index():
    buf = torch.zeros(2, 6, 1, 3)
    new = torch.arange(12, dtype=torch.float32).reshape(2, 2, 1, 3)
    out = tgen.kv_cache_update(buf, new, torch.tensor(3, dtype=torch.int32))
    assert out is buf
    assert torch.equal(buf[:, 3:5], new)
    assert not buf[:, :3].any() and not buf[:, 5:].any()
    jbuf = jgen.kv_cache_update(jnp.zeros((2, 6, 1, 3)), jnp.asarray(
        new.numpy()), 3)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))


def test_init_kv_cache_takes_the_compute_type_of_a_w8a16_model():
    cfg = tllama.tiny_llama_config(**TINY8)
    m = quantize_weight_only(tllama.LlamaForCausalLM(
        cfg, device="cpu", dtype=torch.bfloat16))
    assert any(t.dtype == torch.int8 for t in m.state_dict().values())
    caches = tgen.init_kv_cache(m, 2, 9)
    assert len(caches) == 2
    assert all(t.dtype == torch.bfloat16 and t.shape == (2, 9, 2, 64)
               for kv in caches for t in kv)


# -- greedy, padding, eos, guards --

def test_greedy_tokens_equal_the_jax_module(pair):
    ids = _ids()
    j, t = _both(pair, ids, 6)
    np.testing.assert_array_equal(t, j)
    assert t.shape == (2, 14) and (t[:, :8] == ids).all()
    n = tgen.generate(pair[1], ids, max_new_tokens=6, use_cache=False)
    np.testing.assert_array_equal(n.numpy(), t)
    # the model method and the stream give the same tokens
    np.testing.assert_array_equal(
        pair[1].generate(ids, max_new_tokens=6).numpy(), t)
    steps = list(tgen.generate_stream(pair[1], ids, 6))
    assert all(x.shape == (2,) and x.dtype == np.int32 for x in steps)
    np.testing.assert_array_equal(np.stack(steps, 1), t[:, 8:])


def test_padded_rows_equal_each_row_alone(pair):
    batch, mask, r1, r2 = _padded()
    j, t = _both(pair, batch, 6, attention_mask=mask)
    np.testing.assert_array_equal(t, j)
    _, tm = pair
    ref1 = tgen.generate(tm, r1, max_new_tokens=6).numpy()
    ref2 = tgen.generate(tm, r2, max_new_tokens=6).numpy()
    np.testing.assert_array_equal(t[0, 8:], ref1[0, 8:])
    np.testing.assert_array_equal(t[1, 8:], ref2[0, 5:])
    # a torch mask is the same mask; an all-ones mask is no mask
    t2 = tgen.generate(tm, batch, max_new_tokens=6,
                       attention_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(t2, t)
    np.testing.assert_array_equal(
        tgen.generate(tm, batch, 2, attention_mask=np.ones((2, 8))).numpy(),
        tgen.generate(tm, batch, 2).numpy())


def test_guards_raise_the_jax_modules_errors(pair):
    jm, tm = pair
    mask = np.ones((2, 8), "int32")
    mask[0, -2:] = 0
    cases = [
        (dict(attention_mask=mask), (_ids(), _ids())),
        (dict(attention_mask=np.ones((2, 7))), (_ids(), _ids())),
        (dict(do_sample=True, temperature=0.0), (_ids(), _ids())),
        ({}, (paddle_tpu.to_tensor(np.zeros((1, 4), "float32")),
              torch.zeros((1, 4)))),
    ]
    for kw, (jids, tids) in cases:
        with pytest.raises(ValueError) as je:
            list(jgen.generate_stream(jm, jids, 2, **kw))
        with pytest.raises(ValueError) as te:
            list(tgen.generate_stream(tm, tids, 2, **kw))
        assert str(te.value) == str(je.value)
    # zero tokens stream nothing on every surface
    assert list(tgen.generate_stream(tm, _ids(), 0)) == []
    np.testing.assert_array_equal(
        tgen.generate(tm, _ids(), max_new_tokens=0).numpy(), _ids())
    with pytest.raises(ValueError, match="temperature"):
        tgen.process_logits(torch.zeros(1, 4), temperature=-1.0)


def test_eos_stops_and_pads_like_the_jax_module(pair):
    ids = _ids()
    _, tm = pair
    first = tgen.generate(tm, ids, max_new_tokens=1).numpy()[:, -1]
    eos = int(first[0])
    j, t = _both(pair, ids, 6, eos_token_id=eos, pad_token_id=999)
    np.testing.assert_array_equal(t, j)
    assert t[0, 8] == eos and (t[0, 9:] == 999).all()


# -- sampling --

@pytest.mark.parametrize("kw", [
    dict(temperature=0.8, top_k=20, top_p=0.9, seed=7),
    dict(temperature=1.3, seed=8),
    dict(temperature=0.7, top_k=5, seed=0),
    dict(top_p=0.5, seed=3),
])
def test_sampled_per_token_tokens_equal_the_jax_module(pair, kw):
    """The same numpy Gumbel noise in the same order: the same tokens."""
    ids = _ids()
    j, t = _both(pair, ids, 6, do_sample=True, **kw)
    np.testing.assert_array_equal(t, j)
    again = tgen.generate(pair[1], ids, 6, do_sample=True, **kw).numpy()
    np.testing.assert_array_equal(again, t)


def test_sampled_padded_eos_equal_the_jax_module(pair):
    batch, mask, _, _ = _padded()
    kw = dict(do_sample=True, temperature=0.9, top_k=30, seed=4,
              attention_mask=mask)
    _, tm = pair
    eos = int(tgen.generate(tm, batch, 3, **kw).numpy()[0, -1])
    j, t = _both(pair, batch, 8, eos_token_id=eos, pad_token_id=1, **kw)
    np.testing.assert_array_equal(t, j)


def test_sampled_recompute_path_equals_the_jax_module(pair):
    ids = _ids(seed=5)
    j, t = _both(pair, ids, 4, do_sample=True, temperature=0.8, top_k=10,
                 seed=2, use_cache=False)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("tkp", [(1.0, 0, 1.0), (0.7, 10, 1.0),
                                 (1.3, 0, 0.9), (0.5, 5, 0.8),
                                 (2.0, 64, 1.0), (1.0, 1, 0.3)])
def test_process_logits_and_the_traced_form_match_the_jax_module(tkp):
    t, k, p = tkp
    x = np.random.RandomState(0).randn(4, 64).astype("float32")
    jref = jgen.process_logits(paddle_tpu.to_tensor(x), t, k, p).numpy()
    jtr = jgen._process_logits_traced(
        paddle_tpu.to_tensor(x), paddle_tpu.to_tensor(float(t)),
        paddle_tpu.to_tensor(k, dtype="int32"),
        paddle_tpu.to_tensor(float(p))).numpy()
    got = tgen.process_logits(torch.from_numpy(x), t, k, p).numpy()
    tr = tgen._process_logits_traced(
        torch.from_numpy(x), torch.tensor(float(t)),
        torch.tensor(k, dtype=torch.int32), torch.tensor(float(p))).numpy()
    for a, ref in ((got, jref), (tr, jtr), (tr, got)):
        np.testing.assert_array_equal(a <= -1e8, ref <= -1e8)
        keep = ref > -1e8
        np.testing.assert_allclose(a[keep], ref[keep], rtol=1e-6)
    np.testing.assert_array_equal(tgen._np_process_logits(x, t, k, p),
                                  jgen._np_process_logits(x, t, k, p))
    for sample in (False, True):
        np.testing.assert_array_equal(
            tgen._np_select_token(x, sample, t, k, p,
                                  np.random.RandomState(1)),
            jgen._np_select_token(x, sample, t, k, p,
                                  np.random.RandomState(1)))


def test_the_engine_uses_the_generation_modules_filter():
    assert tpaged._np_process_logits is tgen._np_process_logits


# -- block decode --

@pytest.mark.parametrize("n,tpf", [(10, 4), (10, 3), (7, 16), (9, 8)])
def test_block_decode_equals_per_token_and_the_jax_block(pair, n, tpf):
    """Greedy block decode emits the per-token stream, tail blocks
    included (n - 1 not a multiple of tpf); the JAX block gives the same."""
    ids = _ids()
    ref = tgen.generate(pair[1], ids, max_new_tokens=n).numpy()
    j, t = _both(pair, ids, n, tokens_per_fetch=tpf)
    np.testing.assert_array_equal(t, ref)
    np.testing.assert_array_equal(t, j)


def test_block_decode_eos_early_exit(pair):
    ids = _ids(b=2)
    _, tm = pair
    eos = int(tgen.generate(tm, ids, max_new_tokens=8).numpy()[0, 8 + 2])
    ref = tgen.generate(tm, ids, max_new_tokens=8, eos_token_id=eos,
                        pad_token_id=9).numpy()
    j, t = _both(pair, ids, 8, eos_token_id=eos, pad_token_id=9,
                 tokens_per_fetch=3)
    np.testing.assert_array_equal(t, ref)
    np.testing.assert_array_equal(t, j)
    # every row at eos: the stream ends before max_new_tokens
    first = tgen.generate(tm, ids[:1], max_new_tokens=1).numpy()[0, -1]
    short = tgen.generate(tm, ids[:1], max_new_tokens=8,
                          eos_token_id=int(first), tokens_per_fetch=4)
    assert short.shape == (1, 9)


def test_block_decode_padded_batch(pair):
    batch = _ids(b=2, s=8, seed=3)
    mask = np.ones((2, 8), "int32")
    mask[1, :4] = 0
    ref = tgen.generate(pair[1], batch, max_new_tokens=6,
                        attention_mask=mask).numpy()
    j, t = _both(pair, batch, 6, attention_mask=mask, tokens_per_fetch=6)
    np.testing.assert_array_equal(t, ref)
    np.testing.assert_array_equal(t, j)


def test_tail_block_writes_nothing_past_the_window(pair):
    """A tail block's steps past `limit` run (a graph has no early exit)
    but change no state and write only the buffers' last slot, which no
    step reads: the slots the stream filled equal the per-token run's."""
    _, tm = pair
    ids = _ids()
    n = 7
    tgen.generate(tm, ids, max_new_tokens=n)
    per_tok = [t.clone() for kv in tgen._compiled_steps(
        tm, 2, 8 + n, False).caches for t in kv]
    tgen.generate(tm, ids, max_new_tokens=n, tokens_per_fetch=4)
    blocked = [t for kv in tgen._compiled_steps(tm, 2, 8 + n,
                                                False).caches for t in kv]
    for a, b in zip(per_tok, blocked):
        assert a.shape[1] == 8 + n
        torch.testing.assert_close(b[:, :-1], a[:, :-1], rtol=0, atol=0)


def test_sampled_blocks_are_seeded_and_top_k_1_is_greedy(pair):
    ids = _ids()
    tm = pair[1]
    kw = dict(do_sample=True, temperature=0.8, top_k=20, seed=11,
              tokens_per_fetch=4)
    s1 = tgen.generate(tm, ids, max_new_tokens=10, **kw).numpy()
    s2 = tgen.generate(tm, ids, max_new_tokens=10, **kw).numpy()
    np.testing.assert_array_equal(s1, s2)
    s3 = tgen.generate(tm, ids, max_new_tokens=10,
                       **{**kw, "seed": 12}).numpy()
    assert (s1 != s3).any()
    greedy = tgen.generate(tm, ids, max_new_tokens=10).numpy()
    k1 = tgen.generate(tm, ids, max_new_tokens=10,
                       **{**kw, "top_k": 1}).numpy()
    np.testing.assert_array_equal(k1, greedy)


# -- the recompute path --

def test_recompute_path_masked_and_unmasked_equal_the_jax_module(pair):
    ids = _ids(b=2, s=8, seed=3)
    j, t = _both(pair, ids, 4, use_cache=False)
    np.testing.assert_array_equal(t, j)
    mask = np.ones((2, 8), "int32")
    mask[0, :2] = 0
    j, t = _both(pair, ids, 4, attention_mask=mask, use_cache=False)
    np.testing.assert_array_equal(t, j)
    cached = tgen.generate(pair[1], ids, 4, attention_mask=mask).numpy()
    np.testing.assert_array_equal(cached, t)


def test_mask_needs_a_model_that_takes_attn_mask():
    class Bare(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = torch.nn.Embedding(256, 16)
            self.head = torch.nn.Linear(16, 256)

        def forward(self, input_ids):
            return self.head(self.emb(input_ids.long()))

    m = Bare()
    mask = np.zeros((1, 8), "int32")
    mask[0, 4:] = 1
    with pytest.raises(ValueError, match="attn_mask"):
        list(tgen.generate_stream(m, _ids(b=1), 2, attention_mask=mask))
    out = tgen.generate(m, _ids(b=1), max_new_tokens=3).numpy()
    nxt = m(torch.from_numpy(_ids(b=1)))[:, -1].argmax(-1).numpy()
    assert out.shape == (1, 11) and out[0, 8] == nxt[0]
    assert m.training                  # restored after the stream


# -- W8A16 --

# multiples of 128, as the TPU W8A16 kernel's blocks need
TINY8 = dict(num_hidden_layers=2, vocab_size=256, hidden_size=256,
             intermediate_size=512, num_attention_heads=4,
             num_key_value_heads=2, fused_norm=True, fused_rope=True)


def _jax_kernel_matmul(xv, qwv, eff_scale):
    return j_w8a16(xv, qwv, eff_scale.astype(jnp.float32), block_m=None,
                   block_n=128, block_k=128, out_dtype=xv.dtype,
                   interpret=True).astype(xv.dtype)


def test_w8a16_generation_equals_no_cache_and_the_jax_model(monkeypatch):
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
    tm.load_state_dict(from_paddle_tpu_state(
        {k: np.asarray(v._value) for k, v in jconv.state_dict().items()},
        cfg))
    ids = _ids(b=2, s=6, seed=4)
    t = tgen.generate(tm, ids, max_new_tokens=5).numpy()
    np.testing.assert_array_equal(
        tgen.generate(tm, ids, max_new_tokens=5, use_cache=False).numpy(), t)
    np.testing.assert_array_equal(
        tgen.generate(tm, ids, max_new_tokens=5,
                      tokens_per_fetch=3).numpy(), t)
    monkeypatch.setattr(jq, "_weight_only_matmul", _jax_kernel_matmul)
    with paddle_tpu.no_grad():         # Pallas calls have no JVP rule
        j = jgen.generate(jconv, ids, max_new_tokens=5).numpy()
    np.testing.assert_array_equal(t, j)


# -- the step cache --

def test_steps_are_cached_per_shape_and_shared_by_sampling_configs(pair):
    tm = pair[1]
    ids = _ids()
    tgen.generate(tm, ids, max_new_tokens=3)
    e1 = tgen._compiled_steps(tm, 2, 11, False)
    tgen.generate(tm, ids, max_new_tokens=3, tokens_per_fetch=2)
    assert tgen._compiled_steps(tm, 2, 11, False) is e1
    assert set(e1.programs) == {"decode", ("block", 2)}
    tgen.generate(tm, ids, max_new_tokens=3, do_sample=True,
                  temperature=0.7, top_k=5, seed=0)
    s1 = tgen._compiled_steps(tm, 2, 11, True)
    tgen.generate(tm, ids, max_new_tokens=3, do_sample=True,
                  temperature=1.3, top_p=0.9, seed=1)
    assert tgen._compiled_steps(tm, 2, 11, True) is s1 is not e1
    # the KV buffers (layers, k and v, b, max_len, kv heads, head_dim,
    # f32), the keep mask, the sampling scalars, the decode step's
    # in and out, and the (b, vocab) noise
    assert s1.nbytes() == (2 * 2 * 2 * 11 * 2 * 16 * 4 + 2 * 11 + 3 * 4
                           + 3 * 4 + 2 * 4 + 2 * tm.config.vocab_size * 4)
    # a prompt of another length with the same max_len shares the entry
    tgen.generate(tm, _ids()[:, 2:], max_new_tokens=5)
    assert tgen._compiled_steps(tm, 2, 11, False) is e1


def test_step_cache_is_lru_bounded(pair, monkeypatch):
    _, tm = pair
    monkeypatch.setattr(tgen, "_GEN_CACHE_CAP", 3)
    tm.__dict__.pop("_gen_step_cache", None)
    for n in (1, 2, 3, 4):
        tgen.generate(tm, _ids(), max_new_tokens=n)
    cache = tm.__dict__["_gen_step_cache"]
    assert [k[2] for k in cache] == [10, 11, 12]
    tgen.generate(tm, _ids(), max_new_tokens=2)       # a hit moves to the end
    assert [k[2] for k in cache] == [11, 12, 10]


def test_step_cache_is_bounded_by_bytes(pair, monkeypatch):
    """The entries held stay within `_GEN_CACHE_BYTES` across many
    prompt lengths and max_new_tokens, the least recently used going
    first; the newest entry stays even when it alone is over the
    bound."""
    _, tm = pair
    tm.__dict__.pop("_gen_step_cache", None)
    one = tgen._Steps(tm, 2, 16, False).nbytes()
    bound = 3 * one
    monkeypatch.setattr(tgen, "_GEN_CACHE_BYTES", bound)
    seen = set()
    for s in (3, 5, 8, 4, 7):
        for n in (4, 6, 9, 11):
            tgen.generate(tm, _ids()[:, 8 - s:], max_new_tokens=n,
                          tokens_per_fetch=1 + n % 3)
            seen.add(s + n)
            cache = tm.__dict__["_gen_step_cache"]
            held = sum(e.nbytes() for e in cache.values())
            assert held <= bound, (s, n, held, bound)
            assert list(cache)[-1][2] == s + n
    assert len(seen) > len(cache) > 1
    monkeypatch.setattr(tgen, "_GEN_CACHE_BYTES", one // 2)
    tgen.generate(tm, _ids(), max_new_tokens=8)
    assert [k[2] for k in cache] == [16]


def test_step_cache_dies_with_the_model():
    m = tllama.LlamaForCausalLM(tllama.tiny_llama_config(
        num_hidden_layers=1), device="cpu")
    tgen.generate(m, _ids(), max_new_tokens=2, tokens_per_fetch=2)
    assert "_gen_step_cache" in m.__dict__
    ref = weakref.ref(m)
    del m
    gc.collect()
    assert ref() is None, "the model (and its programs) leaked"


def test_interleaved_streams_of_one_shape_keep_their_own_buffers(pair):
    """A stream whose cached entry is in use runs on its own buffers: two
    streams of the same shape, stepped in turns, give their own tokens."""
    tm = pair[1]
    a, b = _ids(seed=1), _ids(seed=2)
    want = [tgen.generate(tm, x, max_new_tokens=5).numpy()[:, 8:]
            for x in (a, b)]
    sa, sb = tgen.generate_stream(tm, a, 5), tgen.generate_stream(tm, b, 5)
    got = [[], []]
    for ra, rb in zip(sa, sb):
        got[0].append(ra)
        got[1].append(rb)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.stack(g, 1), w)
    results = {}

    def run(i, x):
        results[i] = tgen.generate(tm, x, max_new_tokens=5).numpy()[:, 8:]
    threads = [threading.Thread(target=run, args=(i, x))
               for i, x in enumerate((a, b, a, b))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for i in range(4):
        np.testing.assert_array_equal(results[i], want[i % 2])


def test_models_package_exports_the_generation_surface():
    for name in ("generate", "generate_stream", "generate_speculative",
                 "init_kv_cache", "process_logits"):
        assert getattr(tmodels, name) is getattr(tgen, name)
