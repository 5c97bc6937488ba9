"""The port engine's speculative decoding against the JAX engine, on the CPU.

`PagedKVEngine(model, draft_model=..., spec_tokens=g)` in both packages at
one set of weights (the JAX models' states carried into the port by
`from_paddle_tpu_state`), with an independent draft and with the target
as its own draft, over f32 KV and over int8 KV with a W8A16 model (the
JAX side as tests/test_torch_paged_engine.py runs it: `_weight_only_matmul`
routed through the interpret-mode W8A16 kernel, under
`paddle_tpu.no_grad()`; its decode attend is the plain path,
`kernel="jnp"`). On the CPU the port's spec tick is its body
(`_spec_body`) run eagerly; tests/test_torch_cuda.py holds the captured
graph against it on the card.

Greedy tokens, the spec stats, the draft pools after a full accept (f32
within 1e-5, int8 codes bit-equal), a warm prefix hit's tokens and page
refcounts, and `kv_bytes_per_slot` must equal the JAX engine's. Sampled
slots are checked by distribution, never through seeds (the two RNG
streams differ): over 400 spec ticks from one state, the first emitted
token's frequencies lie within total-variation distance 0.25 of the
target's processed softmax (the JAX test's bound).

Every budget (prompt + max_new_tokens) here stays at least g below the
block table's window, so no verify position reaches past the window:
there the JAX engine overwrites committed k/v (ROADMAP queue 3), and
`test_budget_at_the_window_end_stays_lossless` pins the port's repair.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu
import paddle_tpu.quantization as jq
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.inference.paged import PagedKVEngine as JEngine
from paddle_tpu.inference.paged import PagedState as JPagedState
from paddle_tpu.inference.paged import \
    _process_logits_rowwise as j_process_rowwise
from paddle_tpu.kernels.quant_matmul import \
    weight_only_int8_matmul as j_w8a16
from paddle_tpu.models import llama as jllama
from paddle_tpu.models.generation import generate as j_generate
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
G = 3
# 39 allocatable pages of 4, two slots of up to 8 (a 32-token window)
GEOM = dict(max_slots=2, page_size=4, num_pages=40, max_pages_per_slot=8,
            steps_per_tick=3, spec_tokens=G)


def _state(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _carry(jm, cfg_kw, quantized):
    cfg = tllama.tiny_llama_config(**cfg_kw)
    tm = tllama.LlamaForCausalLM(cfg, device="cpu")
    if quantized:
        tm = quantize_weight_only(tm)
    tm.load_state_dict(from_paddle_tpu_state(_state(jm), cfg))
    return tm


def _jax_model(seed, cfg_kw, quantized):
    paddle_tpu.seed(seed)
    jm = jllama.LlamaForCausalLM(jllama.tiny_llama_config(**cfg_kw))
    if not quantized:
        return jm
    jm.eval()
    ptq = jq.PTQ(jq.QuantConfig(
        activation=None, weight=jq.AbsMaxChannelWiseWeightObserver()))
    qm = ptq.quantize(jm)
    qm(JTensor(jnp.asarray(np.array([[1, 2, 3, 4]], np.int32))))
    return ptq.convert(qm, execute="weight_only_int8")


@pytest.fixture(scope="module")
def f32_models():
    """{"target": (JAX, port), "draft": (JAX, port)}, f32; the draft has
    the target's shapes and independent weights."""
    out = {}
    for name, seed in (("target", 0), ("draft", 5)):
        jm = _jax_model(seed, TINY, False)
        out[name] = (jm, _carry(jm, TINY, False))
    return out


@pytest.fixture(scope="module")
def int8_models():
    """The same over weight-only int8 models (W8A16)."""
    out = {}
    for name, seed in (("target", 0), ("draft", 5)):
        jm = _jax_model(seed, TINY8, True)
        out[name] = (jm, _carry(jm, TINY8, True))
    return out


def _jax_kernel_matmul(xv, qwv, eff_scale):
    return j_w8a16(xv, qwv, eff_scale.astype(jnp.float32), block_m=None,
                   block_n=128, block_k=128, out_dtype=xv.dtype,
                   interpret=True).astype(xv.dtype)


@pytest.fixture(params=["f32", "int8"])
def spec(request, monkeypatch):
    """make(draft="draft"|"target", **geom) -> (JAX engine, port engine)
    with a draft, at one set of weights: f32 KV, or int8 KV over the
    W8A16 models. `make.models` holds the (JAX, port) pairs."""
    if request.param == "f32":
        models = request.getfixturevalue("f32_models")
        kv = {}
    else:
        models = request.getfixturevalue("int8_models")
        monkeypatch.setattr(jq, "_weight_only_matmul", _jax_kernel_matmul)
        kv = dict(kv_dtype="int8")

    def make(draft="draft", **geom):
        geom = dict(GEOM, **kv, **geom)
        (jm, tm), (jd, td) = models["target"], models[draft]
        je = JEngine(jm, kernel="jnp", draft_model=jd, **geom)
        te = TEngine(tm, device="cpu", draft_model=td, **geom)
        return je, te
    make.kind = request.param
    make.models = models
    with paddle_tpu.no_grad():         # Pallas calls have no JVP rule
        yield make


def _spec_stats(eng):
    return {k: eng.stats[k] for k in ("ticks", "spec_ticks",
                                      "spec_proposed", "spec_accepted")}


def _join(eng):
    """Request a decodes one tick alone, then b joins mid-decode."""
    ra = eng.submit([5, 9, 2, 14], max_new_tokens=9)
    eng.step()
    rb = eng.submit([17, 3, 11], max_new_tokens=6)
    eng.run_until_idle()
    return [ra.result(), rb.result()]


@pytest.mark.parametrize("draft", ["draft", "target"])
def test_greedy_tokens_and_stats_equal_the_jax_engines(spec, draft):
    je, te = spec(draft)
    want = _join(je)
    got = _join(te)
    assert got == want
    assert [len(t) for t in got] == [9, 6]
    assert _spec_stats(te) == _spec_stats(je)
    st = te.stats
    assert st["spec_ticks"] == st["ticks"] > 0
    assert 0 <= st["spec_accepted"] <= st["spec_proposed"]
    if draft == "target" and spec.kind == "f32":
        assert st["spec_accepted"] == st["spec_proposed"]
    if spec.kind == "f32":
        # lossless: each request's tokens are the target's solo greedy
        jm = spec.models["target"][0]
        for prompt, n, toks in (([5, 9, 2, 14], 9, got[0]),
                                ([17, 3, 11], 6, got[1])):
            solo = np.asarray(j_generate(jm, np.asarray([prompt], np.int32),
                                         max_new_tokens=n))[0]
            assert toks == solo.tolist()[len(prompt):]
    assert sorted(te._free) == list(range(1, te.num_pages))
    assert te._reserved_unalloc == 0
    if spec.kind == "int8":
        # every freed page's scale rows zeroed in both models' planes
        # (page 0 takes the verify's past-budget rows; the sink the rest)
        for planes in (te._scales, te._draft_scales):
            assert float(planes[:, :, 1:-1].abs().sum()) == 0.0


def test_draft_pools_after_a_full_accept_equal_the_jax_engines(spec):
    """One spec tick with the target as its own draft accepts all g, so
    the bonus step writes the draft's KV at lens + g: the draft pools
    then equal the JAX engine's on every allocatable page."""
    je, te = spec("target", max_slots=1)
    for eng in (je, te):
        eng.submit([5, 9, 2, 14, 17], max_new_tokens=9)
        eng._admit()
        lens = eng._slots[0].lens
        eng.step()
        assert eng.stats["spec_accepted"] == G
        assert eng._slots[0].lens == lens + G + 1
    page, off = divmod(lens + G, te.page_size)
    bonus_page = te._slots[0].pages[page]
    assert te._slots[0].pages == je._slots[0].pages
    for jgrp, tgrp in zip(je.draft_pools, te.draft_pools):
        for ja, ta in zip(jgrp, tgrp):
            ja = np.asarray(ja)[1:te.num_pages]
            ta = ta.numpy()[1:te.num_pages]
            if ta.dtype == np.int8:
                np.testing.assert_array_equal(ta, ja)
            else:
                np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-5)
    kp = te.draft_pools[0][0]
    assert kp[bonus_page, :, off].abs().sum() > 0     # the bonus write


def test_warm_prefix_hit_tokens_and_refcounts_equal_the_jax_engines(spec):
    """Prefix sharing composes with a draft: both models' pools share the
    block tables, so a cached page carries the prefix's draft KV too and
    a warm row's draft prefill runs only its tail."""
    je, te = spec("target", prefix_cache_pages=8, steps_per_tick=2,
                  spec_tokens=2)
    prefix = [5, 9, 2, 14, 17, 3, 11, 4]
    for eng in (je, te):
        eng.generate([prefix + [21, 22]], max_new_tokens=5)
    want = je.generate([prefix + [33]], max_new_tokens=5)
    got = te.generate([prefix + [33]], max_new_tokens=5)
    assert got == want
    assert te.stats["prefix_hits"] == je.stats["prefix_hits"] == 1
    assert te._page_refs == je._page_refs
    assert te.prefix_cache.pages() == je.prefix_cache.pages()
    assert _spec_stats(te) == _spec_stats(je)


def test_kv_bytes_per_slot_counts_the_draft_like_the_jax_engine(spec):
    je, te = spec("draft")
    assert te.kv_bytes_per_slot() == je.kv_bytes_per_slot()
    plain = TEngine(spec.models["target"][1], device="cpu",
                    **dict(GEOM, kv_dtype=te.kv_dtype))
    # the draft has the target's shapes: twice the bytes
    assert te.kv_bytes_per_slot() == 2 * plain.kv_bytes_per_slot()


def test_draft_with_prefill_chunk_raises_as_the_jax_engine(f32_models):
    (jm, tm), (jd, td) = f32_models["target"], f32_models["draft"]
    with pytest.raises(NotImplementedError) as jerr:
        JEngine(jm, draft_model=jd, prefill_chunk=8, **GEOM)
    with pytest.raises(NotImplementedError) as terr:
        TEngine(tm, device="cpu", draft_model=td, prefill_chunk=8, **GEOM)
    assert str(terr.value) == str(jerr.value)


def test_mixed_greedy_and_sampled_slots_ride_one_tick(spec):
    """A greedy and a sampled slot in the same spec ticks: the greedy
    slot keeps the JAX engine's tokens, the sampled one stays in
    vocabulary, and every tick speculates."""
    je, te = spec("draft", seed=7)
    out = []
    for eng in (je, te):
        rg = eng.submit([5, 9, 2], max_new_tokens=5)
        rs = eng.submit([5, 9, 2], max_new_tokens=5, do_sample=True,
                        temperature=0.9, top_k=30)
        eng.run_until_idle()
        out.append((rg.result(), rs.result()))
    (jg, _), (tg, ts) = out
    assert tg == jg
    vocab = spec.models["target"][1].config.vocab_size
    assert len(ts) == 5 and all(0 <= t < vocab for t in ts)
    assert te.stats["spec_ticks"] == te.stats["ticks"] > 0


def test_sampled_first_token_follows_the_targets_distribution(spec):
    """Leviathan's rule on the paged path: over 400 spec ticks from one
    state, whatever the draft proposes, the first emitted token's
    frequencies are the target's processed softmax at that position
    (the JAX engine's target model gives the reference). The pools are
    restored before each tick. f32 runs the JAX test's setting (vocab 97,
    no top-k); the W8A16 model's 256 logits are nearly flat (random
    weights at hidden 256), so 400 draws over all of them would stray
    about 0.3 from any distribution: its filter keeps the top 32."""
    geom = dict(max_slots=1, num_pages=24, max_pages_per_slot=10)
    je, te = spec("draft", seed=0, **geom)
    kw = dict(max_new_tokens=30, do_sample=True, temperature=0.8,
              top_k=0 if spec.kind == "f32" else 32, top_p=1.0)
    for eng in (je, te):
        eng.submit([5, 9, 2], **kw)
        eng._admit()                     # prefill only; no tick yet
    a = je._slot_arrays([0])
    tflat = [x for kv in je.pools for x in kv]
    state = JPagedState(jnp.asarray(je._bt), jnp.asarray(a["lens"]),
                        jnp.asarray(a["active"]).astype(jnp.int32))
    logits, _ = je.model(JTensor(jnp.asarray(a["tok"])[:, None]),
                         caches=je._layer_caches(tflat),
                         position_ids=JTensor(
                             jnp.asarray(a["lens"])[:, None]),
                         cache_index=state)
    want = np.asarray(jax.nn.softmax(j_process_rowwise(
        logits._value[:, -1], jnp.asarray(a["temp"]),
        jnp.asarray(a["topk"]), jnp.asarray(a["topp"])), axis=-1))[0]

    te._slot_arrays([0])
    for k, t in te._inputs.items():
        t.copy_(te._staging[k])
    saved = [t.clone() for grp in te.pools + te.draft_pools for t in grp]
    live = [t for grp in te.pools + te.draft_pools for t in grp]
    program = te._tick_program(True)
    trials = 400
    counts = np.zeros(te.model.config.vocab_size)
    for _ in range(trials):
        for t, s in zip(live, saved):
            t.copy_(s)
        program()
        counts[int(te._outputs[0, 0])] += 1
    tv = 0.5 * np.abs(counts / trials - want).sum()
    assert tv < 0.25, tv


def test_budget_at_the_window_end_stays_lossless(f32_models):
    """The verify writes all g + 1 positions of every live row. With a
    budget equal to the block table's window (prompt 5 + 11 new = 16 =
    4 pages of 4), a late tick's positions run past the window; the port
    sends those rows to the sink page, so the spec engine keeps solo
    greedy's tokens. The JAX engine clamps them to the table's last
    column (paddle_tpu/inference/paged.py:178), where they overwrite
    committed k/v that the same call reads: at this setup, with this
    independent draft, its last token is 32 where solo greedy gives 42
    (ROADMAP queue 3)."""
    (jm, tm), (_, td) = f32_models["target"], f32_models["draft"]
    prompt = [5, 9, 2, 14, 7]
    geom = dict(max_slots=2, page_size=4, num_pages=40,
                max_pages_per_slot=4, spec_tokens=3)
    for max_new in (10, 11):
        solo = np.asarray(j_generate(jm, np.asarray([prompt], np.int32),
                                     max_new_tokens=max_new))[0]
        eng = TEngine(tm, device="cpu", draft_model=td, **geom)
        got = eng.generate([prompt], max_new_tokens=max_new)[0]
        assert got == solo.tolist()[len(prompt):]
    assert got[-1] == 42


def test_draft_on_another_device_raises(f32_models):
    elsewhere = SimpleNamespace(device=torch.device("meta"))
    with pytest.raises(ValueError, match="draft_model lives on meta"):
        TEngine(f32_models["target"][1], device="cpu",
                draft_model=elsewhere, **GEOM)


def test_draft_with_another_vocabulary_raises(f32_models):
    other = tllama.LlamaForCausalLM(
        tllama.tiny_llama_config(**dict(TINY, vocab_size=101)), device="cpu")
    with pytest.raises(ValueError, match="vocab_size 101 != the model's 97"):
        TEngine(f32_models["target"][1], device="cpu", draft_model=other,
                **GEOM)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_int8_rejected_verify_rows_grow_the_pages_scales(int8_models,
                                                         monkeypatch,
                                                         package):
    """Why an int8 spec engine can part from the spec-off engine at a near
    tie though both commit the same tokens: the verify writes all g + 1
    rows, a rejected row's k/v grows its page's scale (a scatter-max),
    and the tokens later committed on that page keep the grown scale. On
    layer 0, whose k/v depend on the tokens alone, the spec engine's
    scales over the pages both engines have filled are never below the
    spec-off engine's and above them on some page, in the JAX engine as
    in the port."""
    monkeypatch.setattr(jq, "_weight_only_matmul", _jax_kernel_matmul)
    side = 0 if package == "jax" else 1
    target, draft = int8_models["target"][side], int8_models["draft"][side]
    geom = dict(GEOM, max_slots=1, kv_dtype="int8")
    if package == "jax":
        spec = JEngine(target, kernel="jnp", draft_model=draft, **geom)
        plain = JEngine(target, kernel="jnp", **geom)
    else:
        spec = TEngine(target, device="cpu", draft_model=draft, **geom)
        plain = TEngine(target, device="cpu", **geom)
    prompt = [5, 9, 2, 14, 7]
    planes = []
    with paddle_tpu.no_grad():
        for eng in (spec, plain):
            req = eng.submit(prompt, max_new_tokens=24)   # budget 29
            while eng._slots[0] is None or eng._slots[0].lens < 20:
                eng.step()
            pages = eng._slots[0].pages[:5]       # positions 0-19
            planes.append(np.stack([np.asarray(t)[pages]
                                    for t in eng.pools[0][2:]]))
            eng.run_until_idle()
            planes.append(req.result())
    grown, tokens, kept, want = planes
    assert tokens == want
    assert spec.stats["spec_accepted"] < spec.stats["spec_proposed"]
    assert (grown >= kept * (1 - 1e-5)).all()
    assert (grown > kept * (1 + 1e-3)).any()
