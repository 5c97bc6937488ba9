"""The port's `generate_speculative` against the JAX module's, on the CPU.

Templates: the speculative tests of tests/test_generation.py. The target
is a 2-layer f32 tiny Llama (fused norm and RoPE) and the draft a 1-layer
one, both made by the JAX package from a seed and carried into the port
by `from_paddle_tpu_state`. Greedy speculative decoding is lossless, so
its tokens equal plain greedy generation; the sampled form draws every
random number from np.random.RandomState(seed) in the JAX module's order
(the prefill's Gumbel noise, each draft step's, then the verify's
uniforms and Gumbel row), so at one seed both packages must emit the
same tokens, and in both forms the `stats` dict must equal the JAX
module's. The guards raise the JAX module's errors.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.models import generation as jgen
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import from_paddle_tpu_state

FUSED = dict(fused_norm=True, fused_rope=True)


def _model(layers, seed):
    """(JAX model, port model with its weights)."""
    paddle_tpu.seed(seed)
    kw = dict(FUSED, num_hidden_layers=layers)
    jm = jllama.LlamaForCausalLM(jllama.tiny_llama_config(**kw))
    jm.eval()
    cfg = tllama.tiny_llama_config(**kw)
    tm = tllama.LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(from_paddle_tpu_state(
        {k: np.asarray(v._value) for k, v in jm.state_dict().items()}, cfg))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    """{"target": (jax, port), "draft": (jax, port)}."""
    return {"target": _model(2, 0), "draft": _model(1, 123)}


def _ids(b=1, s=8, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, s)) \
        .astype("int32")


def _spec(models, draft, ids, n, **kw):
    """(JAX ids, JAX stats, port ids, port stats)."""
    out = []
    for side in (0, 1):
        mod = (jgen, tgen)[side]
        stats = {}
        got = mod.generate_speculative(
            models["target"][side], models[draft][side], ids, n,
            stats=stats, **kw)
        out += [np.asarray(got.numpy()), stats]
    return out


@pytest.mark.parametrize("draft,g", [("draft", 3), ("target", 4),
                                     ("draft", 1)])
def test_greedy_spec_equals_greedy_and_the_jax_module(models, draft, g):
    ids = _ids()
    ref = tgen.generate(models["target"][1], ids, max_new_tokens=12).numpy()
    jout, jst, tout, tst = _spec(models, draft, ids, 12,
                                 num_speculative_tokens=g)
    np.testing.assert_array_equal(tout, ref)
    np.testing.assert_array_equal(tout, jout)
    assert tst == jst and tst["generated"] == 12
    if draft == "target" and g == 4:
        # a perfect draft: prefill + ceil(11 / 4) verify rounds
        assert tst["target_forwards"] <= 5 and tst["accepted_drafts"] >= 8


@pytest.mark.parametrize("kw", [
    dict(temperature=0.9, seed=3),
    dict(temperature=0.8, top_k=20, top_p=0.9, seed=5),
    dict(temperature=1.5, seed=11),
])
@pytest.mark.parametrize("draft", ["draft", "target"])
def test_sampled_spec_tokens_and_stats_equal_the_jax_module(models, draft,
                                                            kw):
    ids = _ids(seed=5)
    jout, jst, tout, tst = _spec(models, draft, ids, 12, do_sample=True,
                                 num_speculative_tokens=4, **kw)
    np.testing.assert_array_equal(tout, jout)
    assert tst == jst
    assert tst["generated"] == tout.shape[1] - 8
    assert (tout[:, :8] == ids).all()


@pytest.mark.parametrize("do_sample", [False, True])
def test_spec_eos_truncates_like_the_jax_module(models, do_sample):
    ids = _ids(seed=2)
    kw = dict(do_sample=do_sample, temperature=0.9, seed=1,
              num_speculative_tokens=3)
    full = tgen.generate_speculative(models["target"][1],
                                     models["draft"][1], ids, 10,
                                     **kw).numpy()
    eos = int(full[0, 8 + 3])
    jout, jst, tout, tst = _spec(models, "draft", ids, 10,
                                 eos_token_id=eos, **kw)
    np.testing.assert_array_equal(tout, jout)
    assert tst == jst
    assert tout[0, -1] == eos and eos not in tout[0, 8:-1]
    # the first greedy token as eos: one generated token
    if not do_sample:
        first = int(tgen.generate(models["target"][1], ids, 1).numpy()[0, -1])
        _, _, one, st = _spec(models, "draft", ids, 8, eos_token_id=first)
        assert one.shape == (1, 9) and one[0, -1] == first
        assert st["generated"] == 1


def test_spec_guards_raise_the_jax_modules_errors(models):
    cases = [(_ids(b=2), {}),
             (_ids(), dict(num_speculative_tokens=0)),
             (_ids(), dict(do_sample=True, temperature=0.0))]
    for ids, kw in cases:
        with pytest.raises(ValueError) as je:
            jgen.generate_speculative(models["target"][0],
                                      models["draft"][0], ids, 4, **kw)
        with pytest.raises(ValueError) as te:
            tgen.generate_speculative(models["target"][1],
                                      models["draft"][1], ids, 4, **kw)
        assert str(te.value) == str(je.value)

    class NoCache(torch.nn.Module):
        def forward(self, input_ids):
            return input_ids

    with pytest.raises(ValueError, match="KV-cache support"):
        tgen.generate_speculative(models["target"][1], NoCache(), _ids(), 4)
    got = tgen.generate_speculative(models["target"][1], models["draft"][1],
                                    _ids(), 0)
    np.testing.assert_array_equal(got.numpy(), _ids())


def test_spec_restores_training_mode(models):
    tm, dm = models["target"][1], models["draft"][1]
    tm.train()
    try:
        tgen.generate_speculative(tm, dm, _ids(), 3)
        assert tm.training and not dm.training
    finally:
        tm.eval()
