"""The MoE expert products (paddle_tpu_torch/nn/moe.py) and the Qwen2-MoE
decode tick on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without
one; the file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_moe.py

- `grouped_mm` (torch._grouped_mm over device offsets) against the plain
  per-expert loop on the same bf16 operands, forward and both
  gradients, at a ragged shape with empty experts and at Qwen1.5-MoE-
  A2.7B's decode and prefill shapes: each entry within 2^-7 x (|ref| +
  the RMS of its row + 2^-6 of the whole RMS) (both sides round an f32
  sum to bf16 once, in other orders); one forward launch counted, two
  backward ones.
- The captured decode tick of a two-layer bf16 Qwen2-MoE, dropless
  (k 4) and capacity (k 2), gives the eager tick's greedy tokens over a
  mid-decode join, and its graph's counts hold 3 grouped products a
  layer a decode step (dropless).
- `generate` on the same model, its per-token decode step and its block
  of 4 as captured graphs, gives bit for bit the tokens of the same
  bodies run eagerly (tests/test_torch_cuda.py's rule for Llama), over
  a left-padded batch; the graphs hold 3 grouped products a layer a
  decode step (dropless).
"""
import gc

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.paged import PagedKVEngine
from paddle_tpu_torch.nn import moe
from paddle_tpu_torch.models.qwen2_moe import (Qwen2MoeForCausalLM,
                                               tiny_qwen2_moe_config)

TOL = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _held(name, out, ref):
    out, ref = out.float(), ref.float()
    rms = ref.pow(2).mean().sqrt()
    row = ref.pow(2).mean(dim=-1, keepdim=True).sqrt()
    bound = TOL * (ref.abs() + row + 2.0 ** -6 * rms)
    excess = ((out - ref).abs() - bound).max().item()
    assert excess <= 0, f"{name}: an entry exceeds its bound by {excess}"


def _operands(dev, rows, k, n, e, empty=()):
    g = torch.Generator(dev).manual_seed(rows + e)
    ids = torch.randint(0, e, (rows,), device=dev, generator=g)
    for x in empty:
        ids[ids == x] = (x + 1) % e
    counts = torch.bincount(ids, minlength=e)
    offsets = torch.cumsum(counts, 0).to(torch.int32)
    x = torch.randn(rows, k, device=dev, generator=g).bfloat16()
    w = (torch.randn(e, k, n, device=dev, generator=g) * 0.02).bfloat16()
    return x, w, offsets


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,n,e,empty", [
    (37, 64, 48, 6, (1, 4)), (32, 2048, 1408, 60, ()),
    (4096, 1408, 2048, 60, (7,))])
def test_grouped_mm_matches_the_plain_loop(cuda, rows, k, n, e, empty):
    x, w, offsets = _operands(cuda, rows, k, n, e, empty)
    xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    before = dict(moe.launches)
    out = moe.grouped_mm(xa, wa, offsets)
    assert moe.launches["grouped_mm"] == before["grouped_mm"] + 1
    dy = torch.randn_like(out)
    out.backward(dy)
    assert moe.launches["grouped_mm_bwd"] == before["grouped_mm_bwd"] + 2
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    ref = moe.grouped_mm_plain(xr, wr, offsets)
    ref.backward(dy)
    _held("out", out, ref)
    _held("dx", xa.grad, xr.grad)
    _held("dw", wa.grad.reshape(-1, n), wr.grad.reshape(-1, n))
    for x_ in empty:
        assert not wa.grad[x_].any()


@pytest.mark.cuda
def test_grouped_mm_refuses_what_the_card_route_does_not_take(cuda):
    x, w, offsets = _operands(cuda, 16, 64, 48, 4)
    with pytest.raises(TypeError, match="bf16"):
        moe.grouped_mm(x.float(), w.float(), offsets)
    with pytest.raises(ValueError, match="multiples of 8"):
        moe.grouped_mm(x[:, :60], w[:, :60], offsets)
    with pytest.raises(TypeError, match="int32"):
        moe.grouped_mm(x, w, offsets.long())


_GEOM = dict(max_slots=2, page_size=4, num_pages=16, max_pages_per_slot=6,
             steps_per_tick=3)


def _drive(eng):
    ra = eng.submit([5, 9, 2, 14], max_new_tokens=10)
    eng.step()
    rb = eng.submit([17, 3, 11, 40, 41], max_new_tokens=7)     # joins
    eng.run_until_idle()
    return [ra.result(), rb.result()]


def _model(dev, dropless, k):
    cfg = tiny_qwen2_moe_config(
        vocab_size=256, hidden_size=256, num_attention_heads=4,
        num_key_value_heads=2, num_experts=8, num_experts_per_tok=k,
        moe_intermediate_size=128, shared_expert_intermediate_size=256,
        moe_dropless=dropless, fused_rope=True)
    return cfg, Qwen2MoeForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                                    seed=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dropless,k", [(True, 4), (False, 2)])
def test_captured_tick_equals_the_eager_tick(cuda, dropless, k):
    cfg, model = _model(cuda, dropless, k)
    eager = PagedKVEngine(model, **_GEOM)
    eager._tick_program = eager._eager_program
    want = _drive(eager)
    del eager
    gc.collect()
    eng = PagedKVEngine(model, **_GEOM)
    assert _drive(eng) == want
    assert [len(t) for t in want] == [10, 7]
    program = eng._programs[("tick", False)]
    counted = {name: n for c, name, n in program.delta if c is moe.launches}
    steps, layers = _GEOM["steps_per_tick"], cfg.num_hidden_layers
    assert counted == ({"grouped_mm": 3 * layers * steps} if dropless
                       else {})
    eng.stop()


@pytest.mark.cuda
@pytest.mark.parametrize("dropless,k", [(True, 4), (False, 2)])
def test_captured_generation_gives_the_eager_bodies_tokens(cuda, dropless,
                                                           k, monkeypatch):
    from paddle_tpu_torch.core.graphs import CapturedProgram
    from paddle_tpu_torch.models import generation as tgen
    cfg, model = _model(cuda, dropless, k)
    rng = np.random.RandomState(1)
    ids = rng.randint(1, 256, (3, 7)).astype(np.int32)
    mask = np.ones((3, 7), bool)
    mask[1, :2] = mask[2, :4] = False
    captured = [tgen.generate(model, ids, 9, attention_mask=mask,
                              tokens_per_fetch=n).numpy() for n in (1, 4)]
    steps = tgen._compiled_steps(model, 3, 16, False)
    assert isinstance(steps.programs["decode"], CapturedProgram)
    assert isinstance(steps.programs[("block", 4)], CapturedProgram)
    assert np.array_equal(captured[0], captured[1])
    for key, n in (("decode", 1), (("block", 4), 4)):
        counted = {name: c for d, name, c in steps.programs[key].delta
                   if d is moe.launches}
        assert counted == ({"grouped_mm": 3 * cfg.num_hidden_layers * n}
                           if dropless else {})
    model.__dict__.pop("_gen_step_cache")
    monkeypatch.setattr(tgen, "capture_graph",
                        lambda body, device, **kw: body)
    for n, want in zip((1, 4), captured):
        got = tgen.generate(model, ids, 9, attention_mask=mask,
                            tokens_per_fetch=n).numpy()
        assert np.array_equal(got, want), n
