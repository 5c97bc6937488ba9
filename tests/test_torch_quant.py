"""The port's weight-only int8 (W8A16) path against the JAX package's, on
the CPU.

- The W8A16 twin (`weight_only_int8_matmul_ref`, which the port's wrapper
  takes for CPU tensors) against the JAX Pallas kernel in interpret mode,
  at 2-D and 3-D x and a ragged M, in f32 and bf16. Tolerance: f32 within
  1e-5 relative to the output's largest entry (both sides sum the same
  exact bf16 x int8 products in f32, in other orders); bf16 outputs
  within one bf16 rounding step (2^-7 relative): the two f32 sums may
  round to neighbouring bf16 values.
- `quantize_weight_only` against JAX's PTQ weight-only convert on the
  same float weights: `qweight` codes and `w_scale` bit-identical, and
  `from_paddle_tpu_state` carries the JAX model's int8 state into a
  converted port model unchanged.
- The converted tiny model's logits against the JAX converted model's
  within 1e-4 at f32, with the JAX side's `_weight_only_matmul` routed
  through the interpret-mode kernel (monkeypatch), so both compute the
  kernel's function.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu
import paddle_tpu.quantization as jq
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.kernels.quant_matmul import \
    weight_only_int8_matmul as j_w8a16
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import quantization as tq
from paddle_tpu_torch.kernels import quant_matmul as tqm
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import from_paddle_tpu_state

# multiples of 128, as the TPU kernel's blocks need: hidden 256, 4 q / 2
# kv heads of 64, FFN 512, vocab 256
TINY = dict(num_hidden_layers=2, vocab_size=256, hidden_size=256,
            intermediate_size=512, num_attention_heads=4,
            num_key_value_heads=2, fused_norm=True, fused_rope=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jax_kernel_matmul(xv, qwv, eff_scale):
    """The JAX package's `_weight_only_matmul` routed through the
    interpret-mode Pallas kernel (off-TPU it would take the
    dequantize-then-matmul fallback)."""
    return j_w8a16(xv, qwv, eff_scale.astype(jnp.float32), block_m=None,
                   block_n=128, block_k=128, out_dtype=xv.dtype,
                   interpret=True).astype(xv.dtype)


def _mm_case(lead, K=256, N=384, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (K,)).astype(np.float32)
    qw = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    s = (rng.random(N).astype(np.float32) * 0.01 + 1e-3).astype(np.float32)
    return x, qw, s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(8,), (2, 4), (12,), (3, 5)])
def test_w8a16_twin_matches_interpret_kernel(lead, dtype):
    # (12,) and (3, 5): M = 12 and 15, not multiples of the 8-row block
    x, qw, s = _mm_case(lead)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jo = j_w8a16(jnp.asarray(x, jdt), jnp.asarray(qw), jnp.asarray(s),
                 block_m=None, block_n=128, block_k=128, out_dtype=jdt,
                 interpret=True)
    to = tqm.weight_only_int8_matmul(_t(x).to(tdt), _t(qw), _t(s))
    assert to.dtype == tdt and tuple(to.shape) == lead + (384,)
    jo = np.asarray(jo.astype(jnp.float32))
    to = to.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(to, jo, rtol=0,
                                   atol=1e-5 * np.abs(jo).max())
    else:
        np.testing.assert_allclose(to, jo, rtol=2 ** -7, atol=1e-6)


def test_w8a16_f32_x_rounds_to_bf16_first():
    # an f32 x whose values are not bf16 values: the product is of their
    # bf16 roundings, as the TPU kernel's astype does
    x, qw, s = _mm_case((4,), seed=1)
    got = tqm.weight_only_int8_matmul(_t(x), _t(qw), _t(s))
    want = tqm.weight_only_int8_matmul(_t(x).bfloat16().float(), _t(qw),
                                       _t(s))
    assert torch.equal(got, want)
    assert not torch.equal(got, (_t(x) @ _t(qw).float()) * _t(s))


def test_w8a16_shape_contract_and_wrapper_checks():
    assert tqm.quant_matmul_shape_problems(8, 4096, 128256) == []
    assert tqm.quant_matmul_shape_problems(2730, 14336, 4096) == []
    probs = tqm.quant_matmul_shape_problems(8, 100, 200)
    assert any("K % 8" in p for p in probs)
    assert any("N % 16" in p for p in probs)
    with pytest.raises(ValueError, match="N % 16"):
        tqm.check_quant_matmul_shapes(1, 64, 40)
    x, qw, s = _mm_case((2,))
    with pytest.raises(TypeError, match="int8"):
        tqm.weight_only_int8_matmul(_t(x), _t(qw).float(), _t(s))
    with pytest.raises(ValueError, match="scale"):
        tqm.weight_only_int8_matmul(_t(x), _t(qw), _t(s[:10]))
    with pytest.raises(TypeError, match="not supported"):
        tqm.weight_only_int8_matmul(_t(x).half(), _t(qw), _t(s))


@pytest.mark.parametrize("M,K,N,route,bm,splits", [
    (8, 4096, 1024, "split_k", 16, 32),    # k/v_proj in decode: 8 tiles
    (8, 4096, 128256, "split_k", 16, 1),   # lm_head: 1002 tiles fill the card
    (8, 14336, 4096, "split_k", 16, 9),    # down_proj in decode
    (2730, 4096, 14336, "wgmma", 256, 1),  # a prefill's gate/up
    (5460, 4096, 1024, "wgmma", 256, 1),   # k/v: 176 tiles of 256 rows
    (656, 4096, 1024, "wgmma", 128, 1),    # 24 or 48 tiles: one wave
    (656, 4096, 4096, "wgmma", 256, 1),    # 96 tiles, where 192 take two
    (300, 200, 208, "wgmma", 128, 1),      # ragged: no split on this route
    (tqm._SMALL_M, 4096, 4096, "split_k", 16, 5),    # at the threshold
    (tqm._SMALL_M + 1, 4096, 4096, "wgmma", 128, 1),  # just past it
])
def test_w8a16_launch_plan(M, K, N, route, bm, splits):
    assert tqm.plan(M, K, N, sms=132) == (route, bm, splits)
    nk = -(-K // 64)
    per = -(-nk // splits)
    assert -(-nk // per) == splits           # no split is empty


def _jax_weight_only(seed=0):
    """A JAX tiny model and its PTQ weight-only convert (one calibration
    forward, as PTQ needs)."""
    paddle_tpu.seed(seed)
    jm = jllama.LlamaForCausalLM(jllama.tiny_llama_config(**TINY))
    jm.eval()
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    ptq = jq.PTQ(jq.QuantConfig(
        activation=None, weight=jq.AbsMaxChannelWiseWeightObserver()))
    qm = ptq.quantize(jm)
    qm(JTensor(jnp.asarray(np.array([[1, 2, 3, 4]], np.int32))))
    conv = ptq.convert(qm, execute="weight_only_int8")
    return jm, conv, state


@pytest.fixture(scope="module")
def converted():
    jm, jconv, state = _jax_weight_only()
    cfg = tllama.tiny_llama_config(**TINY)
    tm = tllama.LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(from_paddle_tpu_state(state, cfg))
    tq.quantize_weight_only(tm)
    return jm, jconv, tm, cfg


def test_quantize_weight_only_codes_bit_identical_to_jax_ptq(converted):
    _, jconv, tm, cfg = converted
    jstate = {k: np.asarray(v._value) for k, v in jconv.state_dict().items()}
    tstate = tm.state_dict()
    assert set(tstate) == set(jstate)
    n_q = 0
    for name, arr in jstate.items():
        got = tstate[name].numpy()
        assert got.dtype == arr.dtype, name
        np.testing.assert_array_equal(got, arr, err_msg=name)
        n_q += name.endswith(".qweight")
    assert n_q == 7 * cfg.num_hidden_layers + 1       # lm_head included
    n_lin = sum(type(m) is torch.nn.Linear for m in tm.modules())
    assert n_lin == 0
    assert type(tm.model.embed_tokens) is torch.nn.Embedding


def test_convert_carries_jax_int8_state(converted):
    _, jconv, tm, cfg = converted
    jstate = {k: np.asarray(v._value) for k, v in jconv.state_dict().items()}
    port = tllama.LlamaForCausalLM(cfg, device="cpu", seed=5)
    tq.quantize_weight_only(port)          # other weights, same layout
    port.load_state_dict(from_paddle_tpu_state(jstate, cfg))
    for name, t in port.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), jstate[name],
                                      err_msg=name)
    lay = port.model.layers[0].self_attn.k_proj
    assert torch.equal(lay.eff_scale, lay.w_scale / 127.0)
    bad = dict(jstate)
    bad["lm_head.w_scale"] = np.ones(7, np.float32)
    with pytest.raises(ValueError, match="lm_head.w_scale"):
        from_paddle_tpu_state(bad, cfg)


def test_quantized_logits_match_jax_kernel_path(converted, monkeypatch):
    _, jconv, tm, _ = converted
    monkeypatch.setattr(jq, "_weight_only_matmul", jax_kernel_matmul)
    ids = np.random.default_rng(0).integers(0, 256, size=(2, 8)).astype(
        np.int32)
    with paddle_tpu.no_grad():     # Pallas calls have no JVP rule
        jl = np.asarray(jconv(JTensor(jnp.asarray(ids)))._value)
    tl = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)


def test_quantized_linear_close_to_float():
    """The pin of tests/test_quantization_int8.py's weight-only test:
    mean |quantized - float| / mean |float| < 0.02, with and without a
    bias, in f32 and with bf16 activations."""
    torch.manual_seed(0)
    for bias in (False, True):
        lin = torch.nn.Linear(256, 384, bias=bias)
        ql = tq.QuantizedLinear.from_linear(lin)
        assert ql.qweight.dtype == torch.int8
        assert tuple(ql.qweight.shape) == (256, 384)
        x = torch.randn(6, 256)
        with torch.no_grad():
            ref = lin(x)
            for xd in (x, x.bfloat16()):
                got = ql(xd)
                assert got.dtype == xd.dtype
                rel = (got.float() - ref).abs().mean() / ref.abs().mean()
                assert rel < 0.02, rel
