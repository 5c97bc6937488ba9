"""The port's kernel modules against the JAX package, on the CPU.

Each plain twin (`*_ref`, which the port's wrappers take for CPU
tensors) is held against the JAX function run the way the JAX tests run
it: the Pallas kernels in interpret mode (`kernel="pallas"` /
`interpret=True` off-TPU). Inputs come from numpy seeds and go to both
packages. Tolerance at f32 is 1e-5: both sides compute the same f32
expressions, only the order of sums and the libm of cos/sin/exp differ.

The CUDA kernels themselves are held against these twins on the card by
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.inference import paged as jpaged
from paddle_tpu.kernels import fused_norm as jfn
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu_torch.inference import paged as tpaged
from paddle_tpu_torch.kernels import fused_norm as tfn
from paddle_tpu_torch.kernels import paged_attention as tpa

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- RMSNorm + residual -----------------------------------------------------

@pytest.mark.parametrize("with_residual", [False, True])
def test_rms_norm_residual_ref_matches_pallas(with_residual):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 256)).astype(np.float32)
    res = rng.normal(size=x.shape).astype(np.float32) if with_residual \
        else None
    w = rng.normal(size=(256,)).astype(np.float32)
    jy, jh = jfn.rms_norm_residual(
        jnp.asarray(x), jnp.asarray(w),
        residual=None if res is None else jnp.asarray(res),
        epsilon=1e-5, kernel="pallas")
    ty, th = tfn.rms_norm_residual(
        _t(x), _t(w), residual=None if res is None else _t(res),
        epsilon=1e-5)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


# -- RoPE --------------------------------------------------------------------

@pytest.mark.parametrize("positions", ["none", "seq", "batch"])
def test_rope_ref_matches_pallas(positions):
    rng = np.random.default_rng(1)
    b, s, h, d = 2, 6, 3, 16
    x = rng.normal(size=(b, s, h, d)).astype(np.float32)
    pos = {"none": None,
           "seq": np.arange(100, 100 + s, dtype=np.int32),
           "batch": rng.integers(0, 5000, size=(b, s)).astype(np.int32)
           }[positions]
    # Llama-3's theta: the f32 tables must agree at large positions too
    jo = jfn.rope_apply(jnp.asarray(x),
                        positions=None if pos is None else jnp.asarray(pos),
                        theta=500000.0, kernel="pallas")
    to = tfn.rope_apply(_t(x), None if pos is None else _t(pos),
                        theta=500000.0)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def test_rope_shared_tables_equal_per_call_tables():
    rng = np.random.default_rng(2)
    x = _t(rng.normal(size=(2, 3, 4, 8)).astype(np.float32))
    pos = _t(rng.integers(0, 50, size=(2, 3)).astype(np.int32))
    tables = tfn.rope_tables(pos.reshape(-1), 8, 10000.0)
    assert torch.equal(tfn.rope_apply(x, pos, 10000.0, tables=tables),
                       tfn.rope_apply(x, pos, 10000.0))


def test_shape_contracts_name_the_dims():
    assert tfn.norm_shape_problems(4096) == []
    assert "hidden" in tfn.norm_shape_problems(20000)[0]
    assert tfn.rope_shape_problems(128) == []
    assert tfn.rope_shape_problems(7)
    assert tpa.decode_shape_problems(32, 8, 128, 16) == []
    probs = tpa.decode_shape_problems(64, 2, 96, 16)
    assert any("hq/hk" in p for p in probs)
    assert any("head_dim" in p for p in probs)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tpa.check_decode_shapes(6, 4, 64, 16)


def test_wrappers_reject_dtype_pairs_the_kernels_lack():
    # the same contract on the CPU as on the card: the kernels are built
    # for one type throughout, plus an f32 query over bf16 pools
    x = torch.randn(3, 16, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="one type"):
        tfn.rms_norm_residual(x, torch.ones(16))
    with pytest.raises(TypeError, match="one type"):
        tfn.rms_norm_residual(x, torch.ones(16, dtype=torch.bfloat16),
                              x.float())
    q, kp, vp, bt, ln = (_t(a) for a in _decode_case(4, 2, [0, 3, 4]))
    with pytest.raises(TypeError, match="not supported"):
        tpa.paged_decode_attention(q.bfloat16(), kp, vp, bt, ln)
    out = tpa.paged_decode_attention(q, kp.bfloat16(), vp.bfloat16(), bt, ln)
    assert out.dtype == torch.float32


# -- paged decode ------------------------------------------------------------

def _decode_case(hq, hk, lens, ps=4, d=8, mp=4, npages=20, seed=0):
    rng = np.random.default_rng(seed)
    b = len(lens)
    kp = rng.normal(size=(npages, hk, ps, d)).astype(np.float32)
    vp = rng.normal(size=(npages, hk, ps, d)).astype(np.float32)
    # scattered block tables: distinct pages, not in slot order
    bt = rng.permutation(np.arange(1, npages))[:b * mp].reshape(b, mp)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    return q, kp, vp, bt.astype(np.int32), np.asarray(lens, np.int32)


@pytest.mark.parametrize("hq,hk", [(4, 2), (2, 2), (8, 1)])
@pytest.mark.parametrize("lens", [[0, 3, 4], [7, 8, 15], [1, 9, 12]])
def test_paged_decode_ref_matches_pallas(hq, hk, lens):
    # lens at 0, page_size - 1, page_size and later page boundaries
    q, kp, vp, bt, ln = _decode_case(hq, hk, lens)
    jo = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(ln), interpret=True)
    to = tpa.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(ln))
    assert to.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def _jax_state(bt, lens, nv):
    return jpaged.PagedState(jnp.asarray(bt), jnp.asarray(lens),
                             jnp.asarray(nv))


def _torch_state(bt, lens, nv):
    return tpaged.PagedState(_t(bt), _t(lens), _t(nv))


def _with_sink(pool):
    """The port's pools hold one sink page past the addressed ones;
    dropped writes land there."""
    return _t(np.concatenate([pool, np.zeros_like(pool[:1])]))


def _update_case(s, seed=3):
    rng = np.random.default_rng(seed)
    b, hq, hk, d, ps, npages, mp = 3, 4, 2, 8, 4, 16, 4
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    kp = rng.normal(size=(npages, hk, ps, d)).astype(np.float32)
    vp = rng.normal(size=(npages, hk, ps, d)).astype(np.float32)
    bt = (1 + np.arange(b * mp, dtype=np.int32)).reshape(b, mp)
    return q, k, v, kp, vp, bt


def test_paged_attention_update_decode_matches_jax_kernel_path():
    q, k, v, kp, vp, bt = _update_case(s=1)
    lens = np.array([0, 4, 11], np.int32)
    nv = np.array([1, 0, 1], np.int32)       # slot 1 finished: write drops
    with jpaged.decode_kernel_scope("pallas", interpret=True):
        jout, (jkp, jvp) = jpaged.paged_attention_update(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            (jnp.asarray(kp), jnp.asarray(vp)), _jax_state(bt, lens, nv))
    tkp, tvp = _with_sink(kp), _with_sink(vp)
    tout = tpaged.paged_attention_update(_t(q), _t(k), _t(v), (tkp, tvp),
                                         _torch_state(bt, lens, nv))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout._value), **TOL)
    np.testing.assert_array_equal(tkp.numpy()[:-1], np.asarray(jkp._value))
    np.testing.assert_array_equal(tvp.numpy()[:-1], np.asarray(jvp._value))


def test_paged_attention_update_padded_prefill_matches_jax():
    q, k, v, kp, vp, bt = _update_case(s=5)
    lens = np.array([0, 3, 6], np.int32)
    nv = np.array([5, 2, 4], np.int32)       # rows past n_valid are padding
    jout, (jkp, jvp) = jpaged.paged_attention_update(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        (jnp.asarray(kp), jnp.asarray(vp)), _jax_state(bt, lens, nv))
    tkp, tvp = _with_sink(kp), _with_sink(vp)
    tout = tpaged.paged_attention_update(_t(q), _t(k), _t(v), (tkp, tvp),
                                         _torch_state(bt, lens, nv))
    jo = np.asarray(jout._value)
    for i, n in enumerate(nv):
        np.testing.assert_allclose(tout.numpy()[i, :n], jo[i, :n], **TOL)
    np.testing.assert_array_equal(tkp.numpy()[:-1], np.asarray(jkp._value))
    np.testing.assert_array_equal(tvp.numpy()[:-1], np.asarray(jvp._value))


@pytest.mark.parametrize("s", [1, 3])
def test_dropped_rows_never_touch_page_zero(s):
    """A caller's block table may hold page 0 legitimately: invalid rows
    whose target would be page 0 go to the sink page instead and leave
    page 0 as it was, even when a valid row writes the same place."""
    rng = np.random.default_rng(4)
    b, hk, d, ps = 2, 1, 4, 4
    kp = rng.normal(size=(3, hk, ps, d)).astype(np.float32)
    vp = rng.normal(size=(3, hk, ps, d)).astype(np.float32)
    bt = np.array([[0, 1], [0, 2]], np.int32)   # both slots start on page 0
    lens = np.array([1, 1], np.int32)
    nv = np.array([s, 0], np.int32)             # slot 1 writes nothing
    k = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    q = rng.normal(size=(b, s, 2, d)).astype(np.float32)
    tkp, tvp = _with_sink(kp), _with_sink(vp)
    tpaged.paged_attention_update(_t(q), _t(k), _t(v), (tkp, tvp),
                                  _torch_state(bt, lens, nv))
    want = kp.copy()
    for j in range(s):
        p = lens[0] + j
        want[bt[0, p // ps], :, p % ps] = k[0, j]
    np.testing.assert_array_equal(tkp.numpy()[:-1], want)


# -- sampling filters ---------------------------------------------------------

def test_process_logits_rowwise_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(5, 97)).astype(np.float32) * 3
    temp = np.array([1.0, 0.7, 1.3, 1.0, 0.5], np.float32)
    topk = np.array([0, 5, 96, 97, 1], np.int32)
    topp = np.array([1.0, 0.9, 0.5, 0.8, 1.0], np.float32)
    jo = jpaged._process_logits_rowwise(jnp.asarray(x), jnp.asarray(temp),
                                        jnp.asarray(topk), jnp.asarray(topp))
    to = tpaged._process_logits_rowwise(_t(x), _t(temp), _t(topk), _t(topp))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def test_np_process_logits_is_the_jax_copy():
    from paddle_tpu.models.generation import _np_process_logits
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 50)).astype(np.float32)
    for args in [(0.8, 10, 0.9), (1.0, 0, 1.0), (1.5, 49, 0.3)]:
        np.testing.assert_array_equal(tpaged._np_process_logits(x, *args),
                                      _np_process_logits(x, *args))
