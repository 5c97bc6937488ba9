"""The port's flash attention against the JAX package's, on the CPU.

The port's plain twins (which its wrappers and its autograd Function
take for CPU tensors) are held against the JAX Pallas kernels run in
interpret mode (`_flash_fwd_pallas` / `_flash_bwd_pallas`, blocks of 32
so a 64-row sequence spans several tiles and a 40-row one has a ragged
tail; also at 136 rows, a group of 8 and head_dim 128) and against JAX's
own chunked attention and its `jax.vjp`. Off the
TPU the JAX package runs GQA by repeating k/v (`jnp.repeat`), so the
port's per-kv-head dk/dv are held against the sum over each group.

Inputs come from numpy seeds and go to both packages. Tolerance 1e-5 in
f32: both sides compute f32 sums of the same products in other orders.
The JAX kernel's lse is base 2, stored (B, H, 8, S_pad); the port's is
natural-log (B, H, S): lse = jax_lse[:, :, 0, :S] * ln 2.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.nn import functional as tF

TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [(s, causal, hq, hk) for s in (64, 40) for causal in (True, False)
         for hq, hk in ((2, 2), (4, 2))]
# also where the CUDA kernels cut their tiles: a sequence ragged against
# 32-row Pallas blocks (and the kernels' 64- and 128-row tiles), a group
# of 8 query heads on one kv head, head_dim 128
TILE_CASES = [pytest.param(*c, 64, id="-".join(map(str, c))) for c in CASES] + [
    pytest.param(136, True, 2, 2, 64, id="136-True-2-2-d64"),
    pytest.param(136, False, 8, 1, 64, id="136-False-8-1-d64"),
    pytest.param(64, True, 8, 1, 128, id="64-True-8-1-d128"),
    pytest.param(136, True, 4, 1, 128, id="136-True-4-1-d128"),
]


def _inputs(s, hq, hk, d=64, b=1, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    do = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    return q, k, v, do


def _jax_bhsd(q, k, v, rep):
    """(B, S, H, D) numpy -> JAX (B, H, S, D), k/v repeated per group."""
    jq = jnp.swapaxes(jnp.asarray(q), 1, 2)
    jk = jnp.repeat(jnp.swapaxes(jnp.asarray(k), 1, 2), rep, axis=1)
    jv = jnp.repeat(jnp.swapaxes(jnp.asarray(v), 1, 2), rep, axis=1)
    return jq, jk, jv


def _bshd(x):
    return np.swapaxes(np.asarray(x), 1, 2)


def _group_sum(x, hk):
    """JAX (B, Hq, S, D) per-query-head grads -> (B, S, Hk, D)."""
    b, hq, s, d = x.shape
    return _bshd(np.asarray(x).reshape(b, hk, hq // hk, s, d).sum(2))


@pytest.mark.parametrize("s,causal,hq,hk,d", TILE_CASES)
def test_flash_fwd_ref_matches_pallas_and_chunked(s, causal, hq, hk, d):
    q, k, v, _ = _inputs(s, hq, hk, d)
    scale = 1 / math.sqrt(q.shape[-1])
    jq, jk, jv = _jax_bhsd(q, k, v, hq // hk)
    jo, jlse = jfa._flash_fwd_pallas(jq, jk, jv, causal, scale, block_q=32,
                                     block_k=32, interpret=True)
    jc = jfa._chunked_attention(jq, jk, jv, causal, scale, block_q=32,
                                block_k=32)
    to, tlse = tfa.flash_attention_fwd(*(torch.from_numpy(a)
                                         for a in (q, k, v)), causal)
    assert to.shape == q.shape and tlse.shape == (1, hq, s)
    np.testing.assert_allclose(to.numpy(), _bshd(jo), **TOL)
    np.testing.assert_allclose(to.numpy(), _bshd(jc), **TOL)
    np.testing.assert_allclose(tlse.numpy(),
                               np.asarray(jlse)[:, :, 0, :s] * math.log(2),
                               **TOL)


@pytest.mark.parametrize("s,causal,hq,hk,d", TILE_CASES)
def test_flash_bwd_matches_pallas_and_vjp(s, causal, hq, hk, d):
    q, k, v, do = _inputs(s, hq, hk, d, seed=1)
    scale = 1 / math.sqrt(q.shape[-1])
    rep = hq // hk
    jq, jk, jv = _jax_bhsd(q, k, v, rep)
    jdo = jnp.swapaxes(jnp.asarray(do), 1, 2)
    _, vjp = jax.vjp(lambda a, b_, c: jfa._chunked_attention(
        a, b_, c, causal, scale, block_q=32, block_k=32), jq, jk, jv)
    refs = [vjp(jdo)]
    jo, jlse = jfa._flash_fwd_pallas(jq, jk, jv, causal, scale, block_q=32,
                                     block_k=32, interpret=True)
    for fused in (True, False):
        refs.append(jfa._flash_bwd_pallas(jq, jk, jv, jo, jlse, jdo, causal,
                                          scale, block_q=32, block_k=32,
                                          interpret=True, fused=fused))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = tfa.flash_attention_bshd(tq, tk, tv, causal=causal)
    dq, dk, dv = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for jdq, jdk, jdv in refs:
        np.testing.assert_allclose(dq.numpy(), _bshd(jdq), **TOL)
        np.testing.assert_allclose(dk.numpy(), _group_sum(jdk, hk), **TOL)
        np.testing.assert_allclose(dv.numpy(), _group_sum(jdv, hk), **TOL)


def test_bhsd_entry_and_functional_surface():
    q, k, v, _ = _inputs(40, 4, 2, seed=2)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ref = tfa.flash_attention_bshd(tq, tk, tv, causal=True)
    bhsd = tfa.flash_attention_bhsd(tq.transpose(1, 2), tk.transpose(1, 2),
                                    tv.transpose(1, 2), causal=True)
    torch.testing.assert_close(bhsd.transpose(1, 2), ref, rtol=0, atol=0)
    out, none = tF.flash_attention(tq, tk, tv, causal=True)
    assert none is None
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    # the plain causal attention of the serving slice computes the same
    torch.testing.assert_close(tF.scaled_dot_product_attention(
        tq, tk, tv, is_causal=True), ref, **TOL)


def test_flash_shape_contract_names_the_dims():
    f32 = torch.float32
    assert tfa.flash_shape_problems((2, 64, 32, 128), (2, 64, 8, 128),
                                    (2, 64, 8, 128), torch.bfloat16) == []
    probs = tfa.flash_shape_problems((2, 64, 6, 96), (2, 32, 4, 96),
                                     (2, 32, 4, 96), torch.float16)
    text = " ".join(probs)
    for word in ("sequence", "multiple of kv heads", "head_dim", "dtype"):
        assert word in text, word
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_fwd(torch.zeros(1, 8, 2, 96, dtype=f32),
                                torch.zeros(1, 8, 2, 96, dtype=f32),
                                torch.zeros(1, 8, 2, 96, dtype=f32))
