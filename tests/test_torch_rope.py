"""The port's RoPE against the JAX package's Pallas RoPE, on the CPU, at the
head widths the CUDA kernel's instances take: d 64 (TinyLlama's heads)
and 128 (Llama-3's), whose half is a whole number of 16-byte chunks in
both types, and d 72, whose half is not in bf16.

The port's plain twin (which its wrappers take for CPU tensors, and
which the kernel matches bit for bit on the card, tests/test_torch_cuda.py)
is held against `paddle_tpu.kernels.fused_norm.rope_apply(kernel="pallas")`
run in interpret mode, forward and through its custom vjp (the inverse
rotation). Inputs come from a numpy seed and go to both packages.
Tolerances: f32 within 1e-5 (both sides compute the same f32 expressions;
the libm of cos and sin differ); bf16 within one bf16 rounding step,
2^-7 relative (an f32 result a unit in the last place apart can round to
the neighbouring bf16 value), with 1e-5 absolute for results that cancel
to near zero.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels import fused_norm as jfn
from paddle_tpu_torch.kernels import fused_norm as tfn

_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=2 ** -7, atol=1e-5)}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# d: (heads, theta) of the model that has such heads
_WIDTHS = {64: (4, 10000.0), 128: (8, 500000.0), 72: (3, 500000.0)}


def _inputs(d, dtype, seed):
    """x and a cotangent (2, 5, heads, d) in dtype, batch positions up to
    5000, theta, as numpy (f32 values, rounded to dtype by each side the
    same way) and as both packages' arrays."""
    heads, theta = _WIDTHS[d]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 5, heads, d)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    pos = rng.integers(0, 5000, size=(2, 5)).astype(np.int32)
    jx, jg = (jnp.asarray(a, dtype=_JAX[dtype]) for a in (x, g))
    tx, tg = (torch.from_numpy(a).to(_TORCH[dtype]) for a in (x, g))
    return (jx, jg, jnp.asarray(pos)), (tx, tg, torch.from_numpy(pos)), theta


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", sorted(_WIDTHS))
def test_rope_twin_matches_pallas(d, dtype):
    (jx, _, jpos), (tx, _, tpos), theta = _inputs(d, dtype, seed=d)
    jo = jfn.rope_apply(jx, positions=jpos, theta=theta, kernel="pallas")
    to = tfn.rope_apply(tx, tpos, theta)
    assert to.dtype == _TORCH[dtype] and to.shape == tx.shape
    np.testing.assert_allclose(_np(to), _np(jo), **_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", sorted(_WIDTHS))
def test_rope_backward_twin_matches_pallas_vjp(d, dtype):
    """dx through the port's RoPE Function (its backward twin: the
    rotation with the sin table negated) against jax.vjp of the Pallas
    op, and the twin called directly on the same cotangent."""
    (jx, jg, jpos), (tx, tg, tpos), theta = _inputs(d, dtype, seed=100 + d)
    _, vjp = jax.vjp(lambda a: jfn.rope_apply(
        a, positions=jpos, theta=theta, kernel="pallas"), jx)
    (jdx,) = vjp(jg)
    txr = tx.clone().requires_grad_(True)
    (tdx,) = torch.autograd.grad(tfn.rope_apply(txr, tpos, theta), txr, tg)
    assert tdx.dtype == _TORCH[dtype]
    np.testing.assert_allclose(_np(tdx), _np(jdx), **_TOL[dtype])
    b, s = tx.shape[:2]
    tables = tfn.rope_tables(tfn._flat_positions(tpos, b, s, tx.device), d,
                             theta)
    assert torch.equal(tfn.rope_apply_bwd(tg, *tables), tdx)
