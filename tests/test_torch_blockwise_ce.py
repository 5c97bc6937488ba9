"""The port's blockwise cross-entropy against the JAX package's, on the CPU.

The same numpy inputs (a seed) go to JAX `blockwise_ce_loss` with
kernel="jnp" (the lax.scan path) and kernel="pallas" (the Pallas kernels
in interpret mode) and to the port's `blockwise_ce_loss`, whose CPU path
is the plain twin (`ce_fwd_ref` / `ce_bwd_ref`) inside the same
autograd Function the card runs. The port holds W as (V, D), JAX as
(D, V): the tests pass the transpose.

Shapes: N = 37 rows (not a multiple of the chunk), D = 64, V = 250 (not
a multiple of the vocab block), three rows at ignore_index.

Tolerances:
- f32: the loss within 1e-6 relative (a loss near 5.6 is not held to
  1e-6 absolute: the f32 rounding of its lse alone is 5e-7) and the lse
  within 1e-5 absolute; dx and dW within 1e-6 of their largest entry
  (the same f32 products summed in other orders: measured 3e-7);
- bf16: the same loss and lse bounds (the products of bf16 values are
  exact in f32 on both sides); dx and dW, rounded to bf16 once on each
  side, within one bf16 step (2^-7 of |ref|) plus 1e-6 of the largest
  entry (measured: equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu.kernels import blockwise_ce as jbce
from paddle_tpu_torch.kernels import blockwise_ce as tbce
from paddle_tpu_torch.nn import functional as tF

N, D, V = 37, 64, 250
IGNORED = (3, 11, 30)


def _inputs(n=N, d=D, v=V, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    w = (rng.randn(v, d) * 0.1).astype(np.float32)      # (V, D)
    lab = rng.randint(0, v, n).astype(np.int32)
    lab[list(IGNORED)] = -100
    return x, w, lab


def _jax(x, w, lab, dtype, chunk, vocab_block, kernel):
    """(loss, lse (N,), dx, dW (V, D)) from the JAX package."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xj, wj, lj = jnp.asarray(x, jd), jnp.asarray(w.T, jd), jnp.asarray(lab)
    pallas = kernel == "pallas"

    def loss(a, b):
        return jbce.blockwise_ce_loss(a, b, lj, chunk=chunk,
                                      vocab_block=vocab_block, kernel=kernel)

    val, (gx, gw) = jax.value_and_grad(loss, argnums=(0, 1))(xj, wj)
    _, res = jbce._bce_fwd(xj, wj, lj, chunk, vocab_block, -100, pallas,
                           pallas)
    lse = np.asarray(res[3]).reshape(-1)[:x.shape[0]]
    return (float(val), lse, np.asarray(gx, np.float32),
            np.asarray(gw, np.float32).T)


def _port(x, w, lab, dtype, chunk, vocab_block):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    wt = torch.from_numpy(w).to(dtype).requires_grad_(True)
    lt = torch.from_numpy(lab)
    loss = tbce.blockwise_ce_loss(xt, wt, lt, chunk=chunk,
                                  vocab_block=vocab_block)
    loss.backward()
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert xt.grad.dtype == dtype and wt.grad.dtype == dtype
    _, lse, _ = tbce.ce_fwd_ref(xt.detach(), wt.detach(), lt, chunk,
                                vocab_block)
    return (float(loss.detach()), lse.numpy(), xt.grad.float().numpy(),
            wt.grad.float().numpy())


def _close(got, want, dtype, name):
    scale = float(np.abs(want).max())
    bound = 1e-6 * scale + (2 ** -7 * np.abs(want) if dtype == torch.bfloat16
                            else 0.0)
    err = np.abs(got - want)
    assert (err <= bound).all(), f"{name}: |err| {err.max()} > its bound"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk,vocab_block", [(8, 0), (16, 64)])
@pytest.mark.parametrize("kernel", ["jnp", "pallas"])
def test_twin_matches_jax(kernel, chunk, vocab_block, dtype):
    x, w, lab = _inputs()
    jl, jlse, jgx, jgw = _jax(x, w, lab, dtype, chunk, vocab_block, kernel)
    tl, tlse, tgx, tgw = _port(x, w, lab, dtype, chunk, vocab_block)
    np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tlse, jlse, rtol=0, atol=1e-5)
    _close(tgx, jgx, dtype, "dx")
    _close(tgw, jgw, dtype, "dW")
    # ignored rows get no gradient on either side
    assert not tgx[list(IGNORED)].any()


@pytest.mark.parametrize("vocab_block", [0, 64])
def test_all_rows_ignored(vocab_block):
    """Every label ignored: loss 0 and zero gradients (the count clamp,
    not a 0/0 NaN), as in JAX."""
    x, w, _ = _inputs()
    lab = np.full(N, -100, np.int32)
    jl, _, jgx, jgw = _jax(x, w, lab, torch.float32, 8, vocab_block, "jnp")
    tl, _, tgx, tgw = _port(x, w, lab, torch.float32, 8, vocab_block)
    assert tl == jl == 0.0
    assert not tgx.any() and not tgw.any() and not jgx.any()


class _Largest(TorchDispatchMode):
    """The largest tensor an op creates whose last dim is not D (so not
    a row of x, of W, of dx or of dW), skipping views."""

    def __init__(self, d):
        super().__init__()
        self.d, self.largest = d, (0, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.dim() >= 2 \
                    and t.shape[-1] != self.d \
                    and t.numel() > self.largest[0]:
                self.largest = (t.numel(), (func, tuple(t.shape)))
        return out


@pytest.mark.parametrize("chunk,vocab_block", [(8, 0), (8, 64), (16, 32)])
def test_twin_never_builds_the_logits(chunk, vocab_block):
    """Forward and backward of the twin create no logits-shaped tensor
    larger than chunk x (vocab_block or V); D = 48 differs from every
    chunk and block width, so only x-, W-, dx- and dW-rows are exempt."""
    d = 48
    x, w, lab = _inputs(d=d)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    mode = _Largest(d)
    with mode:
        loss = tbce.blockwise_ce_loss(xt, wt, torch.from_numpy(lab),
                                      chunk=chunk, vocab_block=vocab_block)
        loss.backward()
    bound = chunk * (vocab_block or V)
    assert 0 < mode.largest[0] <= bound, (mode.largest, bound)
    assert bound < N * V                 # the dense logits would exceed it


@pytest.mark.parametrize("transpose_w", [True, False])
def test_functional_takes_both_weight_layouts(transpose_w):
    """`blockwise_cross_entropy` takes W as (V, D) with transpose_w or
    (D, V) without, and its gradient comes back in that layout; both
    equal the dense `cross_entropy` of the logits."""
    x, w, lab = _inputs()
    lt = torch.from_numpy(lab)
    xt = torch.from_numpy(x).requires_grad_(True)
    wl = torch.from_numpy(w if transpose_w else np.ascontiguousarray(w.T))
    wl.requires_grad_(True)
    loss = tF.blockwise_cross_entropy(xt, wl, lt, chunk=8,
                                      transpose_w=transpose_w)
    loss.backward()
    xd = torch.from_numpy(x).requires_grad_(True)
    wd = torch.from_numpy(w).requires_grad_(True)
    dense = tF.cross_entropy(xd @ wd.t(), lt)
    dense.backward()
    torch.testing.assert_close(loss, dense, rtol=1e-6, atol=0)
    want = wd.grad if transpose_w else wd.grad.t()
    assert wl.grad.shape == wl.shape
    torch.testing.assert_close(wl.grad, want, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(xt.grad, xd.grad, rtol=1e-5, atol=1e-7)


def test_int32_and_int64_labels_agree():
    x, w, lab = _inputs()
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    a = tbce.blockwise_ce_loss(xt, wt, torch.from_numpy(lab), chunk=8)
    b = tbce.blockwise_ce_loss(xt, wt, torch.from_numpy(lab).long(),
                               chunk=8)
    assert torch.equal(a, b)


def test_shape_contract_and_memory_helpers():
    assert tbce.ce_shape_problems(16384, 2048, 32000, torch.bfloat16) == []
    problems = tbce.ce_shape_problems(0, 36, 10, torch.bfloat16)
    assert len(problems) == 2 and any("d=36" in p for p in problems)
    assert tbce.ce_shape_problems(4, 36, 10, torch.float32) == []
    assert any("float16" in p for p in tbce.ce_shape_problems(
        4, 64, 10, torch.float16))
    with pytest.raises(ValueError, match="d=36"):
        tbce.check_ce_shapes(4, 36, 10, torch.bfloat16)
    for args in ((16384, 32000), (37, 250, 2)):
        assert tbce.dense_logits_bytes(*args) == jbce.dense_logits_bytes(
            *args)
    for args in ((16384, 32000, 512), (37, 250, 8, 64, 4), (37, 250, 0),
                 (5, 250, 8, 300)):
        assert tbce.logits_bytes_saved(*args) == \
            jbce.logits_bytes_saved(*args)
    # the backward's dS workspace stays within 256 MiB
    vs = tbce.ce_super_block(16384, 32000, 2)
    assert vs == 8192 and 16384 * vs * 2 <= 256 * 2 ** 20
    assert tbce.ce_super_block(256, 32000, 4) == 32000
    assert tbce.ce_super_block(37, 250, 4) == 256
    assert tbce.ce_super_block(2 ** 22, 128256, 2) == 128


def test_shape_contract_takes_rows_past_the_old_int32_cap():
    """9 x 2048 rows at Llama-3-8B's head (D 4096, V 128256): N x V passes
    2^31, and the kernels' 64-bit offsets take it; the backward's dS
    workspace still stays within 256 MiB."""
    n, d, v = 18432, 4096, 128256
    assert n * v >= 2 ** 31
    assert tbce.ce_shape_problems(n, d, v, torch.bfloat16) == []
    tbce.check_ce_shapes(n, d, v, torch.bfloat16)
    vs = tbce.ce_super_block(n, v, 2)
    assert vs == 7168 and n * vs * 2 <= 256 * 2 ** 20


def test_wrapper_rejects_bad_arguments():
    x, w, lab = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(ValueError, match="mismatch"):
        tbce.blockwise_ce_loss(x, w, lab[:5], chunk=8)
    with pytest.raises(ValueError, match="one type"):
        tbce.blockwise_ce_loss(x, w.bfloat16(), lab, chunk=8)
    with pytest.raises(ValueError, match="int32 or int64"):
        tbce.blockwise_ce_loss(x, w, lab.float(), chunk=8)
    with pytest.raises(ValueError, match="chunk"):
        tbce.blockwise_ce_loss(x, w, lab, chunk=0)
