"""The blockwise CE over vocab shards (tensor parallelism), and the twin's
rule for a label outside the vocab, against the JAX package on the CPU.

- A label outside [0, V) picks nothing and has no one-hot in the CUDA
  kernel (kernels/csrc/blockwise_ce.cu) and in the JAX streamed path
  (`_chunk_lse_picked` with vocab_block > 0: `col == label`); the twin's
  dense path follows the same rule. The JAX dense path is no oracle for
  it (`jnp.take_along_axis` gives NaN for a label of V and wraps -1).
- The vocab-parallel loss in one process: W cut into two shards, each
  shard's `ce_fwd_rows` / `ce_bwd` on its local labels
  (`local_labels`), the row lse combined (`combine_lse`), the picked
  logits and dx summed, dW concatenated, as `vocab_parallel_ce_loss`
  combines them over an mp group; against the whole-vocab twin and JAX
  `blockwise_ce_loss` (kernel="jnp" and the interpret-mode Pallas
  kernels).

Shapes: N = 37 rows, D = 64, V = 250 (two shards of 125), three rows at
ignore_index, labels on both shards. Tolerances: the loss within 1e-6
relative and the lse within 1e-5 absolute (test_torch_blockwise_ce.py's
f32 rules: the same f32 products summed in other orders); dx and dW
within 1e-6 of their largest entry in f32, and in bf16 within chip_smoke's
`_check_rows` rule at one bf16 step, 2^-7 x (|ref| + the row's RMS +
2^-6 of the whole RMS): the combined lse differs from the whole vocab's
in its last f32 bit, which may flip a bf16 rounding of dS, and each
shard's dx is rounded to bf16 before the two are summed in bf16, as the
all-reduce sums them (measured: 0.0067 of a dW row's RMS).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import blockwise_ce as jbce
from paddle_tpu_torch.kernels import blockwise_ce as tbce

N, D, V = 37, 64, 250
IGNORED = (3, 11, 30)
SHARDS = 2


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, D).astype(np.float32)
    w = (rng.randn(V, D) * 0.1).astype(np.float32)      # (V, D)
    lab = rng.randint(0, V, N).astype(np.int32)
    lab[list(IGNORED)] = -100
    return x, w, lab


def _jax(x, w, lab, dtype, chunk, vocab_block, kernel):
    """(loss, dx, dW (V, D)) of JAX `blockwise_ce_loss`."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xj, wj, lj = jnp.asarray(x, jd), jnp.asarray(w.T, jd), jnp.asarray(lab)

    def loss(a, b):
        return jbce.blockwise_ce_loss(a, b, lj, chunk=chunk,
                                      vocab_block=vocab_block, kernel=kernel)

    val, (gx, gw) = jax.value_and_grad(loss, argnums=(0, 1))(xj, wj)
    return float(val), np.asarray(gx, np.float32), np.asarray(gw,
                                                             np.float32).T


def _twin(x, w, lab, chunk, vocab_block):
    """(loss, lse, dx, dW) of the whole-vocab twin, g = 1."""
    one = torch.ones(())
    loss, lse, count = tbce.ce_fwd_ref(x, w, lab, chunk, vocab_block)
    dx, dw = tbce.ce_bwd_ref(x, w, lab, lse, count, one, chunk, vocab_block)
    return loss, lse, dx, dw


def _sharded(x, w, lab, chunk, vocab_block):
    """(loss, lse, dx, dW) combined from the shards."""
    vl = w.shape[0] // SHARDS
    one = torch.ones(())
    locs = [tbce.local_labels(lab, r * vl, vl) for r in range(SHARDS)]
    rows = [tbce.ce_fwd_rows(x, w[r * vl:(r + 1) * vl], locs[r], chunk,
                             vocab_block) for r in range(SHARDS)]
    lse = tbce.combine_lse([r[0] for r in rows])
    picked = sum(r[1] for r in rows)
    valid = lab != -100
    count = torch.clamp(valid.float().sum(), min=1.0)
    loss = torch.where(valid, lse - picked, 0.0).sum() / count
    parts = [tbce.ce_bwd(x, w[r * vl:(r + 1) * vl], locs[r], lse, count,
                         one, chunk, vocab_block) for r in range(SHARDS)]
    dx = parts[0][0]
    for p in parts[1:]:
        dx = dx + p[0]
    return loss, lse, dx, torch.cat([p[1] for p in parts])


def _close(got, want, bf16, name):
    """f32: within 1e-6 of the largest entry; bf16: chip_smoke's
    `_check_rows` rule at one bf16 step, 2^-7 x (|ref| + the row's RMS +
    2^-6 of the RMS of all of ref)."""
    err = np.abs(got - want)
    if bf16:
        sq = want.astype(np.float64) ** 2
        bound = 2 ** -7 * (np.abs(want) + np.sqrt(sq.mean(-1, keepdims=True))
                           + 2 ** -6 * np.sqrt(sq.mean()))
    else:
        bound = 1e-6 * float(np.abs(want).max())
    assert (err <= bound).all(), f"{name}: |err| {err.max()} > its bound"


def test_local_labels():
    lab = torch.tensor([0, 124, 125, 249, -100, 7], dtype=torch.int32)
    assert tbce.local_labels(lab, 0, 125).tolist() == [0, 124, 125, 125,
                                                       -100, 7]
    r1 = tbce.local_labels(lab, 125, 125)
    assert r1.tolist() == [125, 125, 0, 124, -100, 125]
    assert r1.dtype == torch.int32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel,chunk,vocab_block", [
    ("jnp", 8, 0), ("jnp", 16, 48), ("pallas", 16, 48)])
def test_two_shards_combine_to_the_whole_vocab(kernel, chunk, vocab_block,
                                               dtype):
    x, w, lab = _inputs()
    xt, wt = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
    lt = torch.from_numpy(lab)
    loss, lse, dx, dw = _sharded(xt, wt, lt, chunk, vocab_block)
    assert dx.dtype == dtype and dw.dtype == dtype
    bf16 = dtype == torch.bfloat16
    wl, wlse, wdx, wdw = _twin(xt, wt, lt, chunk, vocab_block)
    jl, jdx, jdw = _jax(x, w, lab, dtype, chunk, vocab_block, kernel)
    for ref_loss, ref_dx, ref_dw, tag in (
            (float(wl), wdx.float().numpy(), wdw.float().numpy(), "twin"),
            (jl, jdx, jdw, "jax")):
        np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-6, atol=0)
        _close(dx.float().numpy(), ref_dx, bf16, f"dx {tag}")
        _close(dw.float().numpy(), ref_dw, bf16, f"dW {tag}")
    np.testing.assert_allclose(lse.numpy(), wlse.numpy(), rtol=0, atol=1e-5)
    assert not dx.float()[list(IGNORED)].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_twin_picks_nothing_for_a_label_outside_the_vocab(dtype):
    """Labels V and -1 (not ignore_index) through the twin's dense path
    (vocab_block 0): no pick and no one-hot, as the kernel and the JAX
    streamed path have it."""
    x, w, lab = _inputs(seed=1)
    lab[5], lab[8] = V, -1
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    wt = torch.from_numpy(w).to(dtype).requires_grad_(True)
    loss = tbce.blockwise_ce_loss(xt, wt, torch.from_numpy(lab), chunk=8)
    loss.backward()
    jl, jdx, jdw = _jax(x, w, lab, dtype, 8, 64, "jnp")
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=1e-6, atol=0)
    bf16 = dtype == torch.bfloat16
    _close(xt.grad.float().numpy(), jdx, bf16, "dx")
    _close(wt.grad.float().numpy(), jdw, bf16, "dW")
