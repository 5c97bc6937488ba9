"""The port's MoE (paddle_tpu_torch/nn/moe.py) against the JAX package's
(paddle_tpu/nn/functional/moe.py, paddle_tpu/nn/layer/moe.py), on the
CPU.

The same numpy inputs and weights go to both packages. Tolerances, f32:
- the gates, combine and dispatch tensors and the aux losses: the same
  f32 expressions, within 1e-6 (dispatch masks and expert ids exactly);
- the expert MLP outputs: 1e-5 relative to the output's largest entry
  (the same products summed in other orders); against test_moe.py's
  float64 numpy oracle, 2e-4, as that test holds the JAX package;
- `MoEMLP` forward, aux loss and every gradient against
  `jax.value_and_grad`: 1e-5 relative to each tensor's largest entry.
The random logits have no ties among a token's expert probabilities:
the order of equal values in `torch.topk` is not the one `lax.top_k`
takes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.jit.functional import functional_call, state_arrays
from paddle_tpu.nn.functional import moe as FM
from paddle_tpu.nn.layer import moe as jmoe
from paddle_tpu_torch.nn import moe as tmoe
from test_moe import _dense_moe_reference


def _rel(got, want, tol, name=""):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * scale, f"{name}: |err| {err} > {tol} x {scale}"


def _t(a):
    return torch.from_numpy(np.array(a))


def _logits(t=64, e=4, seed=0, skew=0.0):
    rng = np.random.RandomState(seed)
    x = rng.randn(t, e).astype(np.float32)
    x[:, 0] += skew
    return x


@pytest.mark.parametrize("cf,skew", [(2.0, 0.0), (1.25, 0.0), (0.5, 1.5)])
def test_top2_gating_matches_jax(cf, skew):
    logits = _logits(skew=skew)
    jc, jd, ja = FM.top2_gating(jnp.asarray(logits), capacity_factor=cf)
    tc, td, ta = tmoe.top2_gating(_t(logits), capacity_factor=cf)
    assert tc.shape == jc.shape
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    if cf == 0.5:           # the skewed router overflows expert 0
        kept = np.asarray(jd).sum(axis=(1, 2))
        assert (kept < 2).any()


@pytest.mark.parametrize("cf", [4.0, 0.5])
def test_switch_gating_matches_jax_with_overflow(cf):
    logits = _logits(skew=1.0, seed=1)
    jc, jd, ja = FM.switch_gating(jnp.asarray(logits), capacity_factor=cf)
    tc, td, ta = tmoe.switch_gating(_t(logits), capacity_factor=cf)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    dropped = int((np.asarray(jd).sum(axis=(1, 2)) == 0).sum())
    assert (dropped > 0) == (cf == 0.5), dropped


@pytest.mark.parametrize("k", [1, 2, 4])
def test_topk_gating_dropless_matches_jax(k):
    logits = _logits(t=40, e=8, seed=2)
    ji, jg, ja = FM.topk_gating_dropless(jnp.asarray(logits), k)
    ti, tg, ta = tmoe.topk_gating_dropless(_t(logits), k)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def test_dispatch_and_combine_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(32, 8).astype(np.float32)
    logits = _logits(t=32, seed=4)
    jc, jd, _ = FM.top2_gating(jnp.asarray(logits), capacity_factor=1.0)
    tc, td, _ = tmoe.top2_gating(_t(logits), capacity_factor=1.0)
    j_in = FM.moe_dispatch(jnp.asarray(x), jd)
    t_in = tmoe.moe_dispatch(_t(x), td)
    np.testing.assert_allclose(t_in.numpy(), np.asarray(j_in), atol=1e-6)
    out = rng.randn(*t_in.shape).astype(np.float32)
    np.testing.assert_allclose(
        tmoe.moe_combine(_t(out), tc).numpy(),
        np.asarray(FM.moe_combine(jnp.asarray(out), jc)), rtol=1e-5,
        atol=1e-6)


def _experts(seed, t=24, d=8, f=16, e=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(t, d).astype(np.float32),
            rng.randn(d, e).astype(np.float32),
            (rng.randn(e, d, f) * 0.3).astype(np.float32),
            (rng.randn(e, d, f) * 0.3).astype(np.float32),
            (rng.randn(e, f, d) * 0.3).astype(np.float32))


@pytest.mark.parametrize("k", [2, 4])
def test_moe_dropless_mlp_matches_jax_and_the_oracle(k):
    x, rw, wg, wu, wd = _experts(0, e=6)
    idx, gates, _ = FM.topk_gating_dropless(jnp.asarray(x @ rw), k)
    want = np.asarray(FM.moe_dropless_mlp(
        jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd),
        idx, gates))
    got = tmoe.moe_dropless_mlp(_t(x), _t(wg), _t(wu), _t(wd),
                                _t(np.asarray(idx)), _t(np.asarray(gates)))
    _rel(got.numpy(), want, 1e-5, "dropless")
    oracle = _dense_moe_reference(x, rw, wg, wu, wd, k)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-4, atol=2e-4)


def test_plain_grouped_product_with_empty_groups():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(11, 6).astype(np.float32))
    w = torch.from_numpy(rng.randn(5, 6, 3).astype(np.float32))
    ends = [0, 4, 4, 11, 11]           # experts 0, 2 and 4 have no rows
    out = tmoe.grouped_mm(x, w, torch.tensor(ends, dtype=torch.int32))
    want = torch.cat([x[0:4] @ w[1], x[4:11] @ w[3]])
    assert out.shape == (11, 3)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_sort_by_expert_is_stable_with_empty_experts():
    """The pairs grouped by expert in their flat order within a group
    (jnp.argsort's stable sort in the JAX `moe_dropless_mlp`), each
    expert's end row counted, empty experts included."""
    idx = torch.tensor([[3, 0], [0, 3], [5, 0]], dtype=torch.int32)
    order, offsets = tmoe.sort_by_expert(idx, 6)
    assert order.tolist() == [1, 2, 5, 0, 3, 4]
    assert offsets.dtype == torch.int32
    assert offsets.tolist() == [3, 3, 3, 5, 5, 6]


def _layer_pair(k, dropless, cf, seed=0, d=16, f=24, e=4):
    paddle_tpu.seed(seed)
    jl = jmoe.MoEMLP(d, f, e, top_k=k, capacity_factor=cf,
                     dropless=dropless)
    state = {n: np.asarray(v) for n, v in state_arrays(jl).items()}
    tl = tmoe.MoEMLP(d, f, e, top_k=k, capacity_factor=cf,
                     dropless=dropless)
    tl.load_state_dict({n: _t(v) for n, v in state.items()})
    return jl, tl, state


@pytest.mark.parametrize("k,dropless,cf", [
    (1, False, 0.5), (2, False, 0.5), (2, False, 2.0), (2, True, 1.25),
    (4, True, 1.25)])
def test_moe_layer_forward_aux_and_gradients_match_jax(k, dropless, cf):
    """Capacity k = 1 (Switch) and k = 2 (GShard), each with drops at cf
    0.5, and dropless k = 2 and 4 (8 experts): the output, the aux loss
    and the gradients of sum(out * r) + 0.1 aux for the input and every
    parameter."""
    e = 8 if k == 4 else 4
    jl, tl, state = _layer_pair(k, dropless, cf, e=e)
    rng = np.random.RandomState(7)
    x = rng.randn(2, 12, 16).astype(np.float32)
    r = rng.randn(2, 12, 16).astype(np.float32)

    def jloss(params, xa):
        out = functional_call(jl, params, JTensor(xa))._value
        aux = jl.aux_loss._value
        return jnp.sum(out * r) + 0.1 * aux, (out, aux)

    (jv, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            {n: jnp.asarray(v) for n, v in state.items()}, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    out = tl(xt)
    loss = torch.sum(out * _t(r)) + 0.1 * tl.aux_loss
    loss.backward()
    _rel(out.detach().numpy(), jout, 1e-5, "out")
    np.testing.assert_allclose(float(tl.aux_loss.detach()), float(jaux),
                               rtol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-5)
    _rel(xt.grad.numpy(), jgx, 1e-5, "x")
    for name, p in tl.named_parameters():
        _rel(p.grad.numpy(), jgp[name], 1e-5, name)
        assert np.abs(np.asarray(jgp[name])).max() > 0, name


def test_capacity_path_drops_where_dropless_does_not():
    """test_moe.py's starvation case through the port: at cf 0.25 the
    capacity path leaves the oracle and equals the JAX capacity path; the
    dropless path equals the oracle."""
    x, rw, wg, wu, wd = _experts(1, t=64, f=16)
    rw[:, 0] += 2.0
    oracle = _dense_moe_reference(x, rw, wg, wu, wd, 2)
    args = [paddle_tpu.to_tensor(a) for a in (x, rw, wg, wu, wd)]
    j_cap, _ = jmoe._moe_mlp(*args, k=2, capacity_factor=0.25)
    t_cap, _ = tmoe.moe_mlp(*map(_t, (x, rw, wg, wu, wd)), k=2,
                            capacity_factor=0.25)
    t_drop, _ = tmoe.moe_mlp_dropless(*map(_t, (x, rw, wg, wu, wd)), k=2)
    _rel(t_cap.numpy(), j_cap.numpy(), 1e-5, "capacity")
    assert np.abs(t_cap.numpy() - oracle).max() > 1e-2
    np.testing.assert_allclose(t_drop.numpy(), oracle, rtol=2e-4,
                               atol=2e-4)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def _static_grouped_mm(x, w, offsets):
    """A grouped product that reads the offsets on the device only (each
    row's expert by searchsorted): the stand-in for torch._grouped_mm,
    which the CPU lacks in the card's form."""
    rows = torch.arange(x.shape[0], dtype=torch.int32)
    group = torch.searchsorted(offsets, rows, right=True)
    return torch.bmm(x[:, None, :], w.index_select(0, group))[:, 0]


@pytest.mark.parametrize("dropless", [True, False])
def test_moe_forward_reads_nothing_back_to_the_host(dropless, monkeypatch):
    """Every op of the MoE forward (gating, sort, group counts and
    offsets, gathers, the capacity path's cumsums and einsums) stays on
    the device: no `aten._local_scalar_dense` (.item(), .tolist(), a
    data-sized bincount) and no `aten.nonzero`, so the engine's decode
    tick captures it. The grouped product is swapped for a static one,
    as on the card it is torch._grouped_mm over device offsets (the card
    test captures that)."""
    monkeypatch.setattr(tmoe, "grouped_mm", _static_grouped_mm)
    _, tl, _ = _layer_pair(2, dropless, 1.25)
    x = torch.from_numpy(np.random.RandomState(8).randn(3, 5, 16)
                         .astype(np.float32))
    with torch.no_grad():
        want = tl(x)
        with _Ops() as ops:
            out = tl(x)
    torch.testing.assert_close(out, want)
    assert "aten._local_scalar_dense" not in ops.names, ops.names
    assert "aten.nonzero" not in ops.names, ops.names
    assert "aten.bincount" not in ops.names
    if dropless:
        monkeypatch.undo()
        torch.testing.assert_close(tl(x).detach(), want, rtol=1e-5,
                                   atol=1e-6)
