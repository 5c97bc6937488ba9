"""The port's semi-auto parallel API (paddle_tpu_torch/distributed/api.py,
over torch.distributed.tensor) against the JAX package's
(paddle_tpu/distributed/api.py), on the CPU.

tests/test_distributed_core.py:14-166's cases that api.py covers run in
a 4-rank gloo job (tests/_mp_worker.py api, through the port's launcher,
once): `shard_tensor` and `reshard` Shard(0) -> Shard(1) -> Replicate on
a 2 x 2 (dp, mp) mesh, Partial, the sharded matmul and its gradient on a
1-D mesh of 4, `shard_layer` with `shard_optimizer` and an AdamW step,
`dtensor_from_fn`, `unshard_dtensor`. The JAX side runs the same
functions on a virtual mesh of the same shape (devices 0-3); rank r's
local values are held against the JAX array's shard on device r, or
against the JAX value cut as rank r's placement cuts it where the JAX
result is not laid out so (a gradient, an updated weight).

Tolerance: f32, within 1e-6 of the largest entry (the same f32 values
moved or the same products), 1e-5 after the AdamW step.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_mp_worker.py")


def _close(got, want, tol=1e-6):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(np.asarray(got) - want).max()) <= tol * scale


def _on(t, r):
    """The JAX array's shard on device r."""
    return [np.asarray(s.data) for s in t._value.addressable_shards
            if s.device.id == r][0]


def _inputs():
    rng = np.random.RandomState(0)
    return {"x": np.arange(32, dtype=np.float32).reshape(8, 4),
            "wn": rng.randn(16, 32).astype(np.float32),
            "xm": rng.randn(4, 16).astype(np.float32),
            "lin_w": (rng.randn(16, 32) * 0.1).astype(np.float32),
            "lin_b": (rng.randn(32) * 0.1).astype(np.float32),
            "lin_x": rng.randn(4, 16).astype(np.float32)}


def _jax_want(inp):
    mesh = jdist.ProcessMesh([[0, 1], [2, 3]], dim_names=["dp", "mp"])
    line = jdist.ProcessMesh([0, 1, 2, 3], dim_names=["mp"])
    want = {}
    t = jdist.shard_tensor(inp["x"], mesh, [jdist.Shard(0),
                                            jdist.Replicate()])
    t2 = jdist.reshard(t, mesh, [jdist.Replicate(), jdist.Shard(1)])
    t3 = jdist.reshard(t2, mesh, [jdist.Replicate(), jdist.Replicate()])
    p = jdist.shard_tensor(inp["x"], mesh, [jdist.Partial(),
                                            jdist.Replicate()])
    want.update({f"{k}/{r}": _on(v, r) for r in range(4)
                 for k, v in (("s0", t), ("s1", t2), ("r", t3), ("p", p))})
    want["s0/placements"] = [repr(q) for q in t.placements]
    w = jdist.shard_tensor(inp["wn"], line, [jdist.Shard(1)],
                           stop_gradient=False)
    y = paddle.matmul(paddle.to_tensor(inp["xm"]), w)
    y.sum().backward()
    want.update({"mm/y": y.numpy(), "mm/w_grad": w.grad.numpy()})

    layer = jnn.Linear(16, 32)
    layer.weight.set_value(inp["lin_w"])
    layer.bias.set_value(inp["lin_b"])

    def col_shard(name, sub, m):
        params = getattr(sub, "_parameters", {})
        for pname, prm in list(params.items()):
            if prm is None or prm.ndim != 2:
                continue
            sharded = jdist.shard_tensor(prm, m, [jdist.Shard(1)],
                                         stop_gradient=False)
            from paddle_tpu.core.tensor import Parameter
            new = Parameter(sharded._value, trainable=True)
            new.name = prm.name
            params[pname] = new

    jdist.shard_layer(layer, line, col_shard)
    opt = jdist.shard_optimizer(jopt.AdamW(learning_rate=1e-3,
                                           parameters=layer.parameters()))
    layer(paddle.to_tensor(inp["lin_x"])).sum().backward()
    opt.step()
    want.update({"layer/w": layer.weight.numpy(),
                 "layer/b": layer.bias.numpy()})
    f = jdist.dtensor_from_fn(lambda: paddle.ones([8, 4]), line,
                              [jdist.Shard(0)])
    want.update({f"fn/{r}": _on(f, r) for r in range(4)})
    want["fn/full"] = jdist.unshard_dtensor(f).numpy()
    return want


@pytest.fixture(scope="module")
def api_job(tmp_path_factory):
    """The 4-rank job, started first; the JAX side runs meanwhile."""
    inp = _inputs()
    out = tmp_path_factory.mktemp("api")
    np.savez(out / "in.npz", **inp)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--devices", "0,1,2,3", "--log_dir", str(out / "logs"), WORKER,
           "api", str(out / "in.npz"), str(out)]
    proc = subprocess.Popen(cmd, env=dict(os.environ, PYTHONPATH=REPO))
    try:
        want = _jax_want(inp)
        code = proc.wait(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    logs = "".join((out / "logs" / f).read_text()
                   for f in sorted(os.listdir(out / "logs")))
    assert code == 0, f"api job failed:\n{logs[-4000:]}"
    ranks = []
    for r in range(4):
        with np.load(out / f"rank{r}.npz") as f:
            ranks.append({k: f[k] for k in f.files})
    return inp, want, ranks


def test_shard_tensor_and_reshard(api_job):
    """Shard(0) -> (Replicate, Shard(1)) -> Replicate: each rank's local
    block is the JAX array's shard on its device."""
    _, want, ranks = api_job
    for r, got in enumerate(ranks):
        for k in ("s0", "s1", "r"):
            np.testing.assert_array_equal(got[f"{k}/local"], want[f"{k}/{r}"])
        assert list(got["s0/placements"]) == ["Shard(dim=0)", "Replicate()"]
        assert want["s0/placements"] == ["Shard(dim=0)", "Replicate()"]
        assert bool(got["s0/is_dist"]) and bool(got["s0/mesh"])


def test_partial_keeps_the_implicit_sum(api_job):
    """shard_tensor with Partial divides by the Partial axis's ranks (the
    JAX rule: the implicit sum is the original); reshard to Partial
    raises on both packages."""
    inp, want, ranks = api_job
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["p/local"], want[f"p/{r}"])
        np.testing.assert_array_equal(got["p/full"], inp["x"])
        assert bool(got["p/reshard_raises"])
    mesh = jdist.ProcessMesh([[0, 1], [2, 3]], dim_names=["dp", "mp"])
    t = jdist.shard_tensor(inp["x"], mesh, [jdist.Shard(0),
                                            jdist.Replicate()])
    with pytest.raises(NotImplementedError):
        jdist.reshard(t, mesh, [jdist.Partial(), jdist.Replicate()])


def test_sharded_matmul_and_its_gradient(api_job):
    _, want, ranks = api_job
    for r, got in enumerate(ranks):
        cols = slice(r * 8, (r + 1) * 8)
        _close(got["mm/y"], want["mm/y"])
        _close(got["mm/y_local"], want["mm/y"][:, cols])
        _close(got["mm/w_grad"], want["mm/w_grad"])
        _close(got["mm/w_grad_local"], want["mm/w_grad"][:, cols])


def test_shard_layer_and_shard_optimizer_step(api_job):
    """The JAX test's column sharding (Shard(1) of its (in, out) weight,
    Shard(0) of the port's (out, in) one) and an AdamW step: each rank's
    weight rows equal the JAX weight's, the moments are DTensors placed
    as their parameter."""
    _, want, ranks = api_job
    for r, got in enumerate(ranks):
        rows = slice(r * 8, (r + 1) * 8)
        _close(got["layer/w_local"], want["layer/w"].T[rows], 1e-5)
        _close(got["layer/b_local"], want["layer/b"], 1e-5)
        assert bool(got["layer/moments_dist"])
        assert got["layer/moment1_local"].shape == (8, 16)


def test_dtensor_from_fn_and_unshard(api_job):
    _, want, ranks = api_job
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["fn/local"], want[f"fn/{r}"])
        np.testing.assert_array_equal(got["fn/full"], want["fn/full"])
