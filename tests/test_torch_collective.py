"""The port's process group, collectives, meshes, placements and plans
(paddle_tpu_torch/distributed/{env,collective,mesh,placement}.py,
parallel/plan.py) against the JAX package's, on the CPU.

The JAX facade is single-controller: one process holds a rank-major
(nranks, *local) array. The port is one process a rank. The parity rule:
for a seeded rank-major X, rank r of an N-process gloo job started by the
port's launcher, given X[r], returns row r of the JAX facade's output
on this process's virtual CPU devices. Each job (N = 2 and 4) starts
once, in a module-scoped fixture, and every rank saves what each
collective returned. Where the JAX facade lifts one replicated value to
every rank (the list forms of reduce_scatter and alltoall, scatter's
source), the port's per-rank inputs are also held against numpy.

Tolerances: f32 sums over at most 4 ranks in another order, 1e-6
relative; PROD on positive inputs against the JAX exp(psum(log x)),
1e-5 relative (the JAX PROD is NaN for a negative entry: ROADMAP queue
3); everything else exact.
"""
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

import paddle_tpu.distributed as jdist
from paddle_tpu.core.jax_compat import shard_map
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.distributed import collective as jcoll
from paddle_tpu.parallel import plan as jplan
from paddle_tpu_torch.distributed import chaos as t_chaos
from paddle_tpu_torch.distributed import collective as tcoll
from paddle_tpu_torch.distributed import env as t_env
from paddle_tpu_torch.distributed import mesh as t_mesh
from paddle_tpu_torch.distributed import placement as t_pl
from paddle_tpu_torch.distributed import watchdog as t_watchdog
from paddle_tpu_torch.parallel import plan as tplan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_TIMEOUT_S = 240

# one rank's worker: every collective on its rows of inputs.npz
_WORKER = r'''
import sys
import numpy as np
import torch
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed import watchdog

out = sys.argv[1]
group = dist.init_parallel_env(device="cpu")
r, n = dist.get_rank(), dist.get_world_size()
assert group.nranks == n and dist.is_initialized()
inp = dict(np.load(f"{out}/inputs.npz"))
T = lambda a: torch.from_numpy(np.array(a))
res = {}
watchdog.enable(poll_ms=50)
for op in ("sum", "max", "min", "avg"):
    t = T(inp["X"][r])
    assert dist.all_reduce(t, op) is t
    res[f"all_reduce_{op}"] = t.numpy()
t = T(inp["XP"][r])
dist.all_reduce(t, dist.ReduceOp.PROD)
res["all_reduce_prod"] = t.numpy()
got = []
dist.all_gather(got, T(inp["X"][r]))
res["all_gather_list"] = torch.stack(got).numpy()
res["all_gather_fn"] = torch.stack(dist.all_gather(T(inp["X"][r]))).numpy()
t = T(inp["X"][r])
dist.broadcast(t, src=1)
res["broadcast_from_1"] = t.numpy()
for op in ("sum", "max"):
    t = T(inp["X"][r])
    dist.reduce(t, dst=1, op=op)
    res[f"reduce_to_1_{op}"] = t.numpy()
res["reduce_scatter_rep"] = dist.reduce_scatter(T(inp["S"])).numpy()
into = torch.zeros(inp["SL"].shape[1:], dtype=torch.float32)
ret = dist.reduce_scatter(into, [T(c) for c in inp["SL"]])
assert torch.equal(ret, into)
res["reduce_scatter_rep_list"] = into.numpy()
res["reduce_scatter_own"] = dist.reduce_scatter(T(inp["S"] + r)).numpy()
res["alltoall_tensor"] = dist.alltoall(T(inp["A"][r])).numpy()
outs = []
dist.all_to_all([T(c) for c in inp["A"][r]], outs)
res["alltoall_list"] = torch.stack(outs).numpy()
into = torch.zeros(inp["L"].shape[1:], dtype=torch.float32)
dist.scatter(into, [T(c) for c in inp["L"]] if r == 1 else None, src=1)
res["scatter_list_from_1"] = into.numpy()
full = T(inp["L"]) if r == 0 else torch.zeros(inp["L"].shape[1:])
res["scatter_tensor"] = dist.scatter(full, src=0).numpy()
dist.barrier()
nxt, prv = (r + 1) % n, (r - 1) % n
x = T(inp["X"][r])
if r % 2 == 0:
    dist.send(x, nxt)
    got = dist.recv(src=prv)
else:
    got = dist.recv(src=prv)
    dist.send(x, nxt)
res["send_recv"] = got.numpy()
into = torch.zeros_like(x)
if r % 2 == 0:
    dist.send(x * 2, nxt)
    dist.recv(into, src=prv)
else:
    dist.recv(into, src=prv)
    dist.send(x * 2, nxt)
res["send_recv_into"] = into.numpy()
mesh = dist.init_mesh({"dp": 2, "mp": n // 2})
for axis in mesh.dim_names:
    k = mesh.get_dim_size(axis)
    with mesh:
        res[f"psum_{axis}"] = dist.psum(T(inp["X"][r]), axis).numpy()
        res[f"pmean_{axis}"] = dist.pmean(T(inp["X"][r]), axis).numpy()
        res[f"ppermute_{axis}"] = dist.ppermute(
            T(inp["X"][r]), axis, [(i, (i + 1) % k) for i in range(k)]).numpy()
sub = dist.new_group(sorted({1, n - 1}))
t = T(inp["X"][r])
dist.all_reduce(t, group=sub)
res["subgroup_all_reduce"] = t.numpy()
res["subgroup_rank"] = np.array(dist.get_rank(sub))
res["expired"] = np.array(watchdog.expired_count())
np.savez(f"{out}/rank{r}.npz", **res)
dist.barrier()
dist.destroy_process_group()
'''


def _inputs(n):
    rng = np.random.RandomState(n)
    f = np.float32
    return {"X": rng.standard_normal((n, 4, 3)).astype(f),
            "XP": (np.abs(rng.standard_normal((n, 4, 3))) + 0.5).astype(f),
            "S": rng.standard_normal((2 * n, 3)).astype(f),
            "SL": rng.standard_normal((n, 2, 3)).astype(f),
            "A": rng.standard_normal((n, n, 2)).astype(f),
            "L": rng.standard_normal((n, 3)).astype(f)}


def _launch(tmp, n):
    out = tmp / f"job{n}"
    out.mkdir()
    inp = _inputs(n)
    np.savez(out / "inputs.npz", **inp)
    worker = out / "worker.py"
    worker.write_text(_WORKER)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--devices", ",".join(str(i) for i in range(n)),
           "--log_dir", str(out / "logs"), str(worker), str(out)]
    env = dict(os.environ, PYTHONPATH=REPO)
    return out, inp, subprocess.Popen(cmd, env=env)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Both jobs, started together: {n: (inputs, [rank results])}."""
    tmp = tmp_path_factory.mktemp("coll")
    started = {n: _launch(tmp, n) for n in (2, 4)}
    out = {}
    for n, (d, inp, proc) in started.items():
        try:
            rc = proc.wait(timeout=JOB_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        logs = "".join((d / "logs" / f).read_text()
                       for f in sorted(os.listdir(d / "logs")))
        assert rc == 0, f"{n}-rank job failed:\n{logs[-4000:]}"
        out[n] = (inp, [dict(np.load(d / f"rank{r}.npz")) for r in range(n)])
    return out


def _jgroup(n):
    return jdist.new_group(list(range(n)))


def _rank_major(x, g):
    return JTensor(jax.device_put(np.asarray(x),
                                  NamedSharding(g.mesh, JP(jcoll._AXIS))))


def _rows(t):
    return np.asarray(t._value if isinstance(t, JTensor) else t)


def _check(res, name, want, rtol=1e-6):
    for r, row in enumerate(want):
        np.testing.assert_allclose(res[r][name], row, rtol=rtol, atol=1e-6,
                                   err_msg=f"{name} rank {r}")


N = pytest.mark.parametrize("n", [2, 4])


@N
@pytest.mark.parametrize("op", ["sum", "max", "min", "avg", "prod"])
def test_all_reduce_rows(jobs, n, op):
    inp, res = jobs[n]
    g = _jgroup(n)
    x = inp["XP"] if op == "prod" else inp["X"]
    want = _rows(jdist.all_reduce(_rank_major(x, g), op=op, group=g))
    _check(res, f"all_reduce_{op}", want, 1e-5 if op == "prod" else 1e-6)


@N
def test_all_gather_both_forms(jobs, n):
    inp, res = jobs[n]
    g = _jgroup(n)
    got = jdist.all_gather(_rank_major(inp["X"], g), group=g)
    want = np.stack([_rows(t) for t in got])
    listed = []
    jdist.all_gather(listed, _rank_major(inp["X"], g), group=g)
    np.testing.assert_array_equal(np.stack([_rows(t) for t in listed]), want)
    for r in range(n):
        np.testing.assert_array_equal(res[r]["all_gather_list"], want)
        np.testing.assert_array_equal(res[r]["all_gather_fn"], want)


@N
def test_broadcast_and_reduce_from_rank_1(jobs, n):
    inp, res = jobs[n]
    g = _jgroup(n)
    b = _rows(jdist.broadcast(_rank_major(inp["X"], g), src=1, group=g))
    _check(res, "broadcast_from_1", [b] * n)
    for op in ("sum", "max"):
        want = _rows(jdist.reduce(_rank_major(inp["X"], g), dst=1, op=op,
                                  group=g))
        _check(res, f"reduce_to_1_{op}", want)
        assert np.array_equal(res[0][f"reduce_to_1_{op}"], inp["X"][0])


@N
def test_reduce_scatter_forms(jobs, n):
    inp, res = jobs[n]
    g = _jgroup(n)
    want = _rows(jdist.reduce_scatter(JTensor(inp["S"]), group=g))
    _check(res, "reduce_scatter_rep", want)
    want = _rows(jdist.reduce_scatter(None, [JTensor(c) for c in inp["SL"]],
                                      group=g))
    _check(res, "reduce_scatter_rep_list", want)
    # each rank's own input: the sum over ranks, chunk r
    own = sum(inp["S"] + r for r in range(n)).reshape(n, 2, 3)
    _check(res, "reduce_scatter_own", own)


@N
def test_alltoall_forms(jobs, n):
    inp, res = jobs[n]
    g = _jgroup(n)
    want = _rows(jdist.alltoall(_rank_major(inp["A"], g), group=g))
    _check(res, "alltoall_tensor", want)
    # list form, each rank its own list: rank r receives chunk r of each
    _check(res, "alltoall_list", np.swapaxes(inp["A"], 0, 1))
    np.testing.assert_array_equal(want, np.swapaxes(inp["A"], 0, 1))


@N
def test_scatter_rows(jobs, n):
    inp, res = jobs[n]
    g = _jgroup(n)
    want = _rows(jdist.scatter(None, [JTensor(c) for c in inp["L"]], src=1,
                               group=g))
    _check(res, "scatter_list_from_1", want)
    want = _rows(jdist.scatter(JTensor(inp["L"]), src=0, group=g))
    _check(res, "scatter_tensor", want)


@N
def test_send_recv_ring(jobs, n):
    inp, res = jobs[n]
    prev = np.roll(inp["X"], 1, axis=0)
    _check(res, "send_recv", prev)
    _check(res, "send_recv_into", 2 * prev)


@N
def test_mesh_axis_psum_pmean_ppermute(jobs, n):
    inp, res = jobs[n]
    shape = (2, n // 2)
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), ("dp", "mp"))
    spec = JP(("dp", "mp"))
    for axis, k in zip(("dp", "mp"), shape):
        perm = [(i, (i + 1) % k) for i in range(k)]
        for name, body in (("psum", lambda x: jcoll.psum(x, axis)),
                           ("pmean", lambda x: jcoll.pmean(x, axis)),
                           ("ppermute",
                            lambda x: jcoll.ppermute(x, axis, perm))):
            fn = shard_map(body, mesh=mesh, in_specs=spec, out_specs=spec)
            want = np.asarray(fn(inp["X"].reshape(n * 4, 3))).reshape(
                n, 4, 3)
            _check(res, f"{name}_{axis}", want)


@N
def test_subgroup_and_watchdog(jobs, n):
    inp, res = jobs[n]
    members = sorted({1, n - 1})
    g = jdist.new_group(members)
    rows = _rows(jdist.all_reduce(_rank_major(inp["X"][members], g), group=g))
    want = inp["X"].copy()
    want[members] = rows
    _check(res, "subgroup_all_reduce", want)
    assert [int(res[r]["subgroup_rank"]) for r in range(n)] == \
        [members.index(r) if r in members else -1 for r in range(n)]
    # no collective of the job came near the watchdog's deadline
    assert all(int(res[r]["expired"]) == 0 for r in range(n))


# -- in this process: the one-rank default, the watchdog, chaos ----------------

@pytest.fixture
def one_rank():
    """Collectives without init_parallel_env: the private one-rank world."""
    assert not t_env.is_initialized()
    yield
    tcoll.destroy_process_group()
    assert not torch.distributed.is_initialized()


def test_no_init_default_is_one_rank(one_rank):
    x = np.random.RandomState(0).standard_normal((3, 2)).astype(np.float32)
    g = jdist.new_group([0])
    t = torch.from_numpy(x.copy())
    tcoll.all_reduce(t)
    np.testing.assert_array_equal(
        t.numpy(), _rows(jdist.all_reduce(JTensor(x), group=g))[0])
    assert tcoll.get_group().nranks == 1 and t_env.get_world_size() == 1
    assert not t_env.is_initialized()      # the private world is no init
    assert [a.tolist() for a in tcoll.all_gather(torch.from_numpy(x))] == \
        [x.tolist()]
    np.testing.assert_array_equal(
        tcoll.reduce_scatter(torch.from_numpy(x)).numpy(),
        _rows(jdist.reduce_scatter(JTensor(x), group=g))[0])
    tcoll.send(torch.from_numpy(x), dst=0)
    np.testing.assert_array_equal(tcoll.recv(src=0).numpy(), x)
    with pytest.raises(RuntimeError, match="without a matching send"):
        tcoll.recv(src=0)
    with pytest.raises(ValueError, match="not in group"):
        tcoll.broadcast(torch.from_numpy(x), src=1)


def test_collectives_register_with_watchdog(one_rank):
    """tests/test_watchdog_elastic.py:37 on the port: no expiry over
    collectives that finish in time; a `collective.dispatch/all_reduce`
    delay past the group's deadline is exactly one."""
    t_watchdog.disable()              # an earlier op may have started it
    t_watchdog.enable(poll_ms=50)
    before = t_watchdog.expired_count()
    t = torch.arange(8, dtype=torch.float32)
    tcoll.all_reduce(t)
    tcoll.all_gather(t)
    tcoll.barrier()
    assert t_watchdog.expired_count() == before
    g = tcoll.new_group([0], timeout=0.2)
    with t_chaos.scoped(rates={"collective.dispatch/all_reduce": 1.0},
                        delay_ms=500):
        tcoll.all_reduce(t, group=g)
        assert t_chaos.fire_count("collective.dispatch/all_reduce") == 1
    deadline = time.monotonic() + 5
    while t_watchdog.expired_count() == before and time.monotonic() < deadline:
        time.sleep(0.05)
    time.sleep(0.2)
    assert t_watchdog.expired_count() == before + 1
    assert "collective/all_reduce" in t_watchdog.last_expired()


def test_init_parallel_env_replaces_the_private_world(one_rank, monkeypatch):
    tcoll.all_reduce(torch.ones(2))           # forms the private world
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    g = t_env.init_parallel_env(device="cpu")
    assert t_env.is_initialized() and g.nranks == 1
    assert torch.distributed.get_backend() == "gloo"
    assert t_env.init_parallel_env(device="cpu") is g     # idempotent
    t = torch.ones(2)
    assert tcoll.all_reduce(t).tolist() == [1.0, 1.0]
    env = t_env.ParallelEnv()
    assert (env.rank, env.world_size, env.device_id) == (0, 1, 0)


def test_mesh_needs_the_whole_world(one_rank):
    assert t_mesh.init_mesh({"dp": 1}).shape == [1]
    with pytest.raises(ValueError, match="world of 1"):
        t_mesh.init_mesh({"dp": 2})
    with pytest.raises(ValueError, match="does not cover the world"):
        t_mesh.ProcessMesh([0, 1], ["dp"]).device_mesh
    assert t_mesh.auto_mesh("dp").process_ids == [0]


# -- meshes, placements and plans as data (tests/test_distributed_core.py) -----

def test_mesh_and_placements_match_jax():
    ids = [[0, 1, 2, 3], [4, 5, 6, 7]]
    jm = jdist.ProcessMesh(ids, dim_names=["dp", "mp"])
    tm = t_mesh.ProcessMesh(ids, dim_names=["dp", "mp"])
    assert tm.shape == jm.shape == [2, 4]
    assert tm.get_dim_size("mp") == jm.get_dim_size("mp") == 4
    assert tm.process_ids == jm.process_ids
    for sub_t, sub_j in ((tm.get_mesh_with_dim("mp"),
                          jm.get_mesh_with_dim("mp")),
                         (tm.get_mesh_with_dim("dp", 1),
                          jm.get_mesh_with_dim("dp", 1)),
                         (tm[1], jm[1]), (tm[:, 2], jm[:, 2])):
        assert sub_t.dim_names == sub_j.dim_names
        np.testing.assert_array_equal(sub_t.mesh, sub_j.mesh)
    shape_ids = t_mesh.ProcessMesh(shape=[2, 2], process_ids=[3, 2, 1, 0])
    assert shape_ids.process_ids == [3, 2, 1, 0]
    assert shape_ids.dim_names == ["d0", "d1"]
    cases = [([t_pl.Shard(0), t_pl.Shard(1)], 2),
             ([t_pl.Replicate(), t_pl.Shard(0)], 2),
             ([t_pl.Shard(1), t_pl.Shard(1)], 3),
             ([t_pl.Partial(), t_pl.Shard(-1)], 2),
             ([t_pl.Replicate(), t_pl.Replicate()], None)]
    for tps, ndim in cases:
        jps = [getattr(jdist, type(p).__name__)(*(
            [p.dim] if isinstance(p, t_pl.Shard) else [])) for p in tps]
        ts = t_pl.placements_to_spec(tps, tm, ndim=ndim)
        js = jdist.placements_to_spec(jps, jm, ndim=ndim)
        assert tuple(ts) == tuple(js), (tps, ts, js)
        assert [repr(p) for p in t_pl.spec_to_placements(ts, tm)] == \
            [repr(p) for p in jdist.spec_to_placements(js, jm)]
    with pytest.raises(ValueError):
        t_pl.placements_to_spec([t_pl.Shard(-1)], tm)
    assert repr(t_pl.PartitionSpec("dp", None)) == \
        "PartitionSpec('dp', None)"


def test_placements_convert_to_torch_and_back():
    from torch.distributed import tensor as tdt
    ps = [t_pl.Shard(1), t_pl.Replicate(), t_pl.Partial("sum")]
    tps = t_pl.to_torch_placements(ps)
    assert tps == [tdt.Shard(1), tdt.Replicate(), tdt.Partial("sum")]
    assert t_pl.from_torch_placements(tps) == ps


@pytest.mark.parametrize("axes", [("dp",), ("dp", "mp"), ("fsdp", "mp"),
                                  ("dp", "fsdp", "sp")])
def test_plans_match_jax(axes):
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, tiny_llama_config
    names = [n for n, _ in LlamaForCausalLM(
        tiny_llama_config(num_hidden_layers=1, tie_word_embeddings=False),
        device="cpu").named_parameters()]
    names += ["experts_gate_weight", "experts_down_weight", "router_weight"]
    tp, jp = tplan.llama_sharding_plan(axes), jplan.llama_sharding_plan(axes)
    for name in names:
        assert tuple(tp.spec_for(name)) == tuple(jp.spec_for(name)), name
        assert tplan.fsdp_partition(tp, name) == jplan.fsdp_partition(jp,
                                                                      name)
    for seq in (True, False):
        assert tuple(tplan.batch_spec(axes, seq)) == tuple(
            jplan.batch_spec(axes, seq))


def test_plan_refuses_sharded_parameters():
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, tiny_llama_config
    model = LlamaForCausalLM(tiny_llama_config(num_hidden_layers=1),
                             device="cpu")
    dp_only = t_mesh.ProcessMesh([[0], [1]], ["dp", "mp"])
    assert tplan.apply_plan(model, dp_only, tplan.llama_sharding_plan(
        dp_only.dim_names)) is model
    # since tensor parallelism, 'mp' cuts (tests/test_torch_tp.py); since
    # FSDP, 'fsdp' cuts too (tests/test_torch_fsdp.py): the plan's cut of
    # each parameter, the JAX spec's 'fsdp' dim read on the port's
    # layout; a parameter placed on 'sp' of extent > 1 still raises,
    # naming its slice
    fsdp = t_mesh.ProcessMesh([[0, 1]], ["dp", "fsdp"])
    cuts = {f"{m}.{p}": d for m, p, d in tplan._fsdp_cuts(
        model, tplan.llama_sharding_plan(fsdp.dim_names), 2)}
    assert cuts["model.embed_tokens.weight"] == 1
    assert cuts["model.layers.0.self_attn.q_proj.weight"] == 1
    assert cuts["model.layers.0.self_attn.o_proj.weight"] == 0
    assert cuts["model.layers.0.mlp.down_proj.weight"] == 0
    assert not any("norm" in n for n in cuts)
    sp = t_mesh.ProcessMesh([[0, 1]], ["dp", "sp"])
    on_sp = tplan.ShardingPlan(
        [(r"lm_head\.weight$", t_pl.PartitionSpec("sp", None))])
    with pytest.raises(NotImplementedError, match="context-parallel"):
        tplan.apply_plan(model, sp, on_sp)
