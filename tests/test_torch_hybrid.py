"""The port's hybrid-parallel facade (paddle_tpu_torch/distributed/fleet/)
against the JAX package's, on the CPU.

- In this process: tests/test_fleet.py:15-106's topology, hybrid
  communicate group, strategy and `fleet.init` cases, each on both
  packages' classes (the topology and the strategy are copies; the
  port's `init` counts the world's processes, one here, where the JAX
  one counts this process's 8 virtual devices), and
  `recompute_sequential`.
- A 2-rank gloo job (tests/_mp_worker.py hybrid, through the port's
  launcher, once): the Megatron layers built by their constructors and
  by `from_linear` / `from_embedding` (apply_plan's way, from the
  torch-layout weights), forward and backward, `gather_output`, an input
  that is not parallel, `ParallelCrossEntropy`, a sequence-parallel
  layer, the optimizer's norms over a cut tensor (against numpy's whole
  norms), and `fleet.distributed_model` on the tiny Llama; rank r's
  values against the JAX layers' on an mp-2 mesh of the same weights
  (`fleet.init` over the virtual devices), cut to rank r's part.

Tolerance: f32, each value within 1e-5 of its largest entry (the same
products summed in another order across the ranks).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh_mod
from paddle_tpu.distributed.fleet import layers as jL
from paddle_tpu.jit.functional import state_arrays
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed.fleet import utils as tutils

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_mp_worker.py")
NAMES = ["data", "pipe", "sharding", "sep", "model"]


def _close(got, want, name):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= 1e-5 * scale, f"{name}: |err| {err} > 1e-5 x {scale}"


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_topology_rank_math_matches_reference(pkg):
    fl = jfleet if pkg == "jax" else tfleet
    topo = fl.CommunicateTopology(NAMES, [2, 2, 1, 1, 2])
    assert topo.world_size() == 8
    assert topo.get_rank(data=0, pipe=0, sharding=0, sep=0, model=1) == 1
    assert topo.get_rank(data=0, pipe=1, sharding=0, sep=0, model=0) == 2
    assert topo.get_rank(data=1, pipe=0, sharding=0, sep=0, model=0) == 4
    coord = topo.get_coord(7)
    assert (coord.data, coord.pipe, coord.model) == (1, 1, 1)
    assert topo.get_axis_list("model", 0) == [0, 2, 4, 6]
    comm = topo.get_comm_list("data")
    assert [0, 4] in comm and [3, 7] in comm
    assert topo.get_rank_from_stage(0, pipe=1) == 2
    assert topo.get_dim_size("pipe") == 2
    assert topo.get_hybrid_group_names() == NAMES


def test_hybrid_communicate_group_matches_jax():
    dims = [2, 2, 1, 1, 2]
    jt = jfleet.CommunicateTopology(NAMES, dims)
    tt = tfleet.CommunicateTopology(NAMES, dims)
    calls = ["get_data_parallel_world_size", "get_model_parallel_world_size",
             "get_pipe_parallel_world_size", "get_sharding_parallel_world_size",
             "get_sep_parallel_world_size", "get_data_parallel_rank",
             "get_model_parallel_rank", "get_stage_id",
             "get_sharding_parallel_rank", "get_sep_parallel_rank",
             "get_data_parallel_group", "get_model_parallel_group",
             "get_pipe_parallel_group", "get_sharding_parallel_group",
             "get_sep_parallel_group", "get_data_parallel_group_src_rank",
             "get_model_parallel_group_src_rank", "get_p2p_groups",
             "is_first_stage", "is_last_stage"]
    for rank in range(8):
        jh = jfleet.HybridCommunicateGroup(jt, global_rank=rank)
        th = tfleet.HybridCommunicateGroup(tt, global_rank=rank)
        for c in calls:
            assert getattr(th, c)() == getattr(jh, c)(), (rank, c)
    hcg = tfleet.HybridCommunicateGroup(
        tfleet.CommunicateTopology(NAMES, [2, 1, 1, 1, 4]), global_rank=5)
    assert hcg.get_model_parallel_group() == [4, 5, 6, 7]
    assert hcg.get_data_parallel_group() == [1, 5]
    # without global_rank: this process's rank
    assert tfleet.HybridCommunicateGroup(tt).global_rank == 0


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_strategy_rejects_unknown_field(pkg):
    s = (jfleet if pkg == "jax" else tfleet).DistributedStrategy()
    with pytest.raises(AttributeError):
        s.not_a_real_field = True
    s.hybrid_configs = {"mp_degree": 2}
    assert s.hybrid_configs["pp_degree"] == 1  # merged, not replaced
    assert s.hybrid_configs["mp_degree"] == 2


def test_strategy_fields_match_jax():
    j, t = jfleet.DistributedStrategy(), tfleet.DistributedStrategy()
    assert t._FIELDS == j._FIELDS
    assert {k: getattr(t, k) for k in t._FIELDS} == \
        {k: getattr(j, k) for k in j._FIELDS}
    assert repr(t) == repr(j)


def test_fleet_init_over_a_world_of_one():
    """The port counts the world's processes (one here): every degree 1,
    the five-axis mesh set as the current mesh; degrees that do not
    multiply to the world raise as the JAX init does for its devices."""
    from paddle_tpu_torch.distributed import mesh as tmesh
    tfleet.init(is_collective=True)
    mesh = tfleet.get_mesh()
    assert mesh.dim_names == ["dp", "pp", "fsdp", "sp", "mp"]
    assert mesh.shape == [1, 1, 1, 1, 1] and tmesh.get_mesh() is mesh
    hcg = tfleet.get_hybrid_communicate_group()
    assert hcg.get_model_parallel_world_size() == 1
    assert hcg.get_data_parallel_world_size() == 1
    assert (tfleet.worker_index(), tfleet.worker_num(),
            tfleet.is_first_worker()) == (0, 1, True)
    s = tfleet.DistributedStrategy()
    s.hybrid_configs = {"mp_degree": 2}
    with pytest.raises(ValueError, match="world size 1"):
        tfleet.init(strategy=s)
    opt = tfleet.distributed_optimizer(object.__new__(type(
        "Opt", (), {})))
    assert opt._fleet_strategy is not None
    tmesh._current_mesh.clear()


def test_recompute_sequential_matches_the_plain_run():
    torch.manual_seed(0)
    seq = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.Tanh(),
                              torch.nn.Linear(8, 8), torch.nn.Tanh())
    x = torch.randn(3, 8, requires_grad=True)
    out = tutils.recompute_sequential({"segments": 2}, seq, x)
    out.sum().backward()
    got = [p.grad.clone() for p in seq.parameters()] + [x.grad.clone()]
    seq.zero_grad()
    x.grad = None
    seq(x).sum().backward()
    want = [p.grad for p in seq.parameters()] + [x.grad]
    torch.testing.assert_close(out, seq(x), rtol=0, atol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    assert tfleet.recompute is tutils.recompute


def _inputs():
    """The layers' weights (the JAX layout) and data from a seed, and the
    tiny Llama's JAX weights."""
    rng = np.random.RandomState(0)

    def w(*shape):
        return (rng.randn(*shape) * 0.3).astype(np.float32)

    inp = {"emb_w": w(32, 8), "col_w": w(8, 16), "col_b": w(16),
           "row_w": w(16, 8), "row_b": w(8),
           "ids": rng.randint(0, 32, (4, 4)).astype(np.int64),
           "x": w(4, 8), "logits": w(8, 32) * 10,
           "labels": rng.randint(0, 32, 8).astype(np.int64),
           "llama_ids": rng.randint(0, 256, (2, 16)).astype(np.int64),
           "norm_full": w(4, 6), "norm_rep": w(5)}
    inp["labels"][2] = -100
    paddle.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.tiny_llama_config(
        num_hidden_layers=1))
    inp.update({f"llama/{k}": np.asarray(v)
                for k, v in state_arrays(jm).items()})
    return inp, jm


def _jax_want(inp, jm):
    """The values to hold the ranks to: the JAX layers on an mp-2 mesh
    over the virtual devices (dp 4, so batch dims of 4) with the same
    weights; the Llama's reference is the mesh-free model (GSPMD computes
    the same function; test_torch_tp.py holds the port to the mesh
    Trainer)."""
    lids = paddle.to_tensor(inp["llama_ids"])
    jloss, jlogits = jm(lids, labels=lids)
    want = {"llama/loss": jloss.numpy(), "llama/logits": jlogits.numpy(),
            "norm_full": inp["norm_full"], "norm_rep": inp["norm_rep"]}
    saved = list(jmesh_mod._current_mesh)
    try:
        s = jfleet.DistributedStrategy()
        s.hybrid_configs = {"mp_degree": 2}
        jfleet.init(strategy=s)
        emb = jL.VocabParallelEmbedding(32, 8)
        col = jL.ColumnParallelLinear(8, 16, gather_output=False)
        row = jL.RowParallelLinear(16, 8, input_is_parallel=True)
        col2 = jL.ColumnParallelLinear(8, 16, gather_output=True)
        row2 = jL.RowParallelLinear(16, 8, input_is_parallel=False)
        cs = jL.ColumnSequenceParallelLinear(8, 16, gather_output=True)
        for layer, wk, bk in ((col, "col_w", "col_b"), (row, "row_w",
                                                        "row_b"),
                              (col2, "col_w", "col_b"),
                              (row2, "row_w", "row_b"),
                              (cs, "col_w", "col_b")):
            layer.weight.set_value(inp[wk])
            layer.bias.set_value(inp[bk])
        emb.weight.set_value(inp["emb_w"])
        h = emb(paddle.to_tensor(inp["ids"]))
        mid = col(h)
        y = row(mid)
        (y * y).sum().backward()
        want.update({"h": h.numpy(), "mid": mid.numpy(), "y": y.numpy(),
                     "col_w_grad": col.weight.grad.numpy().T,
                     "col_b_grad": col.bias.grad.numpy(),
                     "row_w_grad": row.weight.grad.numpy().T,
                     "row_b_grad": row.bias.grad.numpy(),
                     "emb_grad": emb.weight.grad.numpy()})
        x = paddle.to_tensor(inp["x"], stop_gradient=False)
        full = col2(x)
        y2 = row2(full)
        (y2 * y2).sum().backward()
        want.update({"gather/full": full.numpy(), "gather/y": y2.numpy(),
                     "gather/x_grad": x.grad.numpy()})
        lg = paddle.to_tensor(inp["logits"], stop_gradient=False)
        loss = jL.ParallelCrossEntropy()(lg, paddle.to_tensor(inp["labels"]))
        loss.backward()
        want.update({"pce/loss": loss.numpy(), "pce/grad": lg.grad.numpy()})
        want["seq/full"] = cs(paddle.to_tensor(inp["x"])).numpy()
        return want
    finally:
        jmesh_mod._current_mesh[:] = saved


@pytest.fixture(scope="module")
def hybrid_job(tmp_path_factory):
    """The 2-rank job, started first; the JAX side runs meanwhile."""
    inp, jm = _inputs()
    out = tmp_path_factory.mktemp("hybrid")
    np.savez(out / "in.npz", **inp)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--devices", "0,1", "--log_dir", str(out / "logs"), WORKER,
           "hybrid", str(out / "in.npz"), str(out)]
    proc = subprocess.Popen(cmd, env=dict(os.environ, PYTHONPATH=REPO))
    try:
        want = _jax_want(inp, jm)
        code = proc.wait(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    logs = "".join((out / "logs" / f).read_text()
                   for f in sorted(os.listdir(out / "logs")))
    assert code == 0, f"hybrid job failed:\n{logs[-4000:]}"
    ranks = []
    for r in range(2):
        with np.load(out / f"rank{r}.npz") as f:
            ranks.append({k: f[k] for k in f.files})
    return want, ranks


@pytest.mark.parametrize("how", ["ctor", "adopt"])
def test_mp_layers_match_jax(hybrid_job, how):
    """Rank r holds the JAX values cut to its part: the column layer's
    output columns and weight rows (the port's (out, in) layout) and bias
    entries, the row layer's weight columns, the embedding's vocab rows;
    the embedding's and the row layer's outputs whole."""
    want, ranks = hybrid_job
    for r, got in enumerate(ranks):
        c, v = slice(r * 8, (r + 1) * 8), slice(r * 16, (r + 1) * 16)
        _close(got[f"{how}/h"], want["h"], "h")
        _close(got[f"{how}/mid"], want["mid"][..., c], "mid")
        _close(got[f"{how}/y"], want["y"], "y")
        _close(got[f"{how}/col_w_grad"], want["col_w_grad"][c], "dW col")
        _close(got[f"{how}/col_b_grad"], want["col_b_grad"][c], "db col")
        _close(got[f"{how}/row_w_grad"], want["row_w_grad"][:, c], "dW row")
        _close(got[f"{how}/row_b_grad"], want["row_b_grad"], "db row")
        _close(got[f"{how}/emb_grad"], want["emb_grad"][v], "dW emb")


def test_gather_output_and_a_whole_input_match_jax(hybrid_job):
    want, ranks = hybrid_job
    for got in ranks:
        for k in ("gather/full", "gather/y", "gather/x_grad"):
            _close(got[k], want[k], k)


def test_parallel_cross_entropy_matches_jax(hybrid_job):
    """Three all-reduces over the vocab-cut logits: the loss equal on
    both ranks, each rank's gradient its columns of the JAX one."""
    want, ranks = hybrid_job
    for r, got in enumerate(ranks):
        _close(got["pce/loss"], want["pce/loss"], "loss")
        _close(got["pce/grad"], want["pce/grad"][:, r * 16:(r + 1) * 16],
               "dlogits")


def test_sequence_parallel_layer_computes_its_parent(hybrid_job):
    want, ranks = hybrid_job
    for got in ranks:
        _close(got["seq/full"], want["seq/full"], "seq")


def test_optimizer_norms_add_the_shards_once(hybrid_job):
    """`global_grad_norm` and the clips over a tensor cut over mp and a
    replicated one: the cut tensor's squares summed over the ranks, the
    replicated one's counted once (the whole tensors' norms)."""
    want, ranks = hybrid_job
    full, rep = want["norm_full"], want["norm_rep"]
    total = float(np.sqrt((full ** 2).sum() + (rep ** 2).sum()))
    for r, got in enumerate(ranks):
        mine = full[r * 2:(r + 1) * 2]
        _close(got["norm/global"], total, "global norm")
        _close(got["norm/by_global/cut"], mine * min(1.0, 1.0 / total),
               "global clip")
        _close(got["norm/by_global/rep"], rep * min(1.0, 1.0 / total),
               "global clip")
        _close(got["norm/by_norm/cut"],
               mine * min(1.0, 1.0 / float(np.linalg.norm(full))), "clip")
        _close(got["norm/by_norm/rep"],
               rep * min(1.0, 1.0 / float(np.linalg.norm(rep))), "clip")


def test_distributed_model_on_the_tiny_llama_matches_jax(hybrid_job):
    want, ranks = hybrid_job
    for got in ranks:
        assert bool(got["llama/tagged"])
        assert int(got["llama/q_rows"]) == 64 // 2
        _close(got["llama/loss"], want["llama/loss"], "loss")
        _close(got["llama/logits"], want["llama/logits"], "logits")
