"""A gloo worker for tests/test_torch_hybrid.py and
tests/test_torch_dist_api.py, started by the port's launcher:

    python -m paddle_tpu_torch.distributed.launch --devices 0,1[,2,3] \\
        tests/_mp_worker.py {hybrid|api} IN.npz OUT_DIR

It reads the test's inputs (the JAX side's weights and data) from IN.npz,
runs the port's functions on this rank and writes what rank r holds to
OUT_DIR/rank{r}.npz, for the test to hold against the JAX functions.

- hybrid (2 ranks, mp 2): the Megatron layers of distributed/fleet/
  layers.py built by their constructors and by `from_linear` /
  `from_embedding` (apply_plan's way), forward and backward;
  ParallelCrossEntropy; the optimizer's norms over a cut tensor;
  `fleet.init` + `distributed_model` on the tiny Llama.
- api (4 ranks, a 2 x 2 dp x mp mesh): distributed/api.py's shard_tensor,
  reshard, the sharded matmul and its gradient, shard_layer with
  shard_optimizer and an AdamW step, dtensor_from_fn, unshard_dtensor.
"""
import sys

import numpy as np
import torch

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed import collective, env


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _np(t):
    return t.detach().float().numpy()


def hybrid(inp, rank):
    from torch import nn
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import layers as L
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.models.convert import from_paddle_tpu_state
    out = {}
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    g = fleet.get_mesh().get_group("mp")
    torch.manual_seed(0)
    col_w, row_w, emb_w = inp["col_w"].T, inp["row_w"].T, inp["emb_w"]
    for how in ("ctor", "adopt"):
        if how == "ctor":
            emb = L.VocabParallelEmbedding(32, 8, mp_group=g)
            col = L.ColumnParallelLinear(8, 16, gather_output=False,
                                         mp_group=g)
            row = L.RowParallelLinear(16, 8, input_is_parallel=True,
                                      mp_group=g)
            with torch.no_grad():
                emb.weight.copy_(_t(emb_w[rank * 16:(rank + 1) * 16]))
                col.weight.copy_(_t(col_w[rank * 8:(rank + 1) * 8]))
                col.bias.copy_(_t(inp["col_b"][rank * 8:(rank + 1) * 8]))
                row.weight.copy_(_t(row_w[:, rank * 8:(rank + 1) * 8]))
                row.bias.copy_(_t(inp["row_b"]))
        else:
            e, c, r = nn.Embedding(32, 8), nn.Linear(8, 16), nn.Linear(16, 8)
            with torch.no_grad():
                e.weight.copy_(_t(emb_w))
                c.weight.copy_(_t(col_w))
                c.bias.copy_(_t(inp["col_b"]))
                r.weight.copy_(_t(row_w))
                r.bias.copy_(_t(inp["row_b"]))
            emb = L.VocabParallelEmbedding.from_embedding(e, g)
            col = L.ColumnParallelLinear.from_linear(c, g)
            row = L.RowParallelLinear.from_linear(r, g)
        h = emb(_t(inp["ids"]))
        mid = col(h)
        y = row(mid)
        (y * y).sum().backward()
        out.update({f"{how}/h": _np(h), f"{how}/mid": _np(mid),
                    f"{how}/y": _np(y), f"{how}/col_w_grad": _np(
                        col.weight.grad), f"{how}/col_b_grad": _np(
                        col.bias.grad), f"{how}/row_w_grad": _np(
                        row.weight.grad), f"{how}/row_b_grad": _np(
                        row.bias.grad), f"{how}/emb_grad": _np(
                        emb.weight.grad)})
    # gather_output and an input that is not parallel
    col2 = L.ColumnParallelLinear(8, 16, gather_output=True, mp_group=g)
    row2 = L.RowParallelLinear(16, 8, input_is_parallel=False, mp_group=g)
    with torch.no_grad():
        col2.weight.copy_(_t(col_w[rank * 8:(rank + 1) * 8]))
        col2.bias.copy_(_t(inp["col_b"][rank * 8:(rank + 1) * 8]))
        row2.weight.copy_(_t(row_w[:, rank * 8:(rank + 1) * 8]))
        row2.bias.copy_(_t(inp["row_b"]))
    x = _t(inp["x"], grad=True)
    full = col2(x)
    y2 = row2(full)
    (y2 * y2).sum().backward()
    out.update({"gather/full": _np(full), "gather/y": _np(y2),
                "gather/x_grad": _np(x.grad)})
    # ParallelCrossEntropy over this rank's vocab columns
    logits = _t(inp["logits"][:, rank * 16:(rank + 1) * 16], grad=True)
    loss = L.ParallelCrossEntropy(mp_group=g)(logits, _t(inp["labels"]))
    loss.backward()
    out.update({"pce/loss": _np(loss), "pce/grad": _np(logits.grad)})
    # the sequence-parallel layers compute their parents' function
    cs = L.ColumnSequenceParallelLinear(8, 16, gather_output=True,
                                        mp_group=g)
    with torch.no_grad():
        cs.weight.copy_(_t(col_w[rank * 8:(rank + 1) * 8]))
        cs.bias.copy_(_t(inp["col_b"][rank * 8:(rank + 1) * 8]))
    out["seq/full"] = _np(cs(_t(inp["x"])))
    # the optimizer's norms over a cut tensor and a replicated one
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm, ClipGradByNorm
    cut = L.MPShard(g, 0).local(_t(inp["norm_full"]))
    grads, groups = [cut, _t(inp["norm_rep"])], [g, None]
    out["norm/global"] = _np(topt.global_grad_norm(grads, groups))
    for name, policy in (("by_norm", ClipGradByNorm(1.0)),
                         ("by_global", ClipGradByGlobalNorm(1.0))):
        clipped = topt._clip(policy, grads, groups)
        out[f"norm/{name}/cut"] = _np(clipped[0])
        out[f"norm/{name}/rep"] = _np(clipped[1])
    # distributed_model on the tiny Llama, the JAX model's weights
    cfg = llama.tiny_llama_config(num_hidden_layers=1)
    state = {k[len("llama/"):]: inp[k] for k in inp.files
             if k.startswith("llama/")}
    model = llama.LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(from_paddle_tpu_state(state, cfg))
    model = fleet.distributed_model(model)
    ids = _t(inp["llama_ids"])
    with torch.no_grad():
        lm_loss, lm_logits = model(ids, labels=ids)
    out.update({"llama/loss": _np(lm_loss), "llama/logits": _np(lm_logits),
                "llama/q_rows": np.array(
                    model.model.layers[0].self_attn.q_proj.weight.shape[0]),
                "llama/tagged": np.array(hasattr(model, "_fleet_plan")
                                         and hasattr(model, "_fleet_mesh"))})
    return out


def api(inp, rank):
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import api as A
    from paddle_tpu_torch.distributed.placement import Partial
    from torch import nn
    out = {}
    mesh = dist.ProcessMesh([[0, 1], [2, 3]], dim_names=["dp", "mp"])
    x = inp["x"]
    t = dist.shard_tensor(x, mesh, [dist.Shard(0), dist.Replicate()])
    out["s0/local"] = _np(t.to_local())
    out["s0/placements"] = np.array([repr(p) for p in A.placements(t)])
    out["s0/is_dist"] = np.array(A.is_dist(t) and not A.is_dist(_t(x)))
    out["s0/mesh"] = np.array(A.process_mesh(t) == mesh)
    t2 = dist.reshard(t, mesh, [dist.Replicate(), dist.Shard(1)])
    out["s1/local"] = _np(t2.to_local())
    t3 = dist.reshard(t2, mesh, [dist.Replicate(), dist.Replicate()])
    out["r/local"] = _np(t3.to_local())
    p = dist.shard_tensor(x, mesh, [Partial(), dist.Replicate()])
    out["p/local"] = _np(p.to_local())
    out["p/full"] = _np(dist.unshard_dtensor(p))
    try:
        dist.reshard(t, mesh, [Partial(), dist.Replicate()])
        out["p/reshard_raises"] = np.array(False)
    except NotImplementedError:
        out["p/reshard_raises"] = np.array(True)
    # the sharded matmul and its gradient on a 1-D mesh
    line = dist.ProcessMesh(list(range(4)), dim_names=["mp"])
    w = dist.shard_tensor(inp["wn"], line, [dist.Shard(1)],
                          stop_gradient=False)
    xd = dist.shard_tensor(inp["xm"], line, [dist.Replicate()])
    y = xd @ w
    out["mm/y_local"] = _np(y.to_local())
    out["mm/y"] = _np(dist.unshard_dtensor(y))
    y.sum().backward()
    # torch leaves the gradient where its propagation puts it: moved to
    # the parameter's placements, and whole
    out["mm/w_grad_local"] = _np(dist.reshard(
        w.grad, line, [dist.Shard(1)]).to_local())
    out["mm/w_grad"] = _np(dist.unshard_dtensor(w.grad))
    # shard_layer + shard_optimizer + an AdamW step
    layer = nn.Linear(16, 32)
    with torch.no_grad():
        layer.weight.copy_(_t(inp["lin_w"].T))
        layer.bias.copy_(_t(inp["lin_b"]))

    def col_shard(name, sub, m):
        for pname, prm in list(sub.named_parameters(recurse=False)):
            # the JAX test's Shard(1) of the (in, out) weight is the
            # port's Shard(0); the bias replicates
            pl = [dist.Shard(0)] if prm.dim() == 2 else [dist.Replicate()]
            setattr(sub, pname, nn.Parameter(dist.shard_tensor(prm, m, pl)))

    dist.shard_layer(layer, line, col_shard,
                     input_fn=lambda inputs, m: tuple(
                         dist.shard_tensor(a, m, [dist.Replicate()])
                         for a in inputs))
    opt = dist.shard_optimizer(topt.AdamW(
        learning_rate=1e-3, parameters=layer.named_parameters()))
    loss = layer(_t(inp["lin_x"])).sum()
    loss.backward()
    opt.step()
    out["layer/w_local"] = _np(layer.weight.to_local())
    out["layer/b_local"] = _np(layer.bias.to_local())
    st = opt.state["weight"]
    out["layer/moments_dist"] = np.array(all(
        A.is_dist(st[k]) and st[k].placements == layer.weight.placements
        for k in ("moment1", "moment2")))
    out["layer/moment1_local"] = _np(st["moment1"].to_local())
    f = dist.dtensor_from_fn(lambda: torch.ones(8, 4), line,
                             [dist.Shard(0)])
    out["fn/local"] = _np(f.to_local())
    out["fn/full"] = _np(dist.unshard_dtensor(f))
    return out


def main(argv):
    case, inp_path, out_dir = argv
    env.init_parallel_env(device="cpu")
    rank = env.get_rank()
    torch.set_num_threads(1)
    with np.load(inp_path) as inp:
        out = {"hybrid": hybrid, "api": api}[case](inp, rank)
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
    collective.barrier()
    print(f"MP_WORKER_OK rank={rank}", flush=True)
    collective.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
