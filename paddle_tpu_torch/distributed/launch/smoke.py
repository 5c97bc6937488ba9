"""A data-, sharded-data (FSDP) or tensor-parallel training job's
worker, for the launcher and the elastic supervisor.

Counterpart of paddle_tpu/distributed/launch/smoke.py: the proof that
the port trains as N coordinated processes. Started as

    python -m paddle_tpu_torch.distributed.launch --master host:port \\
        --nnodes N --rank r paddle_tpu_torch/distributed/launch/smoke.py \\
        --out DIR [--device cpu] [--weights W.npz] [--mesh fsdp:2,mp:2] ...

`--mesh` names the mesh's axes and extents, the first axis varying
slowest (the JAX worker reads SMOKE_MESH from the environment; this one
reads no environment); the default is `dp` over the world. On a mesh
whose 'mp' and 'fsdp' extents are 1 (data parallelism) one worker:
1. `init_parallel_env()` on `--device`;
2. with `--store-port`, a cross-process TCPStore exercise (rank 0 hosts);
3. builds the tiny Llama (LAYERS layers; the JAX package's weights from
   `--weights`, an npz of its state, else seed 0) and the Trainer on
   `init_mesh({"dp": world})` with `llama_sharding_plan`, f32 compute,
   AdamW(LR);
4. runs `--steps` steps on `smoke_batches` (every process the same
   global batch of BATCH x SEQ; rows below PAD_ROWS labelled -100 from
   column PAD_FROM);
5. barrier, then `save_checkpoint(DIR/ckpt)`;
6. with `--fault-steps`, the same run from the same weights with the
   gradients averaged over ranks instead of tokens (a planted fault:
   its losses must leave the JAX trajectory);
7. with `--empty-steps`, the same run from the same weights on batches
   whose rows below PAD_ROWS are -100 throughout (with 2 ranks, rank 0
   holds no valid label);
8. with `--dp-steps`, `DataParallel` with eager backward() and the
   optimizer against the Trainer on unpadded batches, and against
   itself accumulating two half-batches under `no_sync()`: the largest
   parameter differences;
9. rank 0 writes DIR/result.json.

On a mesh with an 'mp' or an 'fsdp' extent above 1 (tensor parallelism,
FSDP, both: `_parallel_job`) it instead runs every TP_VARIANTS
configuration of the tiny Llama (`--tp-weights DIR` holds the JAX
package's weights as DIR/{variant}.npz) for TP_STEPS steps on the
Trainer over the mesh with `llama_sharding_plan`, f32 compute,
AdamW(LR) (with ClipGradByGlobalNorm and the health probe where the
variant says): the losses, the probes' gradient norms and step 1's
gradients gathered whole; whether the parameters that are not cut hold
the same bytes on every rank; the checkpoint of TP_CKPT_VARIANT after
step TP_CKPT_AT, loaded back into a fresh Trainer on the mesh for the
next step (`resumed`); `fleet.init` + `fleet.distributed_model` + the
Trainer on the fleet mesh; `skip_nonfinite_grads` with a NaN in one
rank's gradient piece only (`_skip_run`: every rank must skip); and the
planted faults, each one run from the same weights (`planted`): with
mp, the loss combined from each rank's LOCAL lse (`local_lse`), a
column-parallel f-op whose backward skips its all-reduce (`fop`), a
global norm that counts the replicated gradients once per mp rank
(`norm`); with fsdp, a reducer that sums the reduce-scattered gradients
again over the batch group (`fsdp_double`) and a gather whose backward
keeps this rank's piece of its own gradient without the reduce-scatter
(`fsdp_local`). On the `fsdp:2` mesh it also runs
distributed/sharding.py `group_sharded_parallel` at "p_g_os" on
`init_mesh({"dp": 2})` (`_group_sharded`): the Sequential of
DIR/sequential.npz one eager step on this rank's rows of SEQ_X, saved by
`save_group_sharded_model` to DIR/gs, and the dense variant cut so,
trained by the Trainer with plan=None. Rank 0 writes DIR/result.json
and DIR/grads.npz.

With `--elastic-dir` it is instead a worker of `ElasticSupervisor`:
it heartbeats into the supervisor's store, resumes from the newest
complete checkpoint under that directory, saves after every step, rank
0 appends each step's loss to losses.jsonl, and rank `--kill-rank` of
attempt 0 exits after step `--kill-at`.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os

import numpy as np
import torch


LAYERS = 2
BATCH = 8
SEQ = 32
PAD_ROWS = 4
PAD_FROM = 20
LR = 1e-3
SEED = 7
TP_STEPS = 3
TP_CLIP = 0.05
# name -> (LlamaConfig overrides, ClipGradByGlobalNorm + health probe)
TP_VARIANTS = {
    "dense": ({}, True),
    "dense_tied_fused": (dict(tie_word_embeddings=True,
                              fuse_attention_qkv=True,
                              fuse_attention_ffn=True), False),
    "chunk": (dict(loss_chunk=16, loss_vocab_block=48), True),
    "chunk_tied_fused": (dict(loss_chunk=16, tie_word_embeddings=True,
                              fuse_attention_qkv=True,
                              fuse_attention_ffn=True), False),
}
TP_CKPT_VARIANT = "chunk_tied_fused"
TP_CKPT_AT = 2
# group_sharded_parallel's eager step: Sequential(Linear(16, 16),
# Linear(16, 8)) (the JAX tests/test_fleet.py model), x of SEQ_ROWS x 16
SEQ_ROWS = 4
SEQ_LR = 1e-3


def seq_x():
    """The eager step's global input (tests/test_fleet.py's)."""
    return np.random.RandomState(2).randn(SEQ_ROWS, 16).astype(np.float32)


def smoke_batches(vocab, steps, pad_rows=PAD_ROWS, pad_from=PAD_FROM,
                  seed=SEED):
    """The job's global batches: seeded BATCH x SEQ ids; labels = ids, with
    rows below `pad_rows` set to -100 from column `pad_from`."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        ids = rng.randint(0, vocab, (BATCH, SEQ)).astype(np.int32)
        labels = ids.copy()
        labels[:pad_rows, pad_from:] = -100
        out.append({"input_ids": ids, "labels": labels})
    return out


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--store-port", type=int, default=0)
    p.add_argument("--weights", default=None)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--fault-steps", type=int, default=0)
    p.add_argument("--empty-steps", type=int, default=0)
    p.add_argument("--dp-steps", type=int, default=0)
    p.add_argument("--elastic-dir", default=None)
    p.add_argument("--kill-rank", type=int, default=-1)
    p.add_argument("--kill-at", type=int, default=-1)
    p.add_argument("--mesh", default=None,
                   help="axis:extent pairs, e.g. mp:2, dp:2,fsdp:2")
    p.add_argument("--tp-weights", default=None)
    return p.parse_args(argv)


def _parse_mesh(text, world):
    """{'dp': 2, 'mp': 2} from "dp:2,mp:2"; None gives {'dp': world}."""
    if not text:
        return {"dp": world}
    out = {}
    for item in text.split(","):
        name, _, n = item.partition(":")
        out[name.strip()] = int(n)
    return out


def _model(args, dev):
    from paddle_tpu_torch.models.convert import from_paddle_tpu_state
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               tiny_llama_config)
    cfg = tiny_llama_config(num_hidden_layers=LAYERS)
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    if args.weights:
        with np.load(args.weights) as f:
            state = {k: f[k] for k in f.files}
        model.load_state_dict(from_paddle_tpu_state(state, cfg))
    return cfg, model


def _trainer(args, dev, mesh):
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.parallel.plan import llama_sharding_plan
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    cfg, model = _model(args, dev)
    opt = topt.AdamW(learning_rate=LR,
                     parameters=model.named_parameters())
    return cfg, Trainer(model, opt, TrainStepConfig(compute_dtype=None),
                        mesh=mesh, plan=llama_sharding_plan(mesh.dim_names))


def _store_exercise(port, rank, world):
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.store import TCPStore
    store = TCPStore("127.0.0.1", port, is_master=(rank == 0),
                     world_size=world)
    try:
        store.set(f"smoke_rank_{rank}", str(rank).encode())
        store.add("smoke_counter", rank + 1)
        for r in range(world):
            store.wait(f"smoke_rank_{r}", timeout=60)
            got = store.get(f"smoke_rank_{r}")
            assert got == str(r).encode(), (r, got)
        store.barrier("smoke", rank, world)
    finally:
        # rank 0 hosts the server: it closes once every rank is done
        collective.barrier()
        store.close()


def _rank_mean(tr):
    """The planted fault: every rank's mean loss weighted 1/dp, not by
    its share of the valid tokens."""
    dp = tr._dp["size"]
    tr._token_scales = lambda mbs: torch.full(
        (len(mbs),), 1.0 / dp, device=tr.device)
    return tr


def _data_parallel_gaps(args, dev, mesh, world, rank):
    """Largest parameter differences after `--dp-steps` steps on unpadded
    batches: the Trainer against DataParallel, and DataParallel against
    DataParallel accumulating two half-batches under no_sync()."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed.parallel import DataParallel
    cfg, tr = _trainer(args, dev, mesh)
    runs = []
    for _ in range(2):
        _, model = _model(args, dev)
        model.requires_grad_(True).train()
        runs.append((model, DataParallel(model), topt.AdamW(
            learning_rate=LR, parameters=model.named_parameters())))
    batches = smoke_batches(cfg.vocab_size, args.dp_steps, pad_rows=0,
                            seed=11)
    rows = BATCH // world
    for b in batches:
        tr.step(b)
        ids = torch.from_numpy(
            b["input_ids"][rank * rows:(rank + 1) * rows]).to(dev)
        (_, dp, opt), (_, acc, acc_opt) = runs
        dp(ids, labels=ids)[0].backward()
        half = rows // 2
        with acc.no_sync():
            (acc(ids[:half], labels=ids[:half])[0] / 2).backward()
        (acc(ids[half:], labels=ids[half:])[0] / 2).backward()
        for o in (opt, acc_opt):
            o.step()
            o.zero_grad()

    def gap(a, b):
        return max(float((x - y).abs().max())
                   for x, y in zip(a.parameters(), b.parameters()))
    return gap(tr.model, runs[0][0]), gap(runs[0][0], runs[1][0])


def _elastic(args, dev, mesh, rank, world):
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.distributed.elastic import StoreHeartbeat
    from paddle_tpu_torch.distributed.store import TCPStore
    attempt = env.elastic_attempt()
    host, port = env.master_address().rsplit(":", 1)
    store = TCPStore(host, int(port), world_size=world,
                     prefix=f"a{attempt}/", attempt=attempt)
    hb = StoreHeartbeat(store, rank, world, interval=0.3).start()
    cfg, tr = _trainer(args, dev, mesh)
    start = 0
    last = ckpt.newest_complete_checkpoint(args.elastic_dir)
    if last is not None:
        tr.load_checkpoint(last)
        start = int(os.path.basename(last)[5:]) + 1
    batches = smoke_batches(cfg.vocab_size, args.steps)
    for step in range(start, args.steps):
        loss = float(tr.step(batches[step]))
        if rank == 0:
            with open(os.path.join(args.elastic_dir, "losses.jsonl"),
                      "a") as f:
                f.write(json.dumps({"step": step, "loss": loss,
                                    "attempt": attempt}) + "\n")
        tr.save_checkpoint(os.path.join(args.elastic_dir,
                                        f"step_{step:04d}"))
        if rank == args.kill_rank and attempt == 0 and step == args.kill_at:
            os._exit(17)                 # a preempted rank
    hb.stop()
    store.close()


def _tp_model(args, dev, name):
    from paddle_tpu_torch.models.convert import from_paddle_tpu_state
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               tiny_llama_config)
    cfg = tiny_llama_config(num_hidden_layers=LAYERS,
                            **TP_VARIANTS[name][0])
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    with np.load(os.path.join(args.tp_weights, f"{name}.npz")) as f:
        model.load_state_dict(from_paddle_tpu_state(
            {k: f[k] for k in f.files}, cfg))
    return cfg, model


def _tp_trainer(args, dev, mesh, name, model=None, plan=True):
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.parallel.plan import llama_sharding_plan
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    if model is None:
        _, model = _tp_model(args, dev, name)
    clip = TP_VARIANTS[name][1]
    opt = topt.AdamW(learning_rate=LR, parameters=model.named_parameters(),
                     grad_clip=ClipGradByGlobalNorm(TP_CLIP) if clip
                     else None)
    return Trainer(model, opt, TrainStepConfig(compute_dtype=None,
                                               health_probe=clip),
                   mesh=mesh, plan=llama_sharding_plan(mesh.dim_names)
                   if plan else None)


def _gathered_grads(model):
    """Every parameter's gradient, a cut one gathered whole (a
    collective over its groups)."""
    from paddle_tpu_torch.distributed.sharding import cuts_of, gather_whole
    return {n: gather_whole(p.grad.detach(), cuts_of(p)).cpu()
            for n, p in model.named_parameters()}


def _tp_run(tr, batches, ckpt=None):
    """(losses, probe norms, step 1's gathered gradients); with `ckpt`, a
    checkpoint saved after step TP_CKPT_AT."""
    losses, probes, grad1 = [], [], None
    for i, b in enumerate(batches):
        losses.append(float(tr.step(b)))
        if tr.last_probe is not None:
            probes.append(float(tr.last_probe[0]))
        if i == 0:
            grad1 = _gathered_grads(tr.model)
        if ckpt is not None and i + 1 == TP_CKPT_AT:
            tr.save_checkpoint(ckpt)
    return losses, probes, grad1


def _replicated_digest(model):
    """Whether every rank of the world holds the same bytes of the
    parameters that are not cut."""
    import hashlib
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.sharding import cuts_of
    h = hashlib.sha256()
    for n, p in model.named_parameters():
        if not cuts_of(p):
            h.update(p.detach().cpu().contiguous().numpy().tobytes())
    mine = torch.frombuffer(bytearray(h.digest()), dtype=torch.uint8)
    return all(torch.equal(d, mine) for d in collective.all_gather(mine))


def _fleet_run(args, dev, axes, batches):
    """fleet.init over the world with the mesh's degrees,
    distributed_model, the Trainer on the fleet mesh: the topology's
    view of this rank and the "dense" variant's losses."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import layers
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": axes.get("dp", 1),
                               "mp_degree": axes.get("mp", 1),
                               "sharding_degree": axes.get("fsdp", 1)}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    _, model = _tp_model(args, dev, "dense")
    model = fleet.distributed_model(model)
    kinds = {n: type(m).__name__ for n, m in model.named_modules()
             if isinstance(m, layers._PARALLEL)}
    fsdp_dims = {n: p._fsdp_shard.dim for n, p in model.named_parameters()
                 if hasattr(p, "_fsdp_shard")}
    tr = _tp_trainer(args, dev, fleet.get_mesh(), "dense", model=model,
                     plan=False)
    fleet.distributed_optimizer(tr.optimizer)
    losses = [float(tr.step(b)) for b in batches]
    mesh = fleet.get_mesh()
    return {"losses": losses, "kinds": kinds, "fsdp_dims": fsdp_dims,
            "mesh": [mesh.dim_names, mesh.shape],
            "worker": [fleet.worker_index(), fleet.worker_num(),
                       fleet.is_first_worker()],
            "hcg": {"dp_rank": hcg.get_data_parallel_rank(),
                    "mp_rank": hcg.get_model_parallel_rank(),
                    "dp_group": hcg.get_data_parallel_group(),
                    "mp_group": hcg.get_model_parallel_group(),
                    "mp_world": hcg.get_model_parallel_world_size(),
                    "dp_world": hcg.get_data_parallel_world_size()},
            "sharding": [hcg.get_sharding_parallel_rank(),
                         hcg.get_sharding_parallel_world_size()]}


def _skip_run(args, dev, mesh, rank, batch):
    """skip_nonfinite_grads with a NaN in rank 1's lm_head gradient shard
    only: [[skipped steps, parameters unchanged]] of every rank (each
    must skip)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.parallel.plan import llama_sharding_plan
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    _, model = _tp_model(args, dev, "dense")
    tr = Trainer(model, topt.AdamW(learning_rate=LR,
                                   parameters=model.named_parameters()),
                 TrainStepConfig(compute_dtype=None,
                                 skip_nonfinite_grads=True),
                 mesh=mesh, plan=llama_sharding_plan(mesh.dim_names))
    before = [p.detach().clone() for p in model.parameters()]
    def poison(p):
        p.grad.view(-1)[0] = float("nan")

    if rank == 1:
        model.lm_head.weight.register_post_accumulate_grad_hook(poison)
    tr.step(batch)
    same = all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
    mine = torch.tensor([float(tr.nonfinite_skipped), float(same)])
    return [t.tolist() for t in collective.all_gather(mine)]


@contextlib.contextmanager
def planted(fault, group=None):
    """One planted fault in place for the block: `local_lse` (the
    blockwise loss from each rank's own lse), `fop` (the column-parallel
    f-op's backward without its all-reduce), `norm` (every gradient's
    squares summed over the mp `group`, replicated ones included),
    `fsdp_double` (the Trainer's reducer summing every gradient over the
    whole batch group, the reduce-scattered ones again: in place when
    the Trainer is built), `fsdp_local` (the FSDP gather's backward
    keeping this rank's piece of its own gradient, no reduce-scatter)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import sharding
    from paddle_tpu_torch.distributed.fleet import layers
    from paddle_tpu_torch.kernels import blockwise_ce as bce
    if fault == "fsdp_double":
        target, attr, new = sharding, "summed_axes", lambda p: ()
    elif fault == "fsdp_local":
        target, attr = sharding._GatherShard, "backward"
        new = staticmethod(lambda ctx, g: (
            ctx.cut.local(g).contiguous(), None))
    elif fault == "local_lse":
        target, attr, new = bce, "_combine_lse", lambda lse, g: lse
    elif fault == "fop":
        target, attr = layers._CopyToMP, "backward"
        new = staticmethod(lambda ctx, g: (g, None))
    elif fault == "norm":
        orig = topt._group_sums
        target, attr = topt, "_group_sums"

        def new(sq, groups):
            return orig(sq, [(group,)] * len(groups))
    else:
        raise ValueError(f"unknown fault {fault!r}")
    saved = target.__dict__[attr]
    setattr(target, attr, new)
    try:
        yield
    finally:
        setattr(target, attr, saved)


def _resumed(args, dev, mesh, ckpt, batch):
    """A fresh Trainer on the mesh, the checkpoint loaded back into its
    pieces, one more step: its loss."""
    tr = _tp_trainer(args, dev, mesh, TP_CKPT_VARIANT)
    tr.load_checkpoint(ckpt)
    return float(tr.step(batch))


def _group_sharded(args, dev, rank, world):
    """group_sharded_parallel at "p_g_os" on init_mesh({"dp": world}): the
    Sequential's eager step on this rank's rows (a summed loss) and its
    whole parameters after it, its save_group_sharded_model files, and
    the dense variant cut so and trained by the Trainer with plan=None
    (its losses)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed.mesh import init_mesh, set_mesh
    from paddle_tpu_torch.distributed.sharding import (
        cuts_of, gather_whole, group_sharded_parallel,
        save_group_sharded_model)
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    set_mesh(init_mesh({"dp": world}))
    model = torch.nn.Sequential(torch.nn.Linear(16, 16),
                                torch.nn.Linear(16, 8)).to(dev)
    with np.load(os.path.join(args.tp_weights, "sequential.npz")) as f:
        model.load_state_dict({k: torch.from_numpy(
            f[k].T.copy() if k.endswith("weight") else f[k])
            for k in f.files})
    opt = topt.AdamW(learning_rate=SEQ_LR,
                     parameters=model.named_parameters())
    model, opt, _ = group_sharded_parallel(model, opt, "p_g_os")
    rows = SEQ_ROWS // world
    x = torch.from_numpy(seq_x()[rank * rows:(rank + 1) * rows]).to(dev)
    model(x).sum().backward()
    opt.step()
    opt.zero_grad()
    out = {"axis": model._sharding_axis,
           "local_shapes": {n: list(p.shape)
                            for n, p in model.named_parameters()},
           "params": {n: gather_whole(p.detach(), cuts_of(p)).cpu()
                      .tolist() for n, p in model.named_parameters()}}
    save_group_sharded_model(model, os.path.join(args.out, "gs"), opt)
    _, llama = _tp_model(args, dev, "dense")
    opt = topt.AdamW(learning_rate=LR, parameters=llama.named_parameters())
    llama, opt, _ = group_sharded_parallel(llama, opt, "p_g_os")
    from paddle_tpu_torch.distributed.mesh import get_mesh
    tr = Trainer(llama, opt, TrainStepConfig(compute_dtype=None),
                 mesh=get_mesh())
    out["trainer_losses"] = [float(tr.step(b))
                             for b in smoke_batches(256, TP_STEPS)]
    return out


def _parallel_job(args, dev, mesh, rank):
    """The tensor-parallel and FSDP runs (module docstring)."""
    from paddle_tpu_torch.distributed import collective
    axes = dict(zip(mesh.dim_names, mesh.shape))
    mp, fsdp = axes.get("mp", 1), axes.get("fsdp", 1)
    if dev.type == "cpu":
        # tiny products, and the workers share this host's cores
        torch.set_num_threads(1)
    batches = smoke_batches(256, TP_STEPS)
    result = {"world": torch.distributed.get_world_size(), "rank": rank,
              "backend": torch.distributed.get_backend(),
              "mesh": [[k, v] for k, v in axes.items()], "variants": {}}
    grads = {}
    for name in TP_VARIANTS:
        tr = _tp_trainer(args, dev, mesh, name)
        ckpt = (os.path.join(args.out, "ckpt") if name == TP_CKPT_VARIANT
                else None)
        losses, probes, g1 = _tp_run(tr, batches, ckpt)
        result["variants"][name] = {
            "losses": losses, "probes": probes,
            "replicated_equal": _replicated_digest(tr.model),
            "local_shapes": {n: list(p.shape)
                             for n, p in tr.model.named_parameters()}}
        grads.update({f"{name}/{k}": v for k, v in g1.items()})
    result["resumed"] = _resumed(args, dev, mesh,
                                 os.path.join(args.out, "ckpt"),
                                 batches[TP_CKPT_AT])
    faults = {}
    if mp > 1:
        with planted("local_lse"):
            faults["local_lse"] = _tp_run(
                _tp_trainer(args, dev, mesh, "chunk"), batches[:1])[0]
        with planted("fop"):
            _, _, g1 = _tp_run(_tp_trainer(args, dev, mesh, "dense"),
                               batches[:1])
        grads.update({f"fop/{k}": v for k, v in g1.items()})
        with planted("norm", mesh.get_group("mp")):
            faults["norm"] = _tp_run(_tp_trainer(args, dev, mesh, "dense"),
                                     batches)[1]
    if fsdp > 1:
        for fault in ("fsdp_double", "fsdp_local"):
            with planted(fault):
                faults[fault], _, g1 = _tp_run(
                    _tp_trainer(args, dev, mesh, "dense"), batches[:1])
            grads.update({f"{fault}/{k}": v for k, v in g1.items()})
    result["faults"] = faults
    result["skip"] = _skip_run(args, dev, mesh, rank, batches[0])
    result["fleet"] = _fleet_run(args, dev, axes, batches)
    if axes == {"fsdp": 2}:
        result["group_sharded"] = _group_sharded(args, dev, rank, 2)
    if rank == 0:
        np.savez(os.path.join(args.out, "grads.npz"),
                 **{k: v.numpy() for k, v in grads.items()})
        with open(os.path.join(args.out, "result.json"), "w") as f:
            json.dump(result, f)
    collective.barrier()
    print(f"SMOKE_OK rank={rank} mesh={axes}", flush=True)


def main(argv=None):
    args = _parse(argv)
    from paddle_tpu_torch.distributed import collective, env
    from paddle_tpu_torch.distributed.mesh import init_mesh
    collective_group = env.init_parallel_env(device=args.device)
    rank, world = env.get_rank(), env.get_world_size()
    assert collective_group.nranks == world and env.ParallelEnv().rank == rank
    dev = env.world_device()
    torch.manual_seed(0)
    axes = _parse_mesh(args.mesh, world)
    mesh = init_mesh(axes)
    if axes.get("mp", 1) > 1 or axes.get("fsdp", 1) > 1:
        _parallel_job(args, dev, mesh, rank)
        collective.destroy_process_group()
        return 0
    if args.elastic_dir:
        _elastic(args, dev, mesh, rank, world)
        collective.destroy_process_group()
        return 0
    if args.store_port:
        _store_exercise(args.store_port, rank, world)
    cfg, tr = _trainer(args, dev, mesh)
    batches = smoke_batches(cfg.vocab_size, args.steps)
    losses = [float(tr.step(b)) for b in batches]
    collective.barrier()
    tr.save_checkpoint(os.path.join(args.out, "ckpt"))
    result = {"losses": losses, "world": world, "rank": rank,
              "backend": torch.distributed.get_backend(),
              "mesh": [[k, v] for k, v in axes.items()]}
    if args.fault_steps:
        _, faulty = _trainer(args, dev, mesh)
        _rank_mean(faulty)
        result["fault_losses"] = [float(faulty.step(b))
                                  for b in batches[:args.fault_steps]]
    if args.empty_steps:
        _, empty = _trainer(args, dev, mesh)
        result["empty_losses"] = [
            float(empty.step(b)) for b in smoke_batches(
                cfg.vocab_size, args.empty_steps, pad_from=0)]
    if args.dp_steps:
        (result["data_parallel_max_diff"],
         result["no_sync_max_diff"]) = _data_parallel_gaps(args, dev, mesh,
                                                           world, rank)
    if rank == 0:
        with open(os.path.join(args.out, "result.json"), "w") as f:
            json.dump(result, f)
    collective.barrier()
    print(f"SMOKE_OK rank={rank} losses={losses}", flush=True)
    collective.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
