"""The ring paths' worker: the FSDP overlap rings (parallel/overlap.py) and
context parallelism (distributed/context_parallel.py) across processes,
for the launcher. Started as

    python -m paddle_tpu_torch.distributed.launch --devices 0,1,..,7 \\
        paddle_tpu_torch/distributed/launch/ring_smoke.py --job overlap \\
        --out DIR --weights DIR [--device cpu]

with eight workers (gloo on the CPU). Every input is made here from a
seed, by the same functions the tests call on the JAX side (`op_data`,
`qkv`, `train_batches`, ...), and the models load the JAX package's
weights from DIR/{name}.npz. Each rank writes DIR/rank{r}.npz (its
outputs, named `kind/case/...`) and rank 0 DIR/result.json (losses,
ring counts, phase columns); "SMOKE_OK" ends each worker's log.

`--job overlap`:
1. on init_mesh({"dp": 2, "fsdp": 2, "mp": 2}): `overlap_all_gather_
   matmul` at chunks 1, 2, 3 and shard_dim 0, 1, `overlap_matmul_reduce_
   scatter` at chunks 1, 3 and shard_dim 0, 1, on this rank's shares of
   `op_data()`, and the gradients of sum(sin(ring)) through both
   (chunks 2, shard_dim 0); the Trainer on the tiny Llama ("overlap" model, 2
   layers) with overlap on and off, OVERLAP_STEPS steps (fsdp x mp);
2. on init_mesh({"dp": 2, "fsdp": 4}): the all-gather ring at chunks 3;
   the Trainer with overlap on (chunks 2) and its step 1 gradients
   gathered whole; the rings a bf16-compute step runs and the bytes it
   sends;
   `measure_phase_seconds` of a 1-layer model with overlap on;
3. on init_mesh({"dp": 8, "fsdp": 1}): the one-rank ring.

`--job cp`, on init_mesh({"dp": 2, "sp": 4}):
1. `ring_attention` (plain and flash, causal and full, GQA) and
   `ulysses_attention` (plain and flash; K/V at Hk heads or repeated) on
   this rank's shards of `qkv(...)`, with the gradients of sum(out^2)
   for the causal rings;
2. the Trainer with context_parallel "ring" and "ulysses" on each
   CP_VARIANTS model (plain attention and RoPE; flash attention with the
   fused norm and RoPE), CP_STEPS steps, step 1's gradients gathered
   whole; and, after the ring Trainer's steps, one step on
   `shift_batch()`, whose only valid label sits at the first position
   of rank 1's shard.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

OP_SHAPE = dict(B=8, S=8, K=16, N=32)
OVERLAP_STEPS = 3
OVERLAP_LR = 1e-3
CP_STEPS = 2
CP_LR = 1e-3
# name -> LlamaConfig overrides (tiny_llama_config, 2 layers)
CP_VARIANTS = {
    "plain": {},
    "flash": dict(hidden_size=256, intermediate_size=256,
                  use_flash_attention=True, fused_norm=True, fused_rope=True),
}
CP_BATCH = (4, 32)
# the attention cases: name -> (b, s, hq, hk, d)
CP_OPS = {"d32": (2, 64, 4, 2, 32), "d64": (2, 64, 8, 4, 64)}


def op_data(seed=0, B=8, S=8, K=16, N=32):
    """x (B, S, K), w (K, N) (the JAX layout), g (B, S, N), f32."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, K).astype(np.float32),
            rng.randn(K, N).astype(np.float32),
            rng.randn(B, S, N).astype(np.float32))


def qkv(b, s, hq, hk, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, hq, d).astype(np.float32),
            rng.randn(b, s, hk, d).astype(np.float32),
            rng.randn(b, s, hk, d).astype(np.float32))


def train_batches(vocab, steps, shape=(8, 32), seed=7):
    """tests/test_overlap.py's batches: labels = ids."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        ids = rng.randint(0, vocab, size=shape).astype(np.int64)
        out.append({"input_ids": ids, "labels": ids})
    return out


def shift_batch(vocab, sp, shape=CP_BATCH, seed=5):
    """Ids with every label -100 but one, at the first position of the
    second sequence shard (row 1): only the previous shard's last
    position scores it."""
    ids = np.random.RandomState(seed).randint(0, vocab, size=shape) \
        .astype(np.int64)
    labels = np.full(shape, -100, np.int64)
    labels[1, shape[1] // sp] = ids[1, shape[1] // sp]
    return {"input_ids": ids, "labels": labels}


def ring_counts_per_step(cfg, n, itemsize, recompute=False):
    """The overlap rings one training step runs (one microbatch) over an
    fsdp group of `n`, and the bytes a rank sends over them: every
    projection a forward ring (contract for the input-cut q/k/v/qkv/
    gate/up/gate_up, assemble for the output-cut o/down), its backward
    the sibling ring and the reduce-scatter ring; a recomputed layer
    runs its forward rings twice. Each ring hops its 1/n piece n - 1
    times: the weight's in the compute type (`itemsize` bytes), the
    gradient accumulator's in f32."""
    fwd_contract = (1 if cfg.fuse_attention_qkv else 3) \
        + (1 if cfg.fuse_attention_ffn else 2)
    fwd_assemble = 2
    f = 2 if recompute else 1
    layers = cfg.num_hidden_layers
    d, ff = cfg.hidden_size, cfg.intermediate_size
    kv = cfg.num_key_value_heads * cfg.head_dim
    numel = 2 * d * d + 2 * d * kv + 3 * d * ff
    return {"contract": layers * (f * fwd_contract + fwd_assemble),
            "assemble": layers * (f * fwd_assemble + fwd_contract),
            "reduce_scatter": layers * (fwd_contract + fwd_assemble),
            "bytes": layers * (n - 1) * numel // n * ((f + 1) * itemsize
                                                      + 4)}


def _rows(mesh, axes, n_rows):
    """This rank's slice of `n_rows` rows cut over `axes` (first slowest)."""
    i, k = 0, 1
    for a in axes:
        i = i * mesh.get_dim_size(a) + mesh.coordinate(a)
        k *= mesh.get_dim_size(a)
    step = n_rows // k
    return slice(i * step, (i + 1) * step)


def _cut(a, mesh, axis, dim):
    """This rank's piece of numpy `a` along `dim` over mesh `axis`."""
    n, c = mesh.get_dim_size(axis), mesh.coordinate(axis)
    size = a.shape[dim] // n
    idx = [slice(None)] * a.ndim
    idx[dim] = slice(c * size, (c + 1) * size)
    return a[tuple(idx)]


def _t(a, dev, grad=False):
    return torch.tensor(np.ascontiguousarray(a), device=dev,
                        requires_grad=grad)


def _np(t):
    return t.detach().float().cpu().numpy()


def _model(args, dev, name, cfg):
    from paddle_tpu_torch.models.convert import from_paddle_tpu_state
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    with np.load(os.path.join(args.weights, f"{name}.npz")) as f:
        model.load_state_dict(from_paddle_tpu_state(
            {k: f[k] for k in f.files}, cfg))
    return model


def _trainer(model, mesh, lr, **step_kw):
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.parallel.plan import llama_sharding_plan
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    step_kw.setdefault("compute_dtype", None)
    return Trainer(model, topt.AdamW(learning_rate=lr,
                                     parameters=model.named_parameters()),
                   TrainStepConfig(**step_kw),
                   mesh=mesh, plan=llama_sharding_plan(mesh.dim_names))


def _grads(model):
    from paddle_tpu_torch.distributed.sharding import cuts_of, gather_whole
    return {n: _np(gather_whole(p.grad.detach(), cuts_of(p)))
            for n, p in model.named_parameters()}


def _run(tr, batches, out, key):
    """Steps `batches`; the losses, and step 1's gradients into `out`
    under `key/`."""
    losses = []
    for i, b in enumerate(batches):
        losses.append(float(tr.step(b)))
        if i == 0:
            out.update({f"{key}/grad/{n}": g
                        for n, g in _grads(tr.model).items()})
    return losses


# ---------------------------------------------------------------------------
# --job overlap
# ---------------------------------------------------------------------------

def overlap_cfg(layers=2):
    from paddle_tpu_torch.models.llama import tiny_llama_config
    return tiny_llama_config(num_hidden_layers=layers)


def _overlap_ops(mesh, dev, out):
    from paddle_tpu_torch.parallel import overlap as ov
    x, w, g = op_data(**OP_SHAPE)
    rows = _rows(mesh, ("dp", "fsdp"), x.shape[0])
    for sd in (0, 1):
        xl = x[rows] if sd == 0 else _cut(x[rows], mesh, "mp", 2)
        wl = _cut(_cut(w, mesh, "fsdp", sd), mesh, "mp", 1 - sd)
        for chunks in (1, 2, 3):
            y = ov.overlap_all_gather_matmul(
                _t(xl, dev), _t(wl, dev), chunks=chunks, mesh=mesh,
                shard_dim=sd, kernel="ring")
            out[f"ag/sd{sd}/c{chunks}"] = _np(y)
        gl = _cut(g[rows], mesh, "mp", 2) if sd == 0 else g[rows]
        for chunks in (1, 3):
            r = ov.overlap_matmul_reduce_scatter(
                _t(xl, dev), _t(gl, dev), chunks=chunks, mesh=mesh,
                shard_dim=sd, kernel="ring")
            out[f"rs/sd{sd}/c{chunks}"] = _np(r)
    xt = _t(x[rows], dev, grad=True)
    wt = _t(_cut(_cut(w, mesh, "fsdp", 0), mesh, "mp", 1), dev, grad=True)
    torch.sin(ov.overlap_all_gather_matmul(
        xt, wt, chunks=2, mesh=mesh, kernel="ring")).sum().backward()
    out["grad/x"], out["grad/w"] = _np(xt.grad), _np(wt.grad)
    xt = _t(x[rows], dev, grad=True)
    gt = _t(_cut(g[rows], mesh, "mp", 2), dev, grad=True)
    torch.sin(ov.overlap_matmul_reduce_scatter(
        xt, gt, chunks=2, mesh=mesh, kernel="ring")).sum().backward()
    out["rs_grad/x"], out["rs_grad/g"] = _np(xt.grad), _np(gt.grad)


def overlap_job(args, dev, rank):
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.mesh import init_mesh, set_mesh
    from paddle_tpu_torch.parallel import overlap as ov
    out, result = {}, {}
    mesh = init_mesh({"dp": 2, "fsdp": 2, "mp": 2})
    set_mesh(mesh)
    _overlap_ops(mesh, dev, out)
    cfg = overlap_cfg()
    batches = train_batches(cfg.vocab_size, OVERLAP_STEPS)
    for on in (True, False):
        tr = _trainer(_model(args, dev, "overlap", cfg), mesh, OVERLAP_LR,
                      overlap_fsdp=on, overlap_chunks=2)
        before = dict(ov.counts)
        result[f"fsdp_mp/{on}"] = _run(tr, batches, out, f"fsdp_mp/{on}")
        result[f"fsdp_mp/{on}/rings"] = {
            k: ov.counts[k] - before[k] for k in ov.counts if k != "bytes"}

    mesh = init_mesh({"dp": 2, "fsdp": 4})
    set_mesh(mesh)
    x, w, _ = op_data(**OP_SHAPE)
    y = ov.overlap_all_gather_matmul(
        _t(x[_rows(mesh, ("dp", "fsdp"), 8)], dev),
        _t(_cut(w, mesh, "fsdp", 0), dev), chunks=3, mesh=mesh,
        kernel="ring")
    out["ag2/c3"] = _np(y)
    tr = _trainer(_model(args, dev, "overlap", cfg), mesh, OVERLAP_LR,
                  overlap_fsdp=True, overlap_chunks=2,
                  compute_dtype="bfloat16")
    tr.step(batches[0])                 # the rings' counts over one step
    before = dict(ov.counts)
    tr.step(batches[1])
    result["ring_per_step"] = {k: ov.counts[k] - before[k]
                               for k in ov.counts}
    result["ring_want"] = ring_counts_per_step(cfg, 4, 2)
    tr = _trainer(_model(args, dev, "overlap", cfg), mesh, OVERLAP_LR,
                  overlap_fsdp=True, overlap_chunks=2)
    result["dp_fsdp"] = _run(tr, batches, out, "dp_fsdp")
    tr = _trainer(_model(args, dev, "overlap1", overlap_cfg(1)), mesh,
                  OVERLAP_LR, overlap_fsdp=True, overlap_chunks=2)
    from paddle_tpu_torch import observability
    with observability.scoped(reset=True) as reg:
        phases = tr.measure_phase_seconds(batches[0], iters=1)
        cells = reg.histogram("train.overlap.comm.seconds").labeled()
    result["phases"] = phases
    result["comm_cells"] = sorted(str(c) for c in cells)

    mesh = init_mesh({"dp": 8, "fsdp": 1})
    set_mesh(mesh)
    y = ov.overlap_all_gather_matmul(
        _t(x[rank:rank + 1], dev), _t(w, dev), chunks=2, mesh=mesh,
        kernel="ring")
    out["one_rank"] = _np(y)
    collective.barrier()
    return out, result


# ---------------------------------------------------------------------------
# --job cp
# ---------------------------------------------------------------------------

def cp_cfg(name):
    from paddle_tpu_torch.models.llama import tiny_llama_config
    return tiny_llama_config(num_hidden_layers=2, **CP_VARIANTS[name])


def _cp_ops(mesh, dev, out):
    from paddle_tpu_torch.distributed import context_parallel as cp
    group = mesh.get_group("sp")
    for case, shape in CP_OPS.items():
        q, k, v = qkv(*shape)
        rows = _rows(mesh, ("dp",), q.shape[0])
        ql, kl, vl = (_cut(a[rows], mesh, "sp", 1) for a in (q, k, v))
        flash = (True, False) if shape[-1] == 64 else (False,)
        for use_flash in flash:
            tag = "flash" if use_flash else "plain"
            for causal in (True, False):
                o = cp.ring_attention(_t(ql, dev), _t(kl, dev), _t(vl, dev),
                                      group=group, causal=causal,
                                      use_flash=use_flash)
                out[f"ring/{case}/{tag}/{causal}"] = _np(o)
            o = cp.ulysses_attention(_t(ql, dev), _t(kl, dev), _t(vl, dev),
                                     group=group, use_flash=use_flash)
            out[f"ulysses/{case}/{tag}"] = _np(o)
            for mode, f in (("ring", cp.ring_attention),
                            ("ulysses", cp.ulysses_attention)):
                ts = [_t(a, dev, grad=True) for a in (ql, kl, vl)]
                (f(*ts, group=group, use_flash=use_flash) ** 2).sum() \
                    .backward()
                for n, t in zip("qkv", ts):
                    out[f"grad/{mode}/{case}/{tag}/{n}"] = _np(t.grad)


def cp_job(args, dev, rank):
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed import context_parallel as cp
    from paddle_tpu_torch.distributed.mesh import init_mesh, set_mesh
    from paddle_tpu_torch.kernels import flash_attention as fa
    out, result = {}, {}
    mesh = init_mesh({"dp": 2, "sp": 4})
    set_mesh(mesh)
    _cp_ops(mesh, dev, out)
    for name in CP_VARIANTS:
        cfg = cp_cfg(name)
        batches = train_batches(cfg.vocab_size, CP_STEPS, CP_BATCH)
        for mode in ("ring", "ulysses"):
            tr = _trainer(_model(args, dev, f"cp_{name}", cfg), mesh, CP_LR,
                          context_parallel=mode)
            before = dict(fa.launches), dict(cp.counts)
            key = f"trainer/{name}/{mode}"
            result[key] = _run(tr, batches, out, key)
            result[key + "/launches"] = {k: fa.launches[k] - before[0][k]
                                         for k in fa.launches}
            result[key + "/counts"] = {k: cp.counts[k] - before[1][k]
                                       for k in cp.counts}
            if mode == "ring":
                result[f"shift/{name}"] = float(tr.step(shift_batch(
                    cfg.vocab_size, mesh.get_dim_size("sp"))))
    collective.barrier()
    return out, result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--job", choices=("overlap", "cp"), required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--weights", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from paddle_tpu_torch.distributed import collective, env
    env.init_parallel_env(device=args.device)
    rank = env.get_rank()
    dev = env.world_device()
    if dev.type == "cpu":
        # tiny products, and the workers share this host's cores
        torch.set_num_threads(1)
    torch.manual_seed(0)
    job = overlap_job if args.job == "overlap" else cp_job
    out, result = job(args, dev, rank)
    np.savez(os.path.join(args.out, f"rank{rank}.npz"), **out)
    if rank == 0:
        with open(os.path.join(args.out, "result.json"), "w") as f:
            json.dump(result, f)
    collective.barrier()
    print(f"SMOKE_OK rank={rank} job={args.job}", flush=True)
    collective.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
