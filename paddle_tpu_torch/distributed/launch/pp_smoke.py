"""The pipeline's worker (parallel/pipeline.py) across processes, for the
launcher. Started as

    python -m paddle_tpu_torch.distributed.launch --devices 0,1,..,7 \\
        paddle_tpu_torch/distributed/launch/pp_smoke.py \\
        --out DIR --weights DIR [--device cpu]

with eight workers (gloo on the CPU). Each case of `CASES` builds the
tiny Llama of `case_config(case)` from the JAX package's weights in
DIR/{REFERENCE[case]}.npz, trains it through the PipelineTrainer on its
mesh for STEPS steps of `case_batch(case)` (AdamW(LR,
epsilon=EPSILON), f32), and writes this rank's step 1 gradients and
last parameters into DIR/rank{r}.npz (named `case/grad/...`,
`case/param/...`) and its losses, the layers it holds,
the peak of microbatches it held and its hops a step into
DIR/rank{r}.json. Then the refusals: each message the PipelineTrainer
raises for a bad split, an interleave the stack does not divide, 1F1B
with grad_accum_steps, and the checkpoints and phase timing not yet
under 'pp'; and one skip_nonfinite_grads step with NaN gradients on
stage 0 alone. "SMOKE_OK" ends each worker's log.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

STEPS = 3
# AdamW's: with epsilon 1 the update is about lr x the (clipped) gradient,
# so the parameters after the steps follow the gradients linearly
LR = 0.1
EPSILON = 1.0
SEED = 7            # paddle_tpu.seed of the JAX models (the weights)
# case -> mesh, layers, microbatches, rows of the batch and the rest of
# the PipelineConfig / model / optimizer / labels choices
CASES = {
    "1f1b": dict(mesh={"pp": 4, "dp": 2}, layers=4, M=4, rows=8),
    "gpipe": dict(mesh={"pp": 4, "dp": 2}, layers=4, M=4, rows=8,
                  schedule="gpipe"),
    "vpp": dict(mesh={"pp": 4, "dp": 2}, layers=8, M=8, rows=16,
                interleave=2),
    # ragged -100 labels and M = 8 on {pp 2, dp 4}
    "ragged": dict(mesh={"pp": 2, "dp": 4}, layers=2, M=8, rows=32,
                   ragged=True),
    # 10 layers over 4 stages (3/3/2/2), the head tied to the embedding,
    # a ClipGradByGlobalNorm clip whose norm spans the stages, and the
    # health probe's norm (the port's only: it changes no update)
    "tied": dict(mesh={"pp": 4, "dp": 2}, layers=10, M=4, rows=8,
                 tie=True, clip=0.05, probe=True),
    "bounds": dict(mesh={"pp": 2, "dp": 4}, layers=5, M=4, rows=16,
                   stage_boundaries=(0, 4, 5)),
    # the ragged case on fleet.init(pp_degree=2)'s mesh (dp major)
    "fleet": dict(mesh="fleet", layers=2, M=8, rows=32, ragged=True),
}
# the JAX run each case is held to (its own, or the same model and data's)
REFERENCE = {c: c for c in CASES} | {"fleet": "ragged"}


def case_config(case):
    """The tiny Llama of `case` (tiny_llama_config's widths, either
    package's)."""
    from paddle_tpu_torch.models.llama import tiny_llama_config
    c = CASES[case]
    return tiny_llama_config(num_hidden_layers=c["layers"],
                             tie_word_embeddings=c.get("tie", False))


def case_batch(case, vocab=256, seq=32):
    """`case`'s batch (int32 ids; labels = ids, with rows 0 and 1 mostly
    -100 for the ragged case: the first microbatch nearly empty)."""
    c = CASES[case]
    rng = np.random.RandomState(0)
    ids = rng.randint(0, vocab, (c["rows"], seq)).astype(np.int32)
    labels = ids.copy()
    if c.get("ragged"):
        labels[0, :30] = -100
        labels[1, :20] = -100
    return {"input_ids": ids, "labels": labels}


def pipeline_kwargs(case):
    """`case`'s PipelineConfig fields."""
    c = CASES[case]
    kw = dict(compute_dtype=None, num_microbatches=c["M"],
              schedule=c.get("schedule", "1f1b"),
              interleave=c.get("interleave", 1))
    if "stage_boundaries" in c:
        kw["stage_boundaries"] = c["stage_boundaries"]
    return kw


def _np(t):
    return t.detach().float().cpu().numpy()


def _model(cfg, dev, path=None):
    from paddle_tpu_torch.models.convert import from_paddle_tpu_state
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    if path is not None:
        with np.load(path) as f:
            model.load_state_dict(from_paddle_tpu_state(
                {k: f[k] for k in f.files}, cfg))
    return model


def _trainer(model, mesh, clip=None, **cfg_kw):
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.parallel.pipeline import (PipelineConfig,
                                                    PipelineTrainer)
    from paddle_tpu_torch.parallel.plan import llama_sharding_plan
    opt = topt.AdamW(learning_rate=LR, epsilon=EPSILON,
                     parameters=model.named_parameters(),
                     grad_clip=None if clip is None
                     else ClipGradByGlobalNorm(clip))
    return PipelineTrainer(model, opt, mesh,
                           llama_sharding_plan(mesh.dim_names),
                           PipelineConfig(**cfg_kw))


def _layers(model):
    """The stack indices whose layers this rank holds."""
    from paddle_tpu_torch.models.llama import LlamaDecoderLayer
    return [i for i, m in enumerate(model.model.layers)
            if isinstance(m, LlamaDecoderLayer)]


def run_case(case, args, dev, out, result):
    from paddle_tpu_torch.distributed.mesh import init_mesh
    c = CASES[case]
    if c["mesh"] == "fleet":
        from paddle_tpu_torch.distributed import fleet
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": 4, "pp_degree": 2}
        fleet.init(is_collective=True, strategy=strategy)
        mesh = fleet.get_mesh()
    else:
        mesh = init_mesh(c["mesh"])
    model = _model(case_config(case), dev, os.path.join(
        args.weights, f"{REFERENCE[case]}.npz"))
    tr = _trainer(model, mesh, c.get("clip"),
                  health_probe=c.get("probe", False), **pipeline_kwargs(case))
    batch = case_batch(case)
    losses, peak, hops, probe = [], 0, None, None
    for i in range(STEPS):
        losses.append(float(tr.step(batch)))
        peak = max(peak, tr.last_schedule["in_flight"])
        hops = tr.last_schedule["hops"]
        if i == 0:
            out.update({f"{case}/grad/{n}": _np(p.grad)
                        for n, p in model.named_parameters()})
            if tr.last_probe is not None:
                probe = tr.last_probe.tolist()
    out.update({f"{case}/param/{n}": _np(p)
                for n, p in model.named_parameters()})
    result[case] = dict(losses=losses, in_flight=peak, hops=hops, probe=probe,
                        stage=mesh.coordinate("pp"), layers=_layers(model),
                        names=sorted(n for n, _ in model.named_parameters()))


def _message(fn):
    try:
        fn()
    except Exception as e:         # noqa: BLE001 — the message is the result
        return f"{type(e).__name__}: {e}"
    return None


def refusals(dev):
    """{what: "Type: message"} of each refusal the job can only show with
    a 'pp' axis of extent > 1 (module docstring)."""
    from paddle_tpu_torch.distributed.mesh import init_mesh
    from paddle_tpu_torch.models.llama import tiny_llama_config
    out = {}
    mesh = init_mesh({"pp": 2, "dp": 4})
    cfg4, cfg5 = (tiny_llama_config(num_hidden_layers=n) for n in (4, 5))
    out["bounds"] = _message(lambda: _trainer(
        _model(cfg4, dev), mesh, stage_boundaries=(0, 1, 2, 4)))
    out["vpp_uneven"] = _message(lambda: _trainer(
        _model(cfg5, dev), mesh, num_microbatches=4, interleave=2))
    ids = np.zeros((32, 16), np.int32)
    batch = {"input_ids": ids, "labels": ids}
    tr = _trainer(_model(cfg4, dev), init_mesh({"pp": 4, "dp": 2}),
                  compute_dtype=None, num_microbatches=8, interleave=2)
    out["vpp_divisible"] = _message(lambda: tr.step(batch))
    tr = _trainer(_model(cfg4, dev), mesh, compute_dtype=None,
                  grad_accum_steps=2)
    out["accum_1f1b"] = _message(lambda: tr.step(batch))
    out["save"] = _message(lambda: tr.save_checkpoint("unused"))
    out["load"] = _message(lambda: tr.load_checkpoint("unused"))
    out["phases"] = _message(lambda: tr.measure_phase_seconds(batch))
    return out


def skip_on_one_stage(dev):
    """skip_nonfinite_grads with NaN gradients on stage 0 only (the chaos
    site `trainer.grad` there): {"skipped": steps skipped, "unchanged":
    whether this rank's parameters kept their bits}; every stage skips."""
    import contextlib
    from paddle_tpu_torch.distributed import chaos
    from paddle_tpu_torch.distributed.mesh import init_mesh
    from paddle_tpu_torch.models.llama import tiny_llama_config
    mesh = init_mesh({"pp": 4, "dp": 2})
    model = _model(tiny_llama_config(), dev)
    tr = _trainer(model, mesh, compute_dtype=None, skip_nonfinite_grads=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    poison = chaos.scoped(rates={"trainer.grad": 1.0}) \
        if mesh.coordinate("pp") == 0 else contextlib.nullcontext()
    with poison:
        tr.step(case_batch("1f1b"))
    return {"skipped": tr.nonfinite_skipped,
            "unchanged": all(torch.equal(p, before[n])
                             for n, p in model.named_parameters())}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
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
    out, result = {}, {}
    for case in CASES:
        run_case(case, args, dev, out, result)
    result["refusals"] = refusals(dev)
    result["skip"] = skip_on_one_stage(dev)
    np.savez(os.path.join(args.out, f"rank{rank}.npz"), **out)
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    collective.barrier()
    print(f"SMOKE_OK rank={rank} job=pp", flush=True)
    collective.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
