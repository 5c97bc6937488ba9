"""One rank of tests/test_torch_moe_dp.py's two-rank gloo job.

    PADDLE_TRAINER_ID=r PADDLE_TRAINERS_NUM=2 PADDLE_MASTER=127.0.0.1:p \\
        python tests/_torch_moe_dp_worker.py JOB.json

JOB.json names the npz of the JAX model's weights and of the global
batches, the runs ({name, config overrides, grad_accum_steps, planted})
and the directory the results go to. Each run trains the port's
Qwen2-MoE with the Trainer on init_mesh({"dp": 2}) and
llama_sharding_plan, f32, AdamW; rank r writes OUT/r.json (every run's
losses) and OUT/r_<run>.npz (the step-1 gradients, summed over the
ranks). A run marked
`planted` gates each rank's rows alone (nn/moe.py `batch_group` made a
no-op): the fault the test must see.
"""
import contextlib
import json
import os
import sys

import numpy as np
import torch


def _run(run, job, mesh):
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import qwen2_moe
    from paddle_tpu_torch.models.convert import from_paddle_tpu_state
    from paddle_tpu_torch.parallel.plan import llama_sharding_plan
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    cfg = qwen2_moe.tiny_qwen2_moe_config(**run["config"])
    model = qwen2_moe.Qwen2MoeForCausalLM(cfg, device="cpu")
    with np.load(job["weights"][run["name"]]) as f:
        model.load_state_dict(from_paddle_tpu_state(
            {k: f[k] for k in f.files}, cfg))
    opt = topt.AdamW(learning_rate=job["lr"],
                     parameters=model.named_parameters())
    tr = Trainer(model, opt, TrainStepConfig(
        compute_dtype=None, grad_accum_steps=run["grad_accum_steps"]),
        mesh=mesh, plan=llama_sharding_plan(mesh.dim_names))
    with np.load(job["batches"]) as f:
        ids, labels = f["input_ids"], f["labels"]
    losses, grads = [], {}
    for i in range(len(ids)):
        losses.append(float(tr.step({"input_ids": ids[i],
                                     "labels": labels[i]})))
        if i == 0:
            # the step's gradients, summed over the ranks
            grads = {n: p.grad.numpy().copy()
                     for n, p in model.named_parameters()}
    return losses, grads


def main(path):
    from paddle_tpu_torch.distributed import collective, env
    from paddle_tpu_torch.distributed.mesh import init_mesh
    from paddle_tpu_torch.nn import moe
    with open(path) as f:
        job = json.load(f)
    env.init_parallel_env(device="cpu")
    rank = env.get_rank()
    torch.manual_seed(0)
    torch.set_num_threads(1)       # a tiny model; the suite runs beside it
    mesh = init_mesh({"dp": 2})
    out = {}
    for run in job["runs"]:
        with contextlib.ExitStack() as stack:
            if run["planted"]:
                stack.enter_context(_local_gates(moe))
            losses, grads = _run(run, job, mesh)
        out[run["name"]] = losses
        np.savez(os.path.join(job["out"], f"{rank}_{run['name']}.npz"),
                 **grads)
    with open(os.path.join(job["out"], f"{rank}.json"), "w") as f:
        json.dump(out, f)
    collective.barrier()
    collective.destroy_process_group()


@contextlib.contextmanager
def _local_gates(moe):
    """The planted fault: every rank gates its own rows alone."""
    real = moe.batch_group
    moe.batch_group = lambda group, index, size: contextlib.nullcontext()
    try:
        yield
    finally:
        moe.batch_group = real


if __name__ == "__main__":
    main(sys.argv[1])
