"""The pipeline (paddle_tpu_torch/parallel/pipeline.py) on the card: two
gloo stage ranks on device 0, started through the port's launcher as
chip_smoke.py's phase 24 starts its own.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without
one; the file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_pp.py

- One 1F1B step of a two-layer Llama (hidden 512, 8/2 heads of 64; the
  flash kernels, the fused norm and RoPE, recompute; bf16 compute) over
  four microbatches of one 512-token row, one layer a stage, against a
  one-process mesh-free Trainer of the same model and batch: the loss
  within 2e-3 of its own and step 1's gradient within 4e-2 of its norm
  over both stages (chip_smoke.py's DP_LOSS_TOL and DP_GRAD_TOL); each
  rank launches 8 flash forwards (one layer, recomputed, four
  microbatches) and sends 4 hops.
"""
import os
import socket
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 600

_WORKER = r"""
import sys
import numpy as np
import torch
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import collective, env
from paddle_tpu_torch.distributed.mesh import init_mesh
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models.llama import LlamaForCausalLM, tiny_llama_config
from paddle_tpu_torch.parallel import pipeline as pl
from paddle_tpu_torch.parallel.plan import llama_sharding_plan
from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig

dist.init_parallel_env(device="cuda", backend="gloo")
rank = dist.get_rank()
dev = env.world_device()
cfg = tiny_llama_config(
    vocab_size=1024, hidden_size=512, intermediate_size=1024,
    num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=2,
    max_position_embeddings=512, use_flash_attention=True, fused_norm=True,
    fused_rope=True, recompute=True)
ids = np.random.RandomState(0).randint(0, 1024, (4, 512)).astype(np.int64)
batch = {"input_ids": ids, "labels": ids}
bad = []


def build():
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    return model, topt.AdamW(learning_rate=1e-3,
                             parameters=model.named_parameters())


model, opt = build()
mesh = init_mesh({"pp": 2})
tr = pl.PipelineTrainer(model, opt, mesh, llama_sharding_plan(mesh.dim_names),
                        pl.PipelineConfig(compute_dtype="bfloat16",
                                          num_microbatches=4))
before = fa.launches["flash_fwd"]
loss = float(tr.step(batch))
launched = fa.launches["flash_fwd"] - before
grads = {n: p.grad.float() for n, p in model.named_parameters()}
ref_model, ref_opt = build()
ref = Trainer(ref_model, ref_opt, TrainStepConfig(compute_dtype="bfloat16"))
ref_loss = float(ref.step(batch))
want = dict(ref_model.named_parameters())
sums = torch.zeros(2, dtype=torch.float64)
for n, g in grads.items():
    w = want[n].grad.float()
    sums[0] += float((g - w).double().pow(2).sum())
    sums[1] += float(w.double().pow(2).sum())
collective.all_reduce(sums)
gap = float(sums[0] / sums[1]) ** 0.5
if not abs(loss - ref_loss) <= 2e-3 * abs(ref_loss):
    bad.append(f"loss {loss} against {ref_loss}")
if not gap <= 4e-2:
    bad.append(f"gradient gap {gap}")
if launched != 8:
    bad.append(f"rank {rank} launched {launched} flash forwards")
if tr.last_schedule["hops"] != 4:
    bad.append(f"rank {rank} sent {tr.last_schedule['hops']} hops")
print("RESULT", rank, "ok" if not bad else bad, loss, ref_loss, gap,
      flush=True)
collective.destroy_process_group()
sys.exit(1 if bad else 0)
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_two_gloo_stage_ranks_match_one_process(cuda, tmp_path):
    script = tmp_path / "pp_worker.py"
    script.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--master", f"127.0.0.1:{port}", "--nnodes", "2", "--rank", str(r),
         "--devices", "0", str(script)], env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-4000:]
        assert f"RESULT {r} ok" in out, out[-4000:]
