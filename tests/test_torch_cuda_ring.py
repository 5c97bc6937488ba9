"""The ring paths' transport and kernels on the card: two gloo ranks on
device 0, started through the port's launcher as chip_smoke.py's phases
21-23 start theirs.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without
one; the file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_ring.py

- `collective.ppermute`, `ppermute_start` / `wait` and `send` / `recv`
  (gloo's point-to-point path takes no CUDA tensor: the port stages
  through pinned host buffers) carry bf16 and f32 CUDA tensors of seeded
  random bits, 1 MB and 128 MB, bit for bit, and the results stay on the
  card.
- the flash ring (distributed/context_parallel.py) over the two ranks,
  bf16, causal, (1, 2 x 1024, 8/2, 64): its output and dq, dk, dv
  against the whole-sequence flash kernels by the flash row rule (2^-5,
  tests/test_torch_cuda.py), rank 0 launching one forward block and
  rank 1 two.
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
import torch
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed import collective, env
from paddle_tpu_torch.distributed import context_parallel as cp
from paddle_tpu_torch.distributed.mesh import init_mesh, set_mesh
from paddle_tpu_torch.kernels import flash_attention as fa

dist.init_parallel_env(device="cuda", backend="gloo")
rank = dist.get_rank()
dev = env.world_device()
set_mesh(init_mesh({"sp": 2}))
bad = []


def bits(nbytes, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-2 ** 15, 2 ** 15, (nbytes // 2,), dtype=torch.int16,
                         device=dev, generator=g).view(dtype)


def same(a, b):
    return a.is_cuda and torch.equal(a.view(torch.int16), b.view(torch.int16))


for dtype in (torch.bfloat16, torch.float32):
    for nbytes in (1 << 20, 128 << 20):
        mine, theirs = bits(nbytes, dtype, rank), bits(nbytes, dtype, 1 - rank)
        got = collective.ppermute(mine, "sp", [(0, 1), (1, 0)])
        if not same(got, theirs):
            bad.append(f"ppermute {dtype} {nbytes}")
        got = collective.ppermute_start(mine, "sp", [(0, 1), (1, 0)]).wait()
        if not same(got, theirs):
            bad.append(f"ppermute_start {dtype} {nbytes}")
        if rank == 0:
            collective.send(mine, dst=1)
        else:
            got = collective.recv(src=0)
            if not same(got, theirs):
                bad.append(f"send/recv {dtype} {nbytes}")
        torch.cuda.synchronize()

g = torch.Generator(device=dev).manual_seed(7)
b, s, hq, hk, d = 1, 2048, 8, 2, 64
q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev)
               .to(torch.bfloat16) for h in (hq, hk, hk, hq))
o, lse = fa.flash_attention_fwd(q, k, v, True)
dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
half = slice(rank * s // 2, (rank + 1) * s // 2)
ts = [t[:, half].contiguous().requires_grad_() for t in (q, k, v)]
before = dict(fa.launches)
out = cp.ring_attention(*ts, causal=True)
launched = fa.launches["flash_fwd"] - before["flash_fwd"]
out.backward(do[:, half].contiguous())


def ratio(a, r):
    a, r = a.float(), r.float()
    sq = r.square()
    bound = 2 ** -5 * (r.abs() + sq.mean(-1, keepdim=True).sqrt()
                       + 2 ** -6 * sq.mean().sqrt())
    return float(((a - r).abs() / bound).max())


for name, a, r in (("o", out, o), ("dq", ts[0].grad, dq),
                   ("dk", ts[1].grad, dk), ("dv", ts[2].grad, dv)):
    if not ratio(a, r[:, half]) <= 1.0:
        bad.append(f"ring {name} {ratio(a, r[:, half])}")
if launched != rank + 1:
    bad.append(f"rank {rank} launched {launched} forward blocks")
print("RESULT", rank, "ok" if not bad else bad, flush=True)
collective.destroy_process_group()
sys.exit(1 if bad else 0)
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_two_gloo_ranks_ring_bit_exact_and_flash_ring(cuda, tmp_path):
    script = tmp_path / "ring_worker.py"
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
