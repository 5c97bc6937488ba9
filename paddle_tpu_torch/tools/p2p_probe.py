"""Point-to-point between two gloo ranks on one CUDA card:

    python -m paddle_tpu_torch.tools.p2p_probe [--out probe.json]

Run from the repository root. It starts two workers through the port's
launcher (`--nnodes 2 --rank r --devices 0`, gloo, both on device 0, as
chip_smoke.py's phases 21-23 start theirs) and each, for bf16 and f32
CUDA tensors of 1 MB and 128 MB filled with seeded random bits:

- torch's own `send` / `recv` and `batch_isend_irecv` on the CUDA
  tensors, at 1 MB, in a pair of workers of their own with a 20 s group
  timeout (what gloo's point-to-point path does with them: an error, a
  crash or a hang there is recorded, not fatal);
- the port's `collective.send` / `recv` (rank 0 to rank 1) and
  `collective.ppermute` over a mesh {"sp": 2} (each rank to the other),
  and `ppermute_start` / `wait` (the non-blocking form the rings use).

Each received tensor is held bit for bit against the sender's, on the
card, and each op is timed (host clock around a synchronised call, the
median of 3 after one warm-up). It prints one JSON object: per op, dtype
and size, the seconds or the error the op raised, and whether the bytes
matched; and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

SIZES = {"1MB": 1 << 20, "128MB": 128 << 20}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
REPEATS = 3


def _bits(n_bytes, dtype, seed, dev):
    """A tensor of `dtype` holding `n_bytes` of seeded random bits."""
    g = torch.Generator(device=dev).manual_seed(seed)
    words = torch.randint(-2 ** 15, 2 ** 15, (n_bytes // 2,),
                          dtype=torch.int16, device=dev, generator=g)
    return words.view(dtype)


def _same_bits(a, b):
    return a.shape == b.shape and bool(torch.equal(
        a.view(torch.int16), b.view(torch.int16)))


def _timed(run):
    """(median seconds over REPEATS after a warm-up, the last result)."""
    out = run()
    torch.cuda.synchronize()
    ts = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2], out


def _entry(run, want):
    try:
        sec, got = _timed(run)
    except Exception as e:          # the probe records what gloo refuses
        return {"error": repr(e)[:300]}
    return {"s": sec, "bit_equal": want is None or _same_bits(got, want)}


def worker(out, raw):
    import datetime
    import torch.distributed as tdist
    from paddle_tpu_torch.distributed import collective, env
    from paddle_tpu_torch.distributed.mesh import init_mesh, set_mesh
    env.init_parallel_env(device="cuda", backend="gloo")
    rank = tdist.get_rank()
    peer = 1 - rank
    dev = env.world_device()
    set_mesh(init_mesh({"sp": 2}))
    pg = tdist.new_group([0, 1], backend="gloo",
                         timeout=datetime.timedelta(seconds=20))
    res = {}
    for dname, dt in DTYPES.items():
        for sname, nbytes in SIZES.items():
            if raw and sname != "1MB":
                continue
            mine = _bits(nbytes, dt, 100 + rank, dev)
            theirs = _bits(nbytes, dt, 100 + peer, dev)
            key = f"{dname}/{sname}"

            def raw_send_recv():
                if rank == 0:
                    tdist.send(mine, 1, group=pg)
                    return None
                buf = torch.empty_like(mine)
                tdist.recv(buf, 0, group=pg)
                return buf

            def raw_batch():
                buf = torch.empty_like(mine)
                ops = [tdist.P2POp(tdist.isend, mine, peer, pg),
                       tdist.P2POp(tdist.irecv, buf, peer, pg)]
                for w in tdist.batch_isend_irecv(ops):
                    w.wait()
                return buf

            def port_send_recv():
                if rank == 0:
                    collective.send(mine, dst=1)
                    return None
                return collective.recv(src=0)

            def port_ppermute():
                return collective.ppermute(mine, "sp", [(0, 1), (1, 0)])

            def port_start_wait():
                return collective.ppermute_start(
                    mine, "sp", [(0, 1), (1, 0)]).wait()

            want0 = _bits(nbytes, dt, 100, dev) if rank == 1 else None
            runs = ((("torch.send_recv", raw_send_recv, want0),
                     ("torch.batch_isend_irecv", raw_batch, theirs))
                    if raw else
                    (("port.send_recv", port_send_recv, want0),
                     ("port.ppermute", port_ppermute, theirs),
                     ("port.ppermute_start", port_start_wait, theirs)))
            for name, run, want in runs:
                tdist.barrier()
                res[f"{name}/{key}"] = _entry(run, want)
                # what a rank has so far survives a crash in the next op
                with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
                    json.dump(res, f)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    tdist.barrier()
    collective.destroy_process_group()
    return 0


def _pair(root, tmp, raw, limit):
    """Run the two workers; their exit codes (None: killed at `limit` s)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--master", f"127.0.0.1:{port}", "--nnodes", "2", "--rank", str(r),
         "--devices", "0", os.path.abspath(__file__), "--worker", tmp]
        + (["--raw"] if raw else []),
        env=dict(os.environ, PYTHONPATH=root), cwd=root) for r in range(2)]
    t_end = time.monotonic() + limit
    codes = []
    try:
        for p in procs:
            try:
                codes.append(p.wait(
                    timeout=max(1.0, t_end - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return codes


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None)
    p.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    p.add_argument("--raw", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        return worker(args.worker, args.raw)
    if not torch.cuda.is_available():
        raise SystemExit("p2p_probe: no CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = {"card": _card(), "torch": torch.__version__,
           "cuda": torch.version.cuda}
    for part, raw, limit in (("torch", True, 120), ("port", False, 600)):
        tmp = tempfile.mkdtemp(prefix="p2p-probe-")
        codes = _pair(root, tmp, raw, limit)
        out[part] = {"exit_codes": codes}
        for r in range(2):
            path = os.path.join(tmp, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    out[part][f"rank{r}"] = json.load(f)
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0 if out["port"]["exit_codes"] == [0, 0] else 1


if __name__ == "__main__":
    raise SystemExit(main())
