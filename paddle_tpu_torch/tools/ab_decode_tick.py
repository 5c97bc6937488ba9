"""A/B the serving engine's decode tick of several checkouts of the
repository on one card:

    python -m paddle_tpu_torch.tools.ab_decode_tick [--repeat 5] \
        TREE [TREE ...]

Each TREE is the root of a checkout (it holds `chip_smoke.py` and
`paddle_tpu_torch/`); pass them in the order parent, change, change,
parent to see the spread. For each in turn, one process started from it
builds its kernels from its own sources, times `paged_decode_attention`
alone at chip_smoke's phase 3 shape (bf16 pools: host microseconds a
call over 200 calls queued without a wait, and device milliseconds a
call), then builds Llama-3-8B (bf16, random weights from seed 0, the
fused norm and RoPE), serves chip_smoke's 8 prompts of 64 new tokens
(one joining after the first tick) REPEAT times over bf16 KV pages,
converts the model with `quantize_weight_only` and serves them REPEAT
times over int8 pages. Where the tree's engine captures its tick in a
CUDA graph (it has `_eager_program`), each KV type is also served REPEAT
times through the private eager tick, labelled `eager`; the tree's
default path is labelled by the KV type alone. It prints each run's
tick (host wall ms of 4 decode steps of 8 slots, the warm-up tick and
the capture left out), decode tokens/s, the batched prefill calls' host
wall (ms, each call closed by the copy of its logits to the host, so
the device work is in it) and prefill tokens/s, and their medians over
all runs but the first (which warms the allocator).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

# runs inside each tree: only what every checkout since slice 4 has
_CHILD = r"""
import gc, json, sys, time
import numpy as np
import torch
import chip_smoke as cs
from paddle_tpu_torch.inference.paged import PagedKVEngine
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama3_8b_config
from paddle_tpu_torch.quantization import quantize_weight_only

repeat = int(sys.argv[1])
dev = torch.device("cuda")
out = {}
rng = np.random.default_rng(0)
b, hq, hk, d, ps, mp, npages = 8, 32, 8, 128, 16, 80, 641
g = torch.Generator(device=dev).manual_seed(0)
q = torch.randn(b, hq, d, generator=g, device=dev).bfloat16()
kp, vp = (torch.randn(npages, hk, ps, d, generator=g, device=dev)
          .bfloat16() for _ in range(2))
bt = torch.from_numpy(rng.permutation(np.arange(1, npages))[:b * mp]
                      .reshape(b, mp).astype(np.int32)).to(dev)
lens = torch.tensor([0, 15, 16, 1000, 1279, 517, 64, 300],
                    dtype=torch.int32, device=dev)
for _ in range(20):
    pa.paged_decode_attention(q, kp, vp, bt, lens)
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(200):
    pa.paged_decode_attention(q, kp, vp, bt, lens)
host = time.perf_counter() - t0
torch.cuda.synchronize()
out["decode_call_host_us"] = host / 200 * 1e6
out["decode_call_ms"] = cs._time_ms(
    lambda: pa.paged_decode_attention(q, kp, vp, bt, lens), [()])
del q, kp, vp
cfg = llama3_8b_config(fused_norm=True, fused_rope=True)
model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
prompts = cs._prompts(8, cfg.vocab_size, seed=0)
geom = dict(max_slots=8, page_size=16, num_pages=641,
            max_pages_per_slot=80, steps_per_tick=4)


def serve(kv, eager):
    eng = PagedKVEngine(model, device=dev, kv_dtype=kv, **geom)
    if eager:
        eng._tick_program = eng._eager_program
    reqs = [eng.submit(p, 64) for p in prompts[:7]]
    eng.step()
    reqs.append(eng.submit(prompts[7], 64))
    eng.run_until_idle()
    st = eng.stats
    return (st["tick_s"] / st["ticks"] * 1e3,
            st["decode_tokens"] / st["tick_s"],
            st["prefill_s"] * 1e3,
            st["prefill_tokens"] / st["prefill_s"])


paths = [False] + ([True] if hasattr(PagedKVEngine, "_eager_program")
                   else [])
for kv in ("bf16", "int8"):
    if kv == "int8":
        quantize_weight_only(model)
    for eager in paths:
        runs = []
        for _ in range(repeat):
            runs.append(serve(kv, eager))
            gc.collect()
        out[kv + (" eager" if eager else "")] = runs
print("@@" + json.dumps(out))
"""


def run_tree(tree, repeat):
    """The child's measurements from a process started in `tree`."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(repeat)],
                          cwd=tree, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    line = [x for x in proc.stdout.splitlines() if x.startswith("@@")][-1]
    return json.loads(line[2:])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("trees", nargs="+", help="checkout roots")
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    for tree in args.trees:
        res = run_tree(Path(tree).resolve(), args.repeat)
        parts = [f"decode call {res['decode_call_host_us']:.2f} us host, "
                 f"{res['decode_call_ms']:.4f} ms device"]
        for kv in [k for k in res if k.startswith(("bf16", "int8"))]:
            cols = list(zip(*res[kv]))
            for (name, nd), col in zip((("tick ms", 2), ("tok/s", 1),
                                        ("prefill ms", 2),
                                        ("prefill tok/s", 1)), cols):
                parts.append(
                    f"{kv} {name} {[round(v, nd) for v in col]} median "
                    f"{statistics.median(col[1:] or col):.{nd}f}")
        print(f"[tick] {tree}: " + "; ".join(parts), flush=True)


if __name__ == "__main__":
    main()
