"""A/B the paged-decode kernel on one card, in one process: `csrc/` trees
and the pages per split P, at phase 3's
serving shape of chip_smoke.py (b 8, 32/8 heads, d 128, page 16, lens
0/15/16/1000/1279/517/64/300, 80 pages a slot) and at the full window
(every slot at lens 1279), over bf16 and over int8 pools:

    python -m paddle_tpu_torch.tools.ab_paged_decode [--pages 2,4,8] \
        [TREE ...]

Run from the repository root (it reuses chip_smoke.py's timing and
checks). Each TREE is a directory of CUDA sources laid out as
`paddle_tpu_torch/kernels/csrc` (a variant to try is a scratch copy of
it); pass a tree more than once to see the spread. With no TREE the
package's own sources are timed; with no --pages, the P that the
wrapper's `plan` picks. Every case is first held against
the plain twin within chip_smoke's f32 tolerance (1e-4), then timed by
CUDA-graph replay over 4 pool sets (they miss the 50 MB L2), in ms,
and its device time split between the kernels it launches
(torch.profiler over eager calls).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

import chip_smoke as cs
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import paged_attention as pa

B, HQ, HK, D, PS, NPAGES, MP = 8, 32, 8, 128, 16, 641, 80
LENS = [0, 15, 16, 1000, 1279, 517, 64, 300]
FULL = [MP * PS - 1] * B


def inputs(dev):
    """Block tables, the two lens tensors and 4 sets each of bf16 and
    int8 pools (q, k, v[, k_scale, v_scale]), as chip_smoke builds them."""
    g = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    bt = torch.from_numpy(rng.permutation(np.arange(1, NPAGES))[:B * MP]
                          .reshape(B, MP).astype(np.int32)).to(dev)
    lens = {name: torch.tensor(v, dtype=torch.int32, device=dev)
            for name, v in (("serving", LENS), ("full", FULL))}

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).bfloat16()

    def codes():
        return torch.randint(-127, 128, (NPAGES, HK, PS, D), generator=g,
                             device=dev, dtype=torch.int8)

    def scales():
        return torch.rand(NPAGES, HK, generator=g, device=dev) * 0.02 + 1e-3

    bf16 = [(randn(B, HQ, D), randn(NPAGES, HK, PS, D),
             randn(NPAGES, HK, PS, D)) for _ in range(4)]
    int8 = [(randn(B, HQ, D), codes(), codes(), scales(), scales())
            for _ in range(4)]
    return bt, lens, {"bf16": bf16, "int8": int8}


def call(fn, bt, lens, pools):
    q, kp, vp, *sc = pools
    kw = dict(k_scale=sc[0], v_scale=sc[1]) if sc else {}
    return fn(q, kp, vp, bt, lens, **kw)


def by_kernel(fn, psets, iters=20):
    """Device ms per call of each CUDA kernel that fn launches
    (torch.profiler over `iters` eager calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn(*psets[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*psets[i % len(psets)])
        torch.cuda.synchronize()
    return {_short(e.key): cs._device_us(e) / 1e3 / iters
            for e in prof.key_averages() if cs._device_us(e) > 0}


def _short(key):
    """A kernel's bare name from the profiler's signature."""
    key = key.replace("(anonymous namespace)::", "")
    return key.split("<")[0].split("(")[0].split()[-1]


def measure(label, bt, lens, sets):
    """Check every (pools, lens) case against the twin, then time it, and
    split its time between the kernels it launches."""
    ms, parts = {}, {}
    for kind, psets in sets.items():
        for shape, ln in lens.items():
            cs._check(f"{label} {kind} {shape}",
                      call(pa.paged_decode_attention, bt, ln, psets[0]),
                      call(pa.paged_decode_attention_ref, bt, ln, psets[0]),
                      cs.F32_TOL)

            def fn(*p, ln=ln):
                return call(pa.paged_decode_attention, bt, ln, p)

            ms[f"{kind} {shape}"] = cs._time_ms(fn, psets)
            parts[f"{kind} {shape}"] = by_kernel(fn, psets)
    print(f"[ab] {label}: " + ", ".join(f"{k} {t:.4f} ms"
                                        for k, t in ms.items()), flush=True)
    for k, d in parts.items():
        print(f"[ab]   {k} by kernel (profiler, eager): " + ", ".join(
            f"{n} {t:.4f} ms" for n, t in d.items()), flush=True)
    return ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pages", default="",
                    help="comma-separated pages per split to time")
    ap.add_argument("trees", nargs="*", help="csrc trees")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_paged_decode needs a CUDA card")
    dev = torch.device("cuda")
    print(cs._card())
    bt, lens, sets = inputs(dev)
    pages = [int(p) for p in args.pages.split(",") if p]
    for tree in args.trees or [str(_build._CSRC)]:
        with _build.sources(tree):
            if not pages:
                measure(tree, bt, lens, sets)
            for per in pages:
                plan = pa.plan
                pa.plan = lambda mp, ps, per=per: (per, -(-mp // per))
                try:
                    measure(f"{tree} P={per}", bt, lens, sets)
                finally:
                    pa.plan = plan


if __name__ == "__main__":
    main()
