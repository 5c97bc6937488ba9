"""A/B the blockwise cross-entropy kernels of several `csrc/` trees on one
card, in one process, at the training shape (x (16384, 2048), W (32000,
2048) bf16, every 2048th label ignored, 4 backward super-blocks of 8192):

    python -m paddle_tpu_torch.tools.ab_blockwise_ce [--step] [--profile] \
        [--out results.json] TREE [TREE ...]

Run from the repository root (it reuses chip_smoke.py's timing, checks and
training phases). Each TREE is a directory of CUDA sources laid out as
`paddle_tpu_torch/kernels/csrc` (a `git archive` of the parent's, an edited
variant); pass trees more than once, in the order parent, change, change,
parent, to see the spread. For each tree in turn, its kernels are built,
held against the twin with chip_smoke's rules (lse within 1e-4, the
forward's lse and the backward the same bits twice, dx and dW
entry by entry within 2^-6 of |ref| + row RMS + 2^-6 RMS), and timed by
CUDA-graph replay: the forward, dS, dx and dW over the 4 super-blocks, and
the whole backward (`ce_bwd`). Beside each product it prints the time of
`torch.matmul` of the same bare product at the same shapes (x . Wᵀ over
all of V for the forward; x . W_sᵀ, dS . W_s, dSᵀ . x per super-block, in
the same tree's run), a yardstick of GEMM efficiency only: it leaves out
the epilogues (the forward's stats, the exp pass, the f32 accumulator),
and the port never calls it. Each tree's registers and spills
of the CE kernels are printed from the build log when it compiles. With
`--step` it also trains phase 7 (dense loss, no CE launch: the control)
and phase 9 (bench.py's configuration: the blockwise loss) on that tree's
kernels, as `tools.ab_flash` does, and prints their step ms and tokens/s;
with `--profile` also their torch.profiler rows. With `--time-only` the
trees are timed without the twin and its checks: for a measurement variant
that leaves out part of the work (an epilogue, a k-tile), whose outputs are
not kept.
"""
from __future__ import annotations

import argparse
import json
import re
import sys

import torch

import chip_smoke as cs
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import blockwise_ce as bce
from paddle_tpu_torch.tools import ab_flash


def _registers(log):
    """{kernel: (registers, spill store bytes)} of the CE kernels in a build
    log (nvcc -Xptxas -v)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(ce_wgmmaILi\d|ce_gemmI\w*?Li\dE)", ln)
        if "Compiling entry function" in ln:
            name = m.group(1) if m else None
        elif name and "spill stores" in ln:
            spill = int(re.search(r"(\d+) bytes spill stores", ln).group(1))
            out[name] = (out.get(name, (0, 0))[0], spill)
        elif name and "Used" in ln and "registers" in ln:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            out[name] = (regs, out.get(name, (0, 0))[1])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", help="csrc/ trees, in ABBA order")
    ap.add_argument("--step", action="store_true",
                    help="also time phase 7's and phase 9's training steps")
    ap.add_argument("--profile", action="store_true",
                    help="with --step, trace one step of each")
    ap.add_argument("--time-only", action="store_true",
                    help="time the trees without holding them to the twin")
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("ab_blockwise_ce: needs a CUDA device")
    dev = torch.device("cuda")
    card = cs._card()
    print(card)
    g = torch.Generator(device=dev).manual_seed(12)
    n, d, v = 16384, 2048, 32000
    x = torch.randn(n, d, generator=g, device=dev).bfloat16()
    w = (torch.randn(v, d, generator=g, device=dev) * 0.02).bfloat16()
    lab = torch.randint(0, v, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    lab[2047::2048] = -100
    one = torch.ones((), device=dev)
    if not args.time_only:
        _, lse_r, count_r = bce.ce_fwd_ref(x, w, lab, 512)
        dx_r, dw_r = bce.ce_bwd_ref(x, w, lab, lse_r, count_r, one, 512)
    vs = bce.ce_super_block(n, v, 2)
    blocks = [(i * vs, min(vs, v - i * vs)) for i in range(-(-v // vs))]
    ws = torch.empty((n, vs), dtype=x.dtype, device=dev)
    acc = torch.empty((n, d), dtype=torch.float32, device=dev)
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    s_out = {vc: torch.empty((n, vc), dtype=x.dtype, device=dev)
             for _, vc in blocks + [(0, v)]}
    bound = 2 * n * d * v / cs.BF16_TENSOR_FLOPS * 1e3
    runs = []
    for tree in args.trees:
        with _build.sources(tree):
            regs = _registers(_build.build_info()["log"])
            if regs:
                print(f"[ab-regs] {tree} {regs}", flush=True)
            loss, lse, count = bce.ce_fwd(x, w, lab)
            ratio = same = None
            if not args.time_only:
                gx, gw = bce.ce_bwd(x, w, lab, lse, count, one)
                again = bce.ce_bwd(x, w, lab, lse, count, one)
                torch.cuda.synchronize()
                same = bool(torch.equal(again[0], gx)
                            and torch.equal(again[1], gw)
                            and torch.equal(bce.ce_fwd(x, w, lab)[1], lse))
                cs._check(f"{tree} lse", lse, lse_r, cs.F32_TOL)
                ratio = {k: cs._check_rows(f"{tree} {k}", a, b,
                                           cs.CE_BF16_TOL)[1]
                         for k, a, b in (("dx", gx, dx_r), ("dw", gw, dw_r))}
                del gx, gw, again
            scale = torch.where(lab != -100, one / count, 0.0).contiguous()
            ms = {"fwd": cs._time_ms(lambda: bce.ce_fwd(x, w, lab), [()],
                                     iters=10),
                  "dS": cs._time_ms(lambda: [bce._launch_dlogits(
                      x, w, lab, lse, scale, ws, v0, vc) for v0, vc in blocks],
                      [()], iters=4),
                  "dx": cs._time_ms(lambda: [bce._launch_dx(
                      ws, w, acc, dx, v0, vc, i == 0, i == len(blocks) - 1)
                      for i, (v0, vc) in enumerate(blocks)], [()], iters=4),
                  "dW": cs._time_ms(lambda: [bce._launch_dw(ws, x, dw, v0, vc)
                                             for v0, vc in blocks], [()],
                                    iters=4),
                  "bwd": cs._time_ms(lambda: bce.ce_bwd(x, w, lab, lse, count,
                                                        one), [()], iters=4)}
            matmul = {
                "fwd": cs._time_ms(lambda: torch.matmul(x, w.t(),
                                                        out=s_out[v]),
                                   [()], iters=10),
                "dS": cs._time_ms(lambda: [torch.matmul(
                    x, w[v0:v0 + vc].t(), out=s_out[vc])
                    for v0, vc in blocks], [()], iters=4),
                "dx": cs._time_ms(lambda: [torch.matmul(
                    ws[:, :vc], w[v0:v0 + vc], out=dx)
                    for v0, vc in blocks], [()], iters=4),
                "dW": cs._time_ms(lambda: [torch.matmul(
                    ws[:, :vc].t(), x, out=dw[v0:v0 + vc])
                    for v0, vc in blocks], [()], iters=4)}
            print(f"[ab] {tree}: " + ", ".join(
                f"{k} {t:.4f} ms" + (f" (matmul {matmul[k]:.4f})"
                                     if k in matmul else "")
                for k, t in ms.items())
                + f"; bound {bound:.4f} a product; dx / dW |err| / bound "
                f"{ratio}; same bits twice {same}", flush=True)
            run = {"tree": tree, "registers": regs, "ms": ms,
                   "matmul_ms": matmul, "bound_ms_per_product": bound,
                   "err_over_bound": ratio, "same_bits_twice": same}
            if args.step:
                run["steps"] = ab_flash._steps(tree, dev, card, args.profile)
        runs.append(run)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": runs}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
