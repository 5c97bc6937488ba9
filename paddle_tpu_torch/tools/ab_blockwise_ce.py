"""A/B the blockwise cross-entropy kernels of several `csrc/` trees on one
card, in one process, at the training shape (x (16384, 2048), W (32000,
2048) bf16, every 2048th label ignored):

    python -m paddle_tpu_torch.tools.ab_blockwise_ce TREE [TREE ...]

Run from the repository root (it reuses chip_smoke.py's timing and
checks). Each TREE is a directory of CUDA sources laid out as
`paddle_tpu_torch/kernels/csrc` (pass a tree more than once, in the
order parent, change, change, parent, to see the spread). Each is built,
held against the twin with chip_smoke's bf16 rule, and its forward, dS, dx,
dW and whole-backward times printed (CUDA-graph replay, ms).
"""
from __future__ import annotations

import sys

import torch

import chip_smoke as cs
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import blockwise_ce as bce


def main(trees):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    n, d, v = 16384, 2048, 32000
    x = torch.randn(n, d, generator=g, device=dev).bfloat16()
    w = (torch.randn(v, d, generator=g, device=dev) * 0.02).bfloat16()
    lab = torch.randint(0, v, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    lab[2047::2048] = -100
    one = torch.ones((), device=dev)
    loss_r, lse_r, count_r = bce.ce_fwd_ref(x, w, lab, 512)
    dx_r, dw_r = bce.ce_bwd_ref(x, w, lab, lse_r, count_r, one, 512)
    vs = bce.ce_super_block(n, v, 2)
    blocks = [(i * vs, min(vs, v - i * vs)) for i in range(-(-v // vs))]
    ws = torch.empty((n, vs), dtype=x.dtype, device=dev)
    acc = torch.empty((n, d), dtype=torch.float32, device=dev)
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    print(cs._card())
    for tree in trees:
        with _build.sources(tree):
            loss, lse, count = bce.ce_fwd(x, w, lab)
            gx, gw = bce.ce_bwd(x, w, lab, lse, count, one)
            torch.cuda.synchronize()
            cs._check(f"{tree} lse", lse, lse_r, cs.F32_TOL)
            ratio = {k: cs._check_rows(f"{tree} {k}", a, b, cs.CE_BF16_TOL)[1]
                     for k, a, b in (("dx", gx, dx_r), ("dw", gw, dw_r))}
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
            print(f"[ab] {tree}: " + ", ".join(f"{k} {t:.4f} ms"
                                               for k, t in ms.items())
                  + f"; dx / dW |err| / bound {ratio}", flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        sys.exit("usage (on a CUDA card): python -m "
                 "paddle_tpu_torch.tools.ab_blockwise_ce TREE [TREE ...]")
    main(sys.argv[1:])
