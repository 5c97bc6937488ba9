"""A/B the W8A16 kernels on one card, in one process: `csrc/` trees at
chip_smoke.py's phase 3 shapes (Llama-3-8B's five projection shapes at
M = 8, at the engine's first prefill call's M and at the late joiner's)
and, with --crossover, both routes of the wrapper (the 16-row split-K
kernel and the wgmma kernel with either row tile) at a Llama-3-8B
layer's four projection shapes for each listed M; with --tiles, both
row tiles of the wgmma kernel at the prefill shapes:

    python -m paddle_tpu_torch.tools.ab_w8a16 [--crossover 16,32,64] \
        [--tiles] [TREE ...]

Run from the repository root (it reuses chip_smoke.py's shapes, timing
and rule). Each TREE is a directory of CUDA sources laid out as
`paddle_tpu_torch/kernels/csrc` (a scratch copy with a variant, or the
parent revision's, unpacked by `git archive`); pass a tree more than once
to see the spread. A tree from before the wgmma kernel (no
`ptt_w8a16_matmul_wgmma` in its library) is run as its own revision ran
it: the 16-row tile up to 64 rows, the 128-row mma.sync tile above. With
no TREE the package's own sources are timed. Every case is first held
against the plain twin by chip_smoke's entry-by-entry rule (2^-7 in
bf16), then timed by CUDA-graph replay over weight sets that miss the
50 MB L2, in ms.
"""
from __future__ import annotations

import argparse
import contextlib

import torch

import chip_smoke as cs
from paddle_tpu_torch.inference.paged import PagedKVEngine
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import quant_matmul as qm

CROSSOVER_SHAPES = (("q_proj", 4096, 4096), ("k_proj", 4096, 1024),
                    ("gate_proj", 4096, 14336), ("down_proj", 14336, 4096))


def prefill_ms():
    """M of the engine's first prefill call and of the late joiner's, for
    chip_smoke's 8 prompts."""
    call_ms = cs._prefill_call_ms(cs._prompts(8, 128256, seed=0), 7,
                                  PagedKVEngine._bucket)
    return call_ms[0], int(call_ms[-1])


@contextlib.contextmanager
def route(lib, force=None):
    """Within the block the wrapper takes `force` ("split_k", or
    "wgmma:256" / "wgmma:128" for the wgmma kernel's row tile), or for a
    library without the wgmma kernel its own revision's plan."""
    plan = qm.plan
    legacy = not hasattr(lib, "ptt_w8a16_matmul_wgmma")
    if force == "split_k":
        qm.plan = lambda M, K, N, sms=132: (
            "split_k", 16, qm._k_splits(M, K, N, 16, sms))
    elif force:
        bm = int(force.split(":")[1])
        qm.plan = lambda M, K, N, sms=132: ("wgmma", bm, 1)
    elif legacy:
        def old(M, K, N, sms=132):
            bm = 16 if M <= 64 else 128
            return "split_k", bm, qm._k_splits(M, K, N, bm, sms)
        qm.plan = old
    try:
        yield
    finally:
        qm.plan = plan


def case(dev, M, K, N, g):
    """(x, weight sets) for one shape: enough (qw, scale) sets that the
    timed reads miss the L2."""
    n_sets = max(1, min(40, -(-150 * 2 ** 20 // (K * N))))
    x = torch.randn(M, K, generator=g, device=dev).bfloat16()
    ws = [(torch.randint(-127, 128, (K, N), generator=g, device=dev,
                         dtype=torch.int8),
           torch.rand(N, generator=g, device=dev) * 0.01 + 1e-3)
          for _ in range(n_sets)]
    return x, ws


def measure(x, ws, label):
    """Hold the wrapper to the twin, then time it; ms per call."""
    out = qm.weight_only_int8_matmul(x, *ws[0])
    ref = qm.weight_only_int8_matmul_ref(x, *ws[0])
    _, ratio = cs._check_rows(label, out, ref, cs.BF16_TOL)
    ms = cs._time_ms(lambda qw, s: qm.weight_only_int8_matmul(x, qw, s), ws,
                     iters=50 if x.shape[0] <= 64 else 10)
    return ms, ratio


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--crossover", default="",
                    help="comma-separated M to time both routes at")
    ap.add_argument("--tiles", action="store_true",
                    help="also time both row tiles of the wgmma kernel at "
                         "the prefill shapes")
    ap.add_argument("trees", nargs="*", help="csrc trees")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_w8a16 needs a CUDA card")
    dev = torch.device("cuda")
    print(cs._card(), flush=True)
    ms_list = (8,) + prefill_ms()
    cross = [int(m) for m in args.crossover.split(",") if m]
    for tree in args.trees or [str(_build._CSRC)]:
        g = torch.Generator(device=dev).manual_seed(0)
        with _build.sources(tree) as lib:
            rows = []
            for what, K, N, _ in cs.W8A16_SHAPES:
                for M in ms_list:
                    x, ws = case(dev, M, K, N, g)
                    with route(lib):
                        name, bm, splits = qm.plan(M, K, N)
                        ms, r = measure(x, ws, f"{tree} {what} M={M}")
                    rows.append(f"{what} M {M} {name} (bm {bm}, {splits} "
                                f"splits) {ms:.4f} ms (rule {r:.3g})")
                    del x, ws
            print(f"[ab] {tree}: " + "; ".join(rows), flush=True)
            if not hasattr(lib, "ptt_w8a16_matmul_wgmma"):
                continue
            if args.tiles:
                for what, K, N, _ in cs.W8A16_SHAPES:
                    cells = []
                    for M in ms_list[1:]:
                        x, ws = case(dev, M, K, N, g)
                        for force in ("wgmma:256", "wgmma:128"):
                            with route(lib, force):
                                ms, _ = measure(x, ws, f"{what} {force}")
                            cells.append(f"M {M} {force} {ms:.4f}")
                        del x, ws
                    print(f"[tiles] {tree} {what}: " + "; ".join(cells)
                          + " ms", flush=True)
            for what, K, N in CROSSOVER_SHAPES if cross else ():
                cells = []
                for M in cross:
                    x, ws = case(dev, M, K, N, g)
                    t = {}
                    for force in ("split_k", "wgmma:256", "wgmma:128"):
                        with route(lib, force):
                            t[force], _ = measure(
                                x, ws, f"{tree} {what} M={M} {force}")
                    cells.append(f"M {M}: " + " / ".join(
                        f"{k} {v:.4f}" for k, v in t.items()) + " ms")
                    del x, ws
                print(f"[crossover] {tree} {what} (K {K}, N {N}): "
                      + "; ".join(cells), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
