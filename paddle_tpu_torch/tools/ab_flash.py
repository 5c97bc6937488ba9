"""A/B the flash-attention kernels of several `csrc/` trees on one card, in
one process:

    python -m paddle_tpu_torch.tools.ab_flash [--step] [--profile] \
        [--out results.json] TREE [TREE ...]

Run from the repository root (it reuses chip_smoke.py's flash phase, timing
and training phases). Each TREE is a directory of CUDA sources laid out as
`paddle_tpu_torch/kernels/csrc` (a `git archive` of the parent's, an edited
variant); pass trees more than once, in the order parent, change, change,
parent, to see the spread. For each tree in turn, its kernels are built and
chip_smoke's phase 4 flash entries run on them: the forward, dq and dk/dv
held to the f32 rule at small shapes and to the bf16 row rule at
(8, 2048, 32/4, 64) and (1, 4096, 32/8, 128), causal, then timed by
CUDA-graph replay beside SDPA's forward and backward. It prints fwd, dq,
dk/dv and pair ms per shape. With `--step` it also trains phase 7
(TinyLlama-1.1B, dense loss, fused norm and RoPE, 5 timed steps) and phase 9
(bench.py's configuration, 10 timed steps) on that tree's kernels and
prints their step ms and tokens/s; with `--profile` also their
torch.profiler rows (device busy ms, idle share, the top kernels). The
steps run this checkout's Python on each tree's kernels; a tree from
before `ptt_rope` gets its RoPE launched as that revision launched it
(`legacy_rope`).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import sys

import torch

import chip_smoke as cs
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import blockwise_ce as bce
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_norm as fn
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels import quant_matmul as qm

_MODULES = (fn.launches, pa.launches, fa.launches, bce.launches, qm.launches)


def _reset():
    for d in _MODULES:
        for k in d:
            d[k] = 0


def _counters():
    return {k: v for d in _MODULES for k, v in d.items()}


def _kernels(tree, dev):
    """chip_smoke's flash entries on `tree`'s kernels, and one summary line
    per shape."""
    entries = cs.flash_phases(dev, fa)
    dq, dkv = entries["flash_bwd_dq"], entries["flash_bwd_dkv"]
    fwd = entries["flash_fwd"]
    out = {}
    for pre, tag in (("", "train"), ("llama3_", "llama3")):
        row = {"fwd": fwd[pre + "ms"], "dq": dq[pre + "ms"],
               "dkv": dkv[pre + "ms"],
               "pair": dq[pre + "ms"] + dkv[pre + "ms"],
               "pair_bound": dq[pre + "bound_ms"] + dkv[pre + "bound_ms"],
               "sdpa_fwd": fwd[pre + "library_ms"],
               "sdpa_bwd": dq[pre + "library_ms"],
               "err_over_bound": {k: e[pre + "err_over_bound"]
                                  for k, e in entries.items()}}
        out[tag] = row
        print(f"[ab] {tree} {dq[pre + 'shape']}: fwd {row['fwd']:.4f} ms, "
              f"dq {row['dq']:.4f}, dk/dv {row['dkv']:.4f}, pair "
              f"{row['pair']:.4f} (bound {row['pair_bound']:.4f}); sdpa fwd "
              f"{row['sdpa_fwd']:.4f}, bwd {row['sdpa_bwd']:.4f}; |err| / "
              f"bound {row['err_over_bound']}", flush=True)
    return out


@contextlib.contextmanager
def legacy_rope(lib):
    """Route the RoPE wrapper to a library from before `ptt_rope`: its
    `ptt_rope_apply`, which takes no sign, on the sin table negated by
    torch.neg for the backward, as that revision launched it."""
    lib.ptt_rope_apply.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    lib.ptt_rope_apply.restype = ctypes.c_int

    def launch(x, cos_f, sin_f, out, sign):
        b, s, h, d = x.shape
        sin = sin_f if sign > 0 else torch.neg(sin_f)
        return lib.ptt_rope_apply(
            x.data_ptr(), cos_f.data_ptr(), sin.data_ptr(), out.data_ptr(),
            b * s, h, d, fn._DTYPE_CODE[x.dtype], fn._stream(x))

    saved, fn._launch_rope = fn._launch_rope, launch
    try:
        yield
    finally:
        fn._launch_rope = saved


def _steps(tree, dev, card, profile):
    """Phase 7's and phase 9's steps on the kernels of the library in use
    (`tree`'s, inside `_build.sources`)."""
    lib = _build.load_library()
    out = {}
    with (contextlib.nullcontext() if hasattr(lib, "ptt_rope")
          else legacy_rope(lib)):
        for tag, phase in (("phase7", cs.training_phase),
                           ("phase9", cs.bench_training_phase)):
            m = phase(dev, _counters, _reset, card, profile)
            out[tag] = {k: m[k] for k in ("step_ms", "tokens_per_s", "mfu",
                                          "losses", "launches_per_step")}
            if profile:
                out[tag]["profile"] = m["profile"]
            print(f"[ab-step] {tree} {tag}: step {m['step_ms']:.1f} ms, "
                  f"{m['tokens_per_s']:.1f} tokens/s", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", help="csrc/ trees, in ABBA order")
    ap.add_argument("--step", action="store_true",
                    help="also time phase 7's and phase 9's training steps")
    ap.add_argument("--profile", action="store_true",
                    help="with --step, trace one step of each")
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("ab_flash: needs a CUDA device")
    dev = torch.device("cuda")
    card = cs._card()
    print(card)
    runs = []
    for tree in args.trees:
        with _build.sources(tree):
            run = {"tree": tree, "kernels": _kernels(tree, dev)}
            if args.step:
                run["steps"] = _steps(tree, dev, card, args.profile)
        runs.append(run)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": runs}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
