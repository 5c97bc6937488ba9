"""A/B the RMSNorm and RoPE kernels of several `csrc/` trees on one card,
in one process:

    python -m paddle_tpu_torch.tools.ab_fused_norm [--step] [--profile] \
        [--plans] [--out results.json] TREE [TREE ...]

Run from the repository root (it reuses chip_smoke.py's RMSNorm phase and
training phases). Each TREE is a directory of CUDA sources laid out as
`paddle_tpu_torch/kernels/csrc` (a `git archive` of the parent's, an
edited variant); pass trees more than once, in the order parent, change,
change, parent, to see the spread. For each tree in turn, its kernels are
built and chip_smoke's RMSNorm rules run on them (h bit-equal to x +
residual, y and dh within a rounding step, dw to its largest entry and
the same bits twice), then the cases are timed by CUDA-graph replay: the
forward at (8, 4096) with and without a residual, (6370, 4096) with a
residual and (16384, 2048) with a residual and rstd; the backward at
(16384, 2048) with and without gh. Each prints beside its bound and the
library yardsticks (F.rms_norm at decode; x + residual then F.rms_norm
with a residual; none for the backward). Then chip_smoke's RoPE phase
runs on the tree's kernels: forward and backward held bit for bit
against the twin in f32 and bf16, then timed in bf16 at the decode
(8, 1, 32|8, 128), first batched prefill call's (1, 5460, 32|8, 128) and
training (8, 2048, 32|4, 64) shapes, q and k, each beside its bound and
the twin (no single PyTorch call computes RoPE). With `--step` it also
trains phase 7 (TinyLlama-1.1B, dense loss, fused norm and RoPE) and phase 9
(bench.py's configuration, plain norm) on that tree's kernels, as
`tools.ab_flash` does; with `--profile` also their torch.profiler rows,
the RMSNorm kernels' own among them. With `--plans` it also times each
tree's kernels over launch plans other than `fused_norm.plan`'s (threads
a row, rows a block and, for the backward, blocks an SM) at the training
shape, each held to the twin first. Each tree's registers and spills of
the RMSNorm and RoPE instances are printed from the build log when it
compiles.

A tree from before `ptt_rmsn_fwd` has the entry points
`ptt_rms_norm_residual` and `ptt_rms_norm_bwd`, with a backward grid of
at most 264 blocks: its kernels are launched through those, as that
revision did. A tree from before `ptt_rope` runs its RoPE as that
revision did (`tools.ab_flash.legacy_rope`).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import sys

import torch

import chip_smoke as cs
from paddle_tpu_torch.inference.paged import PagedKVEngine
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import fused_norm as fn
from paddle_tpu_torch.tools import ab_flash

_LEGACY_BWD_BLOCKS = 264
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _ptr(t):
    return None if t is None else t.data_ptr()


@contextlib.contextmanager
def _legacy(lib):
    """Route the wrappers to a pre-plan library's own entry points."""
    lib.ptt_rms_norm_residual.argtypes = [_P] * 6 + [_I, _I, _F, _I, _P]
    lib.ptt_rms_norm_bwd.argtypes = [_P] * 7 + [_I] * 4 + [_P]
    code = fn._DTYPE_CODE

    def fwd(x, residual, weight, y, h, rstd, n, d, eps, p):
        return lib.ptt_rms_norm_residual(
            x.data_ptr(), _ptr(residual), weight.data_ptr(), y.data_ptr(),
            None if residual is None else h.data_ptr(), _ptr(rstd), n, d,
            eps, code[x.dtype], fn._stream(x))

    def bwd(h, weight, rstd, gy, gh, dh, dw_part, n, d, p):
        return lib.ptt_rms_norm_bwd(
            h.data_ptr(), weight.data_ptr(), rstd.data_ptr(), gy.data_ptr(),
            _ptr(gh), dh.data_ptr(), dw_part.data_ptr(), n, d,
            dw_part.shape[0], code[h.dtype], fn._stream(h))

    plan = fn.plan

    def legacy_plan(n, d, dtype, aligned=True, backward=False, **kw):
        p = plan(n, d, dtype, aligned, backward, **kw)
        return p._replace(blocks=min(n, _LEGACY_BWD_BLOCKS)) if backward \
            else p

    saved = fn._launch_fwd, fn._launch_bwd, fn.plan
    fn._launch_fwd, fn._launch_bwd, fn.plan = fwd, bwd, legacy_plan
    try:
        yield
    finally:
        fn._launch_fwd, fn._launch_bwd, fn.plan = saved


def _registers(log):
    """{instance: (registers, stack bytes)} of the RMSNorm and RoPE kernels
    in a build log (nvcc -Xptxas -v); each entry function's lines up to
    the next one's."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = None
            m = re.search(r"(rmsn_(?:fwd|bwd)_kernel)I(\w+?)Li(\d+)ELi(\d+)"
                          r"ELb(\d)", ln)
            r = re.search(r"(rope_kernel)I(\w+?)Li(\d+)ELi(\d+)E", ln)
            if m:
                kind, t, v, k, flag = m.groups()
                name = (f"{kind}<{'bf16' if 'bfloat' in t else 'f32'},{v},"
                        f"{k},{flag}>")
            elif r:
                kind, t, v, h = r.groups()
                name = (f"{kind}<{'bf16' if 'bfloat' in t else 'f32'},{v},"
                        f"{h}>")
        elif name and "Used" in ln and "registers" in ln:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            out[name] = (regs, out.get(name, (0, 0))[1])
        elif name and "stack frame" in ln:
            out[name] = (out.get(name, (0, 0))[0],
                         int(ln.split()[0]))
    return out


def _plans(tree, dev):
    """Backward at (16384, 2048) bf16, with and without gh, and the
    forward with a residual and rstd, over launch plans: ms of each."""
    g = torch.Generator(device=dev).manual_seed(1)
    n, d, eps = 16384, 2048, 1e-5
    h, gy, gh, r = (torch.randn(n, d, generator=g, device=dev)
                    .to(torch.bfloat16) for _ in range(4))
    w = torch.randn(d, generator=g, device=dev).to(torch.bfloat16)
    _, _, rstd = fn._norm_fwd(h, w, None, eps, True)
    plan, out = fn.plan, []

    def forced(tpr, rows, per_sm):
        def p(n_, d_, dtype, aligned=True, backward=False, sms=fn._SMS):
            base = plan(n_, d_, dtype, aligned, backward, sms)
            need = -(-d_ // base.vec // tpr)
            groups = -(-n_ // rows)
            chunks = min(c for c in fn._CHUNKS[base.vector] if c >= need)
            return base._replace(
                threads_per_row=tpr, rows_per_block=rows, chunks=chunks,
                blocks=min(groups, sms * per_sm) if backward else groups)
        return p

    for tpr in (32, 64, 128, 256):
        for threads in (256, 512):
            rows = threads // tpr
            for per_sm in (1, 2, 4):
                fn.plan = forced(tpr, rows, per_sm)
                try:
                    row = {"tpr": tpr, "rows": rows, "per_sm": per_sm}
                    for tag, ghx in (("bwd", None), ("bwd_gh", gh)):
                        args = (h, w, rstd, gy, ghx)
                        ref = fn.rms_norm_residual_bwd_ref(*args)
                        got = fn.rms_norm_residual_bwd(*args)
                        cs._check(f"plan dh {row}", got[0], ref[0],
                                  cs.BF16_TOL)
                        cs._check_to_max(f"plan dw {row}", got[1], ref[1],
                                         cs.BF16_TOL)
                        row[tag] = cs._time_ms(fn.rms_norm_residual_bwd,
                                               [args], iters=20)
                    if per_sm == 1:
                        y = fn._norm_fwd(h, w, r, eps, True)[0]
                        cs._check(f"plan y {row}", y,
                                  fn.rms_norm_residual_ref(h, w, r, eps)[0],
                                  cs.BF16_TOL)
                        row["fwd"] = cs._time_ms(
                            lambda a, b, c: fn._norm_fwd(a, c, b, eps, True),
                            [(h, r, w)], iters=20)
                finally:
                    fn.plan = plan
                out.append(row)
                print(f"[ab-plan] {tree} {row}", flush=True)
    return out


def _kernels(tree, dev):
    """chip_smoke's RMSNorm entries on `tree`'s kernels, and one line per
    case."""
    e = cs.norm_phases(dev, fn)
    f, b = e["rms_norm_residual"], e["rms_norm_residual_bwd"]
    cases = {
        "decode": (f["ms"], f["bound_ms"], f["library_ms"]),
        "decode_res": (f["residual_ms"], f["residual_bound_ms"],
                       f["residual_library_ms"]),
        "prefill_res": (f["prefill_ms"], f["prefill_bound_ms"],
                        f["prefill_library_ms"]),
        "train_res_rstd": (f["train_ms"], f["train_bound_ms"],
                           f["train_library_ms"]),
        "bwd": (b["ms"], b["bound_ms"], None),
        "bwd_gh": (b["gh_ms"], b["gh_bound_ms"], None)}
    out = {}
    for name, (ms, bound, lib) in cases.items():
        out[name] = {"ms": ms, "bound_ms": bound, "library_ms": lib,
                     "share_of_bound": bound / ms}
        yard = "" if lib is None else f", library {lib:.4f}"
        print(f"[ab] {tree} {name}: {ms:.4f} ms (bound {bound:.4f}, "
              f"{bound / ms:.0%}{yard})", flush=True)
    out["plans"] = {"decode": f["plan"], "prefill": f["prefill_plan"],
                    "train": f["train_plan"], "bwd": b["plan"]}
    out["max_abs_err"] = {"fwd": f["max_abs_err"], "bwd": b["max_abs_err"]}
    return out


def _rope(tree, dev, prefill_m):
    """chip_smoke's RoPE entries on `tree`'s kernels, and one line per
    case."""
    out = {}
    for name, e in cs.rope_phases(dev, fn, prefill_m).items():
        for tag in ("decode", "prefill", "train"):
            for kv in ("", "k_"):
                pre = f"{tag}_{kv}"
                ms, bound = e[pre + "ms"], e[pre + "bound_ms"]
                out[f"{name} {tag} {kv[:-1] or 'q'}"] = {
                    "shape": e[pre + "shape"], "ms": ms, "bound_ms": bound,
                    "plain_ms": e[pre + "plain_ms"],
                    "share_of_bound": bound / ms}
                print(f"[ab] {tree} {name} {tag} {kv[:-1] or 'q'} "
                      f"{e[pre + 'shape']}: {ms:.4f} ms (bound {bound:.4f}, "
                      f"{bound / ms:.0%}; plain {e[pre + 'plain_ms']:.4f})",
                      flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", help="csrc/ trees, in ABBA order")
    ap.add_argument("--step", action="store_true",
                    help="also time phase 7's and phase 9's training steps")
    ap.add_argument("--profile", action="store_true",
                    help="with --step, trace one step of each")
    ap.add_argument("--plans", action="store_true",
                    help="also time other launch plans at the training "
                         "shape")
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("ab_fused_norm: needs a CUDA device")
    dev = torch.device("cuda")
    card = cs._card()
    print(card)
    prefill_m = cs._prefill_call_ms(cs._prompts(8, 128256, seed=0), 7,
                                    PagedKVEngine._bucket)[0]
    runs = []
    for tree in args.trees:
        with _build.sources(tree) as lib, contextlib.ExitStack() as legacy:
            old = not hasattr(lib, "ptt_rmsn_fwd")
            old_rope = not hasattr(lib, "ptt_rope")
            regs = _registers(_build.build_info()["log"])
            if regs:
                print(f"[ab-regs] {tree} {regs}", flush=True)
            if old:
                legacy.enter_context(_legacy(lib))
            if old_rope:
                legacy.enter_context(ab_flash.legacy_rope(lib))
            run = {"tree": tree, "legacy_entry_points": old,
                   "legacy_rope": old_rope, "registers": regs,
                   "kernels": _kernels(tree, dev),
                   "rope": _rope(tree, dev, prefill_m)}
            if args.plans and not old:
                run["plans"] = _plans(tree, dev)
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
