#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA card.

    python3 chip_smoke.py [--profile] [--out results.json]

Phases, each of which fails the run (non-zero exit) on any error:

1. the card's name and power limit (nvidia-smi);
2. the CUDA kernels built from paddle_tpu_torch/kernels/csrc;
3. every kernel of the serving path held against its plain PyTorch twin
   on the card at the shapes the path gives it (bf16 and f32), timed
   beside the twin, one library call where there is one, and the least
   time the card could take (bytes / 3.35 TB/s, or operations / peak);
   with them the int8 serving path's kernels: the int8 decode kernel at
   the same shapes (bf16 and f32 q; SDPA over the gathered, dequantized
   window as yardstick), both decode kernels also at the full window
   (every slot at its block table's last position), and W8A16 at every
   distinct Llama-3-8B projection shape at M = 8 (the 16-row split-K
   kernel), at the M of the engine's first batched prefill call and at
   the late joiner's (the wgmma kernel), each row with its route
   (torch.matmul over the dequantized bf16 weight, the unquantized
   layer's cost, as yardstick), and in f32 at a small ragged shape;
4. the same for the training path's kernels: flash attention forward,
   dq and dk/dv at TinyLlama-1.1B's training shape (8, 2048, 32/4, 64)
   and at Llama-3-8B's head shape (1, 4096, 32/8, 128), bf16, and in f32
   at small shapes, each entry held to its own size and its head_dim
   row's (`_check_rows`); the RMSNorm backward at (16384, 2048) with and
   without the residual's gradient, and its forward at the prefill
   call's (6370, 4096) and the training (16384, 2048) shapes with a
   residual (x + residual, then F.rms_norm, as yardstick; each norm entry
   carries the launch plan it ran); RoPE, forward and backward, bit-equal
   to its twin in f32 and bf16 and timed at the decode (8, 1, 32|8, 128),
   first prefill call's (1, M, 32|8, 128) and training (8, 2048, 32|4, 64)
   shapes. SDPA (enable_gqa) is the flash yardstick;
5. Llama-3-8B at full width (32 layers, bf16, weights from a seed) behind
   a PagedKVEngine serving 8 requests of 128..1024 prompt tokens and 64
   new tokens each, one of them joining mid-decode. Each decode tick is
   one replay of the engine's captured CUDA graph (the warm-up tick and
   the capture come first, at the first tick); the launch counters of
   the three kernels show that path went through them, as exact counts
   over every decode step, the warm-up's included. A replay adds the
   counts its capture took, so two more replays of the captured tick run
   under torch.profiler, and each decode-path kernel's rows in that trace
   must equal what the counters gained (the replays' kernel time is
   printed beside the untraced tick's host wall). A second run gives
   the same greedy tokens, and so does a run through the engine's
   private eager tick (`_eager_program`), whose decode tokens/s and tick
   ms are printed beside the captured path's. Then the serving loop:
   `stream()` over two requests with the background ticker running
   (which captures the tick on its own thread) gives each the tokens
   `generate()` gave it, a request cancelled mid-decode returns every
   page and its reservation, and `stop()` joins the ticker;
6. continuous-batching parity on a 2-layer full-width f32 model: a
   request's greedy tokens alone equal its tokens when it joins
   mid-decode of 7 others (or, at a near-tie, the two tokens' logits
   agree within 1e-3);
7. TinyLlama-1.1B (22 layers, full width) trained through the Trainer:
   f32 weights from a seed, bf16 compute, AdamW, flash attention, fused
   RMSNorm and RoPE, recompute; one batch of 8 x 2048 tokens, one
   warm-up step and 5 timed steps. The loss must be finite and fall, and
   each kernel's launches per step must equal the count worked out from
   the model's code;
8. training parity: one Trainer step of a 2-layer model at TinyLlama's
   full width on the card through the kernels against the same state and
   batch on the CPU through the twins, in f32 and with bf16 compute, and
   an f32 step with the blockwise loss, ClipGradByGlobalNorm, a
   LinearWarmup schedule and skip_nonfinite_grads;
9. bench.py's own training configuration (bench.py:1182-1254):
   TinyLlama-1.1B, 22 layers, recompute, flash attention, the blockwise
   loss (loss_chunk=512), plain norm and RoPE; f32 weights from a seed,
   AdamW(1e-4, weight decay 0.01), bf16 compute; one batch of 8 x 2048
   ids fed through `trainer.data_iter(itertools.repeat(data, 11),
   depth=3)`: a warm-up step, then 10 timed steps closed by
   float(loss). The losses must be finite and fall, and each kernel's
   launches per step must equal the count from the code;
10. int8 serving: Llama-3-8B (seed 0, bf16) converted by
   `quantize_weight_only` on the card (every Linear, the lm_head
   included, W8A16), behind PagedKVEngine(kv_dtype="int8") with phase
   5's geometry, prompts and late joiner. Each of layer 0's seven
   projections must stay within 2 % (mean |q - f| / mean |f|) of the
   float layer on a prefill activation; tokens in vocabulary, pages
   back with their scale rows zeroed, int8 decode launches = 32 x decode
   steps, W8A16 launches = 225 x model calls, of which the wgmma route's
   = 224 x prefill calls above its threshold (decode steps counted with
   the warm-up tick's), the kernel rows of two traced replays equal to
   what the counters gained (W8A16's split-K kernel among them), a
   second run the same tokens, the private eager
   tick the same tokens (its decode tokens/s and tick ms printed beside
   the captured path's), KV bytes per slot at most 0.51 x phase 5's. It
   reports the top-1 agreement of the first tokens with phase 5's bf16
   model.

Phase 4 also holds the blockwise cross-entropy kernels (forward, dS,
dx, dW) against their twin at the training shape (N 16384, D 2048,
V 32000) in bf16 and at a small shape in f32, beside the dense path
(torch.matmul logits and the port's dense cross_entropy) and torch.matmul
of each bare product as yardsticks, the forward and the backward the same
bits on two calls, and once more in bf16 past the
old int32 cap (N 18432 = 9 x 2048 rows, Llama-3-8B's head: D 4096,
V 128256, so N x V > 2^31).

`--profile` also traces one prefill and two decode ticks of phases 5 and
10 (two replays of the captured tick, after one untraced tick that
captures it) and one step of each training configuration.

The last line is {"ok": true, "device": {...}}; it is printed only when
every phase passed. Without a CUDA device the script exits non-zero
before printing any result.
"""
from __future__ import annotations

import argparse
import gc
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_TENSOR_FLOPS = 989e12     # H100 SXM dense bf16
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
BF16_TOL = 2 ** -7             # one bf16 rounding step, relative
F32_TOL = 1e-4
# flash kernels in bf16, entry by entry against |ref| + the RMS of its
# head_dim row (`_check_rows`): four bf16 steps. The kernel and the twin
# may round an output to neighbouring bf16 values (one step), and the
# kernel rounds p against the running row max where the twin rounds the
# normalised p: noise of about a third of a step of the row's RMS per
# entry, which over millions of entries reaches 1.7 steps in o and 0.9 in
# dq, dk and dv
FLASH_BF16_TOL = 2 ** -5
# the blockwise cross-entropy's dx and dW, entry by entry (`_check_rows`):
# both sides round dS to bf16 once, and a dS that rounds the other way
# moves a row by 2^-8 of its size
CE_BF16_TOL = 2 ** -6
SERVING_KERNELS = ("paged_decode_attention", "rms_norm_residual",
                   "rope_apply")
# the decode-path kernels as a profiler trace names them (`traced_replays`)
TRACED_DECODE = ("paged_decode_split<", "paged_decode_combine<",
                 "rmsn_fwd_kernel<", "rope_kernel<")
TRACED_INT8 = TRACED_DECODE + ("w8a16_kernel<",)


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, inputs, iters=50):
    """Device ms per call of fn(*inputs[i % len(inputs)]): `iters` calls
    captured in one CUDA graph, so the host's launch overhead is not in
    the time, and the replay timed between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):               # warm-up, as capture wants
        for i in range(3):
            fn(*inputs[i % len(inputs)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes, flops, peak):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_eager_ms(fn, inputs, iters=3):
    """Device ms per call without a graph, for calls whose own time
    dwarfs launch overhead (the plain twins at training shapes, which
    allocate gigabytes per call, and autograd yardsticks)."""
    fn(*inputs[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _check(name, out, ref, tol):
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol, msg=name)
    return float((out - ref).abs().max())


def _check_to_max(name, out, ref, tol):
    """|out - ref| <= tol * max(1, max |ref|); returns max |out - ref|."""
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    err = float((out - ref).abs().max())
    bound = tol * max(1.0, float(ref.abs().max()))
    if err > bound:
        raise AssertionError(f"{name}: max |err| {err} > {bound}")
    return err


def _check_rows(name, out, ref, tol):
    """Entry by entry, |out - ref| <= tol * (|ref| + the RMS of ref's row
    along the last dim + 2^-6 of the RMS of all of ref), so a row or key
    of small values is held to its own size, not to the largest entry.
    The last term covers rows whose exact value is 0 (dq of the first
    causal row), where both sides give rounding noise. Returns (max |out
    - ref|, the largest |out - ref| / bound)."""
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    diff = (out - ref).abs()
    sq = ref.square()
    bound = tol * (ref.abs() + sq.mean(-1, keepdim=True).sqrt()
                   + 2 ** -6 * sq.mean().sqrt())
    ratio = float((diff / bound).max())
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: |err| reaches {ratio:.3g} x its bound "
                             f"{tol:.3g} * (|ref| + row RMS + 2^-6 RMS)")
    return float(diff.max()), ratio


# -- phase 3: kernels against their twins ---------------------------------

def _plan_json(p):
    """The RMSNorm launch plan a timed call ran (fused_norm.plan)."""
    return {"threads_per_row": p.threads_per_row,
            "rows_per_block": p.rows_per_block,
            "instance": "vector" if p.vector else "scalar",
            "chunks": p.chunks, "blocks": p.blocks}


def norm_phases(dev, fn):
    """The rms_norm_residual and rms_norm_residual_bwd entries: each kernel
    held against its twin (h bit-equal to x + residual, y and dh within one
    rounding step in bf16 and 1e-4 in f32, rstd within 1e-4, dw within the
    tolerance of its largest entry and the same bits twice), then timed
    beside its twin, its bound and a library yardstick at the decode
    (8, 4096), prefill (6370, 4096) and training (16384, 2048) shapes;
    each shape's entry carries the launch plan it ran."""
    g = torch.Generator(device=dev).manual_seed(0)
    eps, d = 1e-5, 4096
    rms = torch.nn.functional.rms_norm

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def held(tag, x, r, w, tol):
        y, h = fn.rms_norm_residual(x, w, r, eps)
        ry, rh = fn.rms_norm_residual_ref(x, w, r, eps)
        torch.cuda.synchronize()
        if not torch.equal(h, rh):
            raise AssertionError(f"rms_norm {tag}: h != x + residual")
        return _check(f"rms_norm {tag}", y, ry, tol)

    # decode rows, a 4096-row block and the prefill call's 6370 rows
    err = 0.0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for n in (8, 4096, 6370):
            x, r, w = randn(n, d, dtype=dtype), randn(n, d, dtype=dtype), \
                randn(d, dtype=dtype)
            for res in (None, r):
                e = held(f"{dtype} n={n} res={res is not None}", x, res, w,
                         tol)
                if dtype == torch.bfloat16:
                    err = max(err, e)
    rows = 8
    sets = [(randn(rows, d), randn(rows, d), randn(d)) for _ in range(4)]
    nores = [(s[0], s[2]) for s in sets]
    elem = rows * d
    norm = dict(
        name="rms_norm_residual", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/fused_norm.cu",
        replaces="paddle_tpu/kernels/fused_norm.py:185",
        ms=_time_ms(lambda a, b: fn.rms_norm_residual(a, b, None, eps),
                    nores),
        plain_ms=_time_ms(lambda a, b: fn.rms_norm_residual_ref(a, b, None,
                                                                eps), nores),
        library_ms=_time_ms(lambda a, b: rms(a, (d,), b, eps), nores),
        shape=f"x ({rows}, {d}) bf16, no residual",
        plan=_plan_json(fn.plan(rows, d, torch.bfloat16,
                                sms=fn._sm_count(dev))),
        residual_ms=_time_ms(lambda a, b, c: fn.rms_norm_residual(
            a, c, b, eps), sets),
        residual_plain_ms=_time_ms(lambda a, b, c: fn.rms_norm_residual_ref(
            a, c, b, eps), sets),
        # the library yardstick with a residual: the add, then F.rms_norm
        # of the sum (two calls)
        residual_library_ms=_time_ms(lambda a, b, c: rms(a + b, (d,), c,
                                                         eps), sets))
    norm["bound_ms"], norm["bound_by"] = _bound(
        2 * elem * 2 + d * 2, 4 * elem, F32_FLOPS)
    norm["residual_bound_ms"] = _bound(4 * elem * 2 + d * 2, 5 * elem,
                                       F32_FLOPS)[0]

    def timed_fwd(tag, n, dd, want_rstd):
        x, r, w = randn(n, dd), randn(n, dd), randn(dd)
        e = held(f"bf16 {tag} ({n}, {dd}) res=True", x, r, w, BF16_TOL)
        one = [(x, r, w)]
        out = {f"{tag}_ms": _time_ms(
                   lambda a, b_, c: fn._norm_fwd(a, c, b_, eps, want_rstd),
                   one, iters=20),
               f"{tag}_plain_ms": _time_ms(
                   lambda a, b_, c: fn.rms_norm_residual_ref(a, c, b_, eps),
                   one, iters=5),
               f"{tag}_library_ms": _time_ms(
                   lambda a, b_, c: rms(a + b_, (dd,), c, eps), one,
                   iters=20),
               f"{tag}_bound_ms": _bound(
                   4 * n * dd * 2 + dd * 2 + (n * 4 if want_rstd else 0),
                   5 * n * dd, F32_FLOPS)[0],
               f"{tag}_shape": f"x, residual ({n}, {dd}) bf16"
                               + (", with rstd" if want_rstd else ""),
               f"{tag}_plan": _plan_json(fn.plan(n, dd, torch.bfloat16,
                                                 sms=fn._sm_count(dev)))}
        return e, out

    e, pre = timed_fwd("prefill", 6370, d, False)
    norm.update(pre)
    e2, train = timed_fwd("train", 16384, 2048, True)
    norm.update(train)
    norm["library_note"] = (
        "decode without a residual: F.rms_norm, the same function; with a "
        "residual (residual_, prefill_, train_library_ms): x + residual, "
        "then F.rms_norm, two calls that write no rstd")
    norm["max_abs_err"] = max(err, e, e2)
    print(f"[kernel] rms_norm_residual bf16 (8, 4096): {norm['ms']:.4f} ms, "
          f"plain {norm['plain_ms']:.4f} ms, torch rms_norm "
          f"{norm['library_ms']:.4f} ms, bound {norm['bound_ms']:.5f} ms; "
          f"with residual {norm['residual_ms']:.4f} ms, plain "
          f"{norm['residual_plain_ms']:.4f} ms, x + r and rms_norm "
          f"{norm['residual_library_ms']:.4f} ms, bound "
          f"{norm['residual_bound_ms']:.5f} ms; prefill (6370, 4096) "
          f"{norm['prefill_ms']:.4f} ms, x + r and rms_norm "
          f"{norm['prefill_library_ms']:.4f} ms, bound "
          f"{norm['prefill_bound_ms']:.4f} ms; training (16384, 2048) "
          f"{norm['train_ms']:.4f} ms, x + r and rms_norm "
          f"{norm['train_library_ms']:.4f} ms, bound "
          f"{norm['train_bound_ms']:.4f} ms; max |err| "
          f"{norm['max_abs_err']:.3g}; plans {norm['plan']}, "
          f"{norm['prefill_plan']}, {norm['train_plan']}")

    # the backward at the training shape, with and without gh
    n, d = 16384, 2048
    err = 0.0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        h, gy, gh = randn(n, d, dtype=dtype), randn(n, d, dtype=dtype), \
            randn(n, d, dtype=dtype)
        w = randn(d, dtype=dtype)
        _, _, rstd = fn._norm_fwd(h, w, None, eps, want_rstd=True)
        _check(f"rms_norm rstd {dtype}", rstd,
               fn._rmsn_fwd_math(h, w, eps)[1].reshape(-1), F32_TOL)
        for gh_ in (None, gh):
            dh, dw = fn.rms_norm_residual_bwd(h, w, rstd, gy, gh_)
            rdh, rdw = fn.rms_norm_residual_bwd_ref(h, w, rstd, gy, gh_)
            torch.cuda.synchronize()
            tag = f"{dtype} gh={gh_ is not None}"
            e = _check(f"rms_norm_bwd dh {tag}", dh, rdh, tol)
            # dw sums 16384 rows: held to its largest entry
            e = max(e, _check_to_max(f"rms_norm_bwd dw {tag}", dw, rdw, tol))
            if not torch.equal(fn.rms_norm_residual_bwd(h, w, rstd, gy,
                                                         gh_)[1], dw):
                raise AssertionError("rms_norm_bwd: dw not deterministic")
            if dtype == torch.bfloat16:
                err = max(err, e)
    sets = [(h, w, rstd, gy)]
    gsets = [(h, w, rstd, gy, gh)]
    elem = n * d
    bwd = dict(
        name="rms_norm_residual_bwd", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/fused_norm.cu",
        replaces="paddle_tpu/kernels/fused_norm.py:225", max_abs_err=err,
        ms=_time_ms(fn.rms_norm_residual_bwd, sets, iters=20),
        plain_ms=_time_ms(fn.rms_norm_residual_bwd_ref, sets, iters=5),
        library_ms=None,
        library_note="no single PyTorch call computes the RMSNorm backward",
        shape=f"h ({n}, {d}) bf16, no residual gradient; ms includes the "
              "sum of the dw partials",
        plan=_plan_json(fn.plan(n, d, torch.bfloat16, backward=True,
                                sms=fn._sm_count(dev))),
        gh_ms=_time_ms(fn.rms_norm_residual_bwd, gsets, iters=20),
        gh_plain_ms=_time_ms(fn.rms_norm_residual_bwd_ref, gsets, iters=5))
    bwd["bound_ms"], bwd["bound_by"] = _bound(
        3 * elem * 2 + n * 4 + 2 * d * 2, 8 * elem, F32_FLOPS)
    bwd["gh_bound_ms"] = _bound(4 * elem * 2 + n * 4 + 2 * d * 2, 9 * elem,
                                F32_FLOPS)[0]
    print(f"[kernel] rms_norm_residual_bwd bf16 ({n}, {d}): "
          f"{bwd['ms']:.4f} ms, plain {bwd['plain_ms']:.4f} ms, bound "
          f"{bwd['bound_ms']:.4f} ms; with gh {bwd['gh_ms']:.4f} ms, plain "
          f"{bwd['gh_plain_ms']:.4f} ms, bound {bwd['gh_bound_ms']:.4f} ms; "
          f"max |err| {err:.3g}; plan {bwd['plan']}")
    del h, gy, gh, dh, rdh, sets, gsets
    torch.cuda.empty_cache()
    return {"rms_norm_residual": norm, "rms_norm_residual_bwd": bwd}


def kernel_phases(dev, pa):
    """Returns {kernel name: JSON entry without launches}."""
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    # paged decode: b=8, hq=32, hk=8, d=128, page 16, 641 pages, 80 per slot
    b, hq, hk, hd, ps, npages, mp = 8, 32, 8, 128, 16, 641, 80
    lens_l = [0, 15, 16, 1000, 1279, 517, 64, 300]
    rng = np.random.default_rng(0)
    bt = torch.from_numpy(rng.permutation(np.arange(1, npages))[:b * mp]
                          .reshape(b, mp).astype(np.int32)).to(dev)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp = randn(b, hq, hd, dtype=dtype), \
            randn(npages, hk, ps, hd, dtype=dtype), \
            randn(npages, hk, ps, hd, dtype=dtype)
        e = _check(f"paged_decode {dtype}",
                   pa.paged_decode_attention(q, kp, vp, bt, lens),
                   pa.paged_decode_attention_ref(q, kp, vp, bt, lens),
                   F32_TOL)
        if dtype == torch.bfloat16:
            err = e
    # 4 distinct pool sets (42 MB each) so the timed reads miss the 50 MB
    # L2, as each layer's pools do on the serving path
    psets = [(randn(b, hq, hd), randn(npages, hk, ps, hd),
              randn(npages, hk, ps, hd)) for _ in range(4)]

    def kern(q, kp, vp):
        return pa.paged_decode_attention(q, kp, vp, bt, lens)

    def plain(q, kp, vp):
        return pa.paged_decode_attention_ref(q, kp, vp, bt, lens)

    # the yardstick: one SDPA call over each slot's gathered dense window
    # (gathered outside the timing), masked to its length
    L = mp * ps
    visible = (torch.arange(L, device=dev)[None, :]
               <= lens[:, None].long())[:, None, None, :]
    dense = []
    for q, kp, vp in psets:
        kd = kp[bt.long()].permute(0, 2, 1, 3, 4).reshape(b, hk, L, hd)
        vd = vp[bt.long()].permute(0, 2, 1, 3, 4).reshape(b, hk, L, hd)
        dense.append((q[:, :, None, :], kd.contiguous(), vd.contiguous()))

    def library(q4, kd, vd):
        return torch.nn.functional.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=visible, enable_gqa=True)

    ref_lib = library(*dense[0])[:, :, 0].float()
    _check("sdpa yardstick", ref_lib, plain(*psets[0]), 2e-2)
    vis = sum(x + 1 for x in lens_l)
    per, n_split = pa.plan(mp, ps)
    dec = dict(
        name="paged_decode_attention", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/paged_attention.cu",
        replaces="paddle_tpu/kernels/paged_attention.py:274",
        max_abs_err=err, ms=_time_ms(kern, psets),
        plain_ms=_time_ms(plain, psets, iters=20),
        library_ms=_time_ms(library, dense),
        shape=f"b={b} hq={hq} hk={hk} d={hd} page={ps} lens={lens_l} bf16",
        pages_per_split=per, n_split=n_split)
    nbytes = (vis * hk * hd * 2 * 2 + b * hq * hd * 2 + b * hq * hd * 4
              + b * mp * 4 + b * 4)
    dec["bound_ms"], dec["bound_by"] = _bound(
        nbytes, 4 * vis * hq * hd, BF16_TENSOR_FLOPS)
    dec.update(_full_window(pa, psets, dense, bt, mp * ps, hq, hk, hd,
                            kv_bytes=2))
    print(f"[kernel] paged_decode_attention bf16 {dec['shape']}: "
          f"{dec['ms']:.4f} ms, plain {dec['plain_ms']:.4f} ms, sdpa "
          f"{dec['library_ms']:.4f} ms, bound {dec['bound_ms']:.5f} ms; "
          f"max |err| {err:.3g}; P {per} pages, {n_split} splits; full "
          f"window (lens {mp * ps - 1} x {b}) {dec['full_window_ms']:.4f} "
          f"ms, sdpa {dec['full_window_library_ms']:.4f} ms, bound "
          f"{dec['full_window_bound_ms']:.5f} ms")
    return {dec["name"]: dec}


def _full_window(pa, psets, dense, bt, L, hq, hk, hd, kv_bytes):
    """The decode kernel with every slot at lens L - 1 (the whole window
    of every block table visible, the steady state of long generation):
    held against its twin, timed over the same pool sets beside SDPA over
    the gathered windows (`dense`, as the caller built them), and its
    bytes bound. int8 pools (kv_bytes 1) also read a scale pair per page
    and head."""
    b, mp = bt.shape
    lens = torch.full((b,), L - 1, dtype=torch.int32, device=bt.device)
    ps = L // mp

    def kw(sc):
        return dict(k_scale=sc[0], v_scale=sc[1]) if sc else {}

    def kern(q, kp, vp, *sc):
        return pa.paged_decode_attention(q, kp, vp, bt, lens, **kw(sc))

    def library(q4, kd, vd):
        return torch.nn.functional.scaled_dot_product_attention(
            q4, kd, vd, enable_gqa=True)

    q, kp, vp, *sc = psets[0]
    _check("paged_decode full window", kern(*psets[0]),
           pa.paged_decode_attention_ref(q, kp, vp, bt, lens, **kw(sc)),
           F32_TOL)
    nbytes = (b * L * hk * hd * kv_bytes * 2 + b * hq * hd * 2
              + b * hq * hd * 4 + b * mp * 4 + b * 4
              + (b * mp * hk * 2 * 4 if kv_bytes == 1 else 0))
    return dict(full_window_ms=_time_ms(kern, psets),
                full_window_bound_ms=_bound(nbytes, 4 * b * L * hq * hd,
                                            BF16_TENSOR_FLOPS)[0],
                full_window_library_ms=_time_ms(library, dense))


# -- phase 3, int8 serving: the int8 decode kernel and W8A16 -------------------

# Llama-3-8B's distinct projection shapes (K, N): the layers that use them
W8A16_SHAPES = (("q_proj, o_proj", 4096, 4096, 2),
                ("k_proj, v_proj", 4096, 1024, 2),
                ("gate_proj, up_proj", 4096, 14336, 2),
                ("down_proj", 14336, 4096, 1),
                ("lm_head", 4096, 128256, 0))


def _prefill_call_ms(prompts, late, bucket):
    """M (rows of x) of each of the engine's batched prefill calls when
    `prompts` but `late` are submitted at once and `late` joins later:
    same-bucket prompts go together in admission order, padded to the
    group's longest (PagedKVEngine._admit); the late joiner comes alone."""
    groups = {}
    for i, p in enumerate(prompts):
        if i != late:
            groups.setdefault(bucket(p.size), []).append(p.size)
    return [len(g) * max(g) for g in groups.values()] + [prompts[late].size]


def int8_kernel_phases(dev, pa, qm, prefill_m, late_m):
    """paged_decode_attention_int8 and weight_only_int8_matmul entries,
    each held against its twin on the card and timed; the W8A16 entries
    also at the M of the first prefill call and of the late joiner's."""
    g = torch.Generator(device=dev).manual_seed(20)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def scales(*shape):
        return torch.rand(*shape, generator=g, device=dev) * 0.02 + 1e-3

    # int8 decode at the serving shapes of row 1 (kernel_phases)
    b, hq, hk, hd, ps, npages, mp = 8, 32, 8, 128, 16, 641, 80
    lens_l = [0, 15, 16, 1000, 1279, 517, 64, 300]
    rng = np.random.default_rng(0)
    bt = torch.from_numpy(rng.permutation(np.arange(1, npages))[:b * mp]
                          .reshape(b, mp).astype(np.int32)).to(dev)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)

    def pool_set(dtype=torch.bfloat16):
        return (randn(b, hq, hd, dtype=dtype), codes(npages, hk, ps, hd),
                codes(npages, hk, ps, hd), scales(npages, hk),
                scales(npages, hk))

    def kern(q, kp, vp, ks, vs):
        return pa.paged_decode_attention(q, kp, vp, bt, lens, k_scale=ks,
                                         v_scale=vs)

    def plain(q, kp, vp, ks, vs):
        return pa.paged_decode_attention_ref(q, kp, vp, bt, lens,
                                             k_scale=ks, v_scale=vs)

    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        args = pool_set(dtype)
        e = _check(f"paged_decode_int8 q {dtype}", kern(*args), plain(*args),
                   F32_TOL)
        if dtype == torch.bfloat16:
            err = e
    # 4 pool sets (21 MB each) so the timed reads miss the 50 MB L2
    psets = [pool_set() for _ in range(4)]
    L = mp * ps
    visible = (torch.arange(L, device=dev)[None, :]
               <= lens[:, None].long())[:, None, None, :]
    dense = []
    for q, kp, vp, ks, vs in psets:     # gathered and dequantized, untimed
        kd = pa.gather_window(kp, ks, bt.long()).to(torch.bfloat16)
        vd = pa.gather_window(vp, vs, bt.long()).to(torch.bfloat16)
        dense.append((q[:, :, None, :], kd.contiguous(), vd.contiguous()))

    def library(q4, kd, vd):
        return torch.nn.functional.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=visible, enable_gqa=True)

    _check("sdpa yardstick int8", library(*dense[0])[:, :, 0].float(),
           plain(*psets[0]), 2e-2)
    vis = sum(x + 1 for x in lens_l)
    pages = sum(x // ps + 1 for x in lens_l)
    per, n_split = pa.plan(mp, ps)
    dec = dict(
        name="paged_decode_attention_int8", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/paged_attention.cu",
        replaces="paddle_tpu/kernels/paged_attention.py:274",
        max_abs_err=err, ms=_time_ms(kern, psets),
        plain_ms=_time_ms(plain, psets, iters=20),
        library_ms=_time_ms(library, dense),
        shape=f"b={b} hq={hq} hk={hk} d={hd} page={ps} lens={lens_l} int8 "
              "pools, bf16 q; library: SDPA over the gathered, dequantized "
              "bf16 window",
        pages_per_split=per, n_split=n_split)
    nbytes = (vis * hk * hd * 2 + pages * hk * 2 * 4 + b * hq * hd * 2
              + b * hq * hd * 4 + b * mp * 4 + b * 4)
    dec["bound_ms"], dec["bound_by"] = _bound(
        nbytes, 4 * vis * hq * hd, BF16_TENSOR_FLOPS)
    dec.update(_full_window(pa, psets, dense, bt, L, hq, hk, hd,
                            kv_bytes=1))
    print(f"[kernel] paged_decode_attention_int8 {dec['shape']}: "
          f"{dec['ms']:.4f} ms, plain {dec['plain_ms']:.4f} ms, sdpa "
          f"{dec['library_ms']:.4f} ms, bound {dec['bound_ms']:.5f} ms; "
          f"max |err| {err:.3g}; P {per} pages, {n_split} splits; full "
          f"window (lens {L - 1} x {b}) {dec['full_window_ms']:.4f} ms, "
          f"sdpa {dec['full_window_library_ms']:.4f} ms, bound "
          f"{dec['full_window_bound_ms']:.5f} ms")
    del psets, dense

    # W8A16 at every distinct projection shape, at the decode step's M = 8,
    # at the M of the engine's first batched prefill call and at the late
    # joiner's
    print(f"[kernel] W8A16 at M = 8, M = {prefill_m} (the first prefill "
          f"call: its prompts x their longest length) and M = {late_m} (the "
          "late joiner's prefill)")
    sms = qm._sm_count(torch.device(dev))
    per_shape, err, ratio = [], 0.0, 0.0
    for what, K, N, per_layer in W8A16_SHAPES:
        n_sets = max(1, min(40, -(-150 * 2 ** 20 // (K * N))))
        weights = [(codes(K, N), scales(N)) for _ in range(n_sets)]
        deq = [((qw.float() * s).to(torch.bfloat16),) for qw, s in
               weights[:max(1, n_sets // 2)]]
        for M in (8, prefill_m, late_m):
            x = randn(M, K)
            out = qm.weight_only_int8_matmul(x, *weights[0])
            ref = qm.weight_only_int8_matmul_ref(x, *weights[0])
            e, r = _check_rows(f"w8a16 {what} M={M}", out, ref, BF16_TOL)
            err, ratio = max(err, e), max(ratio, r)
            iters = 50 if M == 8 else 10
            row = dict(layers=what, M=M, K=K, N=N, per_layer=per_layer,
                       err=e, rule_ratio=r,
                       ms=_time_ms(lambda qw, s: qm.weight_only_int8_matmul(
                           x, qw, s), weights, iters=iters),
                       plain_ms=_time_eager_ms(
                           lambda qw, s: qm.weight_only_int8_matmul_ref(
                               x, qw, s), weights, iters=2),
                       library_ms=_time_ms(lambda w: torch.matmul(x, w), deq,
                                           iters=iters))
            row["route"], row["tile_rows"], row["splits"] = qm.plan(M, K, N,
                                                                   sms)
            row["bound_ms"], row["bound_by"] = _bound(
                M * K * 2 + K * N + N * 4 + M * N * 2, 2 * M * N * K,
                BF16_TENSOR_FLOPS)
            per_shape.append(row)
            print(f"[kernel] w8a16 {what} (M {M}, K {K}, N {N}, route "
                  f"{row['route']}, {row['tile_rows']}-row tile, "
                  f"{row['splits']} splits): {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, bf16 matmul of the dequantized "
                  f"weight {row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.5f} ms ({row['bound_by']}); |err| / "
                  f"bound {r:.3g}")
            del x, out, ref
        del weights, deq
    # f32 x at a small ragged shape (a last k-tile of 8, a last column
    # tile of 80), both output types
    x, qw, s = randn(37, 200, dtype=torch.float32), codes(200, 208), \
        scales(208)
    for out_dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16,
                                                       BF16_TOL)):
        _check_rows(f"w8a16 f32 x -> {out_dtype} (37, 200, 208)",
                    qm.weight_only_int8_matmul(x, qw, s, out_dtype),
                    qm.weight_only_int8_matmul_ref(x, qw, s, out_dtype), tol)
    # the entry: one decode step's W8A16 work (M = 8): 32 layers of seven
    # projections and the lm_head once
    dec8 = [r for r in per_shape if r["M"] == 8]

    def step_sum(key):
        return sum(r[key] * (32 * r["per_layer"] if r["per_layer"] else 1)
                   for r in dec8)

    mm = dict(
        name="weight_only_int8_matmul", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/quant_matmul.cu",
        replaces="paddle_tpu/kernels/quant_matmul.py:85",
        max_abs_err=err, ms=step_sum("ms"), plain_ms=step_sum("plain_ms"),
        bound_ms=step_sum("bound_ms"), bound_by="bytes",
        library_ms=step_sum("library_ms"),
        shape="one decode step at M = 8: 32 x (q, k, v, o, gate, up, down) "
              "+ lm_head, bf16 x; library: torch.matmul over the "
              "dequantized bf16 weights (the unquantized layers' cost)",
        rule_ratio=ratio, prefill_m=prefill_m, shapes=per_shape)
    print(f"[kernel] weight_only_int8_matmul, {mm['shape']}: {mm['ms']:.4f} "
          f"ms, plain {mm['plain_ms']:.4f} ms, bf16 matmul "
          f"{mm['library_ms']:.4f} ms, bound {mm['bound_ms']:.4f} ms; "
          f"|err| / bound at most {ratio:.3g} (bound 2^-7 (|ref| + row RMS "
          "+ 2^-6 RMS))")
    # the wgmma route's entry: one first prefill call's projections (32
    # layers of seven; its lm_head runs at M = the group's prompt count)
    pre = [r for r in per_shape if r["M"] == prefill_m and r["per_layer"]]
    if any(r["route"] != "wgmma" for r in pre):
        raise AssertionError(f"W8A16 at M = {prefill_m} did not take the "
                             f"wgmma route: {[r['route'] for r in pre]}")

    def call_sum(key):
        return sum(r[key] * 32 * r["per_layer"] for r in pre)

    wg = dict(
        name="weight_only_int8_matmul_wgmma", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/quant_matmul.cu",
        replaces="paddle_tpu/kernels/quant_matmul.py:85",
        max_abs_err=max(r["err"] for r in pre), ms=call_sum("ms"),
        plain_ms=call_sum("plain_ms"), bound_ms=call_sum("bound_ms"),
        bound_by="operations", library_ms=call_sum("library_ms"),
        shape=f"one prefill call at M = {prefill_m}: 32 x (q, k, v, o, gate, "
              "up, down), bf16 x; library: torch.matmul over the dequantized "
              "bf16 weights (the unquantized layers' cost)",
        rule_ratio=max(r["rule_ratio"] for r in pre), prefill_m=prefill_m)
    print(f"[kernel] weight_only_int8_matmul_wgmma, {wg['shape']}: "
          f"{wg['ms']:.4f} ms, plain {wg['plain_ms']:.4f} ms, bf16 matmul "
          f"{wg['library_ms']:.4f} ms, bound {wg['bound_ms']:.4f} ms")
    torch.cuda.empty_cache()
    return {k["name"]: k for k in (dec, mm, wg)}


# -- phase 4: the training path's kernels ---------------------------------------

def _flash_cost(b, s, hq, hk, d, causal):
    """Visible (query, key) pairs and the bf16 bytes of one q-sized and
    one k-sized (B, S, H, D) tensor."""
    pairs = b * hq * (s * (s + 1) // 2 if causal else s * s)
    return pairs, b * s * hq * d * 2, b * s * hk * d * 2


def flash_phases(dev, fa):
    """flash_fwd, flash_bwd_dq, flash_bwd_dkv entries: checked in f32 at
    small shapes and in bf16 at the training and Llama-3 head shapes
    (the twins at b <= 2 there: at b = 8 their (b, h, s, s) f32 scores
    would take ~25 GB), timed at both shapes."""
    g = torch.Generator(device=dev).manual_seed(10)

    def inputs(b, s, hq, hk, d, dtype):
        return [torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
                for h in (hq, hk, hk, hq)]

    ratios = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}

    def held(kernel, name, got, want, tol):
        e, r = _check_rows(name, got, want, tol)
        ratios[kernel] = max(ratios[kernel], r)
        return e

    for b, s, hq, hk, d in ((2, 200, 8, 2, 64), (1, 160, 8, 2, 128)):
        for causal in (True, False):
            q, k, v, do = inputs(b, s, hq, hk, d, torch.float32)
            o, lse = fa.flash_attention_fwd(q, k, v, causal)
            ro, rlse = fa.flash_attention_fwd_ref(q, k, v, causal)
            tag = f"f32 {(b, s, hq, hk, d)} causal={causal}"
            held("flash_fwd", f"flash fwd {tag}", o, ro, F32_TOL)
            _check(f"flash lse {tag}", lse, rlse, F32_TOL)
            for kern, name, got, want in zip(
                    ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dkv"),
                    ("dq", "dk", "dv"),
                    fa.flash_attention_bwd(q, k, v, o, lse, do, causal),
                    fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)):
                held(kern, f"flash {name} {tag}", got, want, F32_TOL)
    print(f"[kernel] flash f32 at small shapes: |err| / bound at most "
          f"{ratios} (bound {F32_TOL} * (|ref| + row RMS + 2^-6 RMS))")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for tag, (b, s, hq, hk, d) in (("train", (8, 2048, 32, 4, 64)),
                                   ("llama3", (1, 4096, 32, 8, 128))):
        ratios = dict.fromkeys(ratios, 0.0)
        q, k, v, do = inputs(b, s, hq, hk, d, torch.bfloat16)
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
        cb = min(b, 2)
        q2, k2, v2, do2 = (t[:cb] for t in (q, k, v, do))
        ro, rlse = fa.flash_attention_fwd_ref(q2, k2, v2, True)
        err = {"flash_fwd": max(
            held("flash_fwd", f"flash fwd {tag}", o[:cb], ro,
                 FLASH_BF16_TOL),
            _check(f"flash lse {tag}", lse[:cb], rlse, F32_TOL))}
        del ro, rlse
        rdq, rdk, rdv = fa.flash_attention_bwd_ref(q2, k2, v2, o[:cb],
                                                   lse[:cb], do2, True)
        err["flash_bwd_dq"] = held("flash_bwd_dq", f"flash dq {tag}",
                                   dq[:cb], rdq, FLASH_BF16_TOL)
        err["flash_bwd_dkv"] = max(
            held("flash_bwd_dkv", f"flash dk {tag}", dk[:cb], rdk,
                 FLASH_BF16_TOL),
            held("flash_bwd_dkv", f"flash dv {tag}", dv[:cb], rdv,
                 FLASH_BF16_TOL))
        del rdq, rdk, rdv, q2, k2, v2, do2
        torch.cuda.empty_cache()
        # the two backward kernels alone, for their times
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_o = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        _check_to_max(f"sdpa yardstick {tag}", lib_o.transpose(1, 2), o,
                      FLASH_BF16_TOL)
        del lib_o
        qr, kr, vr = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
        dot = do.transpose(1, 2)

        def sdpa_fwd_bwd():
            res = sdpa(qr, kr, vr, is_causal=True, enable_gqa=True)
            torch.autograd.grad(res, (qr, kr, vr), dot)

        lib_fwd = _time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                        enable_gqa=True), [()], iters=20)
        lib_bwd = _time_eager_ms(sdpa_fwd_bwd, [()], iters=10) - lib_fwd
        ms = {"flash_fwd": _time_ms(
                  lambda: fa.flash_attention_fwd(q, k, v, True), [()],
                  iters=20),
              "flash_bwd_dq": _time_ms(lambda: fa._launch_dq(
                  q, k, v, do, lse, delta, True, None), [()], iters=20),
              "flash_bwd_dkv": _time_ms(lambda: fa._launch_dkv(
                  q, k, v, do, lse, delta, True, None), [()], iters=20)}
        fwd_plain = _time_eager_ms(
            lambda: fa.flash_attention_fwd_ref(q, k, v, True), [()], iters=2)
        bwd_plain = _time_eager_ms(lambda: fa.flash_attention_bwd_ref(
            q, k, v, o, lse, do, True), [()], iters=2)
        pairs, qbytes, kbytes = _flash_cost(b, s, hq, hk, d, True)
        rows = b * hq * s * 4                       # one f32 per query row
        bounds = {
            "flash_fwd": _bound(2 * qbytes + 2 * kbytes + rows,
                                4 * pairs * d, BF16_TENSOR_FLOPS),
            "flash_bwd_dq": _bound(3 * qbytes + 2 * kbytes + 2 * rows,
                                   6 * pairs * d, BF16_TENSOR_FLOPS),
            "flash_bwd_dkv": _bound(2 * qbytes + 4 * kbytes + 2 * rows,
                                    8 * pairs * d, BF16_TENSOR_FLOPS)}
        shape = f"(b {b}, s {s}, hq {hq}, hk {hk}, d {d}) causal bf16"
        for name in ms:
            e = out.setdefault(name, {})
            pre = "" if tag == "train" else "llama3_"
            e[pre + "ms"] = ms[name]
            e[pre + "plain_ms"] = (fwd_plain if name == "flash_fwd"
                                   else bwd_plain)
            e[pre + "bound_ms"], e[pre + "bound_by"] = bounds[name]
            e[pre + "library_ms"] = (lib_fwd if name == "flash_fwd"
                                     else lib_bwd)
            e[pre + "shape"] = shape
            # the largest |err| over its bound, FLASH_BF16_TOL * (|ref| +
            # row RMS): under 1, or the run has failed
            e[pre + "err_over_bound"] = ratios[name]
            e["max_abs_err"] = max(e.get("max_abs_err", 0.0), err[name])
        print(f"[kernel] flash {shape}: fwd {ms['flash_fwd']:.4f} ms "
              f"(bound {bounds['flash_fwd'][0]:.4f}), dq "
              f"{ms['flash_bwd_dq']:.4f} ms (bound "
              f"{bounds['flash_bwd_dq'][0]:.4f}), dk/dv "
              f"{ms['flash_bwd_dkv']:.4f} ms (bound "
              f"{bounds['flash_bwd_dkv'][0]:.4f}); plain fwd "
              f"{fwd_plain:.2f} ms, plain bwd {bwd_plain:.2f} ms; sdpa fwd "
              f"{lib_fwd:.4f} ms, sdpa bwd {lib_bwd:.4f} ms; max |err| "
              f"{err}, |err| / bound at most {ratios}")
        del q, k, v, do, o, lse, delta, dq, dk, dv, qr, kr, vr
        torch.cuda.empty_cache()
    replaces = {"flash_fwd": "paddle_tpu/kernels/flash_attention.py:529",
                "flash_bwd_dq": "paddle_tpu/kernels/flash_attention.py:998",
                "flash_bwd_dkv": "paddle_tpu/kernels/flash_attention.py:1016"}
    # the kernels in flash_attention.cu and the instructions they run on
    kernel = {"flash_fwd": "wg::flash_fwd_wgmma (wgmma m64n128k16 S = Q K^T, "
                           "Q from shared memory at d 64 and in registers at "
                           "d 128; m64nDk16 O += P V with P in registers; "
                           "TMA, 128-byte swizzle; a persistent grid of 3 "
                           "warpgroups a block at d 64, 2 at d 128)",
              "flash_bwd_dq": "wg::flash_dq_wgmma (wgmma m64n64k16, TMA, "
                              "128-byte swizzle)",
              "flash_bwd_dkv": "wg::flash_dkv_wgmma (wgmma m64n64k16, TMA, "
                               "128-byte swizzle)"}
    for name, e in out.items():
        e.update(name=name, route="cuda",
                 source="paddle_tpu_torch/kernels/csrc/flash_attention.cu",
                 replaces=replaces[name], kernel=kernel[name])
        if name != "flash_fwd":
            e["library_note"] = ("the SDPA backward computes dq, dk and dv "
                                 "together")
    out["flash_bwd_dq"]["also_replaces"] = [
        "paddle_tpu/kernels/flash_attention.py:980",
        "paddle_tpu/kernels/flash_attention.py:945 (with flash_bwd_dkv)"]
    return out


def _check_equal(name, out, ref):
    """out must have ref's bits; returns max |out - ref| (0.0)."""
    if not torch.equal(out, ref):
        err = float((out.float() - ref.float()).abs().max())
        raise AssertionError(f"{name}: not bit-equal to the twin (max |err| "
                             f"{err})")
    return 0.0


def rope_phases(dev, fn, prefill_m):
    """The rope_apply and rope_apply_bwd entries. Both are held bit for bit
    against their twins (the kernel rounds each product and the sum as the
    twin does) in f32 and bf16 at the decode shapes (8, 1, 32|8, 128) at
    scattered positions, the first batched prefill call's (1, prefill_m,
    32|8, 128) and the training shapes (8, 2048, 32|4, 64), forward and
    backward, then timed in bf16 at each shape, q and k, beside the twin
    and the bound (x read and written once, the two f32 tables read
    once). The forward entry's own time is decode's q, the backward's
    training's q."""
    g = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def seq_pos(b, s):
        return torch.arange(s, dtype=torch.int32, device=dev).repeat(b)

    decode_pos = torch.randint(0, 1280, (8,), generator=g, device=dev,
                               dtype=torch.int32)
    # tag: (b, s, q heads, k heads, d, theta, flat positions)
    shapes = {"decode": (8, 1, 32, 8, 128, 500000.0, decode_pos),
              "prefill": (1, prefill_m, 32, 8, 128, 500000.0,
                          seq_pos(1, prefill_m)),
              "train": (8, 2048, 32, 4, 64, 10000.0, seq_pos(8, 2048))}
    fwd = dict(name="rope_apply", route="cuda",
               source="paddle_tpu_torch/kernels/csrc/fused_norm.cu",
               replaces="paddle_tpu/kernels/fused_norm.py:380",
               library_ms=None,
               library_note="no single PyTorch call computes the RoPE "
                            "rotation")
    bwd = dict(fwd, name="rope_apply_bwd",
               also_replaces="paddle_tpu/kernels/fused_norm.py:415 (the "
                             "same kernel launched on -sin_f)")
    for tag, (b, s, hq, hk, d, theta, pos) in shapes.items():
        tables = fn.rope_tables(pos, d, theta)
        for dtype in (torch.float32, torch.bfloat16):
            for heads in (hq, hk):
                x = randn(b, s, heads, d, dtype=dtype)
                _check_equal(f"rope {tag} {dtype} h={heads}",
                             fn.rope_apply(x, tables=tables),
                             fn.rope_apply_ref(x, tables=tables))
                _check_equal(f"rope_bwd {tag} {dtype} h={heads}",
                             fn.rope_apply_bwd(x, *tables),
                             fn.rope_apply_bwd_ref(x, *tables))
                del x
        for heads, kv in ((hq, ""), (hk, "k_")):
            xs = [(randn(b, s, heads, d),) for _ in range(4 if s == 1
                                                          else 1)]
            elem = b * s * heads * d
            bound = _bound(2 * elem * 2 + 2 * b * s * d * 4, 3 * elem,
                           F32_FLOPS)
            iters, plain_iters = (50, 50) if s == 1 else (20, 5)
            for e, kern, plain in (
                    (fwd, lambda a: fn.rope_apply(a, tables=tables),
                     lambda a: fn.rope_apply_ref(a, tables=tables)),
                    (bwd, lambda a: fn.rope_apply_bwd(a, *tables),
                     lambda a: fn.rope_apply_bwd_ref(a, *tables))):
                pre = f"{tag}_{kv}"
                e[pre + "ms"] = _time_ms(kern, xs, iters=iters)
                e[pre + "plain_ms"] = _time_ms(plain, xs, iters=plain_iters)
                e[pre + "bound_ms"], e[pre + "bound_by"] = bound
                e[pre + "shape"] = f"({b}, {s}, {heads}, {d}) bf16"
            del xs
        del tables
    for e, main in ((fwd, "decode_"), (bwd, "train_")):
        e.update(max_abs_err=0.0, ms=e[main + "ms"],
                 plain_ms=e[main + "plain_ms"], bound_ms=e[main + "bound_ms"],
                 bound_by=e[main + "bound_by"], shape=e[main + "shape"])
        print(f"[kernel] {e['name']} bf16, bit-equal to the twin in f32 and "
              f"bf16 at every shape: " + "; ".join(
                  f"{tag} {kv[:-1] or 'q'} {e[f'{tag}_{kv}shape']} "
                  f"{e[f'{tag}_{kv}ms']:.4f} ms (plain "
                  f"{e[f'{tag}_{kv}plain_ms']:.4f}, bound "
                  f"{e[f'{tag}_{kv}bound_ms']:.5f})"
                  for tag in shapes for kv in ("", "k_")))
    return {"rope_apply": fwd, "rope_apply_bwd": bwd}


def ce_phases(dev, bce, fnl):
    """ce_fwd, ce_dlogits, ce_dx, ce_dw entries: f32 at a small shape with
    one and with eight backward super-blocks, bf16 at the training shape
    (N 16384 = 8 x 2048 rows, D 2048, V 32000, every 2048th row ignored as
    the shifted labels leave it) and past the old int32 cap (N 18432, D
    4096, V 128256), each held against the twin (chunk 512), the backward
    the same bits twice; timed beside the twin and the dense path
    (torch.matmul logits and the port's dense cross_entropy, `fnl`), with
    the peak memory of both."""
    g = torch.Generator(device=dev).manual_seed(12)
    one = torch.ones((), device=dev)

    def inputs(n, d, v, dtype):
        x = torch.randn(n, d, generator=g, device=dev).to(dtype)
        w = (torch.randn(v, d, generator=g, device=dev) * 0.02).to(dtype)
        lab = torch.randint(0, v, (n,), generator=g, device=dev,
                            dtype=torch.int32)
        return x, w, lab

    def kernels(x, w, lab):
        loss, lse, count = bce.ce_fwd(x, w, lab)
        return (loss, lse) + bce.ce_bwd(x, w, lab, lse, count, one)

    def twins(x, w, lab):
        loss, lse, count = bce.ce_fwd_ref(x, w, lab, 512)
        return (loss, lse) + bce.ce_bwd_ref(x, w, lab, lse, count, one, 512)

    def held(tag, got, want, tol):
        if abs(float(got[0]) - float(want[0])) > 1e-5 * abs(float(want[0])):
            raise AssertionError(f"ce loss {tag}: {float(got[0])} against "
                                 f"{float(want[0])}")
        err = {"lse": _check(f"ce lse {tag}", got[1], want[1], F32_TOL)}
        ratio = {}
        for name, a, b in (("dx", got[2], want[2]), ("dw", got[3], want[3])):
            err[name], ratio[name] = _check_rows(f"ce {name} {tag}", a, b, tol)
        return err, ratio

    budget = bce._WORKSPACE_BYTES
    f32_ratio = {}
    for supers in (1, 8):
        x, w, lab = inputs(300, 256, 1000, torch.float32)
        lab[::10] = -100
        bce._WORKSPACE_BYTES = 300 * 128 * 4 if supers > 1 else budget
        try:
            got = kernels(x, w, lab)
        finally:
            bce._WORKSPACE_BYTES = budget
        _, r = held(f"f32 (300, 256, 1000) {supers} super-blocks", got,
                    twins(x, w, lab), F32_TOL)
        f32_ratio[supers] = r
    print(f"[kernel] blockwise CE f32 (300, 256, 1000), 1 and 8 backward "
          f"super-blocks: |err| / bound at most {f32_ratio} (bound "
          f"{F32_TOL} * (|ref| + row RMS + 2^-6 RMS))")

    n, d, v = 16384, 2048, 32000
    x, w, lab = inputs(n, d, v, torch.bfloat16)
    lab[2047::2048] = -100
    got = kernels(x, w, lab)
    torch.cuda.synchronize()
    err, ratio = held("train", got, twins(x, w, lab), CE_BF16_TOL)
    again = kernels(x, w, lab)
    if not torch.equal(again[1], got[1]):
        raise AssertionError("ce forward: two calls differ")
    if not (torch.equal(again[2], got[2]) and torch.equal(again[3], got[3])):
        raise AssertionError("ce backward: two calls differ")
    del again
    loss, lse, count = bce.ce_fwd(x, w, lab)
    # one super-block's dS against the twin's, on its first 512 rows:
    # entry by entry within one bf16 step
    vs = bce.ce_super_block(n, v, 2)
    n_super = -(-v // vs)
    scale = torch.where(lab != -100, one / count, 0.0).contiguous()
    ws = torch.empty((n, vs), dtype=x.dtype, device=dev)
    bce._launch_dlogits(x, w, lab, lse, scale, ws, 0, vs)
    s_ref = x[:512].float() @ w[:vs].float().t()
    p_ref = torch.exp(s_ref - lse[:512, None])
    onehot = torch.arange(vs, device=dev)[None, :] == lab[:512, None]
    ds_ref = ((p_ref - onehot.float()) * scale[:512, None]).to(x.dtype)
    ds_err = (ws[:512].float() - ds_ref.float()).abs()
    if not (ds_err <= BF16_TOL * ds_ref.float().abs() + 1e-12).all():
        raise AssertionError(f"ce dS: |err| {float(ds_err.max())} past one "
                             "bf16 step")
    err["ds"] = float(ds_err.max())
    del s_ref, p_ref, onehot, ds_ref, ds_err

    acc = torch.empty((n, d), dtype=torch.float32, device=dev)
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    blocks = [(i * vs, min(vs, v - i * vs)) for i in range(n_super)]
    ms = {"ce_fwd": _time_ms(lambda: bce.ce_fwd(x, w, lab), [()], iters=10),
          "ce_dlogits": _time_ms(lambda: [bce._launch_dlogits(
              x, w, lab, lse, scale, ws, v0, vc) for v0, vc in blocks],
              [()], iters=4),
          "ce_dx": _time_ms(lambda: [bce._launch_dx(
              ws, w, acc, dx, v0, vc, i == 0, i == n_super - 1)
              for i, (v0, vc) in enumerate(blocks)], [()], iters=4),
          "ce_dw": _time_ms(lambda: [bce._launch_dw(ws, x, dw, v0, vc)
                                     for v0, vc in blocks], [()], iters=4)}
    bwd_ms = _time_ms(lambda: bce.ce_bwd(x, w, lab, lse, count, one), [()],
                      iters=4)
    # torch.matmul of each bare product at the same shapes (bf16 out): a
    # yardstick of GEMM efficiency without the epilogues, never called by
    # the port
    s_out = {vc: torch.empty((n, vc), dtype=x.dtype, device=dev)
             for _, vc in blocks + [(0, v)]}
    matmul_ms = {
        "ce_fwd": _time_ms(lambda: torch.matmul(x, w.t(), out=s_out[v]),
                           [()], iters=10),
        "ce_dlogits": _time_ms(lambda: [torch.matmul(
            x, w[v0:v0 + vc].t(), out=s_out[vc]) for v0, vc in blocks],
            [()], iters=4),
        "ce_dx": _time_ms(lambda: [torch.matmul(ws[:, :vc], w[v0:v0 + vc],
                                                out=dx) for v0, vc in blocks],
                          [()], iters=4),
        "ce_dw": _time_ms(lambda: [torch.matmul(
            ws[:, :vc].t(), x, out=dw[v0:v0 + vc]) for v0, vc in blocks],
            [()], iters=4)}
    del s_out
    fwd_plain = _time_eager_ms(lambda: bce.ce_fwd_ref(x, w, lab, 512), [()],
                               iters=2)
    bwd_plain = _time_eager_ms(lambda: bce.ce_bwd_ref(
        x, w, lab, lse, count, one, 512), [()], iters=1)
    # the dense path at the same shape: logits, then the port's dense CE
    xr, wr = (t.detach().requires_grad_(True) for t in (x, w))

    def dense_fwd():
        return fnl.cross_entropy(x @ w.t(), lab)

    def dense_fwd_bwd():
        torch.autograd.grad(fnl.cross_entropy(xr @ wr.t(), lab), (xr, wr))

    def blockwise_fwd_bwd():
        torch.autograd.grad(bce.blockwise_ce_loss(xr, wr, lab, chunk=512),
                            (xr, wr))

    dense_fwd_ms = _time_eager_ms(dense_fwd, [()], iters=3)
    dense_fwd_bwd_ms = _time_eager_ms(dense_fwd_bwd, [()], iters=3)
    peak = {}
    for name, fn_ in (("dense", dense_fwd_bwd),
                      ("blockwise", blockwise_fwd_bwd)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn_()
        torch.cuda.synchronize()
        peak[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
    flops = 2 * n * d * v
    in_bytes = n * d * 2 + v * d * 2 + n * 4
    bounds = {"ce_fwd": _bound(in_bytes + 2 * n * 4, flops,
                               BF16_TENSOR_FLOPS),
              "ce_dlogits": _bound(in_bytes + 2 * n * 4 + n * v * 2, flops,
                                   BF16_TENSOR_FLOPS),
              "ce_dx": _bound(n * v * 2 + v * d * 2 + n * d * 2, flops,
                              BF16_TENSOR_FLOPS),
              "ce_dw": _bound(n * v * 2 + n * d * 2 + v * d * 2, flops,
                              BF16_TENSOR_FLOPS)}
    replaces = {"ce_fwd": "paddle_tpu/kernels/blockwise_ce.py:426",
                "ce_dlogits": "paddle_tpu/kernels/blockwise_ce.py:467",
                "ce_dx": "paddle_tpu/kernels/blockwise_ce.py:467",
                "ce_dw": "paddle_tpu/kernels/blockwise_ce.py:485"}
    errs = {"ce_fwd": err["lse"], "ce_dlogits": err["ds"], "ce_dx": err["dx"],
            "ce_dw": err["dw"]}
    shape = f"x ({n}, {d}), W ({v}, {d}) bf16, {n_super} super-blocks of {vs}"
    out = {}
    for name in ms:
        out[name] = dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/kernels/csrc/blockwise_ce.cu",
            replaces=replaces[name], max_abs_err=errs[name], ms=ms[name],
            plain_ms=fwd_plain if name == "ce_fwd" else bwd_plain,
            bound_ms=bounds[name][0], bound_by=bounds[name][1],
            library_ms=None,
            library_note=("no single PyTorch call computes the lm_head "
                          "projection fused with the cross entropy or its "
                          "gradient; the dense path is the yardstick"),
            shape=shape, dense_fwd_ms=dense_fwd_ms,
            dense_fwd_bwd_ms=dense_fwd_bwd_ms, backward_ms=bwd_ms,
            backward_bound_ms=3 * flops / BF16_TENSOR_FLOPS * 1e3,
            dense_peak_gb=peak["dense"], blockwise_peak_gb=peak["blockwise"],
            f32_err_over_bound=f32_ratio, matmul_ms=matmul_ms[name])
        if name != "ce_fwd":
            out[name]["plain_note"] = "the twin's backward computes dx and dW"
    out["ce_dlogits"]["also_replaces"] = [
        "paddle_tpu/kernels/blockwise_ce.py:485 (the recompute of S)"]
    out["ce_dx"]["err_over_bound"] = ratio["dx"]
    out["ce_dw"]["err_over_bound"] = ratio["dw"]
    print(f"[kernel] blockwise CE {shape}: fwd {ms['ce_fwd']:.4f} ms (bound "
          f"{bounds['ce_fwd'][0]:.4f}), dS {ms['ce_dlogits']:.4f}, dx "
          f"{ms['ce_dx']:.4f}, dW {ms['ce_dw']:.4f} ms (bound "
          f"{bounds['ce_dx'][0]:.4f} each); torch.matmul of the bare "
          f"products: fwd {matmul_ms['ce_fwd']:.4f}, dS "
          f"{matmul_ms['ce_dlogits']:.4f}, dx {matmul_ms['ce_dx']:.4f}, dW "
          f"{matmul_ms['ce_dw']:.4f} ms; whole backward {bwd_ms:.4f} ms "
          f"(least work {3 * flops / BF16_TENSOR_FLOPS * 1e3:.4f}); plain "
          f"fwd {fwd_plain:.2f} ms, plain bwd {bwd_plain:.2f} ms; dense "
          f"logits + CE fwd {dense_fwd_ms:.2f} ms, fwd + bwd "
          f"{dense_fwd_bwd_ms:.2f} ms; peak memory of fwd + bwd beyond the "
          f"inputs: dense {peak['dense']:.3f} GB, blockwise "
          f"{peak['blockwise']:.3f} GB; max |err| {errs}, dx / dW |err| / "
          f"bound {ratio}")
    del x, w, lab, got, ws, acc, dx, dw, xr, wr
    torch.cuda.empty_cache()
    out["ce_dx"]["past_old_cap"] = out["ce_dw"]["past_old_cap"] = \
        _ce_past_old_cap(inputs, kernels, twins, held)
    torch.cuda.empty_cache()
    return out


def _ce_past_old_cap(inputs, kernels, twins, held):
    """The blockwise CE forward and backward at N 18432 = 9 x 2048 rows of
    Llama-3-8B's head (D 4096, V 128256): N x V = 2.36e9 offsets past
    the int32 cap that `ce_shape_problems` refused until the kernels'
    offsets were 64-bit. Held against the twin by phase 4's rules."""
    n, d, v = 18432, 4096, 128256
    x, w, lab = inputs(n, d, v, torch.bfloat16)
    lab[2047::2048] = -100
    got = kernels(x, w, lab)
    torch.cuda.synchronize()
    err, ratio = held("past the old cap", got, twins(x, w, lab),
                      CE_BF16_TOL)
    del got
    torch.cuda.empty_cache()
    fwd_bwd_ms = _time_eager_ms(lambda: kernels(x, w, lab), [()], iters=2)
    shape = f"x ({n}, {d}), W ({v}, {d}) bf16"
    print(f"[kernel] blockwise CE past the old int32 cap, {shape} (N x V = "
          f"{n * v}): forward + backward {fwd_bwd_ms:.2f} ms; max |err| "
          f"{err}, dx / dW |err| / bound {ratio}")
    del x, w, lab
    return dict(shape=shape, n_times_v=n * v, max_abs_err=err,
                err_over_bound=ratio, fwd_bwd_ms=fwd_bwd_ms)


# -- phase 5: Llama-3-8B serving ----------------------------------------------

def _prompts(n, vocab, seed, lo=128, hi=1024):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1)))
            .astype(np.int32) for _ in range(n)]


def _serve(model, prompts, max_new, late, eager=False, **geom):
    """Submit all but `late` prompts, run one tick, submit the late one
    (it joins mid-decode), drain. `eager` runs every tick through the
    engine's private eager tick instead of its captured graph. Returns
    (engine, token lists)."""
    from paddle_tpu_torch.inference.paged import PagedKVEngine
    eng = PagedKVEngine(model, device=model.device, **geom)
    if eager:
        eng._tick_program = eng._eager_program
    reqs = {i: eng.submit(p, max_new) for i, p in enumerate(prompts)
            if i != late}
    eng.step()
    reqs[late] = eng.submit(prompts[late], max_new)
    eng.run_until_idle()
    return eng, [reqs[i].result() for i in range(len(prompts))]


def serving_phase(dev, counters, reset, card, profile=False):
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    cfg = llama3_8b_config(fused_norm=True, fused_rope=True)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    print(f"[serve] Llama-3-8B bf16 built on the card in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
          "params)")
    geom = dict(max_slots=8, page_size=16, num_pages=641,
                max_pages_per_slot=80, steps_per_tick=4, kv_dtype="bf16")
    prompts = _prompts(8, cfg.vocab_size, seed=0)
    max_new = 64
    reset()
    t0 = time.perf_counter()
    eng, toks = _serve(model, prompts, max_new, late=7, **geom)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in counters().items() if k in SERVING_KERNELS}
    for i, t in enumerate(toks):
        if len(t) != max_new or not all(0 <= x < cfg.vocab_size for x in t):
            raise AssertionError(f"request {i}: {len(t)} tokens, want "
                                 f"{max_new} in-vocab")
    if sorted(eng._free) != list(range(1, eng.num_pages)) \
            or eng._reserved_unalloc != 0:
        raise AssertionError(f"pages not returned: free {len(eng._free)}, "
                             f"reserved {eng._reserved_unalloc}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    steps = _decode_steps(eng)
    if launches["paged_decode_attention"] != cfg.num_hidden_layers * steps:
        raise AssertionError(f"decode launches {launches} != 32 x {steps}")
    st = dict(eng.stats)
    traced = traced_replays(eng, counters, reset, card, "serve",
                            TRACED_DECODE)
    kv_slot = eng.kv_bytes_per_slot()
    peak = torch.cuda.max_memory_allocated() / 1e9
    del eng
    eng2, toks2 = _serve(model, prompts, max_new, late=7, **geom)
    if toks2 != toks:
        raise AssertionError("second identical run gave other tokens")
    st2 = dict(eng2.stats)
    del eng2
    metrics = dict(
        card=card, prompt_lens=[int(p.size) for p in prompts],
        **_tick_metrics(st),
        prefill_tokens_per_s=st["prefill_tokens"] / st["prefill_s"],
        # the same work again: host-clock rates vary from run to run
        repeat_decode_tokens_per_s=st2["decode_tokens"] / st2["tick_s"],
        repeat_prefill_tokens_per_s=(st2["prefill_tokens"]
                                     / st2["prefill_s"]),
        decode_steps=steps, kv_bytes_per_slot=kv_slot, wall_s=wall,
        peak_mem_gb=peak, launches=launches, tokens=toks,
        traced_replays=traced)
    metrics["eager"] = _eager_run(model, prompts, max_new, geom, toks,
                                  "serve")
    print(f"[serve] {card}: captured tick: decode "
          f"{metrics['decode_tokens_per_s']:.1f} tok/s, prefill "
          f"{metrics['prefill_tokens_per_s']:.1f} tok/s, tick "
          f"{metrics['tick_ms']:.2f} ms ({geom['steps_per_tick']} steps "
          f"of 8 slots; warm-up ticks {st['warmup_ticks']}, warm-up and "
          f"capture {st['warmup_s']:.2f} s), KV {kv_slot} B/slot, wall "
          f"{wall:.2f} s, peak {peak:.2f} GB, launches {launches}; second "
          f"run identical, decode "
          f"{metrics['repeat_decode_tokens_per_s']:.1f} tok/s, prefill "
          f"{metrics['repeat_prefill_tokens_per_s']:.1f} tok/s; eager tick "
          f"identical, decode "
          f"{metrics['eager']['decode_tokens_per_s']:.1f} tok/s, tick "
          f"{metrics['eager']['tick_ms']:.2f} ms")
    metrics["serving_loop"] = serving_loop(model, prompts, geom, card)
    if profile:
        metrics["profile"] = profile_serving(model, prompts, max_new, geom,
                                             card)
    del model
    torch.cuda.empty_cache()
    return metrics


def _decode_steps(eng):
    """Decode steps the engine launched: its ticks' and the warm-up
    ticks' that preceded each capture."""
    return (eng.stats["ticks"] + eng.stats["warmup_ticks"]) \
        * eng.steps_per_tick


def _tick_metrics(st):
    return dict(decode_tokens_per_s=st["decode_tokens"] / st["tick_s"],
                tick_ms=st["tick_s"] / st["ticks"] * 1e3,
                ticks=st["ticks"], warmup_ticks=st["warmup_ticks"],
                warmup_s=st["warmup_s"])


def _eager_run(model, prompts, max_new, geom, toks, tag):
    """The same requests through the engine's private eager tick: the
    greedy tokens must equal the captured path's."""
    eng, got = _serve(model, prompts, max_new, late=7, eager=True, **geom)
    if got != toks:
        bad = [i for i, (a, b) in enumerate(zip(got, toks)) if a != b]
        raise AssertionError(f"{tag}: the eager tick gave other tokens "
                             f"than the captured tick (requests {bad})")
    if eng.stats["warmup_ticks"] or eng._programs:
        raise AssertionError(f"{tag}: the eager engine captured a graph")
    out = _tick_metrics(eng.stats)
    del eng
    gc.collect()            # the engine holds its own bound method
    return out


def _trace_want(c):
    """The kernel rows a trace must hold for launch counts `c`: a wrapper
    call launches each of its kernels once (the decode kernel's split and
    combine), and the W8A16 counter counts both routes. The split-K
    reduce runs only where K is split, so no count holds it."""
    decode = c["paged_decode_attention"] + c["paged_decode_attention_int8"]
    wgmma = c["weight_only_int8_matmul_wgmma"]
    return {"paged_decode_split<": decode, "paged_decode_combine<": decode,
            "rmsn_fwd_kernel<": c["rms_norm_residual"],
            "rope_kernel<": c["rope_apply"],
            "w8a16_kernel<": c["weight_only_int8_matmul"] - wgmma,
            "w8a16_wgmma_kernel<": wgmma}


def traced_replays(eng, counters, reset, card, tag, path, n=2):
    """The launch gates read from the card. A captured tick's counts come
    from its capture (each replay adds them), so here `n` replays of the
    engine's greedy tick run under torch.profiler, and each kernel's rows
    in the trace must equal what the counters gained; every kernel of
    `path` must have run. Every slot is idle (KV writes land in the sink
    page, and the decode kernel reads no page), so the replays do less
    work than a served tick. Also the replays' kernel time beside the
    host wall of `n` untraced replays of the same inputs: an idle
    estimate (busy traced, wall untraced)."""
    from torch.profiler import ProfilerActivity, profile
    program = eng._programs[("tick", False)]
    eng._idle_inputs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        program.graph.replay()
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) / n * 1e3
    reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            program()
        torch.cuda.synchronize()
    counted = counters()
    want = _trace_want(counted)
    rows = dict.fromkeys(want, 0)
    busy_us = 0.0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA") or _device_us(e) <= 0:
            continue
        busy_us += _device_us(e)
        for sym in rows:
            if sym in e.key:
                rows[sym] += e.count
    others = {k: v for k, v in counted.items() if v and k not in (
        "paged_decode_attention", "paged_decode_attention_int8",
        "rms_norm_residual", "rope_apply", "weight_only_int8_matmul",
        "weight_only_int8_matmul_wgmma")}
    if rows != want or others:
        raise AssertionError(f"{tag}: {n} traced replays ran kernels "
                             f"{rows}, the counters say {want} "
                             f"(other counters {others})")
    if min(want[k] for k in path) <= 0:
        raise AssertionError(f"{tag}: a replay launched no {path}: {want}")
    busy_ms = busy_us / 1e3 / n
    out = dict(replays=n, kernel_rows=rows, busy_ms=busy_ms,
               replay_ms=replay_ms,
               replay_idle_estimate=1 - busy_ms / replay_ms)
    print(f"[{tag}] {card}: {n} traced replays of the captured tick (every "
          f"slot idle) ran {rows}, as the counters say; kernels "
          f"{busy_ms:.3f} ms a replay; untraced a replay takes "
          f"{replay_ms:.3f} ms (idle estimate "
          f"{out['replay_idle_estimate']:.3f})")
    return out


def serving_loop(model, prompts, geom, card):
    """stream() over two requests with the background ticker running
    gives each the tokens generate() gave it; a request cancelled
    mid-decode returns every page and its reservation; stop() joins the
    ticker within its timeout. The two prompts lie in different prefill
    buckets, so each prefills alone whenever the ticker admits it."""
    from paddle_tpu_torch.inference.paged import PagedKVEngine
    by_bucket = {}
    for p in prompts:
        by_bucket.setdefault(PagedKVEngine._bucket(p.size), p)
    pair = list(by_bucket.values())[:2]
    max_new = 16
    want = PagedKVEngine(model, device=model.device, **geom).generate(
        pair, max_new)
    eng = PagedKVEngine(model, device=model.device, **geom)
    ids = np.zeros((2, max(p.size for p in pair)), np.int32)
    mask = np.zeros(ids.shape, bool)
    for i, p in enumerate(pair):
        ids[i, :p.size], mask[i, :p.size] = p, True
    try:
        t0 = time.perf_counter()
        rows = list(eng.stream(ids, max_new_tokens=max_new,
                               attention_mask=mask))
        stream_s = time.perf_counter() - t0
        got = [[int(r[j]) for r in rows] for j in range(2)]
        if got != want:
            raise AssertionError("stream(): rows differ from generate()'s "
                                 f"tokens: {got} vs {want}")
        if ("tick", False) not in eng._programs:
            raise AssertionError("stream(): the ticker captured no tick")
        req = eng.submit(pair[0], 64)
        it = req.stream_tokens()
        next(it), next(it)
        req.cancel()
        if not req.done.wait(timeout=60):
            raise AssertionError("cancel: the request did not end")
        deadline = time.monotonic() + 60
        while eng.has_work() and time.monotonic() < deadline:
            time.sleep(0.01)
        if sorted(eng._free) != list(range(1, eng.num_pages)) \
                or eng._reserved_unalloc != 0 \
                or eng.stats["cancelled"] != 1:
            raise AssertionError(
                f"cancel: free {len(eng._free)}, reserved "
                f"{eng._reserved_unalloc}, cancelled "
                f"{eng.stats['cancelled']}")
    finally:
        t1 = time.perf_counter()
        eng.stop()
        stop_s = time.perf_counter() - t1
    if eng._ticker.is_alive():
        raise AssertionError("stop(): the ticker did not join in 30 s")
    print(f"[serve-loop] {card}: stream() of 2 requests x {max_new} tokens "
          f"(prompts {[int(p.size) for p in pair]}) equal to generate() in "
          f"{stream_s:.2f} s; a request cancelled after "
          f"{len(req.tokens)} tokens returned its pages and reservation; "
          f"stop() joined in {stop_s * 1e3:.1f} ms")
    return dict(stream_s=stream_s, stop_s=stop_s,
                cancelled_after=len(req.tokens))


def _device_us(evt):
    return (getattr(evt, "self_device_time_total", None)
            or getattr(evt, "self_cuda_time_total", 0))


def _norm_rows(kernels):
    """The RMSNorm and RoPE kernels' own profiler rows, in or out of the
    top."""
    return [(e.key[:90], _device_us(e) / 1e3, e.count) for e in kernels
            if "rms" in e.key or "rope" in e.key]


def profile_serving(model, prompts, max_new, geom, card, label=""):
    """Where the time goes (`--profile`): torch.profiler over the prefill
    of all prompts and over two decode ticks, replays of the captured
    tick (one untraced tick first warms it up and captures it); device
    busy time is the sum of the kernels' device times (one stream, so
    they do not overlap), idle share = 1 - busy / host wall time."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference.paged import PagedKVEngine
    eng = PagedKVEngine(model, device=model.device, **geom)
    for p in prompts:
        eng.submit(p, max_new)
    out = {}

    def trace(phase, run):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # kernel rows only: an operator's row repeats its kernels' time
        kernels = [e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and _device_us(e) > 0]
        busy = sum(_device_us(e) for e in kernels) / 1e6
        top = sorted(kernels, key=_device_us, reverse=True)[:12]
        out[phase] = dict(
            wall_s=wall, device_busy_s=busy,
            idle_share=max(0.0, 1 - busy / wall) if wall else None,
            top=[(e.key[:90], _device_us(e) / 1e3, e.count) for e in top],
            norm=_norm_rows(kernels))
        print(f"[profile] {card} {label}{phase}: wall {wall * 1e3:.1f} ms, device "
              f"busy {busy * 1e3:.1f} ms, idle share "
              f"{out[phase]['idle_share']:.3f}")
        for name, ms, n in out[phase]["top"]:
            print(f"[profile]   {ms:9.3f} ms  x{n:<6} {name}")
        for name, ms, n in out[phase]["norm"]:
            print(f"[profile] norm {ms:9.3f} ms  x{n:<6} {name}")

    trace("prefill", eng._admit)
    eng.step()          # untraced: the warm-up tick and the capture
    trace("decode_2_ticks", lambda: (eng.step(), eng.step()))
    eng.run_until_idle()
    return out


# -- phase 6: continuous-batching parity ---------------------------------------

def parity_phase(dev):
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama3_8b_config(num_hidden_layers=2, fused_norm=True,
                           fused_rope=True)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=1)
    geom = dict(max_slots=8, page_size=16, num_pages=641,
                max_pages_per_slot=80, steps_per_tick=4)
    target = _prompts(1, cfg.vocab_size, seed=2, lo=200, hi=200)[0]
    others = _prompts(7, cfg.vocab_size, seed=3, lo=64, hi=512)
    max_new = 32
    _, (alone,) = _serve(model, [target], max_new, late=0, **geom)
    _, joined = _serve(model, others + [target], max_new, late=7, **geom)
    joined = joined[7]
    if joined == alone:
        print(f"[parity] 2-layer f32: {max_new} greedy tokens identical "
              "alone and joined mid-decode of 7 others")
        return {"identical": True}
    t = next(i for i, (a, j) in enumerate(zip(alone, joined)) if a != j)
    ids = torch.from_numpy(np.concatenate(
        [target, np.asarray(alone[:t], np.int32)]))[None].to(dev)
    logits = model(ids)[0, -1]
    gap = abs(float(logits[alone[t]] - logits[joined[t]]))
    print(f"[parity] tokens differ at step {t}: {alone[t]} vs {joined[t]}, "
          f"logit gap {gap:.3g}")
    if gap > 1e-3:
        raise AssertionError(f"parity: step {t} differs by a logit gap "
                             f"{gap} > 1e-3")
    return {"identical": False, "step": t, "logit_gap": gap}


# -- phase 7: TinyLlama-1.1B training ---------------------------------------

def _tinyllama_config(**overrides):
    """bench.py's TinyLlama-1.1B (paddle_tpu bench.py:1182-1192) with the
    dense loss (loss_chunk=0) and the fused norm and RoPE kernels; phase
    9 overrides these back to bench.py's own values."""
    from paddle_tpu_torch.models.llama import LlamaConfig
    base = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                num_hidden_layers=22, num_attention_heads=32,
                num_key_value_heads=4, max_position_embeddings=2048,
                rope_theta=10000.0, seq_length=2048, recompute=True,
                use_flash_attention=True, loss_chunk=0, fused_norm=True,
                fused_rope=True)
    base.update(overrides)
    return LlamaConfig(**base)


def expected_train_launches(cfg, tokens):
    """Kernel launches per training step of `cfg` on `tokens` rows, from
    the model's code. Each decoder layer runs one flash forward, and with
    `fused_norm` two RMSNorms and with `fused_rope` RoPE on q and k; with
    recompute all of these run twice (the forward, then again in the
    backward), and one backward of each. The final norm runs once each
    way. With `loss_chunk` > 0 the loss is one blockwise-CE forward and,
    per backward super-block of `ce_super_block` vocab rows, one dS, one
    dx and one dW kernel."""
    from paddle_tpu_torch.kernels.blockwise_ce import ce_super_block
    layers = cfg.num_hidden_layers
    passes = 2 if cfg.recompute else 1
    norm, rope = int(cfg.fused_norm), int(cfg.fused_rope)
    supers = (-(-cfg.vocab_size // ce_super_block(tokens, cfg.vocab_size))
              if cfg.loss_chunk else 0)
    return {"flash_fwd": passes * layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers,
            "rms_norm_residual": norm * (2 * passes * layers + 1),
            "rms_norm_residual_bwd": norm * (2 * layers + 1),
            "rope_apply": rope * 2 * passes * layers,
            "rope_apply_bwd": rope * 2 * layers,
            "paged_decode_attention": 0,
            "ce_fwd": int(bool(cfg.loss_chunk)), "ce_dlogits": supers,
            "ce_dx": supers, "ce_dw": supers}


def training_phase(dev, counters, reset, card, profile=False):
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, flops_per_token
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    cfg = _tinyllama_config()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    opt = topt.AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                     weight_decay=0.01)
    trainer = Trainer(model, opt, TrainStepConfig(compute_dtype="bfloat16"))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train] TinyLlama-1.1B f32 built on the card in "
          f"{time.perf_counter() - t0:.1f} s ({n_params / 1e9:.3f} B params)")
    batch, seq, timed = 8, 2048, 5
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (batch, seq)) \
        .astype(np.int32)
    data = {"input_ids": torch.from_numpy(ids).to(dev),
            "labels": torch.from_numpy(ids).to(dev)}
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    losses = [trainer.step(data)]                    # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(timed):
        losses.append(trainer.step(data))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall {losses}")
    steps = timed + 1
    want = expected_train_launches(cfg, batch * seq)
    per_step = {k: launches[k] / steps for k in want}
    if per_step != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"train: launches per step {per_step} != the "
                             f"count from the code {want}")
    tokens_per_s = batch * seq * timed / wall
    ftok = flops_per_token(cfg, seq) * 8.0 / 6.0     # recompute: ~8N
    metrics = dict(
        card=card, batch=batch, seq=seq, steps_timed=timed,
        tokens_per_s=tokens_per_s, step_ms=wall / timed * 1e3,
        warmup_s=warm, mfu=tokens_per_s * ftok / BF16_TENSOR_FLOPS,
        flops_per_token=ftok,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        losses=losses, launches=launches, launches_per_step=per_step)
    print(f"[train] {card}: {tokens_per_s:.1f} tokens/s, step "
          f"{metrics['step_ms']:.1f} ms, MFU {metrics['mfu']:.4f} (of 989 "
          f"TF/s, {ftok:.4g} flops/token with recompute), peak memory "
          f"{metrics['peak_mem_gb']:.2f} GB, warm-up step {warm:.2f} s")
    print(f"[train] losses {losses}")
    print(f"[train] launches per step {per_step} (= the count from the "
          "code)")
    if profile:
        metrics["profile"] = profile_training(trainer, data, card)
    del trainer, opt, model, data
    torch.cuda.empty_cache()
    return metrics


def bench_training_phase(dev, counters, reset, card, profile=False):
    """Phase 9: bench.py's own training loop (bench.py:1182-1254) through
    the port, with its configuration: the blockwise loss
    (loss_chunk=512), plain norm and RoPE, recompute, flash attention;
    the batch fed by `trainer.data_iter(..., depth=3)`, a warm-up step,
    then 10 timed steps closed by float(loss)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, flops_per_token
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    cfg = _tinyllama_config(loss_chunk=512, loss_vocab_block=0,
                            fused_norm=False, fused_rope=False)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    opt = topt.AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                     weight_decay=0.01)
    trainer = Trainer(model, opt, TrainStepConfig(compute_dtype="bfloat16"))
    torch.cuda.synchronize()
    print(f"[bench-train] TinyLlama-1.1B f32, bench.py's config (loss_chunk "
          f"512, plain norm and RoPE) built in "
          f"{time.perf_counter() - t0:.1f} s")
    batch, seq, steps = 8, 2048, 10
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (batch, seq)) \
        .astype(np.int32)
    data = {"input_ids": ids, "labels": ids}
    torch.cuda.reset_peak_memory_stats()
    reset()
    it = trainer.data_iter(itertools.repeat(data, steps + 1), depth=3)
    t0 = time.perf_counter()
    losses = [float(trainer.step(next(it)))]          # warm-up
    warm = time.perf_counter() - t0
    step_losses = []
    t0 = time.perf_counter()
    for b in it:
        loss = trainer.step(b)
        step_losses.append(loss)
    loss = float(loss)          # the last step's output closes the chain
    dt = time.perf_counter() - t0
    it.close()
    launches = counters()
    losses += [float(x) for x in step_losses]
    if len(losses) != steps + 1 or not all(np.isfinite(losses)):
        raise AssertionError(f"bench-train: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"bench-train: the loss did not fall {losses}")
    want = expected_train_launches(cfg, batch * seq)
    per_step = {k: launches[k] / (steps + 1) for k in want}
    if per_step != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"bench-train: launches per step {per_step} != "
                             f"the count from the code {want}")
    tokens_per_s = batch * seq * steps / dt
    ftok = flops_per_token(cfg, seq) * 8.0 / 6.0       # recompute: ~8N
    metrics = dict(
        card=card, batch=batch, seq=seq, steps_timed=steps,
        tokens_per_s=tokens_per_s, step_ms=dt / steps * 1e3, warmup_s=warm,
        mfu=tokens_per_s * ftok / BF16_TENSOR_FLOPS, flops_per_token=ftok,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, losses=losses,
        launches=launches, launches_per_step=per_step)
    print(f"[bench-train] {card}: {tokens_per_s:.1f} tokens/s, step "
          f"{metrics['step_ms']:.1f} ms, MFU {metrics['mfu']:.4f} (of 989 "
          f"TF/s, {ftok:.4g} flops/token with recompute), peak memory "
          f"{metrics['peak_mem_gb']:.2f} GB, warm-up step {warm:.2f} s")
    print(f"[bench-train] losses {losses}")
    print(f"[bench-train] launches per step {per_step} (= the count from "
          "the code)")
    placed = trainer._place(data)
    metrics["phase_seconds"] = trainer.measure_phase_seconds(placed, iters=2)
    print(f"[bench-train] {card}: measure_phase_seconds "
          f"{metrics['phase_seconds']}")
    if profile:
        metrics["profile"] = profile_training(trainer, placed, card)
    del trainer, opt, model, placed
    torch.cuda.empty_cache()
    return metrics


def profile_training(trainer, data, card):
    """Where the time goes (`--profile`): torch.profiler over one
    training step; device busy time is the sum of the kernels' device
    times (one stream), idle share = 1 - busy / host wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=_device_us, reverse=True)[:20]
    out = dict(wall_s=wall, device_busy_s=busy,
               idle_share=max(0.0, 1 - busy / wall) if wall else None,
               top=[(e.key[:90], _device_us(e) / 1e3, e.count) for e in top],
               norm=_norm_rows(kernels))
    print(f"[profile] {card} train step: wall {wall * 1e3:.1f} ms, device "
          f"busy {busy * 1e3:.1f} ms, idle share {out['idle_share']:.3f}")
    for name, ms, n in out["top"]:
        print(f"[profile]   {ms:9.3f} ms  x{n:<6} {name}")
    for name, ms, n in out["norm"]:
        print(f"[profile] norm {ms:9.3f} ms  x{n:<6} {name}")
    return out


# -- phase 8: training parity, card against CPU -----------------------------

# bf16-compute parity: the loss within this fraction of itself, and each
# gradient within this fraction of its own norm (||card - cpu|| <=
# tol * ||cpu||): the card's cuBLAS and the CPU round the same bf16
# products after sums in other orders, and each flip of a rounding
# travels through the layers
TRAIN_BF16_LOSS_TOL = 1e-3
TRAIN_BF16_GRAD_TOL = 4e-2


def _parity_step(cfg, state, ids, dev, compute_dtype, opt_kw=dict,
                 **step_kw):
    """(loss, {name: gradient on the CPU}) of one Trainer step from
    `state`, on the CPU through the twins and on the card through the
    kernels. `opt_kw()` gives extra AdamW arguments (a fresh schedule per
    device), `step_kw` extra TrainStepConfig fields."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    results = []
    for device in ("cpu", dev):
        model = LlamaForCausalLM(cfg, device=device)
        model.load_state_dict(state)
        kw = {"learning_rate": 1e-4, **opt_kw()}
        trainer = Trainer(model, topt.AdamW(
            parameters=model.named_parameters(), **kw),
            TrainStepConfig(compute_dtype=compute_dtype, **step_kw))
        loss = float(trainer.step({"input_ids": ids, "labels": ids}))
        if step_kw.get("skip_nonfinite_grads") and trainer.nonfinite_skipped:
            raise AssertionError(f"train parity: a finite step on {device} "
                                 "was skipped")
        results.append((loss, {n: p.grad.cpu() for n, p in
                               model.named_parameters()}))
        del trainer, model
    torch.cuda.empty_cache()
    return results


def training_parity_phase(dev):
    """One Trainer step of a 2-layer model at TinyLlama's full width: the
    card through the kernels against the CPU through the twins, with the
    same state and batch, first in f32 and then with bf16 compute (the
    twins round p and dS to bf16 where the kernels do, so this holds the
    bf16 kernels against an independent path).

    f32: the loss within 1e-5 relative; every gradient within 1e-4 of its
    largest entry (the same f32 products summed in other orders). bf16:
    TRAIN_BF16_LOSS_TOL and TRAIN_BF16_GRAD_TOL. The updated parameters
    are not compared: Adam divides each gradient entry by its own
    magnitude, so an entry within the noise of zero can step by the
    learning rate either way."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _tinyllama_config(num_hidden_layers=2)
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, (1, 256)) \
        .astype(np.int32)
    state = LlamaForCausalLM(cfg, device="cpu", seed=0).state_dict()
    out = {}
    (cpu_loss, cpu_g), (gpu_loss, gpu_g) = _parity_step(cfg, state, ids, dev,
                                                         None)
    if abs(gpu_loss - cpu_loss) > 1e-5 * abs(cpu_loss):
        raise AssertionError(f"train parity: loss {gpu_loss} on the card, "
                             f"{cpu_loss} on the CPU")
    worst = 0.0
    for name, g in cpu_g.items():
        rel = float((gpu_g[name] - g).abs().max()) / max(
            float(g.abs().max()), 1e-30)
        if rel > 1e-4:
            raise AssertionError(f"train parity: {name} gradient differs by "
                                 f"{rel:.3g} of its largest entry")
        worst = max(worst, rel)
    print(f"[train-parity] 2-layer TinyLlama width f32: loss card "
          f"{gpu_loss:.7f} cpu {cpu_loss:.7f}; worst gradient difference "
          f"{worst:.3g} of its largest entry (tolerance 1e-4)")
    out["f32"] = {"loss_card": gpu_loss, "loss_cpu": cpu_loss,
                  "worst_grad_rel": worst}
    (cpu_loss, cpu_g), (gpu_loss, gpu_g) = _parity_step(cfg, state, ids, dev,
                                                         "bfloat16")
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    if loss_rel > TRAIN_BF16_LOSS_TOL:
        raise AssertionError(f"train parity bf16: loss {gpu_loss} on the "
                             f"card, {cpu_loss} on the CPU")
    rels = {name: float((gpu_g[name] - g).norm() / g.norm().clamp_min(1e-30))
            for name, g in cpu_g.items()}
    name = max(rels, key=rels.get)
    if rels[name] > TRAIN_BF16_GRAD_TOL:
        raise AssertionError(f"train parity bf16: {name} gradient differs by "
                             f"{rels[name]:.3g} of its norm")
    print(f"[train-parity] 2-layer TinyLlama width bf16 compute: loss card "
          f"{gpu_loss:.7f} cpu {cpu_loss:.7f} ({loss_rel:.3g} relative, "
          f"tolerance {TRAIN_BF16_LOSS_TOL}); worst gradient difference "
          f"{rels[name]:.3g} of its norm, {name} (tolerance "
          f"{TRAIN_BF16_GRAD_TOL}); median "
          f"{float(np.median(list(rels.values()))):.3g}")
    out["bf16"] = {"loss_card": gpu_loss, "loss_cpu": cpu_loss,
                   "loss_rel": loss_rel, "worst_grad_rel_norm": rels[name],
                   "grad_rel_norm": rels}
    out["blockwise_f32"] = _blockwise_parity(cfg, state, ids, dev)
    return out


def _blockwise_parity(cfg, state, ids, dev):
    """Phase 8's blockwise-loss step: the 2-layer model with loss_chunk
    512, AdamW with ClipGradByGlobalNorm(1.0) and a LinearWarmup
    schedule, skip_nonfinite_grads on; f32, the card's CE kernels against
    the CPU's twin. The loss within 1e-5 relative, every gradient within
    1e-4 of its largest entry (as the f32 step above)."""
    from dataclasses import replace
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.kernels import blockwise_ce as bce
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    def opt_kw():
        return dict(learning_rate=topt.lr.LinearWarmup(
            learning_rate=1e-4, warmup_steps=10, start_lr=1e-5, end_lr=1e-4),
            grad_clip=ClipGradByGlobalNorm(1.0))

    before = dict(bce.launches)
    (cpu_loss, cpu_g), (gpu_loss, gpu_g) = _parity_step(
        replace(cfg, loss_chunk=512), state, ids, dev, None, opt_kw,
        skip_nonfinite_grads=True)
    if not all(bce.launches[k] > before[k] for k in before):
        raise AssertionError(f"train parity: the blockwise step did not "
                             f"launch every CE kernel {bce.launches}")
    if abs(gpu_loss - cpu_loss) > 1e-5 * abs(cpu_loss):
        raise AssertionError(f"train parity blockwise: loss {gpu_loss} on "
                             f"the card, {cpu_loss} on the CPU")
    worst = 0.0
    for name, g in cpu_g.items():
        rel = float((gpu_g[name] - g).abs().max()) / max(
            float(g.abs().max()), 1e-30)
        if rel > 1e-4:
            raise AssertionError(f"train parity blockwise: {name} gradient "
                                 f"differs by {rel:.3g} of its largest entry")
        worst = max(worst, rel)
    print(f"[train-parity] 2-layer TinyLlama width f32, blockwise loss "
          f"(chunk 512), global-norm clip, LinearWarmup, skip_nonfinite: "
          f"loss card {gpu_loss:.7f} cpu {cpu_loss:.7f}; worst gradient "
          f"difference {worst:.3g} of its largest entry (tolerance 1e-4)")
    return {"loss_card": gpu_loss, "loss_cpu": cpu_loss,
            "worst_grad_rel": worst}


# -- phase 10: Llama-3-8B int8 serving ------------------------------------------

INT8_SERVING_KERNELS = ("paged_decode_attention_int8", "weight_only_int8_matmul",
                        "weight_only_int8_matmul_wgmma", "rms_norm_residual",
                        "rope_apply")
# mean |quantized - float| / mean |float| of one projection on a prefill
# activation (the pin of tests/test_quantization_int8.py:63-74)
W8A16_REL_TOL = 0.02


def int8_serving_phase(dev, counters, reset, card, bf16_serving,
                       profile=False):
    """Phase 10: Llama-3-8B (seed 0, bf16) converted by
    `quantize_weight_only` on the card, served through
    PagedKVEngine(kv_dtype="int8") with phase 5's geometry, prompts and
    late joiner."""
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.nn import functional as fnl
    from paddle_tpu_torch.quantization import quantize_weight_only
    cfg = llama3_8b_config(fused_norm=True, fused_rope=True)
    torch.cuda.reset_peak_memory_stats()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    prompts = _prompts(8, cfg.vocab_size, seed=0)
    # layer 0's float projections and a prefill activation of each width,
    # kept for the per-projection check
    layer = model.model.layers[0]
    projs = {n: getattr(layer.self_attn, n) for n in
             ("q_proj", "k_proj", "v_proj", "o_proj")}
    projs.update({n: getattr(layer.mlp, n) for n in
                  ("gate_proj", "up_proj", "down_proj")})
    floats = {n: m.weight.detach().clone() for n, m in projs.items()}
    ids = torch.from_numpy(prompts[0].astype(np.int64)).to(dev)
    x = layer.input_layernorm(model.model.embed_tokens(ids))
    h = fnl.swiglu(x @ floats["gate_proj"].t(), x @ floats["up_proj"].t())
    del projs
    t0 = time.perf_counter()
    quantize_weight_only(model)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    convert_peak = torch.cuda.max_memory_allocated() / 1e9
    layer = model.model.layers[0]
    rel = {}
    for name, w in floats.items():
        mod = getattr(layer.mlp if name in ("gate_proj", "up_proj",
                                            "down_proj") else
                      layer.self_attn, name)
        xin = h if name == "down_proj" else x
        ref = torch.nn.functional.linear(xin.float(), w.float())
        got = mod(xin).float()
        rel[name] = float((got - ref).abs().mean() / ref.abs().mean())
    del floats, x, h
    print(f"[int8] Llama-3-8B converted to W8A16 on the card in {convert_s:.1f}"
          f" s (peak {convert_peak:.2f} GB); layer 0 mean |q - f| / mean |f| "
          f"on a prefill activation: "
          + ", ".join(f"{k} {v:.4f}" for k, v in rel.items()))
    if not max(rel.values()) < W8A16_REL_TOL:
        raise AssertionError(f"int8: a projection is off by more than "
                             f"{W8A16_REL_TOL}: {rel}")
    weight_gb = sum(t.numel() * t.element_size() for t in
                    itertools.chain(model.parameters(), model.buffers())) / 1e9
    geom = dict(max_slots=8, page_size=16, num_pages=641,
                max_pages_per_slot=80, steps_per_tick=4, kv_dtype="int8")
    max_new = 64
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    eng, toks = _serve(model, prompts, max_new, late=7, **geom)
    wall = time.perf_counter() - t0
    all_counts = counters()
    launches = {k: all_counts[k] for k in INT8_SERVING_KERNELS}
    for i, t in enumerate(toks):
        if len(t) != max_new or not all(0 <= v < cfg.vocab_size for v in t):
            raise AssertionError(f"int8 request {i}: {len(t)} tokens, want "
                                 f"{max_new} in-vocab")
    if sorted(eng._free) != list(range(1, eng.num_pages)) \
            or eng._reserved_unalloc != 0:
        raise AssertionError(f"int8: pages not returned: free "
                             f"{len(eng._free)}, reserved "
                             f"{eng._reserved_unalloc}")
    # every page but the sink went back with its scale rows zeroed (page
    # 0 is never written)
    left = float(eng._scales[:, :, :-1].abs().sum())
    if left != 0.0:
        raise AssertionError(f"int8: freed pages kept scales (sum {left})")
    steps = _decode_steps(eng)
    calls = eng.stats["prefill_calls"] + steps
    per_call = 7 * cfg.num_hidden_layers + 1
    if launches["paged_decode_attention_int8"] != cfg.num_hidden_layers * steps:
        raise AssertionError(f"int8 decode launches {launches} != 32 x "
                             f"{steps}")
    if launches["weight_only_int8_matmul"] != per_call * calls:
        raise AssertionError(f"W8A16 launches {launches} != {per_call} x "
                             f"{calls} model calls")
    # the projections of every prefill call above the route's threshold
    # take the wgmma kernel (the lm_head runs at M = the group's size)
    from paddle_tpu_torch.kernels import quant_matmul as qm
    from paddle_tpu_torch.inference.paged import PagedKVEngine
    call_ms = _prefill_call_ms(prompts, 7, PagedKVEngine._bucket)
    big = sum(m > qm._SMALL_M for m in call_ms)
    if eng.stats["prefill_calls"] != len(call_ms):
        raise AssertionError(f"int8: {eng.stats['prefill_calls']} prefill "
                             f"calls, want {len(call_ms)} ({call_ms})")
    if launches["weight_only_int8_matmul_wgmma"] != \
            7 * cfg.num_hidden_layers * big:
        raise AssertionError(f"wgmma W8A16 launches {launches} != 7 x "
                             f"{cfg.num_hidden_layers} x {big} prefill calls "
                             f"of M {call_ms}")
    if all_counts["paged_decode_attention"] != 0:
        raise AssertionError("int8 serving launched the float decode kernel")
    kv_slot = eng.kv_bytes_per_slot()
    kv_ratio = kv_slot / bf16_serving["kv_bytes_per_slot"]
    if not kv_ratio <= 0.51:
        raise AssertionError(f"int8 KV bytes per slot {kv_slot} = "
                             f"{kv_ratio:.4f} x bf16's, want <= 0.51")
    st = dict(eng.stats)
    traced = traced_replays(eng, counters, reset, card, "int8", TRACED_INT8)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del eng
    eng2, toks2 = _serve(model, prompts, max_new, late=7, **geom)
    if toks2 != toks:
        raise AssertionError("int8: a second identical run gave other tokens")
    st2 = dict(eng2.stats)
    del eng2
    # top-1 agreement with phase 5's bf16 model (same seed, same prompts):
    # its prefill token and its first decode step's token, per request
    ref = bf16_serving["tokens"]
    agree = {f"token_{j}": sum(a[j] == b[j] for a, b in zip(toks, ref))
             / len(ref) for j in (0, 1)}
    metrics = dict(
        card=card, **_tick_metrics(st),
        prefill_tokens_per_s=st["prefill_tokens"] / st["prefill_s"],
        repeat_decode_tokens_per_s=st2["decode_tokens"] / st2["tick_s"],
        repeat_prefill_tokens_per_s=(st2["prefill_tokens"]
                                     / st2["prefill_s"]),
        decode_steps=steps,
        prefill_calls=st["prefill_calls"], kv_bytes_per_slot=kv_slot,
        kv_ratio_to_bf16=kv_ratio, weight_gb=weight_gb, wall_s=wall,
        peak_mem_gb=peak, convert_s=convert_s, convert_peak_gb=convert_peak,
        projection_rel_err=rel, top1_agreement_with_bf16=agree,
        launches=launches, tokens=toks, traced_replays=traced)
    metrics["eager"] = _eager_run(model, prompts, max_new, geom, toks, "int8")
    print(f"[int8] {card}: captured tick: decode "
          f"{metrics['decode_tokens_per_s']:.1f} tok/s, prefill "
          f"{metrics['prefill_tokens_per_s']:.1f} tok/s, tick "
          f"{metrics['tick_ms']:.2f} ms ({geom['steps_per_tick']} steps of 8 "
          f"slots; warm-up ticks {st['warmup_ticks']}, warm-up and capture "
          f"{st['warmup_s']:.2f} s), KV {kv_slot} B/slot ({kv_ratio:.4f} x "
          f"bf16), weights {weight_gb:.2f} GB, peak {peak:.2f} GB, wall "
          f"{wall:.2f} s, launches {launches} ({per_call} W8A16 x {calls} "
          f"model calls); second run identical, decode "
          f"{metrics['repeat_decode_tokens_per_s']:.1f} tok/s, prefill "
          f"{metrics['repeat_prefill_tokens_per_s']:.1f} tok/s; eager tick "
          f"identical, decode "
          f"{metrics['eager']['decode_tokens_per_s']:.1f} tok/s, tick "
          f"{metrics['eager']['tick_ms']:.2f} ms; top-1 agreement with "
          f"phase 5's bf16 tokens {agree}")
    if profile:
        metrics["profile"] = profile_serving(model, prompts, max_new, geom,
                                             card, label="int8 ")
    del model
    torch.cuda.empty_cache()
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="also trace the serving path and one step of each "
                         "training configuration with torch.profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.kernels import _build, launch_counters
    from paddle_tpu_torch.kernels import blockwise_ce as bce
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_norm as fn
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.kernels import quant_matmul as qm
    from paddle_tpu_torch.inference.paged import PagedKVEngine
    from paddle_tpu_torch.nn import functional as fnl

    card = _card()
    print(card)
    dev = torch.device("cuda")
    t_build = time.perf_counter()
    _build.load_library()
    info = _build.build_info()
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"[build] {info['sources']} -> {info['path']} in "
          f"{time.perf_counter() - t_build:.1f} s (compiled: "
          f"{info['built']})")
    for ln in regs:
        print(f"[build] {ln}")

    t_start = time.perf_counter()
    kernels = norm_phases(dev, fn)
    kernels.update(kernel_phases(dev, pa))
    call_ms = _prefill_call_ms(_prompts(8, 128256, seed=0), 7,
                               PagedKVEngine._bucket)
    kernels.update(rope_phases(dev, fn, call_ms[0]))
    kernels.update(int8_kernel_phases(dev, pa, qm, call_ms[0], call_ms[-1]))
    kernels.update(flash_phases(dev, fa))
    kernels.update(ce_phases(dev, bce, fnl))

    def reset():
        for d in launch_counters():
            for k in d:
                d[k] = 0

    def counters():
        return {k: v for d in launch_counters() for k, v in d.items()}

    serving = serving_phase(dev, counters, reset, card, args.profile)
    parity = parity_phase(dev)
    training = training_phase(dev, counters, reset, card, args.profile)
    train_parity = training_parity_phase(dev)
    bench_training = bench_training_phase(dev, counters, reset, card,
                                          args.profile)
    serving_int8 = int8_serving_phase(dev, counters, reset, card, serving,
                                      args.profile)
    for name, e in kernels.items():
        by_path = {"serving": serving["launches"].get(name, 0),
                   "training": training["launches"].get(name, 0),
                   "training_bench": bench_training["launches"].get(name, 0),
                   "serving_int8": serving_int8["launches"].get(name, 0)}
        if sum(by_path.values()) <= 0:
            raise AssertionError(f"{name} was launched on no main path")
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path
    now = time.perf_counter()
    print(f"[time] build {t_start - t_build:.1f} s, phases "
          f"{now - t_start:.1f} s, total {now - t_build:.1f} s")
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    line = {"kernels": [{**{k: e[k] for k in order},
                         **{k: v for k, v in e.items() if k not in order}}
                        for e in kernels.values()]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernels": line["kernels"],
                       "serving": serving, "parity": parity,
                       "training": training, "train_parity": train_parity,
                       "training_bench": bench_training,
                       "serving_int8": serving_int8,
                       "torch": torch.__version__}, f, indent=1)
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
