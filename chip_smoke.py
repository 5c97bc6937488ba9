#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Phases, each of which fails the run (non-zero exit) on any error:

1. the card's name and power limit (nvidia-smi);
2. the CUDA kernels built from paddle_tpu_torch/kernels/csrc;
3. every kernel of the serving path held against its plain PyTorch twin
   on the card at the shapes the path gives it (bf16 and f32), timed
   beside the twin, one library call where there is one, and the least
   time the card could take (bytes / 3.35 TB/s, or operations / peak);
4. Llama-3-8B at full width (32 layers, bf16, weights from a seed) behind
   a PagedKVEngine serving 8 requests of 128..1024 prompt tokens and 64
   new tokens each, one of them joining mid-decode; the launch counters
   of the three kernels show that path went through them; a second run
   gives the same greedy tokens;
5. continuous-batching parity on a 2-layer full-width f32 model: a
   request's greedy tokens alone equal its tokens when it joins
   mid-decode of 7 others (or, at a near-tie, the two tokens' logits
   agree within 1e-3).

The last line is {"ok": true, "device": {...}}; it is printed only when
every phase passed. Without a CUDA device the script exits non-zero
before printing any result.
"""
from __future__ import annotations

import argparse
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


def _check(name, out, ref, tol):
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol, msg=name)
    return float((out - ref).abs().max())


# -- phase 3: kernels against their twins ---------------------------------

def kernel_phases(dev, fn, pa):
    """Returns {kernel name: JSON entry without launches}."""
    g = torch.Generator(device=dev).manual_seed(0)
    rows, d, eps = 8, 4096, 1e-5          # decode: one row per slot

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    # RMSNorm(+residual): decode rows and a prefill-sized block, both types
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for n in (rows, 4096):
            x, r, w = randn(n, d, dtype=dtype), randn(n, d, dtype=dtype), \
                randn(d, dtype=dtype)
            for res in (None, r):
                y, h = fn.rms_norm_residual(x, w, res, eps)
                ry, rh = fn.rms_norm_residual_ref(x, w, res, eps)
                torch.cuda.synchronize()
                _check(f"rms_norm {dtype} n={n} res={res is not None}", y,
                       ry, tol)
                if not torch.equal(h, rh):
                    raise AssertionError("rms_norm: h != x + residual")
    sets = [(randn(rows, d), randn(rows, d), randn(d)) for _ in range(4)]
    x, r, w = sets[0]
    err = _check("rms_norm bf16", fn.rms_norm_residual(x, w, None, eps)[0],
                 fn.rms_norm_residual_ref(x, w, None, eps)[0], BF16_TOL)
    err = max(err, _check("rms_norm+res bf16",
                          fn.rms_norm_residual(x, w, r, eps)[0],
                          fn.rms_norm_residual_ref(x, w, r, eps)[0],
                          BF16_TOL))
    elem = rows * d
    nores = [(s[0], s[2]) for s in sets]
    norm = dict(
        name="rms_norm_residual", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/fused_norm.cu",
        replaces="paddle_tpu/kernels/fused_norm.py:185",
        max_abs_err=err,
        ms=_time_ms(lambda a, b: fn.rms_norm_residual(a, b, None, eps),
                    nores),
        plain_ms=_time_ms(lambda a, b: fn.rms_norm_residual_ref(a, b, None,
                                                                eps), nores),
        library_ms=_time_ms(
            lambda a, b: torch.nn.functional.rms_norm(a, (d,), b, eps),
            nores),
        shape=f"x ({rows}, {d}) bf16, no residual",
        residual_ms=_time_ms(lambda a, b, c: fn.rms_norm_residual(
            a, c, b, eps), sets),
        residual_plain_ms=_time_ms(lambda a, b, c: fn.rms_norm_residual_ref(
            a, c, b, eps), sets))
    norm["bound_ms"], norm["bound_by"] = _bound(
        2 * elem * 2 + d * 2, 4 * elem, F32_FLOPS)
    norm["residual_bound_ms"] = _bound(4 * elem * 2 + d * 2, 5 * elem,
                                       F32_FLOPS)[0]
    print(f"[kernel] rms_norm_residual bf16 (8, 4096): {norm['ms']:.4f} ms, "
          f"plain {norm['plain_ms']:.4f} ms, torch rms_norm "
          f"{norm['library_ms']:.4f} ms, bound {norm['bound_ms']:.5f} ms; "
          f"with residual {norm['residual_ms']:.4f} ms, plain "
          f"{norm['residual_plain_ms']:.4f} ms, bound "
          f"{norm['residual_bound_ms']:.5f} ms; max |err| {err:.3g}")

    # RoPE: q (8, 1, 32, 128) and k (8, 1, 8, 128) at decode positions
    pos = torch.randint(0, 1280, (rows, 1), generator=g, device=dev,
                        dtype=torch.int32)
    theta = 500000.0
    err = 0.0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for heads in (32, 8):
            xq = randn(rows, 1, heads, 128, dtype=dtype)
            e = _check(f"rope {dtype} h={heads}",
                       fn.rope_apply(xq, pos, theta),
                       fn.rope_apply_ref(xq, pos, theta), tol)
            if dtype == torch.bfloat16:
                err = max(err, e)
    # ... and at the batched prefill's shapes, q/k (8, 1024, 32|8, 128)
    # with positions arange per row and one table pair for both: 2^25
    # elements want more than the launcher's 65535 blocks of 256 threads,
    # so the kernel's grid-stride loop runs past its first pass
    ppos = torch.arange(1024, dtype=torch.int32, device=dev).repeat(rows, 1)
    ptables = fn.rope_tables(ppos.reshape(-1), 128, theta)
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for heads in (32, 8):
            xp = randn(rows, 1024, heads, 128, dtype=dtype)
            e = _check(f"rope prefill {dtype} h={heads}",
                       fn.rope_apply(xp, ppos, theta, tables=ptables),
                       fn.rope_apply_ref(xp, ppos, theta, tables=ptables),
                       tol)
            if dtype == torch.bfloat16:
                err = max(err, e)
            del xp
    del ptables
    tables = fn.rope_tables(pos.reshape(-1), 128, theta)
    qs = [(randn(rows, 1, 32, 128),) for _ in range(4)]
    rope = dict(
        name="rope_apply", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/fused_norm.cu",
        replaces="paddle_tpu/kernels/fused_norm.py:380",
        max_abs_err=err,
        ms=_time_ms(lambda a: fn.rope_apply(a, pos, theta, tables=tables),
                    qs),
        plain_ms=_time_ms(lambda a: fn.rope_apply_ref(a, pos, theta,
                                                      tables=tables), qs),
        library_ms=None, shape="q (8, 1, 32, 128) bf16, tables shared")
    relem = rows * 32 * 128
    rope["bound_ms"], rope["bound_by"] = _bound(
        2 * relem * 2 + 2 * rows * 128 * 4, 3 * relem, F32_FLOPS)
    print(f"[kernel] rope_apply bf16 q (8, 1, 32, 128): {rope['ms']:.4f} ms,"
          f" plain {rope['plain_ms']:.4f} ms, bound "
          f"{rope['bound_ms']:.5f} ms; max |err| {err:.3g}")

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
    dec = dict(
        name="paged_decode_attention", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/paged_attention.cu",
        replaces="paddle_tpu/kernels/paged_attention.py:274",
        max_abs_err=err, ms=_time_ms(kern, psets),
        plain_ms=_time_ms(plain, psets, iters=20),
        library_ms=_time_ms(library, dense),
        shape=f"b={b} hq={hq} hk={hk} d={hd} page={ps} lens={lens_l} bf16")
    nbytes = (vis * hk * hd * 2 * 2 + b * hq * hd * 2 + b * hq * hd * 4
              + b * mp * 4 + b * 4)
    dec["bound_ms"], dec["bound_by"] = _bound(
        nbytes, 4 * vis * hq * hd, BF16_TENSOR_FLOPS)
    print(f"[kernel] paged_decode_attention bf16 {dec['shape']}: "
          f"{dec['ms']:.4f} ms, plain {dec['plain_ms']:.4f} ms, sdpa "
          f"{dec['library_ms']:.4f} ms, bound {dec['bound_ms']:.5f} ms; "
          f"max |err| {err:.3g}")
    return {k["name"]: k for k in (dec, norm, rope)}


# -- phase 4: Llama-3-8B serving ----------------------------------------------

def _prompts(n, vocab, seed, lo=128, hi=1024):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1)))
            .astype(np.int32) for _ in range(n)]


def _serve(model, prompts, max_new, late, **geom):
    """Submit all but `late` prompts, run one tick, submit the late one
    (it joins mid-decode), drain. Returns (engine, token lists)."""
    from paddle_tpu_torch.inference.paged import PagedKVEngine
    eng = PagedKVEngine(model, device=model.device, **geom)
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
    launches = counters()
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
    steps = eng.stats["ticks"] * eng.steps_per_tick
    if launches["paged_decode_attention"] != cfg.num_hidden_layers * steps:
        raise AssertionError(f"decode launches {launches} != 32 x {steps}")
    st = dict(eng.stats)
    kv_slot = eng.kv_bytes_per_slot()
    del eng
    eng2, toks2 = _serve(model, prompts, max_new, late=7, **geom)
    if toks2 != toks:
        raise AssertionError("second identical run gave other tokens")
    st2 = dict(eng2.stats)
    del eng2
    metrics = dict(
        card=card, prompt_lens=[int(p.size) for p in prompts],
        decode_tokens_per_s=st["decode_tokens"] / st["tick_s"],
        prefill_tokens_per_s=st["prefill_tokens"] / st["prefill_s"],
        tick_ms=st["tick_s"] / st["ticks"] * 1e3,
        # the same work again: host-clock rates vary from run to run
        repeat_decode_tokens_per_s=st2["decode_tokens"] / st2["tick_s"],
        repeat_prefill_tokens_per_s=(st2["prefill_tokens"]
                                     / st2["prefill_s"]),
        ticks=st["ticks"], decode_steps=steps,
        kv_bytes_per_slot=kv_slot, wall_s=wall,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches)
    print(f"[serve] {card}: decode {metrics['decode_tokens_per_s']:.1f} "
          f"tok/s, prefill {metrics['prefill_tokens_per_s']:.1f} tok/s, "
          f"tick {metrics['tick_ms']:.2f} ms ({geom['steps_per_tick']} steps "
          f"of 8 slots), KV {kv_slot} B/slot, wall {wall:.2f} s, launches "
          f"{launches}; second run identical, decode "
          f"{metrics['repeat_decode_tokens_per_s']:.1f} tok/s, prefill "
          f"{metrics['repeat_prefill_tokens_per_s']:.1f} tok/s")
    if profile:
        metrics["profile"] = profile_serving(model, prompts, max_new, geom,
                                             card)
    del model
    torch.cuda.empty_cache()
    return metrics


def _device_us(evt):
    return (getattr(evt, "self_device_time_total", None)
            or getattr(evt, "self_cuda_time_total", 0))


def profile_serving(model, prompts, max_new, geom, card):
    """Where the time goes (`--profile`): torch.profiler over the prefill
    of all prompts and over two decode ticks; device busy time is the sum
    of the kernels' device times (one stream, so they do not overlap),
    idle share = 1 - busy / host wall time."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference.paged import PagedKVEngine
    eng = PagedKVEngine(model, device=model.device, **geom)
    for p in prompts:
        eng.submit(p, max_new)
    out = {}
    for phase, run in (("prefill", eng._admit),
                       ("decode_2_ticks", lambda: (eng.step(), eng.step()))):
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
            top=[(e.key[:90], _device_us(e) / 1e3, e.count) for e in top])
        print(f"[profile] {card} {phase}: wall {wall * 1e3:.1f} ms, device "
              f"busy {busy * 1e3:.1f} ms, idle share "
              f"{out[phase]['idle_share']:.3f}")
        for name, ms, n in out[phase]["top"]:
            print(f"[profile]   {ms:9.3f} ms  x{n:<6} {name}")
    eng.run_until_idle()
    return out


# -- phase 5: continuous-batching parity ---------------------------------------

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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="also trace the serving path with torch.profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import fused_norm as fn
    from paddle_tpu_torch.kernels import paged_attention as pa

    card = _card()
    print(card)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.load_library()
    info = _build.build_info()
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"[build] {info['sources']} -> {info['path']} in "
          f"{time.perf_counter() - t0:.1f} s (compiled: {info['built']})")
    for ln in regs:
        print(f"[build] {ln}")

    kernels = kernel_phases(dev, fn, pa)

    def reset():
        for d in (fn.launches, pa.launches):
            for k in d:
                d[k] = 0

    def counters():
        return {**pa.launches, **fn.launches}

    serving = serving_phase(dev, counters, reset, card, args.profile)
    for name, n in serving["launches"].items():
        kernels[name]["launches"] = n
    parity = parity_phase(dev)
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
                       "torch": torch.__version__}, f, indent=1)
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
