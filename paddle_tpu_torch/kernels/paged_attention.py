"""Paged-attention decode: one query row per slot over its paged KV window.

Counterpart of paddle_tpu/kernels/paged_attention.py, both branches:
bf16/f32 pools, and int8 pools with per-page-per-head f32 scales
(`k_scale` / `v_scale`, (num_pages, hk)). The CUDA kernel
(csrc/paged_attention.cu) splits each slot's window into runs of P pages
(split-KV): one block per (slot, kv_head, tile of at most 8 of its query
heads, split), so a long window is read by many blocks at once. Each
block folds its query heads so each K/V row it reads serves all of them,
keeps an f32 online softmax, and writes a partial (o, m, l) to a
workspace; a second kernel merges the splits in split order (the same
bits every run). Over int8 pools it reads the codes and each page's
scales and never forms the dequantized window. P and the split count
come from `plan`, from static shapes only, never from
`lens`: a call reads nothing back to the host, and a CUDA graph can
capture it. `paged_decode_attention_ref` is the plain twin: gather the
window in f32 (dequantized as the JAX package's `_attend_pages` does),
masked softmax, GQA by reshape.

Masking contract (as in the JAX package): the query of slot i sits at
position lens[i], its own k/v already scattered there, so column c is
visible iff c <= lens[i].
"""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.kernels import LaunchCounter, _build

__all__ = ["paged_decode_attention", "paged_decode_attention_ref",
           "gather_window", "decode_shape_problems", "check_decode_shapes",
           "plan", "launches"]

# one count per pool type: float pools, and int8 pools with scales
launches = LaunchCounter({"paged_decode_attention": 0,
                           "paged_decode_attention_int8": 0})

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# (q, pools) types compiled: one type throughout, an f32 model over bf16
# pools (kv_dtype="bf16"), or either query type over int8 pools
# (kv_dtype="int8")
_DTYPE_PAIRS = {(torch.float32, torch.float32),
                (torch.bfloat16, torch.bfloat16),
                (torch.float32, torch.bfloat16),
                (torch.float32, torch.int8),
                (torch.bfloat16, torch.int8)}
# csrc/paged_attention.cu limits
_HEAD_DIMS = (64, 128, 256)
# window rows a split starts from: 4 warps x one 16-row chunk
# (chosen on the card, PERF.md)
_SPLIT_ROWS = 64
_MAX_SPLITS = 65535   # the grid's third dimension


def plan(max_pages, page_size):
    """(P, n_split): the decode kernel's pages per split and split count
    for block tables of max_pages pages of page_size rows. Static shapes
    only, never the lengths: P = _SPLIT_ROWS // page_size pages (at least
    one), doubled only where the split count would pass the grid's limit.
    The workspace then holds hq * (d + 2) f32 per slot and split, about
    g / 64 of the bf16 KV bytes a full split of 64 rows covers."""
    per = max(1, _SPLIT_ROWS // page_size)
    while -(-max_pages // per) > _MAX_SPLITS:
        per *= 2
    return per, max(1, -(-max_pages // per))


def decode_shape_problems(hq, hk, d, page_size, kv_dtype=None):
    """Reasons this (hq, hk, d, page_size) geometry cannot take the CUDA
    decode kernel; empty list = supported. `kv_dtype` is the pool type
    (None: any compiled one). The TPU kernel's sublane rules (page_size
    % 32 for int8 pools) do not apply here; these are the CUDA kernel's
    own limits, the same for every pool type: an int8 row of d >= 64
    codes is still a whole number of 16-byte vectors per lane."""
    problems = []
    if kv_dtype is not None and kv_dtype not in (torch.float32,
                                                 torch.bfloat16, torch.int8):
        problems.append(f"pools of {kv_dtype} are not compiled (float32, "
                        "bfloat16 or int8 with scales)")
    if hk <= 0 or hq % hk != 0:
        problems.append(f"q heads must be a multiple of kv heads "
                        f"(hq={hq}, hk={hk})")
        return problems
    if d not in _HEAD_DIMS:
        problems.append(f"head_dim in {_HEAD_DIMS} required (compiled per "
                        f"width; got d={d})")
    if page_size <= 0:
        problems.append(f"page_size must be positive (got {page_size})")
    return problems


def check_decode_shapes(hq, hk, d, page_size, kv_dtype=None):
    """Raise a ValueError naming every unsupported dim; no-op when the
    kernel can take the geometry."""
    problems = decode_shape_problems(hq, hk, d, page_size, kv_dtype)
    if problems:
        raise ValueError("paged_decode_attention: shapes cannot take the "
                         "CUDA decode kernel — " + "; ".join(problems))


def gather_window(pool, scale, bt):
    """Each slot's paged window of `pool` as (b, hk, L, d) f32, L = mp *
    page_size: window column c IS logical position c (page j holds
    positions [j*page_size, (j+1)*page_size)). int8 pools are
    dequantized as the JAX package's `_attend_pages` does: int8 -> f32,
    times the page's (page, head) scale."""
    b = bt.shape[0]
    hk, page_size, d = pool.shape[1:]
    w = pool[bt].permute(0, 2, 1, 3, 4).reshape(b, hk, -1, d).float()
    if scale is not None:
        w = w * scale[bt].transpose(1, 2).repeat_interleave(
            page_size, dim=2)[..., None]
    return w


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lens,
                               sm_scale=None, k_scale=None, v_scale=None):
    """Plain twin of `paged_decode_attention` (same arguments, same
    (b, hq, d) f32 result)."""
    b, hq, d = q.shape
    hk = k_pool.shape[1]
    g = hq // hk
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    bt = block_tables.long()
    ks = gather_window(k_pool, k_scale, bt)
    vs = gather_window(v_pool, v_scale, bt)
    L = ks.shape[2]
    qg = q.float().reshape(b, hk, g, d)
    scores = torch.einsum("bhgd,bhcd->bhgc", qg, ks) * sm_scale
    col = torch.arange(L, device=q.device)
    visible = col[None, :] <= lens.long()[:, None]              # (b, L)
    scores = scores.masked_fill(~visible[:, None, None, :], -1e9)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgc,bhcd->bhgd", p, vs).reshape(b, hq, d)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lens, *,
                           k_scale=None, v_scale=None, sm_scale=None):
    """One decode step of paged attention for every slot.

    q: (b, hq, d) position-encoded query rows, f32 or bf16.
    k_pool / v_pool: (num_pages, hk, page_size, d), f32 or bf16, or int8
        with `k_scale` / `v_scale` (num_pages, hk) f32 such that
        k ~= k_pool * k_scale[page, head, None, None].
    block_tables: (b, max_pages) int32, physical page of each logical
        page per slot (unallocated entries may be anything in range;
        they are never read past lens).
    lens: (b,) int32, the query's position per slot.
    Returns (b, hq, d) f32.
    """
    quantized = k_pool.dtype == torch.int8
    if quantized and (k_scale is None or v_scale is None):
        raise ValueError("int8 pools require k_scale and v_scale "
                         "(num_pages, hk) f32")
    if not quantized and (k_scale is not None or v_scale is not None):
        raise ValueError("k_scale / v_scale belong to int8 pools; got "
                         f"{k_pool.dtype} pools")
    if quantized:
        want = tuple(k_pool.shape[:2])
        for t in (k_scale, v_scale):
            if tuple(t.shape) != want or t.dtype != torch.float32:
                raise ValueError(f"scales must be {want} float32; got "
                                 f"{tuple(t.shape)} {t.dtype}")
    b, hq, d = q.shape
    num_pages, hk, page_size, dk = k_pool.shape
    if v_pool.shape != k_pool.shape or dk != d:
        raise ValueError(f"pools must both be (P, hk, page_size, {d}); got "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    if block_tables.shape[0] != b or lens.shape != (b,):
        raise ValueError(f"block_tables must be ({b}, max_pages) and lens "
                         f"({b},); got {tuple(block_tables.shape)}, "
                         f"{tuple(lens.shape)}")
    if (q.dtype, k_pool.dtype) not in _DTYPE_PAIRS \
            or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged_decode_attention: q {q.dtype} over pools "
                        f"{k_pool.dtype}/{v_pool.dtype} is not supported; "
                        "(q, pools) must be (f32, f32), (bf16, bf16), "
                        "(f32, bf16) or (f32 or bf16, int8), pools alike")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, block_tables,
                                          lens, sm_scale, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    check_decode_shapes(hq, hk, d, page_size, k_pool.dtype)
    scales = (k_scale, v_scale) if quantized else ()
    for t in (k_pool, v_pool, block_tables, lens) + scales:
        if t.device != q.device:
            raise ValueError(f"paged_decode_attention: all inputs must be "
                             f"on {q.device}")
    for t in (q, k_pool, v_pool, block_tables, lens) + scales:
        if not t.is_contiguous():
            raise ValueError("paged_decode_attention: inputs must be "
                             "contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_decode_attention: pools must start on a "
                         "16-byte boundary (the kernel reads them in "
                         "16-byte vectors)")
    if block_tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("paged_decode_attention: block_tables and lens "
                        "must be int32")
    max_pages = block_tables.shape[1]
    per, n_split = plan(max_pages, page_size)
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    # the splits' partials: o (b, hq, n_split, d), then m and l
    ws = torch.empty(b * hq * n_split * (d + 2), dtype=torch.float32,
                     device=q.device)
    lib = _build.load_library()
    status = lib.ptt_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        block_tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
        ws.data_ptr(), b, hq, hk, d, page_size, max_pages, per, n_split,
        float(sm_scale),
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "paged_decode_attention")
    launches.add("paged_decode_attention_int8" if quantized
                 else "paged_decode_attention")
    return out
