"""Paged-attention decode: one query row per slot over its paged KV window.

Counterpart of paddle_tpu/kernels/paged_attention.py (the unquantized
branch; int8 pools are a later slice). The CUDA kernel
(csrc/paged_attention.cu) runs one block per (slot, kv_head) whose warps
share out the slot's pages up to its length, folds the g = hq/hk query
heads of a KV head into the block so each K/V row is read once, and
keeps an f32 online softmax per warp, merged at the end. `paged_decode_attention_ref` is the plain twin: gather
the window in f32, masked softmax, GQA by reshape.

Masking contract (as in the JAX package): the query of slot i sits at
position lens[i], its own k/v already scattered there, so column c is
visible iff c <= lens[i].
"""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.kernels import _build

__all__ = ["paged_decode_attention", "paged_decode_attention_ref",
           "decode_shape_problems", "check_decode_shapes", "launches"]

launches = {"paged_decode_attention": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (q, pools) types compiled: one type throughout, or an f32 model over
# bf16 pools (kv_dtype="bf16")
_DTYPE_PAIRS = {(torch.float32, torch.float32),
                (torch.bfloat16, torch.bfloat16),
                (torch.float32, torch.bfloat16)}
# csrc/paged_attention.cu limits
_MAX_G = 8
_HEAD_DIMS = (64, 128, 256)


def decode_shape_problems(hq, hk, d, page_size):
    """Reasons this (hq, hk, d, page_size) geometry cannot take the CUDA
    decode kernel; empty list = supported. The TPU kernel's sublane
    rules do not apply here; these are the CUDA kernel's own limits."""
    problems = []
    if hk <= 0 or hq % hk != 0:
        problems.append(f"q heads must be a multiple of kv heads "
                        f"(hq={hq}, hk={hk})")
        return problems
    if hq // hk > _MAX_G:
        problems.append(f"hq/hk <= {_MAX_G} required (the query heads of "
                        f"a kv head are held in registers; got {hq // hk})")
    if d not in _HEAD_DIMS:
        problems.append(f"head_dim in {_HEAD_DIMS} required (compiled per "
                        f"width; got d={d})")
    if page_size <= 0:
        problems.append(f"page_size must be positive (got {page_size})")
    return problems


def check_decode_shapes(hq, hk, d, page_size):
    """Raise a ValueError naming every unsupported dim; no-op when the
    kernel can take the geometry."""
    problems = decode_shape_problems(hq, hk, d, page_size)
    if problems:
        raise ValueError("paged_decode_attention: shapes cannot take the "
                         "CUDA decode kernel — " + "; ".join(problems))


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lens,
                               sm_scale=None):
    """Plain twin of `paged_decode_attention` (same arguments, same
    (b, hq, d) f32 result)."""
    b, hq, d = q.shape
    hk, page_size = k_pool.shape[1], k_pool.shape[2]
    g = hq // hk
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    bt = block_tables.long()
    # window column c IS logical position c (page j holds positions
    # [j*page_size, (j+1)*page_size))
    ks = k_pool[bt].permute(0, 2, 1, 3, 4).reshape(b, hk, -1, d).float()
    vs = v_pool[bt].permute(0, 2, 1, 3, 4).reshape(b, hk, -1, d).float()
    L = ks.shape[2]
    qg = q.float().reshape(b, hk, g, d)
    scores = torch.einsum("bhgd,bhcd->bhgc", qg, ks) * sm_scale
    col = torch.arange(L, device=q.device)
    visible = col[None, :] <= lens.long()[:, None]              # (b, L)
    scores = scores.masked_fill(~visible[:, None, None, :], -1e9)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgc,bhcd->bhgd", p, vs).reshape(b, hq, d)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lens,
                           sm_scale=None):
    """One decode step of paged attention for every slot.

    q: (b, hq, d) position-encoded query rows, f32 or bf16.
    k_pool / v_pool: (num_pages, hk, page_size, d), f32 or bf16.
    block_tables: (b, max_pages) int32, physical page of each logical
        page per slot (unallocated entries may be anything in range;
        they are never read past lens).
    lens: (b,) int32, the query's position per slot.
    Returns (b, hq, d) f32.
    """
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
                        "(q, pools) must be (f32, f32), (bf16, bf16) or "
                        "(f32, bf16), pools alike")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, block_tables,
                                          lens, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    check_decode_shapes(hq, hk, d, page_size)
    for t in (k_pool, v_pool, block_tables, lens):
        if t.device != q.device:
            raise ValueError(f"paged_decode_attention: all inputs must be "
                             f"on {q.device}")
    for t in (q, k_pool, v_pool, block_tables, lens):
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
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    status = lib.ptt_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
        b, hq, hk, d, page_size, block_tables.shape[1], float(sm_scale),
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "paged_decode_attention")
    launches["paged_decode_attention"] += 1
    return out
