"""Weight-only int8 matmul (W8A16): x @ dequant(qw), the int8 weight
converted to bf16 inside the kernel.

Counterpart of paddle_tpu/kernels/quant_matmul.py. The function is the
JAX kernel's: x rounded to bf16, qw (K, N) int8 converted to bf16, the
products summed in f32, the per-column f32 `scale` (the weight scale
already divided by the quant bound) applied once after the sum, then one
cast to `out_dtype`. The CUDA kernels (csrc/quant_matmul.cu) stream qw
as int8, so a decode step reads one byte per weight, half the bf16
layer's. `plan` picks the route: up to `_SMALL_M` rows the 16-row tile
kernel with K split over the card (decode: bound by bytes), above it the
wgmma kernel (prefill: bound by operations; TMA loads, the int8 -> bf16
conversion overlapping the tensor cores, no split). f32 x takes the wgmma
route rounded to bf16 first, the round-to-nearest-even the tile kernel
applies on load. `weight_only_int8_matmul_ref` is the plain twin the CPU
takes.

The TPU kernel's tiling rules (`pick_block_m`, K and N divisible by the
block) and the JAX package's fallback to a dequantize-then-matmul for
shapes that do not tile do not carry over: the CUDA kernel masks ragged
M, N and K edges itself, and a CUDA tensor always takes it (or the
wrapper raises, naming the dims it cannot take).
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.kernels import LaunchCounter, _build

__all__ = ["weight_only_int8_matmul", "weight_only_int8_matmul_ref",
           "quant_matmul_shape_problems", "check_quant_matmul_shapes",
           "plan", "launches"]

# every launch of either route, and the wgmma route's alone
launches = LaunchCounter({"weight_only_int8_matmul": 0,
                           "weight_only_int8_matmul_wgmma": 0})

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# csrc/quant_matmul.cu geometry
_BN, _BK = 128, 64      # the 16-row tile kernel's column and k tiles
_WG_BM = (256, 128)     # the wgmma kernel's row tiles (x rows)
_WG_BN = 128            # and its column tile
# M at or below this takes the 16-row split-K kernel: the measured
# crossover of a Llama-3-8B layer's seven projections (H100, PERF.md)
# lies between 32 and 48 rows (q_proj's and down_proj's alone between 32
# and 48, gate_proj's between 16 and 24, k_proj's above 128)
_SMALL_M = 32


def quant_matmul_shape_problems(M, K, N):
    """Reasons x (M, K) @ qw (K, N) cannot take the CUDA kernels; empty
    list = supported. The 16-row kernel loads whole 16-byte chunks and
    masks the ragged edge per chunk (8 values of a bf16 x row, 16 of an
    int8 qw row); the wgmma kernel's TMA loads need row strides that are
    multiples of 16 bytes, which the same two rules give."""
    problems = []
    if M < 0 or K <= 0 or N <= 0:
        problems.append(f"M >= 0, K >= 1 and N >= 1 required (got M={M}, "
                        f"K={K}, N={N})")
        return problems
    if K % 8:
        problems.append(f"K % 8 == 0 required (x rows load in 16-byte "
                        f"chunks; got K={K})")
    if N % 16:
        problems.append(f"N % 16 == 0 required (qw rows load in 16-byte "
                        f"chunks of int8; got N={N})")
    return problems


def check_quant_matmul_shapes(M, K, N):
    """Raise a ValueError naming every unsupported dim; no-op when the
    kernel can take the shapes."""
    problems = quant_matmul_shape_problems(M, K, N)
    if problems:
        raise ValueError("weight_only_int8_matmul: shapes cannot take the "
                         "CUDA kernel — " + "; ".join(problems))


def plan(M, K, N, sms=132):
    """(route, row tile, K splits) the wrapper launches for an (M, K, N)
    product on a card with `sms` multiprocessors. Above `_SMALL_M` rows
    ("wgmma", 256 or 128, 1): the 128-row tile where its waves of tiles
    over the card, each taking about 0.8 of a 256-row tile's time
    (measured on the H100, PERF.md), finish sooner; else ("split_k", 16,
    splits), K split so that about two blocks per SM are in flight when
    the output tiles alone are fewer (every split holds the same number
    of k-tiles, the last perhaps fewer, none empty)."""
    if M > _SMALL_M:
        def waves(bm):
            return -(-(-(-M // bm) * -(-N // _WG_BN)) // sms)
        big, small = _WG_BM
        return "wgmma", small if 4 * waves(small) < 5 * waves(big) else big, 1
    return "split_k", 16, _k_splits(M, K, N, 16, sms)


def _k_splits(M, K, N, bm, sms=132):
    """K splits of the tile kernel with row tile `bm` (see `plan`)."""
    tiles = -(-N // _BN) * -(-M // bm)
    nk = -(-K // _BK)
    want = min(nk, -(-2 * sms // tiles)) if tiles < 2 * sms else 1
    per = -(-nk // max(want, 1))
    return -(-nk // per)


def weight_only_int8_matmul_ref(x, qw, scale, out_dtype=None):
    """Plain twin of `weight_only_int8_matmul` (same arguments and
    result): the kernel's function, not the JAX package's
    dequantize-then-matmul fallback."""
    out_dtype = out_dtype or x.dtype
    acc = x.to(torch.bfloat16).float() @ qw.float()
    return (acc * scale).to(out_dtype)


def weight_only_int8_matmul(x, qw, scale, out_dtype=None):
    """x (..., K) bf16 or f32 @ int8 qw (K, N), `scale` (N,) f32 already
    divided by the quant bound (w ~= qw * scale). Returns (..., N) in
    `out_dtype` (default x's type)."""
    out_dtype = out_dtype or x.dtype
    if qw.dtype != torch.int8 or qw.dim() != 2:
        raise TypeError(f"qw must be a 2-D int8 (K, N) tensor; got "
                        f"{qw.dtype} {tuple(qw.shape)}")
    K, N = qw.shape
    if x.shape[-1] != K or tuple(scale.shape) != (N,) \
            or scale.dtype != torch.float32:
        raise ValueError(f"x (..., {K}) and scale ({N},) float32 required; "
                         f"got x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"weight_only_int8_matmul: x {x.dtype} -> "
                        f"{out_dtype} is not supported; x and the output "
                        "must be float32 or bfloat16")
    if x.device.type == "cpu":
        return weight_only_int8_matmul_ref(x, qw, scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"weight_only_int8_matmul: unsupported device "
                         f"{x.device}")
    lead = x.shape[:-1]
    M = x.numel() // K
    check_quant_matmul_shapes(M, K, N)
    for t in (qw, scale):
        if t.device != x.device:
            raise ValueError(f"weight_only_int8_matmul: all inputs must be "
                             f"on {x.device}")
    if not (x.is_contiguous() and qw.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("weight_only_int8_matmul: x, qw and scale must be "
                         "contiguous")
    if x.data_ptr() % 16 or qw.data_ptr() % 16:
        raise ValueError("weight_only_int8_matmul: x and qw must start on "
                         "a 16-byte boundary (the kernel reads them in "
                         "16-byte chunks)")
    out = torch.empty(lead + (N,), dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    route, bm, splits = plan(M, K, N, _sm_count(x.device))
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "wgmma":
        xb = x if x.dtype == torch.bfloat16 else x.to(torch.bfloat16)
        status = lib.ptt_w8a16_matmul_wgmma(
            xb.data_ptr(), qw.data_ptr(), scale.data_ptr(), out.data_ptr(),
            M, K, N, bm, _DTYPE_CODE[out_dtype], stream)
        _build.check(status, "weight_only_int8_matmul (wgmma)")
        launches.add("weight_only_int8_matmul_wgmma")
    else:
        ws = (torch.empty((splits, M, N), dtype=torch.float32,
                          device=x.device) if splits > 1 else None)
        status = lib.ptt_w8a16_matmul(
            x.data_ptr(), qw.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), M, K, N, bm, splits,
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype], stream)
        _build.check(status, "weight_only_int8_matmul")
    launches.add("weight_only_int8_matmul")
    return out


_SMS = {}


def _sm_count(device):
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]
