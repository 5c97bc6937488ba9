"""Fused RMSNorm(+residual add) and fused RoPE apply, forward only.

Counterpart of paddle_tpu/kernels/fused_norm.py. Each op has a CUDA
kernel (csrc/fused_norm.cu) and a plain PyTorch twin (`*_ref`) with the
JAX package's numerics: f32 statistics and f32 rotation, one cast back
to the input type. The wrapper takes the twin only for CPU tensors; a
CUDA tensor goes to the kernel or raises.

`launches` counts kernel launches per op, so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.kernels import _build

__all__ = ["rms_norm_residual", "rms_norm_residual_ref", "rope_apply",
           "rope_apply_ref", "rope_tables", "norm_shape_problems",
           "rope_shape_problems", "launches"]

launches = {"rms_norm_residual": 0, "rope_apply": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_NORM_D = 12032     # csrc/fused_norm.cu kMaxNormD (row in 48 KB smem)


def norm_shape_problems(d):
    """Reasons the CUDA RMSNorm kernel cannot take a row width d."""
    if not 0 < d <= _MAX_NORM_D:
        return [f"hidden must be in 1..{_MAX_NORM_D} (the row is kept "
                f"in shared memory; got d={d})"]
    return []


def rope_shape_problems(d):
    """Reasons the CUDA RoPE kernel cannot take head_dim d."""
    if d <= 0 or d % 2 != 0:
        return [f"head_dim must be even and positive (got d={d})"]
    return []


def _check_cuda_inputs(what, tensors, dtype):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: all inputs must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: dtype {dtype} not supported "
                        "(float32 or bfloat16)")


# ---------------------------------------------------------------------------
# RMSNorm + residual
# ---------------------------------------------------------------------------

def _rmsn_fwd_math(h, w, eps):
    """f32 stats, f32 scale-by-weight, one cast back: the JAX package's
    `_rmsn_fwd_math` (== nn/functional/norm.py `_rms_norm`)."""
    hf = h.float()
    ms = torch.mean(hf * hf, dim=-1, keepdim=True)
    return (hf * torch.rsqrt(ms + eps) * w.float()).to(h.dtype)


def rms_norm_residual_ref(x, weight, residual=None, epsilon=1e-6):
    """Plain twin of `rms_norm_residual`."""
    h = x if residual is None else x + residual
    return _rmsn_fwd_math(h, weight, float(epsilon)), h


def rms_norm_residual(x, weight, residual=None, epsilon=1e-6):
    """`h = x + residual; y = rms_norm(h) * weight` in one pass.

    x / residual: (..., d), same shape and type; weight: (d,) in x's
    type too. Returns (y, h) in x's type; with residual=None, h is x
    itself.
    """
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"weight must be ({d},), got {tuple(weight.shape)}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual {tuple(residual.shape)} must match x "
                         f"{tuple(x.shape)}")
    if weight.dtype != x.dtype or (residual is not None
                                   and residual.dtype != x.dtype):
        raise TypeError(f"rms_norm_residual: x {x.dtype}, weight "
                        f"{weight.dtype} and residual must share one type")
    if x.device.type == "cpu":
        return rms_norm_residual_ref(x, weight, residual, epsilon)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm_residual: unsupported device {x.device}")
    ins = [x, weight] + ([] if residual is None else [residual])
    _check_cuda_inputs("rms_norm_residual", ins, x.dtype)
    problems = norm_shape_problems(d)
    if problems:
        raise ValueError("rms_norm_residual: " + "; ".join(problems))
    n = x.numel() // d
    y = torch.empty_like(x)
    h = x if residual is None else torch.empty_like(x)
    lib = _build.load_library()
    status = lib.ptt_rms_norm_residual(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        weight.data_ptr(), y.data_ptr(),
        None if residual is None else h.data_ptr(), n, d, float(epsilon),
        _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "rms_norm_residual")
    launches["rms_norm_residual"] += 1
    return y, h


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_tables(positions, d, theta):
    """Full-width f32 tables per row, as the JAX `_cos_sin_rows`:
    cos_f (n, d) = cat(cos, cos), sin_f (n, d) = cat(-sin, sin) (the sign
    fold that makes the half-split rotation mul/roll/mul/add).
    `inv_freq` is computed in f32, as there: f64 tables give other
    angles at large positions."""
    inv_freq = 1.0 / (float(theta) ** (
        torch.arange(0, d, 2, dtype=torch.float32,
                     device=positions.device) / d))
    ang = positions.to(torch.float32)[:, None] * inv_freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def _flat_positions(positions, b, s, device):
    if positions is None:
        return torch.arange(s, dtype=torch.int32, device=device).repeat(b)
    pos = positions.to(device=device, dtype=torch.int32)
    return pos.repeat(b) if pos.dim() == 1 else pos.reshape(-1)


def _rope_fwd_math(x3, cos_f, sin_f):
    d2 = x3.shape[-1] // 2
    xf = x3.float()
    rolled = torch.cat([xf[..., d2:], xf[..., :d2]], dim=-1)
    return (xf * cos_f[:, None, :] + rolled * sin_f[:, None, :]).to(x3.dtype)


def rope_apply_ref(x, positions=None, theta=10000.0, tables=None):
    """Plain twin of `rope_apply`."""
    b, s, h, d = x.shape
    if tables is None:
        tables = rope_tables(_flat_positions(positions, b, s, x.device), d,
                             theta)
    return _rope_fwd_math(x.reshape(b * s, h, d), *tables).reshape(x.shape)


def rope_apply(x, positions=None, theta=10000.0, tables=None):
    """NeoX/Llama RoPE on x (B, S, H, D) in one pass.

    positions: (S,) or (B, S) int positions (None = arange(S)). `tables`
    lets q and k share one `rope_tables(flat_positions, D, theta)`
    pair. f32 compute, cast back to x's type.
    """
    b, s, h, d = x.shape
    problems = rope_shape_problems(d)
    if problems:
        raise ValueError("rope_apply: " + "; ".join(problems))
    if x.device.type == "cpu":
        return rope_apply_ref(x, positions, theta, tables)
    if x.device.type != "cuda":
        raise ValueError(f"rope_apply: unsupported device {x.device}")
    if tables is None:
        tables = rope_tables(_flat_positions(positions, b, s, x.device), d,
                             theta)
    cos_f, sin_f = tables
    if cos_f.shape != (b * s, d) or cos_f.dtype != torch.float32:
        raise ValueError(f"rope_apply: tables must be f32 ({b * s}, {d}), "
                         f"got {tuple(cos_f.shape)} {cos_f.dtype}")
    _check_cuda_inputs("rope_apply", [x, cos_f, sin_f], x.dtype)
    out = torch.empty_like(x)
    lib = _build.load_library()
    status = lib.ptt_rope_apply(
        x.data_ptr(), cos_f.data_ptr(), sin_f.data_ptr(), out.data_ptr(),
        b * s, h, d, _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "rope_apply")
    launches["rope_apply"] += 1
    return out
