"""Fused RMSNorm(+residual add) and fused RoPE apply, forward and backward.

Counterpart of paddle_tpu/kernels/fused_norm.py. Each op has CUDA kernels
(csrc/fused_norm.cu) and plain PyTorch twins (`*_ref`) with the JAX
package's numerics: f32 statistics and f32 rotation, one cast back to the
input type. The wrappers take the twins only for CPU tensors; a CUDA
tensor goes to the kernel or raises.

Both ops are `torch.autograd.Function`s when a gradient is wanted, as the
JAX ops are `custom_vjp`s: the RMSNorm forward then also keeps the f32
rstd of each row and the backward is its own kernel; the RoPE backward is
the forward kernel launched with the sin table negated (the inverse
rotation). Without a gradient (serving) the plain forward runs and keeps
nothing.

`launches` counts kernel launches per op, so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.kernels import _build

__all__ = ["rms_norm_residual", "rms_norm_residual_ref",
           "rms_norm_residual_bwd", "rms_norm_residual_bwd_ref",
           "rope_apply", "rope_apply_ref", "rope_apply_bwd",
           "rope_apply_bwd_ref", "rope_tables", "norm_shape_problems",
           "rope_shape_problems", "launches"]

launches = {"rms_norm_residual": 0, "rms_norm_residual_bwd": 0,
            "rope_apply": 0, "rope_apply_bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_NORM_D = 12032     # csrc/fused_norm.cu kMaxNormD (row in 48 KB smem)
_BWD_BLOCKS = 264       # RMSNorm backward grid: two blocks per H100 SM


def norm_shape_problems(d):
    """Reasons the CUDA RMSNorm kernels cannot take a row width d."""
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


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


# ---------------------------------------------------------------------------
# RMSNorm + residual
# ---------------------------------------------------------------------------

def _rmsn_fwd_math(h, w, eps):
    """f32 stats, f32 scale-by-weight, one cast back: the JAX package's
    `_rmsn_fwd_math` (== nn/functional/norm.py `_rms_norm`). Returns
    (y, rstd) with rstd (..., 1) f32."""
    hf = h.float()
    ms = torch.mean(hf * hf, dim=-1, keepdim=True)
    rstd = torch.rsqrt(ms + eps)
    return (hf * rstd * w.float()).to(h.dtype), rstd


def rms_norm_residual_ref(x, weight, residual=None, epsilon=1e-6):
    """Plain twin of `rms_norm_residual`'s forward."""
    h = x if residual is None else x + residual
    return _rmsn_fwd_math(h, weight, float(epsilon))[0], h


def _norm_fwd(x, weight, residual, eps, want_rstd):
    """(y, h, rstd (n,) f32 or None) by the kernel or, for CPU tensors,
    the twin."""
    if x.device.type == "cpu":
        h = x if residual is None else x + residual
        y, rstd = _rmsn_fwd_math(h, weight, eps)
        return y, h, rstd.reshape(-1)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm_residual: unsupported device {x.device}")
    d = x.shape[-1]
    ins = [x, weight] + ([] if residual is None else [residual])
    _check_cuda_inputs("rms_norm_residual", ins, x.dtype)
    problems = norm_shape_problems(d)
    if problems:
        raise ValueError("rms_norm_residual: " + "; ".join(problems))
    n = x.numel() // d
    y = torch.empty_like(x)
    h = x if residual is None else torch.empty_like(x)
    rstd = (torch.empty(n, dtype=torch.float32, device=x.device)
            if want_rstd else None)
    lib = _build.load_library()
    status = lib.ptt_rms_norm_residual(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        weight.data_ptr(), y.data_ptr(),
        None if residual is None else h.data_ptr(),
        None if rstd is None else rstd.data_ptr(), n, d, eps,
        _DTYPE_CODE[x.dtype], _stream(x))
    _build.check(status, "rms_norm_residual")
    launches["rms_norm_residual"] += 1
    return y, h, rstd


def rms_norm_residual_bwd_ref(h, weight, rstd, gy, gh=None):
    """Plain twin of `rms_norm_residual_bwd`: the JAX `_rmsn_bwd_math`."""
    hf = h.float()
    gyf = gy.float()
    xhat = hf * rstd.reshape(h.shape[:-1] + (1,))
    dxhat = gyf * weight.float()
    c = torch.mean(dxhat * xhat, dim=-1, keepdim=True)
    dh = rstd.reshape(h.shape[:-1] + (1,)) * (dxhat - xhat * c)
    if gh is not None:
        dh = dh + gh.float()
    dw = torch.sum((gyf * xhat).reshape(-1, h.shape[-1]), dim=0)
    return dh.to(h.dtype), dw.to(weight.dtype)


def rms_norm_residual_bwd(h, weight, rstd, gy, gh=None):
    """Closed-form RMSNorm backward from the saved rstd.

    h: (..., d) the normed input (x + residual); weight (d,); rstd (n,)
    f32, n = h.numel() / d; gy: the gradient of y; gh: the gradient
    reaching h directly (None = zero). Returns (dh, dw), dh in h's type,
    dw in weight's type. dw is summed from per-block f32 partials in a
    fixed order: deterministic.
    """
    if h.device.type == "cpu":
        return rms_norm_residual_bwd_ref(h, weight, rstd, gy, gh)
    if h.device.type != "cuda":
        raise ValueError(f"rms_norm_residual_bwd: unsupported device "
                         f"{h.device}")
    d = h.shape[-1]
    n = h.numel() // d
    ins = [h, weight, gy] + ([] if gh is None else [gh])
    _check_cuda_inputs("rms_norm_residual_bwd", ins + [rstd], h.dtype)
    if any(t.dtype != h.dtype for t in ins) or gy.shape != h.shape \
            or (gh is not None and gh.shape != h.shape):
        raise TypeError("rms_norm_residual_bwd: h, weight, gy and gh must "
                        "share one type and h's shape")
    if rstd.dtype != torch.float32 or rstd.numel() != n:
        raise ValueError(f"rms_norm_residual_bwd: rstd must be f32 ({n},)")
    problems = norm_shape_problems(d)
    if problems:
        raise ValueError("rms_norm_residual_bwd: " + "; ".join(problems))
    dh = torch.empty_like(h)
    if n == 0:
        return dh, torch.zeros_like(weight)
    blocks = min(n, _BWD_BLOCKS)
    dw_part = torch.empty((blocks, d), dtype=torch.float32, device=h.device)
    lib = _build.load_library()
    status = lib.ptt_rms_norm_bwd(
        h.data_ptr(), weight.data_ptr(), rstd.data_ptr(), gy.data_ptr(),
        None if gh is None else gh.data_ptr(), dh.data_ptr(),
        dw_part.data_ptr(), n, d, blocks, _DTYPE_CODE[h.dtype], _stream(h))
    _build.check(status, "rms_norm_residual_bwd")
    launches["rms_norm_residual_bwd"] += 1
    return dh, torch.sum(dw_part, dim=0).to(weight.dtype)


class _RmsNormResidual(torch.autograd.Function):
    """y (and h) forward keeping (h, w, rstd); the gradient of h reaches
    both x and the residual (JAX `_rmsn_res_bwd`)."""

    @staticmethod
    def forward(ctx, x, weight, residual, eps):
        y, h, rstd = _norm_fwd(x, weight, residual, eps, want_rstd=True)
        ctx.save_for_backward(h, weight, rstd)
        ctx.has_residual = residual is not None
        ctx.set_materialize_grads(False)
        return y if residual is None else (y, h)

    @staticmethod
    def backward(ctx, gy, gh=None):
        h, weight, rstd = ctx.saved_tensors
        gy = torch.zeros_like(h) if gy is None else gy.contiguous()
        dh, dw = rms_norm_residual_bwd(
            h, weight, rstd, gy, None if gh is None else gh.contiguous())
        return dh, dw, (dh if ctx.has_residual else None), None


def rms_norm_residual(x, weight, residual=None, epsilon=1e-6):
    """`h = x + residual; y = rms_norm(h) * weight` in one pass.

    x / residual: (..., d), same shape and type; weight: (d,) in x's
    type too. Returns (y, h) in x's type; with residual=None, h is x
    itself. Differentiable in x, weight and residual.
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
    eps = float(epsilon)
    if _needs_grad(x, weight, residual):
        out = _RmsNormResidual.apply(x, weight, residual, eps)
        return (out, x) if residual is None else out
    y, h, _ = _norm_fwd(x, weight, residual, eps, want_rstd=False)
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
    """Plain twin of `rope_apply`'s forward."""
    b, s, h, d = x.shape
    if tables is None:
        tables = rope_tables(_flat_positions(positions, b, s, x.device), d,
                             theta)
    return _rope_fwd_math(x.reshape(b * s, h, d), *tables).reshape(x.shape)


def rope_apply_bwd_ref(g, cos_f, sin_f):
    """Plain twin of `rope_apply_bwd`: the inverse rotation of the
    gradient g (B, S, H, D), i.e. the forward with sin_f negated."""
    b, s, h, d = g.shape
    return _rope_fwd_math(g.reshape(b * s, h, d), cos_f,
                          -sin_f).reshape(g.shape)


def _rope_launch(x, cos_f, sin_f, counter):
    b, s, h, d = x.shape
    if cos_f.shape != (b * s, d) or cos_f.dtype != torch.float32 \
            or sin_f.shape != cos_f.shape or sin_f.dtype != torch.float32:
        raise ValueError(f"rope_apply: tables must be f32 ({b * s}, {d}), "
                         f"got {tuple(cos_f.shape)} {cos_f.dtype}")
    _check_cuda_inputs("rope_apply", [x, cos_f, sin_f], x.dtype)
    out = torch.empty_like(x)
    lib = _build.load_library()
    status = lib.ptt_rope_apply(
        x.data_ptr(), cos_f.data_ptr(), sin_f.data_ptr(), out.data_ptr(),
        b * s, h, d, _DTYPE_CODE[x.dtype], _stream(x))
    _build.check(status, counter)
    launches[counter] += 1
    return out


def _rope_fwd(x, cos_f, sin_f):
    if x.device.type == "cpu":
        return rope_apply_ref(x, tables=(cos_f, sin_f))
    if x.device.type != "cuda":
        raise ValueError(f"rope_apply: unsupported device {x.device}")
    return _rope_launch(x, cos_f, sin_f, "rope_apply")


def rope_apply_bwd(g, cos_f, sin_f):
    """Gradient of `rope_apply` with respect to x: the RoPE kernel on g
    with the sin table negated (JAX `_rope_bwd`)."""
    if g.device.type == "cpu":
        return rope_apply_bwd_ref(g, cos_f, sin_f)
    if g.device.type != "cuda":
        raise ValueError(f"rope_apply_bwd: unsupported device {g.device}")
    return _rope_launch(g, cos_f, torch.neg(sin_f), "rope_apply_bwd")


class _Rope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cos_f, sin_f):
        ctx.save_for_backward(cos_f, sin_f)
        return _rope_fwd(x, cos_f, sin_f)

    @staticmethod
    def backward(ctx, g):
        cos_f, sin_f = ctx.saved_tensors
        return rope_apply_bwd(g.contiguous(), cos_f, sin_f), None, None


def rope_apply(x, positions=None, theta=10000.0, tables=None):
    """NeoX/Llama RoPE on x (B, S, H, D) in one pass.

    positions: (S,) or (B, S) int positions (None = arange(S)). `tables`
    lets q and k share one `rope_tables(flat_positions, D, theta)`
    pair. f32 compute, cast back to x's type. Differentiable in x.
    """
    b, s, h, d = x.shape
    problems = rope_shape_problems(d)
    if problems:
        raise ValueError("rope_apply: " + "; ".join(problems))
    if tables is None:
        tables = rope_tables(_flat_positions(positions, b, s, x.device), d,
                             theta)
    if _needs_grad(x):
        return _Rope.apply(x, *tables)
    return _rope_fwd(x, *tables)
