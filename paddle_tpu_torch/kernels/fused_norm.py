"""Fused RMSNorm(+residual add) and fused RoPE apply, forward and backward.

Counterpart of paddle_tpu/kernels/fused_norm.py. Each op has CUDA kernels
(csrc/fused_norm.cu) and plain PyTorch twins (`*_ref`) with the JAX
package's numerics: f32 statistics and f32 rotation, one cast back to the
input type. The wrappers take the twins only for CPU tensors; a CUDA
tensor goes to the kernel or raises.

Both ops are `torch.autograd.Function`s when a gradient is wanted, as the
JAX ops are `custom_vjp`s: the RMSNorm forward then also keeps the f32
rstd of each row and the backward is its own kernel; the RoPE backward is
the forward kernel launched with sign -1 on the sin table (the inverse
rotation; the kernel negates as it reads, so no negated table is made).
Without a gradient (serving) the plain forward runs and keeps nothing.

`plan(n, d, dtype)` chooses the RMSNorm kernels' layout (threads a row,
rows a block, 16-byte or scalar accesses, chunks a thread, grid) from
the shape alone, in Python, so the CPU tests can check it.

`launches` counts kernel launches per op, so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

import collections
import functools

import torch

from paddle_tpu_torch.kernels import LaunchCounter, _build

__all__ = ["plan", "NormPlan", "rms_norm_residual", "rms_norm_residual_ref",
           "rms_norm_residual_bwd", "rms_norm_residual_bwd_ref",
           "rope_apply", "rope_apply_ref", "rope_apply_bwd",
           "rope_apply_bwd_ref", "rope_tables", "norm_shape_problems",
           "rope_shape_problems", "launches"]

launches = LaunchCounter({"rms_norm_residual": 0, "rms_norm_residual_bwd": 0,
                           "rope_apply": 0, "rope_apply_bwd": 0})

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
_MAX_NORM_D = 12032     # csrc/fused_norm.cu kMaxNormD (dw row in 48 KB)
_SMS = 132              # H100 SXM streaming multiprocessors
_MAX_TEAM = 512         # csrc/fused_norm.cu kMaxBlock: threads a row at most
_BLOCK = 256            # forward: threads a block when a row takes fewer
_BWD_BLOCK = 512        # backward: threads a block, one block an SM
# chunks a thread compiled in csrc/fused_norm.cu, vector and scalar
_CHUNKS = {True: (1, 2, 4, 8), False: (1, 2, 4, 8, 16, 24)}

NormPlan = collections.namedtuple(
    "NormPlan", "vector vec threads_per_row rows_per_block chunks blocks")


def plan(n, d, dtype, aligned=True, backward=False, sms=_SMS):
    """The RMSNorm kernels' launch for n rows of width d (1 <= d <=
    12032) in dtype, from the shape alone.

    vector: 16-byte accesses of `vec` values (8 bf16, 4 f32), where
    d * itemsize is a multiple of 16 and every base pointer is 16-byte
    aligned (`aligned`); else the scalar instance of the same kernel
    (vec 1). A team of threads_per_row threads (a power of two, at most
    512) holds a row, `chunks` accesses a thread at most (vec *
    threads_per_row * chunks >= d), rows_per_block teams share a block.
    Block b takes the row groups b, b + blocks, ..., rows
    rows_per_block * group + team.

    Forward: one group a block, blocks of 256 threads (or one wider
    team). With many rows (training, prefill) about four accesses a
    thread; with few (decode, where the card is not filled and latency
    is the time) about two, a wider team. Backward: about two accesses a
    thread (the thread also holds its columns' dw sums), teams of a warp
    or more, one 512-thread block on each of the `sms` SMs walking its
    groups, so the (blocks, d) dw partials stay few. n = 0: no blocks.
    """
    size = _ITEMSIZE[dtype]
    vector = bool(aligned) and d * size % 16 == 0
    vec = 16 // size if vector else 1
    units = -(-d // vec)
    least = 32 if backward else 1

    def team(per):
        want = -(-units // per)
        return min(_MAX_TEAM, max(least, 1 << (want - 1).bit_length()))

    if backward:
        tpr = team(2)
    else:
        tpr = team(4)
        if n * tpr < sms * 1024:
            tpr = team(2)
    need = -(-units // tpr)
    chunks = next(c for c in _CHUNKS[vector] if c >= need)
    rows = max(1, (_BWD_BLOCK if backward else _BLOCK) // tpr)
    groups = -(-n // rows)
    blocks = min(groups, sms) if backward else groups
    return NormPlan(vector, vec, tpr, rows, chunks, blocks)


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _aligned(*tensors):
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def norm_shape_problems(d):
    """Reasons the CUDA RMSNorm kernels cannot take a row width d."""
    if not 0 < d <= _MAX_NORM_D:
        return [f"hidden must be in 1..{_MAX_NORM_D} (the backward keeps "
                f"a block's dw row in 48 KB of shared memory; got d={d})"]
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
    p = plan(n, d, x.dtype, _aligned(x, residual, weight, y, h),
             sms=_sm_count(x.device))
    _build.check(_launch_fwd(x, residual, weight, y, h, rstd, n, d, eps, p),
                 "rms_norm_residual")
    launches.add("rms_norm_residual")
    return y, h, rstd


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(x, residual, weight, y, h, rstd, n, d, eps, p):
    return _build.load_library().ptt_rmsn_fwd(
        x.data_ptr(), _ptr(residual), weight.data_ptr(), y.data_ptr(),
        None if residual is None else h.data_ptr(), _ptr(rstd), n, d, eps,
        _DTYPE_CODE[x.dtype], int(p.vector), p.threads_per_row,
        p.rows_per_block, p.chunks, p.blocks, _stream(x))


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
    dw in weight's type. dw is summed from the kernel's per-block f32
    partials (`plan(..., backward=True).blocks` of them) in a fixed
    order: deterministic.
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
    p = plan(n, d, h.dtype, _aligned(h, weight, gy, gh, dh), backward=True,
             sms=_sm_count(h.device))
    dw_part = torch.empty((p.blocks, d), dtype=torch.float32,
                          device=h.device)
    _build.check(_launch_bwd(h, weight, rstd, gy, gh, dh, dw_part, n, d, p),
                 "rms_norm_residual_bwd")
    launches.add("rms_norm_residual_bwd")
    return dh, torch.sum(dw_part, dim=0).to(weight.dtype)


def _launch_bwd(h, weight, rstd, gy, gh, dh, dw_part, n, d, p):
    return _build.load_library().ptt_rmsn_bwd(
        h.data_ptr(), weight.data_ptr(), rstd.data_ptr(), gy.data_ptr(),
        _ptr(gh), dh.data_ptr(), dw_part.data_ptr(), n, d,
        _DTYPE_CODE[h.dtype], int(p.vector), p.threads_per_row,
        p.rows_per_block, p.chunks, p.blocks, _stream(h))


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


def _rope_launch(x, cos_f, sin_f, sign, counter):
    b, s, h, d = x.shape
    if cos_f.shape != (b * s, d) or cos_f.dtype != torch.float32 \
            or sin_f.shape != cos_f.shape or sin_f.dtype != torch.float32:
        raise ValueError(f"rope_apply: tables must be f32 ({b * s}, {d}), "
                         f"got {tuple(cos_f.shape)} {cos_f.dtype}")
    _check_cuda_inputs("rope_apply", [x, cos_f, sin_f], x.dtype)
    out = torch.empty_like(x)
    _build.check(_launch_rope(x, cos_f, sin_f, out, sign), counter)
    launches.add(counter)
    return out


def _launch_rope(x, cos_f, sin_f, out, sign):
    b, s, h, d = x.shape
    return _build.load_library().ptt_rope(
        x.data_ptr(), cos_f.data_ptr(), sin_f.data_ptr(), out.data_ptr(),
        b * s, h, d, float(sign), _DTYPE_CODE[x.dtype], _stream(x))


def _rope_fwd(x, cos_f, sin_f):
    if x.device.type == "cpu":
        return rope_apply_ref(x, tables=(cos_f, sin_f))
    if x.device.type != "cuda":
        raise ValueError(f"rope_apply: unsupported device {x.device}")
    return _rope_launch(x, cos_f, sin_f, 1.0, "rope_apply")


def rope_apply_bwd(g, cos_f, sin_f):
    """Gradient of `rope_apply` with respect to x: the RoPE kernel on g
    with sign -1 on the sin table (JAX `_rope_bwd`, which negates the
    table)."""
    if g.device.type == "cpu":
        return rope_apply_bwd_ref(g, cos_f, sin_f)
    if g.device.type != "cuda":
        raise ValueError(f"rope_apply_bwd: unsupported device {g.device}")
    return _rope_launch(g, cos_f, sin_f, -1.0, "rope_apply_bwd")


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
