"""Flash attention, forward and backward.

Counterpart of paddle_tpu/kernels/flash_attention.py. Three CUDA kernels
(csrc/flash_attention.cu): the forward with the row logsumexp, the dq
backward and the dk/dv backward, each beside its plain PyTorch twin
(`flash_attention_fwd_ref`, `flash_attention_bwd_ref`). The wrappers take
the twins only for CPU tensors; a CUDA tensor goes to the kernel or
raises. `_FlashAttention` ties them into a `torch.autograd.Function`, as
the JAX `_flash` custom_vjp does.

Conventions (csrc/flash_attention.cu states them in full): q, k, v are
(B, S, H, D) and read through their strides; GQA when Hk divides Hq
(query head h reads kv head h // (Hq / Hk)); scores (q . k) * scale in
f32; lse is the natural-log logsumexp per row, f32 (B, Hq, S); p and dS
are rounded to the input type before their products. The JAX kernel's
lse is base 2 and stored (B, H, 8, S_pad): lse = jax_lse[:, :, 0] * ln 2.

`launches` counts kernel launches per kernel.
"""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.kernels import LaunchCounter, _build

__all__ = ["flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_fwd_ref", "flash_attention_bwd_ref",
           "flash_attention_bshd", "flash_attention_bhsd",
           "flash_shape_problems", "launches"]

launches = LaunchCounter({"flash_fwd": 0, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0})

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)          # csrc/flash_attention.cu instantiations


def flash_shape_problems(q_shape, k_shape, v_shape, dtype):
    """Reasons the CUDA flash kernels cannot take q (B, Sq, Hq, D) and
    k / v (B, Sk, Hk, D) of `dtype`; empty list = supported."""
    problems = []
    if len(q_shape) != 4 or len(k_shape) != 4:
        return [f"q and k must be (B, S, H, D) (got {tuple(q_shape)}, "
                f"{tuple(k_shape)})"]
    b, sq, hq, d = q_shape
    if tuple(v_shape) != tuple(k_shape):
        problems.append(f"v {tuple(v_shape)} must match k {tuple(k_shape)}")
    if k_shape[0] != b or k_shape[3] != d:
        problems.append(f"k {tuple(k_shape)} must share batch and head_dim "
                        f"with q {tuple(q_shape)}")
    if k_shape[1] != sq:
        problems.append(f"self-attention only: q and k must share the "
                        f"sequence length (got {sq} and {k_shape[1]})")
    hk = k_shape[2]
    if hk <= 0 or hq % hk != 0:
        problems.append(f"q heads must be a multiple of kv heads (hq={hq}, "
                        f"hk={hk})")
    if d not in _HEAD_DIMS:
        problems.append(f"head_dim in {_HEAD_DIMS} required (compiled per "
                        f"width; got d={d})")
    if dtype not in _DTYPE_CODE:
        problems.append(f"dtype {dtype} not supported (float32 or "
                        "bfloat16)")
    return problems


def _check(q, k, v, what):
    problems = flash_shape_problems(q.shape, k.shape, v.shape, q.dtype)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        problems.append(f"q, k and v must share one type (got {q.dtype}, "
                        f"{k.dtype}, {v.dtype})")
    if problems:
        raise ValueError(f"{what}: " + "; ".join(problems))


def _check_layout(what, t, dense=False):
    """The kernels read 16-byte vectors along the head dim: it must be
    dense, every other stride a multiple of 16 bytes and the start
    16-byte aligned; `dense` tensors must be contiguous."""
    vec = 16 // t.element_size()
    if dense and not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
    if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{what}: strides {t.stride()} cannot take the "
                         "kernel (the head dim must be dense, every other "
                         "stride a multiple of 16 bytes, the start 16-byte "
                         "aligned); pass a .contiguous() tensor")


def _strides(*ts):
    out = []
    for t in ts:
        out += [t.stride(0), t.stride(1), t.stride(2)]
    return out


def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None \
        else float(sm_scale)


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def _grouped(q, k, v):
    """f32 views for GQA: q (B, Hk, G, S, D), k / v (B, Hk, S, D)."""
    b, s, hq, d = q.shape
    hk = k.shape[2]
    qf = q.float().permute(0, 2, 1, 3).reshape(b, hk, hq // hk, s, d)
    return qf, k.float().permute(0, 2, 1, 3), v.float().permute(0, 2, 1, 3)


def _scores(qf, kf, causal, scale):
    sc = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
    if causal:
        s = sc.shape[-1]
        above = torch.ones(s, s, dtype=torch.bool,
                           device=sc.device).triu(1)
        sc = sc.masked_fill(above, float("-inf"))
    return sc


def _ungroup(x, b, s):
    """(B, Hk, G, S, D) -> (B, S, Hk * G, D)."""
    return x.reshape(b, -1, s, x.shape[-1]).permute(0, 2, 1, 3)


def flash_attention_fwd_ref(q, k, v, causal=False, sm_scale=None):
    """Plain twin of `flash_attention_fwd`: (o, lse)."""
    b, s = q.shape[:2]
    scale = _scale(q, sm_scale)
    qf, kf, vf = _grouped(q, k, v)
    sc = _scores(qf, kf, causal, scale)
    lse = torch.logsumexp(sc, dim=-1)                        # (B, Hk, G, S)
    p = torch.exp(sc - lse[..., None]).to(v.dtype).float()
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
    return (_ungroup(o, b, s).to(q.dtype).contiguous(),
            lse.reshape(b, -1, s).contiguous())


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal=False,
                            sm_scale=None):
    """Plain twin of `flash_attention_bwd`: (dq, dk, dv)."""
    b, s, hq, d = q.shape
    hk = k.shape[2]
    scale = _scale(q, sm_scale)
    qf, kf, vf = _grouped(q, k, v)
    sc = _scores(qf, kf, causal, scale)
    p = torch.exp(sc - lse.reshape(b, hk, hq // hk, s)[..., None])
    dof = do.float().permute(0, 2, 1, 3).reshape(b, hk, hq // hk, s, d)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)
    delta = delta.reshape(b, hk, hq // hk, s)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p.to(q.dtype).float(), dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf)
    return (_ungroup(dq, b, s).to(q.dtype).contiguous(),
            dk.permute(0, 2, 1, 3).to(k.dtype).contiguous(),
            dv.permute(0, 2, 1, 3).to(v.dtype).contiguous())


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def flash_attention_fwd(q, k, v, causal=False, sm_scale=None):
    """Exact softmax(q kᵀ · scale) v, causal or full.

    q (B, S, Hq, D), k / v (B, S, Hk, D), f32 or bf16, any strides with a
    dense head dim. Returns o (B, S, Hq, D) dense in q's type and lse
    (B, Hq, S) f32 (natural log).
    """
    _check(q, k, v, "flash_attention_fwd")
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device "
                         f"{q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} is not on "
                             f"{q.device}")
        _check_layout(f"flash_attention_fwd: {name}", t)
    b, s, hq, d = q.shape
    o = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    status = lib.ptt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, s, hq, k.shape[2], d, *_strides(q, k, v),
        _scale(q, sm_scale), int(causal), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "flash_attention_fwd")
    launches.add("flash_fwd")
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, sm_scale=None):
    """Gradients (dq, dk, dv) of `flash_attention_fwd` for the output
    gradient do, from the forward's o and lse. o and do are dense
    (B, S, Hq, D) in q's type; dq, dk, dv come out dense in it. Two
    kernels: dq over the q tiles, dk/dv over the k tiles; delta =
    rowsum(do * o) is a PyTorch expression, as the JAX package computes
    it outside its kernels."""
    _check(q, k, v, "flash_attention_bwd")
    b, s, hq, d = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o and do must be "
                         f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, hq, s) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be f32 "
                         f"({b}, {hq}, {s})")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal,
                                       sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do),
                    ("lse", lse)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} is not on "
                             f"{q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(f"flash_attention_bwd: {name}", t)
    for name, t in (("o", o), ("do", do)):
        _check_layout(f"flash_attention_bwd: {name}", t, dense=True)
    if not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be contiguous")
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return (_launch_dq(q, k, v, do, lse, delta, causal, sm_scale),
            *_launch_dkv(q, k, v, do, lse, delta, causal, sm_scale))


def _bwd_args(q, k, v, do, lse, delta, causal, sm_scale):
    b, s, hq, d = q.shape
    return ([q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr()],
            [b, s, hq, k.shape[2], d, *_strides(q, k, v),
             _scale(q, sm_scale), int(causal), _DTYPE_CODE[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream])


def _launch_dq(q, k, v, do, lse, delta, causal, sm_scale):
    """The dq kernel alone (checked inputs; delta (B, Hq, S) f32)."""
    dq = torch.empty_like(do)
    ptrs, rest = _bwd_args(q, k, v, do, lse, delta, causal, sm_scale)
    status = _build.load_library().ptt_flash_bwd_dq(*ptrs, dq.data_ptr(),
                                                     *rest)
    _build.check(status, "flash_attention_bwd (dq)")
    launches.add("flash_bwd_dq")
    return dq


def _launch_dkv(q, k, v, do, lse, delta, causal, sm_scale):
    """The dk/dv kernel alone (checked inputs; delta (B, Hq, S) f32)."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    ptrs, rest = _bwd_args(q, k, v, do, lse, delta, causal, sm_scale)
    status = _build.load_library().ptt_flash_bwd_dkv(
        *ptrs, dk.data_ptr(), dv.data_ptr(), *rest)
    _build.check(status, "flash_attention_bwd (dk, dv)")
    launches.add("flash_bwd_dkv")
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward keeps (q, k, v, o, lse); the backward is the two
    backward kernels (JAX `_flash_fwd_rule` / `_flash_bwd_rule`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_attention_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention_bshd(q, k, v, causal=False, sm_scale=None):
    """(B, S, H, D) entry (the reference flash_attention layout). GQA:
    the kv head count may divide the query head count. Differentiable
    in q, k and v; returns (B, S, Hq, D)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, bool(causal), sm_scale)
    return flash_attention_fwd(q, k, v, causal, sm_scale)[0]


def flash_attention_bhsd(q, k, v, causal=False, sm_scale=None):
    """(B, H, S, D) entry: the kernels read the transposed views through
    their strides, so no copy is made."""
    out = flash_attention_bshd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal, sm_scale)
    return out.transpose(1, 2)
