"""Plain ops the Llama model needs, with the JAX package's cast points.

- `rms_norm`: paddle_tpu/nn/functional/norm.py `_rms_norm` (f32 stats,
  f32 scale-by-weight, one cast back);
- `swiglu`: paddle_tpu/incubate/nn/functional `_swiglu` (silu in f32,
  cast back, then times y in the input type);
- `rope_neox`: the half-split NeoX rotation `_rope_neox_raw` with the
  tables of `_rope_cos_sin`, for `LlamaConfig(fused_rope=False)`;
- `causal_attention`: the no-cache causal attention of `_sdpa_ref`
  (f32 scores, probabilities cast to the input type before the value
  product), GQA by head groups instead of repeated K/V.
"""
from __future__ import annotations

import math

import torch

__all__ = ["rms_norm", "swiglu", "rope_neox", "causal_attention"]


def rms_norm(x, weight=None, epsilon=1e-6):
    xf = x.float()
    out = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True)
                           + epsilon)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def swiglu(x, y=None):
    """silu(x) * y, or split x in half when y is None."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return torch.nn.functional.silu(x.float()).to(x.dtype) * y


def rope_neox(x, position_ids=None, theta=10000.0):
    """NeoX/Llama rotation of x (B, S, H, D) over [first half | second
    half]; position_ids (S,) or (B, S), None = arange(S)."""
    b, s, h, d = x.shape
    inv_freq = 1.0 / (float(theta) ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    if position_ids is None:
        position_ids = torch.arange(s, device=x.device)
    freqs = position_ids.to(torch.float32)[..., None] * inv_freq
    if freqs.dim() == 2:                                   # (S, D/2)
        cos, sin = torch.cos(freqs)[None, :, None], torch.sin(freqs)[None, :, None]
    else:                                                  # (B, S, D/2)
        cos, sin = torch.cos(freqs)[:, :, None], torch.sin(freqs)[:, :, None]
    d2 = d // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def causal_attention(q, k, v):
    """softmax(q kᵀ / sqrt(d), causal) v for q (B, S, Hq, D) and k/v
    (B, S, Hk, D); query head h reads kv head h // (Hq/Hk). Returns
    (B, S, Hq, D) in q's type."""
    b, s, hq, d = q.shape
    hk = k.shape[2]
    g = hq // hk
    qg = q.transpose(1, 2).reshape(b, hk, g, s, d)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)           # (B, Hk, S, D)
    scores = torch.einsum("bhgsd,bhcd->bhgsc", qg.float(),
                          kt.float()) / math.sqrt(d)
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgsc,bhcd->bhgsd", p, vt)
    return out.reshape(b, hq, s, d).transpose(1, 2)
