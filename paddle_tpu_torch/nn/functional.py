"""Plain ops the Llama model needs, with the JAX package's cast points.

- `rms_norm`: paddle_tpu/nn/functional/norm.py `_rms_norm` (f32 stats,
  f32 scale-by-weight, one cast back);
- `swiglu`: paddle_tpu/incubate/nn/functional `_swiglu` (silu in f32,
  cast back, then times y in the input type);
- `rope_neox`: the half-split NeoX rotation `_rope_neox_raw` with the
  tables of `_rope_cos_sin`, for `LlamaConfig(fused_rope=False)`;
- `causal_attention`: the no-cache causal attention of `_sdpa_ref`
  (f32 scores, probabilities cast to the input type before the value
  product), GQA by head groups instead of repeated K/V;
- `flash_attention`: nn/functional/attention.py `flash_attention` over
  the flash kernels (kernels/flash_attention.py);
- `cross_entropy`: the pretrain-shape fast path of nn/functional/loss.py
  (`_ce_mean_fused`): f32 log-softmax, mean over the rows that are not
  `ignore_index`, the gradient in the logits' type;
- `blockwise_cross_entropy`: nn/functional/loss.py's, the lm_head
  projection fused with the CE over the blockwise kernels
  (kernels/blockwise_ce.py), so no [N, V] logits exist.
"""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.kernels.blockwise_ce import blockwise_ce_loss
from paddle_tpu_torch.kernels.flash_attention import flash_attention_bshd

__all__ = ["rms_norm", "swiglu", "rope_neox", "causal_attention",
           "flash_attention", "cross_entropy", "blockwise_cross_entropy"]


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


def flash_attention(query, key, value, causal=False):
    """(B, S, H, D) flash attention; returns (out, None) like the JAX
    package's (out, softmax placeholder) pair."""
    return flash_attention_bshd(query, key, value, causal=causal), None


class _CrossEntropyMean(torch.autograd.Function):
    """Mean softmax-CE over int labels keeping only the f32 lse per row:
    the backward recomputes softmax from the logits in one pass,
    dlogits = (softmax - onehot) * g * valid / count, in the logits'
    type (JAX `_ce_mean_fused`)."""

    @staticmethod
    def forward(ctx, logits, labels, ignore_index):
        m = torch.amax(logits, dim=-1).float()
        sumexp = torch.sum(torch.exp(logits.float() - m[:, None]), dim=-1)
        lse = m + torch.log(sumexp)
        valid = labels != ignore_index
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        picked = torch.gather(logits, 1, safe[:, None].long())[:, 0].float()
        count = torch.clamp(valid.float().sum(), min=1.0)
        loss = torch.where(valid, lse - picked,
                           torch.zeros_like(lse)).sum() / count
        ctx.save_for_backward(logits, safe, lse, valid, count)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, safe, lse, valid, count = ctx.saved_tensors
        scale = (g / count) * valid.float()
        d = torch.exp(logits.float() - lse[:, None])
        rows = torch.arange(d.shape[0], device=d.device)
        d[rows, safe.long()] -= 1.0
        d *= scale[:, None]
        return d.to(logits.dtype), None, None


def cross_entropy(input, label, ignore_index=-100):
    """Mean cross entropy of logits `input` (N, V) against int labels
    (N,), rows labelled `ignore_index` left out of the mean: the
    pretrain shape the Llama loss takes. f32 result."""
    if input.dim() != 2 or label.dim() != 1 \
            or label.dtype.is_floating_point:
        raise NotImplementedError("cross_entropy: only the mean over 2-D "
                                  "logits and 1-D int labels is ported")
    return _CrossEntropyMean.apply(input, label, int(ignore_index))


def blockwise_cross_entropy(hidden, weight, label, chunk, vocab_block=0,
                            ignore_index=-100, transpose_w=False):
    """Mean CE of `hidden @ weight` against int `label` without the
    [N, V] logits. hidden (N, D), weight (D, V), or (V, D) with
    transpose_w=True, label (N,). On the CPU `chunk` rows (and
    `vocab_block` vocab rows when > 0) stream per block; the CUDA kernels
    pick their own tiles. The kernels read W as dense (V, D) rows, so a
    (D, V) weight is transposed into a copy once per call."""
    w = weight if transpose_w else weight.t().contiguous()
    return blockwise_ce_loss(hidden, w, label, chunk=chunk,
                             vocab_block=vocab_block,
                             ignore_index=ignore_index)
