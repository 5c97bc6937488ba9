"""Plain ops the Llama model needs, with the JAX package's cast points.

- `rms_norm`: paddle_tpu/nn/functional/norm.py `_rms_norm` (f32 stats,
  f32 scale-by-weight, one cast back);
- `swiglu`: paddle_tpu/incubate/nn/functional `_swiglu` (silu in f32,
  cast back, then times y in the input type);
- `rope_neox`: the half-split NeoX rotation `_rope_neox_raw` with the
  tables of `_rope_cos_sin`, for `LlamaConfig(fused_rope=False)`;
- `scaled_dot_product_attention`: nn/functional/attention.py `_sdpa_ref`
  (every plain attention of models/llama.py: causal, masked and over
  the dense cache): f32 scores times the scale, GQA by head groups
  instead of repeated K/V, a bool mask as -inf and a float mask added,
  probabilities cast to q's type before the value product, and a row
  the mask hides entirely gives 0, not NaN;
- `flash_attention`: nn/functional/attention.py `flash_attention` over
  the flash kernels (kernels/flash_attention.py);
- inside distributed/context_parallel.py's `context_parallel_guard`, a
  causal, mask-free attention of either kind runs over the sequence cut
  (the flash ring or Ulysses for `flash_attention`, their plain
  versions for `scaled_dot_product_attention`);
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

__all__ = ["rms_norm", "swiglu", "rope_neox",
           "scaled_dot_product_attention", "flash_attention",
           "cross_entropy", "blockwise_cross_entropy"]


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


def scaled_dot_product_attention(q, k, v, attn_mask=None, is_causal=False,
                                 scale=None):
    """`_sdpa_plain`; inside distributed/context_parallel.py's guard a
    causal, mask-free call on this rank's sequence shard goes to the
    guard's plain ring or Ulysses attention instead (JAX `_sdpa`)."""
    if is_causal and attn_mask is None and scale is None:
        from paddle_tpu_torch.distributed import context_parallel as cp
        if cp._cp_state["mode"]:
            return cp.dispatch_context_parallel(q, k, v, True,
                                                use_flash=False)
    return _sdpa_plain(q, k, v, attn_mask, is_causal, scale)


def _sdpa_plain(q, k, v, attn_mask=None, is_causal=False, scale=None):
    """softmax(q kᵀ · scale + mask) v on (B, S, H, D) inputs, k/v (B, L,
    Hk, D): query head h reads kv head h // (H/Hk), the head a repeat of
    the kv heads gives it, without the repeated copy. `attn_mask` is
    broadcastable to (B, H, S, L): bool keeps where True, a float mask
    is added to the scores. torch's own scaled_dot_product_attention
    gives NaN for a row the mask hides entirely (a left-padded
    position); this gives 0 there, as the JAX reference does."""
    b, sq, hq, d = q.shape
    kl, hk = k.shape[1], k.shape[2]
    g = hq // hk
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.transpose(1, 2).reshape(b, hk, g * sq, d).float()
    kt = k.transpose(1, 2).float()                         # (B, Hk, L, D)
    scores = (qg @ kt.transpose(-1, -2)).reshape(b, hq, sq, kl) * sc
    if is_causal:
        keep = torch.ones(sq, kl, dtype=torch.bool,
                          device=q.device).tril(kl - sq)
        scores = scores.masked_fill(~keep, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = scores.masked_fill(~attn_mask, float("-inf"))
        else:
            scores = scores + attn_mask.to(scores.dtype)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if attn_mask is not None or (is_causal and kl < sq):
        # a causal row is fully hidden only when queries outnumber keys
        hidden = torch.isneginf(scores).all(-1, keepdim=True)
        probs = probs.masked_fill(hidden, 0.0)
    out = probs.reshape(b, hk, g * sq, kl) @ v.transpose(1, 2)
    return out.reshape(b, hq, sq, d).transpose(1, 2)


def flash_attention(query, key, value, causal=False):
    """(B, S, H, D) flash attention; returns (out, None) like the JAX
    package's (out, softmax placeholder) pair. Inside distributed/
    context_parallel.py's guard a causal call on this rank's sequence
    shard goes to the guard's flash ring or Ulysses attention (JAX
    `_flash_attention`)."""
    if causal:
        from paddle_tpu_torch.distributed import context_parallel as cp
        if cp._cp_state["mode"]:
            return cp.dispatch_context_parallel(query, key, value, True), \
                None
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
