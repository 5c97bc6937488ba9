"""Llama-3 model family, in PyTorch.

Counterpart of paddle_tpu/models/llama.py: the no-cache causal forward,
the paged-KV forward the serving engine drives (inference/paged.py), and
the training forward: `forward(input_ids, labels=...)` returns the
shifted next-token loss and the logits, with flash attention
(`use_flash_attention`) and per-layer recomputation (`recompute`) as in
the JAX package. With `loss_chunk > 0` the loss is the blockwise cross
entropy (kernels/blockwise_ce.py) straight from the final hidden states,
and the forward returns (loss, None), as in JAX. Each projection goes
through parallel/overlap.py `linear` (JAX `_maybe_overlap_linear`):
inside the Trainer's `overlap_fsdp_guard` an fsdp-cut projection takes
the overlap ring, else it is the module's own call. Inside
distributed/context_parallel.py's guard the causal attention (flash or
plain) runs over the sequence cut; `position_ids` then carry the shard's
global positions, for the plain and the fused RoPE alike, and the
Trainer passes labels already shifted over the whole sequence with
`label_shift=False`.

With an int or 0-d tensor `cache_index` and per-layer (k, v) buffers
of (B, max_len, Hk, D) as `caches`, the forward is the dense-cache step
models/generation.py drives: it writes this call's k/v into the buffers
at cache_index + arange(S), in place, attends over the whole buffer
under the position mask (key j visible to query i iff j <= cache_index
+ i) combined with `attn_mask`, and returns (logits, caches). The index
stays on the device, so a captured CUDA graph replays it at each step's
own position.

`fused_norm` routes the decoder's RMSNorms through the RMSNorm(+residual)
kernels and `fused_rope` routes RoPE through the RoPE kernel
(kernels/fused_norm.py), forward and backward; the plain paths compute
the same function.

Linear weights follow torch's (out, in) layout; models/convert.py
carries a paddle_tpu state dict ((in, out) layout) across.

Tensor parallelism: parallel/plan.py `apply_plan` (through the Trainer
or `fleet.distributed_model`) turns the projections, the embedding and
the head into distributed/fleet/layers.py's classes over this rank's
shards. The attention and the MLP then run on the local heads and
columns, the counts read from the projections' own shapes (no config
field changes), and with a vocab-sharded head (lm_head, or the tied
embedding) the loss is the vocab-parallel one: `next_token_loss` through
`parallel_cross_entropy` over the shard's logits, `next_token_loss_
blockwise` through kernels/blockwise_ce.py `vocab_parallel_ce_loss`.
The logits the forward returns are gathered to the whole vocab.

FSDP: a parameter cut over 'fsdp' (distributed/sharding.py) is gathered
by its module for the module's forward; the reads outside a module's own
forward (the tied head's embedding, the blockwise loss's head weight,
the fused RMSNorm's weights) take it whole through `sharding.gathered`.
The head counts read the layers' `out_features` / `num_embeddings`,
which an fsdp cut leaves as they are.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.distributed.fleet.layers import (
    copy_to_mp, gather_from_mp, parallel_cross_entropy)
from paddle_tpu_torch.distributed.recompute import recompute
from paddle_tpu_torch.distributed.sharding import gathered
from paddle_tpu_torch.inference.paged import (PagedState,
                                             paged_attention_update)
from paddle_tpu_torch.kernels.blockwise_ce import vocab_parallel_ce_loss
from paddle_tpu_torch.kernels.fused_norm import (rms_norm_residual,
                                                 rope_apply, rope_tables)
from paddle_tpu_torch.models.generation import generate, kv_cache_update
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.parallel.overlap import linear as _project

__all__ = ["LlamaConfig", "llama3_8b_config", "tiny_llama_config",
           "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer", "LlamaModel",
           "LlamaForCausalLM", "next_token_loss", "next_token_loss_blockwise",
           "shift_labels",
           "param_count", "flops_per_token"]


@dataclass
class LlamaConfig:
    """The serving and training fields of the JAX package's LlamaConfig."""
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    tie_word_embeddings: bool = False
    initializer_range: float = 0.02
    # one (d + 2*kv, d) qkv matmul / one (2*f, d) gate-up matmul
    fuse_attention_qkv: bool = False
    fuse_attention_ffn: bool = False
    # RMSNorm(+residual) and RoPE through the CUDA kernels
    fused_norm: bool = False
    fused_rope: bool = False
    # no-cache attention through the flash kernels
    use_flash_attention: bool = False
    # rerun each decoder layer's forward in the backward when training
    recompute: bool = False
    # sequence length helpers use (benchmarks, example inputs)
    seq_length: int = 4096
    # > 0: the blockwise loss (the lm_head projection fused with the CE,
    # kernels/blockwise_ce.py); rows per streamed chunk on the CPU
    loss_chunk: int = 0
    loss_vocab_block: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def llama3_8b_config(**overrides) -> LlamaConfig:
    return LlamaConfig(**overrides)


def tiny_llama_config(**overrides) -> LlamaConfig:
    """4-layer toy config for tests / CPU dry runs."""
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=4, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256,
                rope_theta=10000.0, seq_length=32)
    base.update(overrides)
    return LlamaConfig(**base)


def next_token_loss(logits, labels, vocab_size, mp_group=None,
                    vocab_start=0, shift=True):
    """Shifted next-token cross entropy: position t scores labels[t+1];
    the last position is marked ignore_index (-100) instead of slicing
    the logits, and the mean leaves ignored rows out (JAX
    `next_token_loss`). With an `mp_group`, `logits` hold this rank's
    vocab columns from global id `vocab_start` on (a vocab-sharded
    head). `shift=False`: position t scores labels[t] (shifted before)."""
    target = _shifted(labels) if shift else labels.reshape(-1)
    if mp_group is not None:
        return parallel_cross_entropy(
            logits.reshape(-1, logits.shape[-1]), target,
            mp_group, vocab_start, ignore_index=-100)
    return F.cross_entropy(logits.reshape(-1, vocab_size), target,
                           ignore_index=-100)


def shift_labels(labels):
    """(B, S) next-token targets: labels[:, t + 1] at position t, -100 at
    the last (what the loss scores; the Trainer's sequence cut takes them
    before it cuts)."""
    b = labels.shape[0]
    return torch.cat([labels[:, 1:], torch.full(
        (b, 1), -100, dtype=labels.dtype, device=labels.device)], dim=1)


def _shifted(labels):
    """labels[:, t + 1] at position t, -100 at the last, flattened."""
    return shift_labels(labels).reshape(-1)


def next_token_loss_blockwise(hidden, weight, labels, config,
                              transpose_w=False, mp_group=None,
                              vocab_start=0, shift=True):
    """Shifted next-token CE straight from the final hidden states, the
    lm_head projection fused into the blockwise loss: the [B*S, vocab]
    logits never exist. `weight` is (D, V), or (V, D) with transpose_w;
    the same label shift and ignore_index as `next_token_loss` (JAX
    `next_token_loss_blockwise`). With an `mp_group`, `weight` is this
    rank's (V/n, D) vocab shard from global id `vocab_start` on.
    `shift=False`: position t scores labels[t] (shifted before)."""
    target = _shifted(labels) if shift else labels.reshape(-1)
    if mp_group is not None:
        w = weight if transpose_w else weight.t().contiguous()
        return vocab_parallel_ce_loss(
            hidden.reshape(-1, hidden.shape[-1]), w, target,
            vocab_start=vocab_start, group=mp_group, chunk=config.loss_chunk,
            vocab_block=config.loss_vocab_block, ignore_index=-100)
    return F.blockwise_cross_entropy(
        hidden.reshape(-1, hidden.shape[-1]), weight, target,
        chunk=config.loss_chunk, vocab_block=config.loss_vocab_block,
        ignore_index=-100, transpose_w=transpose_w)


def _linear(d_in, d_out):
    return nn.Linear(d_in, d_out, bias=False)


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class LlamaAttention(nn.Module):
    """GQA attention with RoPE; no-cache causal or paged-KV."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        d, hd = config.hidden_size, config.head_dim
        kv_out = config.num_key_value_heads * hd
        if config.fuse_attention_qkv:
            self.qkv_proj = _linear(d, d + 2 * kv_out)
        else:
            self.q_proj = _linear(d, d)
            self.k_proj = _linear(d, kv_out)
            self.v_proj = _linear(d, kv_out)
        self.o_proj = _linear(d, d)

    def forward(self, hidden_states, position_ids=None, cache=None,
                cache_index=None, rope=None, attn_mask=None):
        """`rope` carries RoPE tables shared across layers (fused_rope);
        None builds them here. With a (k_pool, v_pool) `cache` and a
        PagedState `cache_index`, k/v are written into the pools in place
        and attention runs over each slot's pages; with (k_buf, v_buf)
        and an int or 0-d tensor `cache_index`, the dense-cache step (the
        module doc). `attn_mask` (bool keep or additive float,
        broadcastable to (B, H, S, L)) joins the causal or position
        mask."""
        cfg = self.config
        b, s = hidden_states.shape[0], hidden_states.shape[1]
        hq, hk, hd = self.local_heads()
        if cfg.fuse_attention_qkv:
            q, k, v = torch.split(_project(self.qkv_proj, hidden_states),
                                  [hq * hd, hk * hd, hk * hd], dim=-1)
        else:
            q = _project(self.q_proj, hidden_states)
            k = _project(self.k_proj, hidden_states)
            v = _project(self.v_proj, hidden_states)
        # contiguous: the RoPE kernel takes dense (B, S, H, D) rows
        q = q.reshape(b, s, hq, hd).contiguous()
        k = k.reshape(b, s, hk, hd).contiguous()
        v = v.reshape(b, s, hk, hd)
        if cfg.fused_rope:
            q = rope_apply(q, position_ids, cfg.rope_theta, tables=rope)
            k = rope_apply(k, position_ids, cfg.rope_theta, tables=rope)
        else:
            q = F.rope_neox(q, position_ids, cfg.rope_theta)
            k = F.rope_neox(k, position_ids, cfg.rope_theta)
        if isinstance(cache_index, PagedState):
            out = paged_attention_update(q, k, v, cache, cache_index)
        elif cache is not None:
            out = _dense_cache_attention(q, k, v, cache, cache_index,
                                         attn_mask).reshape(b, s, hq * hd)
        elif cfg.use_flash_attention and attn_mask is None:
            out = F.flash_attention(q, k, v, causal=True)[0]
            out = out.reshape(b, s, hq * hd)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask,
                is_causal=attn_mask is None).reshape(b, s, hq * hd)
        return _project(self.o_proj, out)

    def local_heads(self):
        """(query heads, kv heads, head dim) this rank computes: the
        config's, or under tensor parallelism (a column-parallel q/k/v
        projection with an mp group) its share, read from the
        projections' shapes."""
        cfg = self.config
        hq, hk, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        proj = self.qkv_proj if cfg.fuse_attention_qkv else self.q_proj
        if getattr(proj, "mp_group", None) is None:
            return hq, hk, hd
        if cfg.fuse_attention_qkv:
            n = (hq + 2 * hk) * hd // proj.out_features
            return hq // n, hk // n, hd
        return proj.out_features // hd, self.k_proj.out_features // hd, hd


def _dense_cache_attention(q, k, v, cache, index, attn_mask):
    """The JAX dense-cache step (models/llama.py `LlamaAttention`): this
    call's k/v into the buffers at `index`, then attention over the whole
    buffer, key j visible to query i iff j <= index + i, combined with
    the caller's mask: a bool mask by `and`, a float mask added to a 0 /
    -inf position mask, so a row the float mask hides entirely still
    gives 0."""
    k_buf, v_buf = kv_cache_update(cache[0], k, index), \
        kv_cache_update(cache[1], v, index)
    s, kl = q.shape[1], k_buf.shape[1]
    q_pos = torch.arange(s, device=q.device) + index
    mask = (torch.arange(kl, device=q.device)[None, :]
            <= q_pos[:, None])[None, None]                 # (1, 1, S, L)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            mask = mask & attn_mask
        else:
            mask = torch.zeros(mask.shape, device=q.device).masked_fill(
                ~mask, float("-inf")) + attn_mask
    return F.scaled_dot_product_attention(q, k_buf, v_buf, attn_mask=mask)


class LlamaMLP(nn.Module):
    """SwiGLU MLP."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        d, f = config.hidden_size, config.intermediate_size
        self.fuse_ffn = config.fuse_attention_ffn
        if self.fuse_ffn:
            self.gate_up_fused_proj = _linear(d, 2 * f)
        else:
            self.gate_proj = _linear(d, f)
            self.up_proj = _linear(d, f)
        self.down_proj = _linear(f, d)

    def forward(self, x):
        if self.fuse_ffn:
            h = F.swiglu(_project(self.gate_up_fused_proj, x))
        else:
            h = F.swiglu(_project(self.gate_proj, x),
                         _project(self.up_proj, x))
        return _project(self.down_proj, h)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.self_attn = LlamaAttention(config)
        self.mlp = LlamaMLP(config)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps)

    def forward(self, hidden_states, position_ids=None, cache=None,
                cache_index=None, rope=None, attn_mask=None):
        eps = self.config.rms_norm_eps
        residual = hidden_states
        if self.config.fused_norm:
            h, _ = rms_norm_residual(hidden_states,
                                     gathered(self.input_layernorm), None,
                                     eps)
        else:
            h = self.input_layernorm(hidden_states)
        h = self.self_attn(h, position_ids, cache, cache_index, rope,
                           attn_mask)
        if self.config.fused_norm:
            # the attention residual add rides the norm's pass
            h2, residual = rms_norm_residual(
                h, gathered(self.post_attention_layernorm), residual, eps)
        else:
            h = residual + h
            residual = h
            h2 = self.post_attention_layernorm(h)
        return residual + self.mlp(h2)


class LlamaModel(nn.Module):
    # the decoder layer a subclass stacks (models/qwen2_moe.py)
    decoder_layer = LlamaDecoderLayer

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size)
        self.layers = nn.ModuleList(
            [self.decoder_layer(config)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps)

    def forward(self, input_ids, position_ids=None, caches=None,
                cache_index=None, attn_mask=None):
        """Final hidden states (B, S, D). `caches`: one (k_pool, v_pool)
        pair per layer (paged forward) or one (k_buf, v_buf) pair (dense
        cache), updated in place."""
        cfg = self.config
        h = self.embed_tokens(input_ids)
        rope = None
        if cfg.fused_rope:
            # one table pair per forward, shared by q and k of every layer
            b, s = input_ids.shape
            if position_ids is None:
                flat = torch.arange(s, dtype=torch.int32,
                                    device=h.device).repeat(b)
            else:
                flat = position_ids.to(torch.int32).expand(b, s).reshape(-1)
            rope = rope_tables(flat, cfg.head_dim, cfg.rope_theta)
        train_recompute = cfg.recompute and self.training and caches is None
        for i, layer in enumerate(self.layers):
            if train_recompute:
                h = recompute(layer, h, position_ids, None, None, rope,
                              attn_mask)
                continue
            cache = None if caches is None else caches[i]
            h = layer(h, position_ids, cache, cache_index, rope, attn_mask)
        return self._final_norm(h)

    def _final_norm(self, h):
        if self.config.fused_norm:
            return rms_norm_residual(h, gathered(self.norm), None,
                                     self.config.rms_norm_eps)[0]
        return self.norm(h)


class LlamaForCausalLM(nn.Module):
    """Causal LM head over LlamaModel.

    Built directly on `device` (default the CUDA card; "cpu" must be
    asked for) in `dtype`: parameters are created without storage and
    then initialised in place from `seed` with a generator on the
    device, normal(0, initializer_range) for projections and embeddings
    and ones for norm weights, as the JAX package initialises them.

    Built for serving: no parameter requires a gradient and the model is
    in eval mode, so a forward records no autograd graph. The Trainer
    (parallel/trainer.py) makes the parameters trainable and puts the
    model in training mode.
    """

    def __init__(self, config: LlamaConfig, *, device="cuda",
                 dtype=torch.float32, seed=0):
        dev = resolve_device(device)
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.model, self.lm_head = self._build(config)
        # cast while still storage-free, so the device only ever holds
        # the parameters once, in `dtype`
        self.to(dtype)
        self.to_empty(device=dev)
        self.requires_grad_(False)       # forward only: no autograd graph
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, config.initializer_range, generator=gen)
        self.eval()

    @staticmethod
    def _build(config):
        """(the body, the lm_head Linear or None for a tied head)."""
        return LlamaModel(config), (
            None if config.tie_word_embeddings
            else _linear(config.hidden_size, config.vocab_size))

    @property
    def device(self):
        return self.model.embed_tokens.weight.device

    @property
    def dtype(self):
        return self.model.embed_tokens.weight.dtype

    def _head(self):
        """(the head module: lm_head, or the tied embedding; its mp group
        or None; the first vocab id of its rows)."""
        mod = self.model.embed_tokens if self.lm_head is None \
            else self.lm_head
        group = getattr(mod, "mp_group", None)
        if group is None:
            return mod, None, 0
        rows = mod.num_embeddings if self.lm_head is None \
            else mod.out_features
        return mod, group, group.rank * rows

    def _local_logits(self, hidden):
        """Logits over the head's rows: the whole vocab, or this rank's
        shard of it."""
        if self.lm_head is None:
            group = getattr(self.model.embed_tokens, "mp_group", None)
            return copy_to_mp(hidden, group) @ \
                gathered(self.model.embed_tokens).t()
        return self.lm_head(hidden)

    def logits(self, hidden):
        return gather_from_mp(self._local_logits(hidden), self._head()[1])

    def forward(self, input_ids, position_ids=None, caches=None,
                cache_index=None, labels=None, attn_mask=None,
                label_shift=True):
        """Logits (B, S, vocab). With `caches`/`cache_index` (a
        PagedState), the paged forward: pools are updated in place. With
        dense (k_buf, v_buf) `caches` and an int or 0-d tensor
        `cache_index`, (logits, caches): the dense-cache step (module
        doc). `attn_mask` (bool keep or additive float, broadcastable to
        (B, H, S, L)) joins the causal or position mask; without a cache
        it takes the plain masked attention. With `labels` (B, S), (loss,
        logits): the shifted next-token loss, f32 (a no-cache forward
        only); with `loss_chunk > 0`, (loss, None): the blockwise loss
        builds no logits to return. `label_shift=False`: `labels` are
        the next-token targets already (position t scores labels[t])."""
        if labels is not None and caches is not None:
            raise ValueError("KV-cache decode is inference-only; drop "
                             "labels or caches")
        h = self.model(input_ids, position_ids, caches, cache_index,
                       attn_mask)
        if caches is not None and not isinstance(cache_index, PagedState):
            return self.logits(h), caches
        head, group, start = self._head()
        if labels is not None and self.config.loss_chunk:
            # both heads hold W as (V, D): the embedding, and nn.Linear's
            # (out, in) weight
            return next_token_loss_blockwise(
                h, gathered(head), labels, self.config, transpose_w=True,
                mp_group=group, vocab_start=start, shift=label_shift), None
        logits = self._local_logits(h)
        if labels is None:
            return gather_from_mp(logits, group)
        loss = next_token_loss(logits, labels, self.config.vocab_size,
                               mp_group=group, vocab_start=start,
                               shift=label_shift)
        if group is not None:
            logits = gather_from_mp(logits.detach(), group)
        return loss, logits

    def generate(self, input_ids, max_new_tokens=32, **kwargs):
        """KV-cache autoregressive generation (models/generation.py
        `generate`)."""
        return generate(self, input_ids, max_new_tokens, **kwargs)


def param_count(config: LlamaConfig) -> int:
    """Analytic parameter count (JAX `param_count`)."""
    d, f, v = config.hidden_size, config.intermediate_size, config.vocab_size
    hd = config.head_dim
    per_layer = (d * d + 2 * d * config.num_key_value_heads * hd + d * d
                 + 3 * d * f + 2 * d)
    head = 0 if config.tie_word_embeddings else d * v
    return v * d + config.num_hidden_layers * per_layer + d + head


def flops_per_token(config: LlamaConfig, seq_len: int) -> float:
    """Training FLOPs per token ~= 6 N + the attention term, N without
    the embedding and head (JAX `flops_per_token`)."""
    n = param_count(config) - config.vocab_size * config.hidden_size * (
        1 if config.tie_word_embeddings else 2)
    attn = 12 * config.num_hidden_layers * config.hidden_size * seq_len
    return 6.0 * n + attn
