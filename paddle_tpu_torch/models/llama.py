"""Llama-3 model family for serving, in PyTorch.

Counterpart of paddle_tpu/models/llama.py, forward only: the no-cache
causal forward (plain math) and the paged-KV forward the serving engine
drives (inference/paged.py). Training-only knobs (recompute, blockwise
loss, FSDP overlap) wait for the training slice.

`fused_norm` routes the decoder's RMSNorms through the RMSNorm(+residual)
kernel and `fused_rope` routes RoPE through the RoPE kernel
(kernels/fused_norm.py); the plain paths compute the same function.

Linear weights follow torch's (out, in) layout; models/convert.py
carries a paddle_tpu state dict ((in, out) layout) across.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.inference.paged import paged_attention_update
from paddle_tpu_torch.kernels.fused_norm import (rms_norm_residual,
                                                 rope_apply, rope_tables)
from paddle_tpu_torch.nn import functional as F

__all__ = ["LlamaConfig", "llama3_8b_config", "tiny_llama_config",
           "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer", "LlamaModel",
           "LlamaForCausalLM"]


@dataclass
class LlamaConfig:
    """The serving fields of the JAX package's LlamaConfig."""
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
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

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def llama3_8b_config(**overrides) -> LlamaConfig:
    return LlamaConfig(**overrides)


def tiny_llama_config(**overrides) -> LlamaConfig:
    """4-layer toy config for tests / CPU dry runs."""
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=4, num_attention_heads=4,
                num_key_value_heads=2, rope_theta=10000.0)
    base.update(overrides)
    return LlamaConfig(**base)


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
                cache_index=None, rope=None):
        """`rope` carries RoPE tables shared across layers (fused_rope);
        None builds them here. With a (k_pool, v_pool) `cache` and a
        PagedState `cache_index`, k/v are written into the pools in place
        and attention runs over each slot's pages."""
        cfg = self.config
        b, s = hidden_states.shape[0], hidden_states.shape[1]
        hq, hk, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        if cfg.fuse_attention_qkv:
            q, k, v = torch.split(self.qkv_proj(hidden_states),
                                  [hq * hd, hk * hd, hk * hd], dim=-1)
        else:
            q = self.q_proj(hidden_states)
            k = self.k_proj(hidden_states)
            v = self.v_proj(hidden_states)
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
        if cache is not None:
            out = paged_attention_update(q, k, v, cache, cache_index)
        else:
            out = F.causal_attention(q, k, v).reshape(b, s, hq * hd)
        return self.o_proj(out)


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
            h = F.swiglu(self.gate_up_fused_proj(x))
        else:
            h = F.swiglu(self.gate_proj(x), self.up_proj(x))
        return self.down_proj(h)


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
                cache_index=None, rope=None):
        eps = self.config.rms_norm_eps
        residual = hidden_states
        if self.config.fused_norm:
            h, _ = rms_norm_residual(hidden_states,
                                     self.input_layernorm.weight, None, eps)
        else:
            h = self.input_layernorm(hidden_states)
        h = self.self_attn(h, position_ids, cache, cache_index, rope)
        if self.config.fused_norm:
            # the attention residual add rides the norm's pass
            h2, residual = rms_norm_residual(
                h, self.post_attention_layernorm.weight, residual, eps)
        else:
            h = residual + h
            residual = h
            h2 = self.post_attention_layernorm(h)
        return residual + self.mlp(h2)


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps)

    def forward(self, input_ids, position_ids=None, caches=None,
                cache_index=None):
        """Final hidden states (B, S, D). `caches`: one (k_pool, v_pool)
        pair per layer, updated in place (paged forward)."""
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
        for i, layer in enumerate(self.layers):
            cache = None if caches is None else caches[i]
            h = layer(h, position_ids, cache, cache_index, rope)
        if cfg.fused_norm:
            return rms_norm_residual(h, self.norm.weight, None,
                                     cfg.rms_norm_eps)[0]
        return self.norm(h)


class LlamaForCausalLM(nn.Module):
    """Causal LM head over LlamaModel.

    Built directly on `device` (default the CUDA card; "cpu" must be
    asked for) in `dtype`: parameters are created without storage and
    then initialised in place from `seed` with a generator on the
    device, normal(0, initializer_range) for projections and embeddings
    and ones for norm weights, as the JAX package initialises them.
    """

    def __init__(self, config: LlamaConfig, *, device="cuda",
                 dtype=torch.float32, seed=0):
        dev = resolve_device(device)
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.model = LlamaModel(config)
            self.lm_head = (None if config.tie_word_embeddings
                            else _linear(config.hidden_size,
                                         config.vocab_size))
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

    @property
    def device(self):
        return self.model.embed_tokens.weight.device

    @property
    def dtype(self):
        return self.model.embed_tokens.weight.dtype

    def logits(self, hidden):
        if self.lm_head is None:
            return hidden @ self.model.embed_tokens.weight.t()
        return self.lm_head(hidden)

    def forward(self, input_ids, position_ids=None, caches=None,
                cache_index=None):
        """Logits (B, S, vocab). With `caches`/`cache_index` (a
        PagedState), the paged forward: pools are updated in place."""
        h = self.model(input_ids, position_ids, caches, cache_index)
        return self.logits(h)
