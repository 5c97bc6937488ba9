"""Qwen2-MoE model family, in PyTorch.

Counterpart of paddle_tpu/models/qwen2_moe.py: the Llama attention stack
(the port's `LlamaAttention`, with its paged-KV, dense-cache, flash and
fused-RoPE paths) with the MoE MLP of nn/moe.py in every layer, plus the
Qwen2-MoE shared expert, a SwiGLU MLP scaled by sigmoid(shared_expert_
gate(x)). As in the JAX package, the layer norms are the plain RMSNorm
(`fused_norm` is ignored), the lm_head is always its own Linear
(`tie_word_embeddings` is ignored) and the training loss is the dense
`next_token_loss` (a `loss_chunk` is refused) plus `router_aux_loss_coef`
times the sum of the layers' aux losses from the same forward.

The forward takes the Llama model's arguments and returns what it
returns, so the paged engine (inference/paged.py), `generate`
(models/generation.py) and the Trainer (parallel/trainer.py) drive it
as they drive Llama. Built the same way: on `device` (default the CUDA
card) in `dtype`, weights drawn from `seed` on the device (norm weights
ones, everything else normal(0, initializer_range), the router and the
stacked experts included), for serving until the Trainer takes it.

Parameters: the Llama names for attention and norms;
`mlp.moe.router_weight` (D, E), `mlp.moe.experts_{gate,up}_weight`
(E, D, F), `mlp.moe.experts_down_weight` (E, F, D) in the JAX layout;
`mlp.shared_expert.{gate,up,down}_proj.weight` and
`mlp.shared_expert_gate.weight` (1, D) as torch Linears (out, in).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch.models.llama import (LlamaAttention, LlamaConfig,
                                           LlamaForCausalLM, LlamaMLP,
                                           LlamaModel, RMSNorm, _linear)
from paddle_tpu_torch.nn.moe import MoEMLP

__all__ = ["Qwen2MoeConfig", "tiny_qwen2_moe_config", "Qwen2MoeSparseBlock",
           "Qwen2MoeDecoderLayer", "Qwen2MoeModel", "Qwen2MoeForCausalLM"]


@dataclass
class Qwen2MoeConfig(LlamaConfig):
    num_experts: int = 60
    num_experts_per_tok: int = 2
    moe_intermediate_size: int = 1408
    shared_expert_intermediate_size: int = 5632
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.001
    # the dropless grouped-product path instead of GShard capacity
    moe_dropless: bool = False


def tiny_qwen2_moe_config(**overrides) -> Qwen2MoeConfig:
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256,
                rope_theta=10000.0, seq_length=32, num_experts=4,
                num_experts_per_tok=2, moe_intermediate_size=32,
                shared_expert_intermediate_size=64)
    base.update(overrides)
    return Qwen2MoeConfig(**base)


class Qwen2MoeSparseBlock(nn.Module):
    """The routed experts plus the always-on shared expert with its
    sigmoid gate."""

    def __init__(self, config: Qwen2MoeConfig):
        super().__init__()
        self.moe = MoEMLP(config.hidden_size, config.moe_intermediate_size,
                          config.num_experts,
                          top_k=config.num_experts_per_tok,
                          capacity_factor=config.capacity_factor,
                          dropless=config.moe_dropless)
        self.shared_expert = LlamaMLP(LlamaConfig(
            hidden_size=config.hidden_size,
            intermediate_size=config.shared_expert_intermediate_size))
        self.shared_expert_gate = _linear(config.hidden_size, 1)

    def forward(self, x):
        moe_out = self.moe(x)
        shared = self.shared_expert(x)
        return moe_out + torch.sigmoid(self.shared_expert_gate(x)) * shared

    @property
    def aux_loss(self):
        return self.moe.aux_loss


class Qwen2MoeDecoderLayer(nn.Module):
    def __init__(self, config: Qwen2MoeConfig):
        super().__init__()
        self.config = config
        self.self_attn = LlamaAttention(config)
        self.mlp = Qwen2MoeSparseBlock(config)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps)

    def forward(self, hidden_states, position_ids=None, cache=None,
                cache_index=None, rope=None, attn_mask=None):
        h = hidden_states + self.self_attn(
            self.input_layernorm(hidden_states), position_ids, cache,
            cache_index, rope, attn_mask)
        return h + self.mlp(self.post_attention_layernorm(h))


class Qwen2MoeModel(LlamaModel):
    """The Llama body over Qwen2-MoE layers, with the plain final norm."""
    decoder_layer = Qwen2MoeDecoderLayer

    def _final_norm(self, h):
        return self.norm(h)

    def aux_losses(self):
        """The aux loss of each layer's last forward."""
        return [layer.mlp.aux_loss for layer in self.layers
                if layer.mlp.aux_loss is not None]


class Qwen2MoeForCausalLM(LlamaForCausalLM):
    """Causal LM head over Qwen2MoeModel (module doc); built as
    LlamaForCausalLM is."""

    @staticmethod
    def _build(config):
        if config.loss_chunk:
            raise ValueError(
                f"loss_chunk {config.loss_chunk}: Qwen2-MoE takes the dense "
                "next-token loss, as the JAX model does")
        return Qwen2MoeModel(config), _linear(config.hidden_size,
                                              config.vocab_size)

    def forward(self, input_ids, position_ids=None, caches=None,
                cache_index=None, labels=None, attn_mask=None,
                label_shift=True):
        """LlamaForCausalLM.forward's contract; with `labels`, (loss,
        logits), the loss carrying `router_aux_loss()`."""
        out = super().forward(input_ids, position_ids, caches, cache_index,
                              labels, attn_mask, label_shift)
        if labels is None:
            return out
        loss, logits = out
        return loss + self.router_aux_loss(), logits

    def router_aux_loss(self):
        """router_aux_loss_coef times the sum of the layers' aux losses
        from the last forward; inside nn/moe.py's `batch_group`, this
        rank's share of the group's (parallel/trainer.py weighs it apart
        from the token mean)."""
        auxes = self.model.aux_losses()
        if not auxes:
            return 0.0
        return self.config.router_aux_loss_coef * sum(auxes[1:], auxes[0])
