"""Carry weights from a paddle_tpu Llama state dict into the port.

paddle_tpu keeps a Linear weight as (in, out) (paddle_tpu/nn/layer/
common.py); torch.nn.Linear keeps (out, in). Parameter names are the same
in both packages, so conversion is a transpose of every Linear weight
and a copy of everything else (embeddings (vocab, d) and norm weights
(d,) keep their layout). Training configs (flash attention, recompute,
the fused kernels) hold the same parameters, so one conversion serves
serving and training; bf16 arrays (numpy's `ml_dtypes.bfloat16`, which
torch cannot take directly) come across exactly as torch.bfloat16.

A JAX model converted to weight-only int8 (`PTQ(...).convert(execute=
"weight_only_int8")`) holds `<layer>.qweight` (K, N) int8 and
`<layer>.w_scale` (N,) f32 in place of each Linear weight; they are
copied as they are into a port model that `quantization.
quantize_weight_only` has converted, which keeps the same (K, N) layout.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_paddle_tpu_state"]


def _is_linear_weight(name):
    return name == "lm_head.weight" or name.endswith("_proj.weight")


def _expected_shapes(config, weight_only_int8=False):
    """Parameter name -> shape of the port's LlamaForCausalLM(config),
    from a storage-free copy of the model; with `weight_only_int8`, of
    that model after `quantize_weight_only` (each Linear weight (N, K)
    replaced by qweight (K, N) and w_scale (N,))."""
    from paddle_tpu_torch.models.llama import LlamaModel
    with torch.device("meta"):
        body = LlamaModel(config)
    shapes = {"model." + k: tuple(v.shape)
              for k, v in body.state_dict().items()}
    if not config.tie_word_embeddings:
        shapes["lm_head.weight"] = (config.vocab_size, config.hidden_size)
    if weight_only_int8:
        for name in [n for n in shapes if _is_linear_weight(n)]:
            n_out, n_in = shapes.pop(name)
            base = name[:-len(".weight")]
            shapes[base + ".qweight"] = (n_in, n_out)
            shapes[base + ".w_scale"] = (n_out,)
    return shapes


def from_paddle_tpu_state(np_state, config):
    """`np_state`: {name: np.ndarray} from a paddle_tpu LlamaForCausalLM
    (e.g. `{k: np.asarray(v._value) for k, v in m.state_dict().items()}`).
    Returns a torch state dict for the port's LlamaForCausalLM(config),
    or, when the JAX model is weight-only int8, for that model after
    `quantize_weight_only`; raises ValueError on a missing, unexpected or
    misshapen entry."""
    expected = _expected_shapes(
        config, any(k.endswith(".qweight") for k in np_state))
    missing = sorted(set(expected) - set(np_state))
    extra = sorted(set(np_state) - set(expected))
    if missing or extra:
        raise ValueError(f"state dict does not fit the config: missing "
                         f"{missing}, unexpected {extra}")
    out = {}
    for name, arr in np_state.items():
        arr = np.asarray(arr)
        if _is_linear_weight(name):
            arr = arr.T                          # (in, out) -> (out, in)
        if arr.shape != expected[name]:
            raise ValueError(f"{name}: shape {arr.shape} after conversion, "
                             f"expected {expected[name]}")
        out[name] = _to_torch(arr)
    return out


def _to_torch(arr):
    """An own, C-ordered torch copy of a numpy array; bf16 goes through
    f32, which holds every bf16 value exactly."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.array(arr.astype(np.float32), order="C")).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, order="C"))
