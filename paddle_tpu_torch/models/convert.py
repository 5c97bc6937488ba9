"""Carry weights from a paddle_tpu Llama state dict into the port.

paddle_tpu keeps a Linear weight as (in, out) (paddle_tpu/nn/layer/
common.py); torch.nn.Linear keeps (out, in). Parameter names are the same
in both packages, so conversion is a transpose of every Linear weight
and a copy of everything else (embeddings (vocab, d) and norm weights
(d,) keep their layout).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_paddle_tpu_state"]


def _expected_shapes(config):
    """Parameter name -> shape of the port's LlamaForCausalLM(config),
    from a storage-free copy of the model."""
    from paddle_tpu_torch.models.llama import LlamaModel
    with torch.device("meta"):
        body = LlamaModel(config)
    shapes = {"model." + k: tuple(v.shape)
              for k, v in body.state_dict().items()}
    if not config.tie_word_embeddings:
        shapes["lm_head.weight"] = (config.vocab_size, config.hidden_size)
    return shapes


def from_paddle_tpu_state(np_state, config):
    """`np_state`: {name: np.ndarray} from a paddle_tpu LlamaForCausalLM
    (e.g. `{k: np.asarray(v._value) for k, v in m.state_dict().items()}`).
    Returns a torch state dict for the port's LlamaForCausalLM(config);
    raises ValueError on a missing, unexpected or misshapen entry."""
    expected = _expected_shapes(config)
    missing = sorted(set(expected) - set(np_state))
    extra = sorted(set(np_state) - set(expected))
    if missing or extra:
        raise ValueError(f"state dict does not fit the config: missing "
                         f"{missing}, unexpected {extra}")
    out = {}
    for name, arr in np_state.items():
        arr = np.asarray(arr)
        if name == "lm_head.weight" or name.endswith("_proj.weight"):
            arr = arr.T                          # (in, out) -> (out, in)
        if arr.shape != expected[name]:
            raise ValueError(f"{name}: shape {arr.shape} after conversion, "
                             f"expected {expected[name]}")
        out[name] = torch.from_numpy(np.array(arr, order="C"))  # own copy
    return out
