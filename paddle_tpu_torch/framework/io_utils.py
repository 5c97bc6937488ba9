"""paddle.save / paddle.load over torch tensors.

Counterpart of paddle_tpu/framework/io_utils.py (reference:
python/paddle/framework/io.py:721,960): the pickle container structure,
each tensor serialized as a `_TensorPayload` holding a numpy array,
nested state dicts supported. numpy has no bfloat16, so a bf16 (or fp8)
tensor is stored as f32 and tagged with its dtype name, as the JAX
module tags it, and restored to that dtype on load. The payload class
has this module's path, so the files of the two packages are each
read by their own package.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load"]


class _TensorPayload:
    """Pickle-stable tensor representation: numpy data and the dtype's
    name (numpy's spelling; bf16 and fp8 data held as f32)."""

    def __init__(self, t: torch.Tensor):
        t = t.detach().cpu()
        self.dtype_name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16 or "float8" in self.dtype_name:
            t = t.float()
        self.data = t.numpy()

    def restore(self):
        return torch.from_numpy(np.array(self.data)).to(
            getattr(torch, self.dtype_name))


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(obj)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _unpack(obj, return_numpy=False):
    if isinstance(obj, _TensorPayload):
        t = obj.restore()
        return t.numpy() if return_numpy else t
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle `obj` (tensors as payloads) to `path` or a file object."""
    if hasattr(path, "write"):
        pickle.dump(_pack(obj), path, protocol=protocol)
        return
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, **configs):
    """What `save` wrote; `return_numpy=True` gives numpy arrays."""
    return_numpy = configs.get("return_numpy", False)
    if hasattr(path, "read"):
        return _unpack(pickle.load(path), return_numpy)
    with open(path, "rb") as f:
        return _unpack(pickle.load(f), return_numpy)
