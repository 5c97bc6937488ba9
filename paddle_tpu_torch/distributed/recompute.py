"""Activation recomputation (gradient checkpointing).

Counterpart of paddle_tpu/distributed/recompute.py: run a layer without
keeping its inner activations and run its forward again in the backward,
over `torch.utils.checkpoint.checkpoint(use_reentrant=False)`.

A layer's parameters join the checkpointed inputs, as in the JAX
package: the call reads the layer's parameters as they are when it is
made (a caller's `torch.func.functional_call` may have swapped in cast
copies) and the recomputation in the backward runs on those same
tensors, whatever the module holds by then. The kernels'
`autograd.Function`s run again inside the recomputation.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["recompute"]


def recompute(layer, *args, **kwargs):
    """`layer(*args, **kwargs)` (an `nn.Module`) with its internal
    activations recomputed in the backward instead of kept; its
    parameters become inputs of the checkpoint."""
    named = list(layer.named_parameters())
    names = [name for name, _ in named]
    params = [p for _, p in named]
    n = len(params)

    def run(*flat, **kw):
        state = dict(zip(names, flat[:n]))
        return torch.func.functional_call(layer, state, flat[n:], kw)

    return checkpoint(run, *params, *args, use_reentrant=False, **kwargs)
