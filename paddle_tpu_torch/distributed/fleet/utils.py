"""fleet.utils: recompute and recompute_sequential.

Counterpart of paddle_tpu/distributed/fleet/utils.py (reference:
python/paddle/distributed/fleet/utils/__init__.py), over the port's
distributed/recompute.py and `torch.nn.Sequential`.
"""
from __future__ import annotations

from torch import nn

from paddle_tpu_torch.distributed.recompute import recompute

__all__ = ["recompute", "recompute_sequential"]


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Run the layers of `functions` (a Sequential or any iterable of
    modules) in `ctx["segments"]` segments, each recomputed in the
    backward; each segment is a Sequential, so recompute sees its
    parameters and their gradients flow."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    seg_size = max(len(layers) // max(segments, 1), 1)
    x = args[0] if len(args) == 1 else args
    for i in range(0, len(layers), seg_size):
        x = recompute(nn.Sequential(*layers[i:i + seg_size]), x)
    return x
