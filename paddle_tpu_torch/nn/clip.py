"""Gradient clipping policies (paddle_tpu/nn/__init__.py's classes).

Each is a plain description that an optimizer built with
`grad_clip=` applies to the gradients before its update
(optimizer/__init__.py), on the device, with no host sync:

- `ClipGradByGlobalNorm(clip_norm)`: every gradient times
  min(1, clip_norm / max(global norm, 1e-12)), the global norm taken over
  all of them together;
- `ClipGradByNorm(clip_norm)`: the same per gradient, by its own norm;
- `ClipGradByValue(max, min=-max)`: each entry clamped to [min, max].
"""
from __future__ import annotations

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"]


class ClipGradByNorm:
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm


class ClipGradByValue:
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm
