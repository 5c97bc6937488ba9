"""The device rule for every entry point of the port.

Entry points default to the CUDA card. A caller who wants the CPU says
so with `device="cpu"`; asking for CUDA on a machine without a card is
an error, never a quiet fall back to the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "on_cuda", "is_hopper"]


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; raises RuntimeError when it names
    CUDA and no CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def on_cuda() -> bool:
    return torch.cuda.is_available()


def is_hopper(device=None) -> bool:
    """True when the (current) CUDA device has compute capability 9.0,
    the target the kernels are built for (sm_90a)."""
    if not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(device) == (9, 0)
