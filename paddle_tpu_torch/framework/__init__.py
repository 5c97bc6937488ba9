"""Framework helpers: `save` / `load` (io_utils.py)."""
from paddle_tpu_torch.framework.io_utils import load, save  # noqa: F401

__all__ = ["save", "load"]
