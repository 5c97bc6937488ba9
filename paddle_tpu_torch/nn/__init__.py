"""paddle_tpu_torch.nn: the plain ops (`functional`) and the gradient
clipping policies (`clip`)."""
from paddle_tpu_torch.nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                                      ClipGradByValue)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"]
