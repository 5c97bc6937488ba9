"""Weight-only int8 (W8A16) execution for serving.

Counterpart of the weight-only part of paddle_tpu/quantization/__init__.py:
the JAX package gets there by `PTQ(QuantConfig(activation=None,
weight=AbsMaxChannelWiseWeightObserver())).quantize(model)`, one
calibration forward and `convert(execute="weight_only_int8")`; here
`quantize_weight_only(model)` gives the same layers in one call, since a
weight observer needs no calibration data. Every `torch.nn.Linear` (the
projections and the lm_head; the embedding is not a Linear) becomes a
`QuantizedLinear` holding `qweight` (K, N) int8 in the JAX package's
(in, out) layout and `w_scale` (N,) f32, the per-out-channel absmax, with
the codes on the JAX package's grid (`_round_clip_i8`), so both packages
hold bit-identical weights. Its forward is the W8A16 kernel
(kernels/quant_matmul.py) on the card and the kernel's plain twin on the
CPU; there is no dequantize-then-matmul fallback.

W8A8 (`mode="int8"`), the QAT observers and int8 convolution carry no
TPU kernel and are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.kernels.quant_matmul import weight_only_int8_matmul

__all__ = ["QuantizedLinear", "quantize_weight_only"]

_BND = 127.0          # the symmetric int8 grid: codes in [-127, 127]


def _round_clip_i8(x, scale, bnd):
    """x (float) -> int8 codes on the JAX package's grid: round half to
    even of x / max(scale, 1e-9) * bnd, clipped to +-bnd, in that
    expression order so the codes agree bit for bit."""
    s = scale.clamp_min(1e-9)
    return torch.clamp(torch.round(x / s * bnd), -bnd, bnd).to(torch.int8)


def _weight_only_matmul(x, qw, eff_scale):
    """W8A16 matmul, out in x's type: the kernel on the card (every
    shape it takes; no fallback), its twin on the CPU."""
    return weight_only_int8_matmul(x, qw, eff_scale, out_dtype=x.dtype)


class QuantizedLinear(nn.Module):
    """A Linear with int8 weights, executed as W8A16 (JAX
    `QuantizedLinear(mode="weight_only_int8")`): `qweight` (K, N) int8,
    `w_scale` (N,) f32 per out channel, an optional bias; the forward is
    `x @ qweight * (w_scale / 127) + bias` through the kernel.
    Inference only: no gradient flows."""

    def __init__(self, qweight, w_scale, bias=None):
        super().__init__()
        self.register_buffer("qweight", qweight)
        self.register_buffer("w_scale", w_scale)
        self.bias = None if bias is None else nn.Parameter(
            bias.detach(), requires_grad=False)
        # the kernel's per-column scale, w_scale / 127 (JAX divides at
        # every call; here once, and again whenever w_scale is loaded)
        self.register_buffer("eff_scale", w_scale / _BND, persistent=False)

    @classmethod
    def from_linear(cls, layer: nn.Linear):
        """Quantize `layer`'s weight per out channel on the absmax scale
        (JAX `AbsMaxChannelWiseWeightObserverLayer`, quant_axis 1 of the
        (in, out) weight) and the `_QuantizedExec._init_quant` grid."""
        w = layer.weight.detach()                     # (N, K): torch layout
        w_scale = w.abs().amax(dim=1).float()         # (N,)
        qweight = _round_clip_i8(w.t().float(), w_scale[None, :], _BND)
        return cls(qweight.contiguous(), w_scale, layer.bias)

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self.eff_scale = self.w_scale / _BND

    def forward(self, x):
        out = _weight_only_matmul(x, self.qweight, self.eff_scale)
        return out if self.bias is None else out + self.bias.to(out.dtype)

    def extra_repr(self):
        k, n = self.qweight.shape
        return f"in_features={k}, out_features={n}, weight_only_int8"


@torch.no_grad()
def quantize_weight_only(model):
    """Replace every `torch.nn.Linear` in `model` by a `QuantizedLinear`
    on the same device, in place, and return the model. Each float
    weight is dropped as soon as its layer is converted, so the model
    never holds more than one float Linear beyond its int8 copy."""
    parents = [m for m in model.modules() if type(m) is not nn.Linear]
    for parent in parents:
        names = [n for n, c in parent.named_children()
                 if type(c) is nn.Linear]
        for name in names:
            setattr(parent, name,
                    QuantizedLinear.from_linear(getattr(parent, name)))
    return model
