"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu` is the reference; this package is held
against it module by module and never imports it (nor jax). Module names
follow the JAX package so each counterpart is easy to find:

- `core.device`: the device rule every entry point follows;
- `kernels`: hand-written CUDA kernels for Hopper (sm_90a), each beside a
  plain PyTorch twin that the CPU takes;
- `nn.functional`: the plain ops the Llama model needs;
- `models.llama` / `models.convert`: the Llama family and weight
  conversion from a paddle_tpu state dict;
- `inference.paged`: the continuous-batching paged-KV serving engine.

Entry points (`LlamaForCausalLM(...)`, `PagedKVEngine(...)`) run on the
CUDA card unless the caller passes `device="cpu"`; without a card they
raise instead of falling back to the CPU.
"""
from paddle_tpu_torch.core.device import is_hopper, on_cuda, resolve_device

__all__ = ["resolve_device", "on_cuda", "is_hopper"]
