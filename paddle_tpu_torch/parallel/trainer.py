"""The training step: forward, backward and optimizer update.

Counterpart of paddle_tpu/parallel/trainer.py's single-device path.
`Trainer(model, optimizer, config).step(batch)` runs one optimizer step
on a dict batch (the model's forward keywords, e.g. `input_ids` and
`labels`) and returns the f32 loss as a 0-d tensor on the model's device
without waiting for the device.

- `compute_dtype` ("bfloat16" by default; None = the parameters' own
  type) casts every floating parameter, norm weights included, for the
  forward and backward, as the JAX `_cast_tree` does: the forward runs
  through `torch.func.functional_call` over the cast copies, so the f32
  parameters receive f32 gradients (the cast's backward).
- `grad_accum_steps` splits the batch into that many microbatches along
  dim 0, sums their losses and gradients and divides both by the count,
  as the JAX microbatch loop does.

Making the model trainable (every parameter requires a gradient,
training mode) is the Trainer's job: a model built for serving carries
no autograd graph. Meshes and sharding, optimizer offload, the
non-finite skip, the health probe, checkpoints and the data iterator are
not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

__all__ = ["TrainStepConfig", "Trainer"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class TrainStepConfig:
    compute_dtype: Any = "bfloat16"   # forward/backward type; None = as-is
    grad_accum_steps: int = 1         # microbatches per step


class Trainer:
    def __init__(self, model, optimizer, config: TrainStepConfig | None = None):
        self.model = model
        self.optimizer = optimizer
        self.config = config or TrainStepConfig()
        dt = self.config.compute_dtype
        self._dtype = _DTYPES.get(dt, dt) if isinstance(dt, str) else dt
        if self._dtype not in (None, *_DTYPES.values()):
            raise ValueError(f"compute_dtype must be None, 'bfloat16' or "
                             f"'float32' (got {dt!r})")
        if self.config.grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1")
        model.requires_grad_(True)
        model.train()

    def _loss(self, batch):
        if self._dtype is None:
            out = self.model(**batch)
        else:
            params = {n: (p.to(self._dtype) if p.is_floating_point() else p)
                      for n, p in self.model.named_parameters()}
            out = torch.func.functional_call(self.model, params, (), batch)
        loss = out[0] if isinstance(out, (tuple, list)) else out
        return loss.float()

    def step(self, batch: dict) -> torch.Tensor:
        """One optimizer step on `batch` ({name: tensor or array}, moved to
        the model's device); returns the mean f32 loss (0-d tensor)."""
        dev = next(self.model.parameters()).device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        n_mb = self.config.grad_accum_steps
        self.optimizer.zero_grad()
        if n_mb == 1:
            loss = self._loss(batch)
            loss.backward()
        else:
            size = next(iter(batch.values())).shape[0]
            if size % n_mb:
                raise ValueError(f"batch {size} does not split into "
                                 f"{n_mb} microbatches")
            mbs = {k: torch.chunk(v, n_mb, dim=0) for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n_mb):
                mb_loss = self._loss({k: v[i] for k, v in mbs.items()})
                mb_loss.backward()
                loss = loss + mb_loss.detach()
            loss = loss / n_mb
            with torch.no_grad():
                for p in self.model.parameters():
                    if p.grad is not None:
                        p.grad.div_(n_mb)
        self.optimizer.step()
        return loss.detach()
