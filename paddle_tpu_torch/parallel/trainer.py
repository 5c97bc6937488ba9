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
- The learning rate of each update is `optimizer._lr_value() *
  lr_scale` (`set_lr_scale`); a schedule is stepped by its owner.
- `skip_nonfinite_grads`: an update whose loss or any gradient is Inf or
  NaN is suppressed on the device (select, don't branch): parameters,
  moments and beta powers stay bit-identical. The skip flags are read on
  the host every `nonfinite_check_every` steps, and
  `max_consecutive_nonfinite` skips in a row raise `NonFiniteGradError`.
- `health_probe`: the same suppression for a non-finite update or a loss
  above the cap (`set_loss_cap`), and `last_probe` = [global gradient
  norm, applied], a lazy 0-d pair on the device; the step adds no host
  sync.
- `data_iter(loader, depth)` prefetches batches onto the device
  (io/prefetch.py); `step` moves nothing that is already there.
- `measure_phase_seconds(batch, iters)` times forward, backward and the
  optimizer apart.

Making the model trainable (every parameter requires a gradient,
training mode) is the Trainer's job: a model built for serving carries
no autograd graph. Meshes and sharding, optimizer offload, checkpoints
and the FSDP overlap columns of the phase timing are not ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import torch

from paddle_tpu_torch.optimizer import global_grad_norm

__all__ = ["TrainStepConfig", "Trainer", "NonFiniteGradError"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class TrainStepConfig:
    compute_dtype: Any = "bfloat16"   # forward/backward type; None = as-is
    grad_accum_steps: int = 1         # microbatches per step
    # suppress an update whose loss or gradients hold Inf / NaN
    skip_nonfinite_grads: bool = False
    # consecutive skipped steps before the trainer raises
    max_consecutive_nonfinite: int = 25
    # skip flags buffered before the host reads them (each read syncs)
    nonfinite_check_every: int = 1
    # last_probe = [global grad norm, applied]; suppresses non-finite
    # updates and those whose loss exceeds the cap (subsumes the skip)
    health_probe: bool = False


class NonFiniteGradError(RuntimeError):
    """max_consecutive_nonfinite steps in a row produced Inf/NaN
    gradients: the run has diverged."""


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
        if self.config.health_probe and self.config.skip_nonfinite_grads:
            raise ValueError(
                "TrainStepConfig.health_probe subsumes skip_nonfinite_grads "
                "(the probe suppresses non-finite updates too); enable "
                "only one")
        self._lr_scale = 1.0
        self._loss_cap = float("inf")
        self.last_probe = None
        self._pending_skips = []
        self.nonfinite_streak = 0
        self.nonfinite_skipped = 0
        model.requires_grad_(True)
        model.train()

    @property
    def device(self):
        return next(self.model.parameters()).device

    def _loss(self, batch):
        if self._dtype is None:
            out = self.model(**batch)
        else:
            params = {n: (p.to(self._dtype) if p.is_floating_point() else p)
                      for n, p in self.model.named_parameters()}
            out = torch.func.functional_call(self.model, params, (), batch)
        loss = out[0] if isinstance(out, (tuple, list)) else out
        return loss.float()

    def _place(self, batch):
        """The batch's leaves as tensors on the model's device; a leaf
        already there (a `data_iter` batch) is used as it is."""
        dev = self.device
        return {k: v if isinstance(v, torch.Tensor) and v.device == dev
                else torch.as_tensor(v).to(dev) for k, v in batch.items()}

    def _forward_backward(self, batch, backward=True):
        """The mean loss over the microbatches, and, with `backward`,
        their mean gradients in the parameters' `.grad`."""
        n_mb = self.config.grad_accum_steps
        if n_mb == 1:
            loss = self._loss(batch)
            if backward:
                loss.backward()
            return loss.detach()
        size = next(iter(batch.values())).shape[0]
        if size % n_mb:
            raise ValueError(f"batch {size} does not split into {n_mb} "
                             "microbatches")
        mbs = {k: torch.chunk(v, n_mb, dim=0) for k, v in batch.items()}
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(n_mb):
            mb_loss = self._loss({k: v[i] for k, v in mbs.items()})
            if backward:
                mb_loss.backward()
            loss = loss + mb_loss.detach()
        if backward:
            with torch.no_grad():
                for p in self.model.parameters():
                    if p.grad is not None:
                        p.grad.div_(n_mb)
        return loss / n_mb

    def step(self, batch: dict) -> torch.Tensor:
        """One optimizer step on `batch` ({name: tensor or array}, moved to
        the model's device unless it is there); returns the mean f32 loss
        (0-d tensor)."""
        batch = self._place(batch)
        self.optimizer.zero_grad()
        loss = self._forward_backward(batch)
        self._apply_update(loss)
        return loss

    def _apply_update(self, loss):
        """The optimizer update; with skip_nonfinite_grads or health_probe
        suppressed on the device when the step is unhealthy (JAX
        `_apply_update`)."""
        cfg = self.config
        lr = self._lr_value()
        if not (cfg.health_probe or cfg.skip_nonfinite_grads):
            self.optimizer.step(lr)
            return
        grads = [p.grad.float() for p in self.model.parameters()
                 if p.grad is not None]
        if cfg.health_probe:
            # one reduction: the norm carries any NaN / Inf, so it is both
            # the all-finite check and the probe's gradient norm
            gnorm = global_grad_norm(grads)
            healthy = (torch.isfinite(loss) & torch.isfinite(gnorm)
                       & (loss <= self._loss_cap))
            self.optimizer.step(lr, apply=healthy)
            self.last_probe = torch.stack([gnorm, healthy.float()])
            return
        finite = torch.isfinite(loss) & torch.stack(
            [torch.isfinite(g).all() for g in grads]).all()
        self.optimizer.step(lr, apply=finite)
        self._note_skip(~finite)

    def _note_skip(self, flag):
        """Count consecutive non-finite skips without a per-step host
        sync: flags buffer until nonfinite_check_every of them pend, then
        one read drains them; reaching max_consecutive_nonfinite raises
        NonFiniteGradError."""
        self._pending_skips.append(flag)
        if len(self._pending_skips) < max(
                1, self.config.nonfinite_check_every):
            return
        pending, self._pending_skips = self._pending_skips, []
        for f in pending:
            if bool(f):
                self.nonfinite_streak += 1
                self.nonfinite_skipped += 1
            else:
                self.nonfinite_streak = 0
        if self.nonfinite_streak >= self.config.max_consecutive_nonfinite:
            raise NonFiniteGradError(
                f"{self.nonfinite_streak} consecutive steps produced "
                f"non-finite gradients (limit "
                f"{self.config.max_consecutive_nonfinite}); aborting")

    def _lr_value(self):
        return self.optimizer._lr_value() * self._lr_scale

    def set_lr_scale(self, scale):
        """Transient multiplier on the schedule's rate (1.0 = none)."""
        self._lr_scale = float(scale)

    def set_loss_cap(self, cap):
        """health_probe only: an update whose loss exceeds `cap` is
        suppressed on the device and the probe reports applied = 0;
        +inf disarms."""
        self._loss_cap = float(cap)

    def data_iter(self, loader, depth=2):
        """Batches of `loader` (any iterator of {name: array or tensor})
        prefetched onto the model's device by a background thread,
        `depth` ahead, the copies overlapping the steps:

            for batch in trainer.data_iter(loader):
                loss = trainer.step(batch)

        Returns a DevicePrefetcher (io/prefetch.py), a context manager
        with close()."""
        from paddle_tpu_torch.io.prefetch import DevicePrefetcher
        return DevicePrefetcher(loader, device=self.device, depth=depth)

    def measure_phase_seconds(self, batch: dict, iters: int = 2):
        """Where a step's time goes, as the JAX Trainer attributes it:

            fwd       = t(loss)
            bwd       = t(loss and gradients) - t(loss)
            optimizer = t(full step)          - t(loss and gradients)

        each a mean over `iters` runs after one warm-up, synchronised on
        the card. Returns {"fwd", "bwd", "optimizer", "step"} seconds. The
        full-step timing drives `iters + 1` real optimizer steps."""
        batch = self._place(batch)
        dev = self.device

        def timed(run):
            run()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(max(1, iters)):
                run()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return (time.perf_counter() - t0) / max(1, iters)

        def fwd():
            with torch.no_grad():
                self._forward_backward(batch, backward=False)

        def fwd_bwd():
            self.optimizer.zero_grad()
            self._forward_backward(batch)

        t_fwd = timed(fwd)
        t_fwd_bwd = timed(fwd_bwd)
        self.optimizer.zero_grad()
        t_step = timed(lambda: self.step(batch))
        return {"fwd": t_fwd, "bwd": max(0.0, t_fwd_bwd - t_fwd),
                "optimizer": max(0.0, t_step - t_fwd_bwd), "step": t_step}
