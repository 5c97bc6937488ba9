"""Per-step training telemetry: tokens/sec, MFU, loss, skips.

Counterpart of paddle_tpu/observability/telemetry.py. `TrainingTelemetry`
turns (tokens, step wall time) into tokens/sec and an MFU estimate from
the same flops-per-token helper the port's models carry
(models/llama.py `flops_per_token`, with the 8/6 recompute replay
factor) over the card's peak from `PEAK_FLOPS`, publishing into the
port's metrics registry under the JAX module's names.
`parallel/trainer.py` drives it when observability is enabled; the cost
when disabled is one attribute check in `Trainer.step`.

Two measurement caveats, as in the JAX module:
  - step time is the interval between consecutive `step()` dispatches
    (`time.perf_counter()`). An eager step enqueues thousands of
    launches, more than CUDA's launch queue holds, so the host waits in
    the queue and in steady state the interval is the device's step
    time (chip_smoke.py phase 18 holds the two within 5 %).
  - the loss gauge lags `loss_lag` steps. A loss on the card is copied
    to pinned host memory when it is handed over, behind an event
    recorded on its stream, and read only once that event has completed:
    reading it adds no stream sync (a `float()` of the device tensor
    would wait for the newest queued step, not the one `loss_lag` steps
    back). `flush()` waits for whatever is still in flight.

The peak table is the card's, not the TPU's: a device kind it does not
know (and the CPU) gets None, and MFU reads 0 there.

Importing this module imports torch and the port's metrics registry
only; model helpers are imported inside functions.
"""
from __future__ import annotations

import collections

import torch

from paddle_tpu_torch.observability import metrics as _metrics

__all__ = ["PEAK_FLOPS", "peak_flops_for_kind", "detect_peak_flops",
           "flops_per_token_for", "TrainingTelemetry"]

# dense bf16 peak FLOP/s per card by device name (NVIDIA's data sheet,
# SXM part, at its 700 W limit)
PEAK_FLOPS = {
    "H100 80GB HBM3": 989e12,      # H100 SXM
}


def peak_flops_for_kind(kind: str):
    """Longest-key-first match of a device name (e.g. "NVIDIA H100
    80GB HBM3") against `PEAK_FLOPS`; None for a kind the table does
    not hold."""
    kind = kind or ""
    for k in sorted(PEAK_FLOPS, key=len, reverse=True):
        if kind.startswith(k) or k in kind:
            return PEAK_FLOPS[k]
    return None


def detect_peak_flops(device=None):
    """Peak FLOP/s of `device` (default: the current CUDA device), or
    None off the card or for an unknown card (MFU reads 0 there)."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else None)
    if dev is None or dev.type != "cuda":
        return None
    return peak_flops_for_kind(torch.cuda.get_device_name(dev))


def flops_per_token_for(model, seq_len: int) -> float:
    """Training FLOPs/token for `model`: models/llama.py
    `flops_per_token` (6N + the attention term) when the model carries a
    Llama config, otherwise 6 x its trainable parameter count; x 8/6
    when the config says recompute (each layer's forward runs twice)."""
    cfg = getattr(model, "config", None)
    ftok = None
    if cfg is not None:
        try:
            from paddle_tpu_torch.models.llama import flops_per_token
            ftok = flops_per_token(cfg, seq_len)
        except (AttributeError, TypeError):
            ftok = None
    if ftok is None:
        n = sum(p.numel() for p in model.parameters() if p.requires_grad)
        ftok = 6.0 * n
    if cfg is not None and getattr(cfg, "recompute", False):
        ftok = ftok * 8.0 / 6.0
    return float(ftok)


class _Staged:
    """A loss on the card on its way to the host: a non-blocking copy
    into pinned memory, ordered on the loss's stream, and the event
    recorded after it."""

    __slots__ = ("host", "event")

    def __init__(self, loss):
        self.host = torch.empty((), dtype=loss.dtype, pin_memory=True)
        self.host.copy_(loss.detach(), non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(loss.device))

    def ready(self):
        return self.event.query()

    def value(self):
        self.event.synchronize()
        return float(self.host)


def _stage(loss):
    if isinstance(loss, torch.Tensor) and loss.is_cuda:
        return _Staged(loss)
    return loss


def _ready(item):
    return item.ready() if isinstance(item, _Staged) else True


class TrainingTelemetry:
    """Per-step reporter publishing into a metrics registry.

    flops_per_token: float, or a callable seq_len -> float (so the
    attention term can track the batch's actual sequence length).
    peak_flops: the card's peak FLOP/s; None disables MFU (reports 0).
    """

    def __init__(self, flops_per_token=None, peak_flops=None,
                 registry=None, loss_lag=8):
        self._fpt = flops_per_token
        self.peak_flops = peak_flops
        self.registry = registry if registry is not None \
            else _metrics.REGISTRY
        self.loss_lag = max(0, int(loss_lag))
        self._loss_buf: collections.deque = collections.deque()
        self.steps = 0
        self.last_tokens_per_sec = 0.0
        self.last_mfu = 0.0
        self.last_loss = None

    @classmethod
    def for_model(cls, model, registry=None, peak_flops=None, **kw):
        """Reporter bound to `model`'s analytic flops-per-token and the
        peak of the card its parameters live on."""
        if peak_flops is None:
            p = next(iter(model.parameters()), None)
            peak_flops = detect_peak_flops(p.device if p is not None
                                           else None)
        return cls(
            flops_per_token=lambda seq: flops_per_token_for(model, seq),
            peak_flops=peak_flops, registry=registry, **kw)

    def flops_per_token(self, seq_len) -> float:
        if callable(self._fpt):
            return float(self._fpt(seq_len))
        return float(self._fpt or 0.0)

    def mfu(self, tokens_per_sec, seq_len) -> float:
        """tokens/sec x FLOPs/token / peak."""
        if not self.peak_flops:
            return 0.0
        return tokens_per_sec * self.flops_per_token(seq_len) \
            / self.peak_flops

    def step(self, tokens, step_time_s, seq_len=None, loss=None,
             grad_norm=None):
        """Report one completed step. `loss` may be a tensor on the card:
        it is staged to the host and published `loss_lag` steps later,
        never blocking the current dispatch."""
        reg = self.registry
        self.steps += 1
        reg.inc("train.steps")
        if step_time_s and step_time_s > 0:
            reg.observe("train.step.seconds", step_time_s)
            tps = tokens / step_time_s
            self.last_tokens_per_sec = tps
            reg.set_gauge("train.tokens_per_sec", tps)
            seq = seq_len if seq_len is not None else tokens
            self.last_mfu = self.mfu(tps, seq)
            reg.set_gauge("train.mfu", self.last_mfu)
        if grad_norm is not None:
            reg.set_gauge("train.grad_norm", float(grad_norm))
        if loss is not None:
            self._loss_buf.append(_stage(loss))
            # a staged loss whose copy has not landed yet stays queued
            # (the lag grows by a step) rather than wait for the card
            while len(self._loss_buf) > self.loss_lag \
                    and _ready(self._loss_buf[0]):
                self._publish_loss(self._loss_buf.popleft())

    def _publish_loss(self, loss):
        try:
            val = loss.value() if isinstance(loss, _Staged) \
                else float(loss)
        except (TypeError, ValueError, RuntimeError):
            return              # non-scalar: drop silently, as JAX does
        self.last_loss = val
        self.registry.set_gauge("train.loss", val)

    def flush(self):
        """Materialize every buffered loss (end of run / snapshot)."""
        while self._loss_buf:
            self._publish_loss(self._loss_buf.popleft())

    def snapshot(self) -> dict:
        self.flush()
        return {"steps": self.steps,
                "tokens_per_sec": round(self.last_tokens_per_sec, 2),
                "mfu": round(self.last_mfu, 4),
                "loss": self.last_loss}
