"""Adam and AdamW with the JAX package's update rule.

Counterpart of paddle_tpu/optimizer/__init__.py (`Adam._rule`, the
decoupled `AdamW`). Per parameter: f32 moments and f32 beta powers;
with `multi_precision`, an f32 master copy of each low-precision
parameter, which the update runs on and the parameter is rounded from.

    g     = grad (f32) [+ wd * p for Adam's L2 decay]
    m1    = b1 * m1 + (1 - b1) * g
    m2    = b2 * m2 + (1 - b2) * g * g
    upd   = (m1 / (1 - b1^t)) / (sqrt(m2 / (1 - b2^t)) + eps)
            [+ wd * p for AdamW's decoupled decay]
    p     = p - lr * upd

The rule runs on lists of tensors through `torch._foreach_*`, one
multi-tensor launch per operation over all parameters, and updates the
parameters and the state in place (JAX returns new arrays; in place
keeps one copy of each on the card).

`learning_rate` is a float or an `lr.LRScheduler`, read at each update
(`_lr_value`, `get_lr`, `set_lr`, as `paddle_tpu.optimizer.Optimizer`).
`grad_clip` (nn/clip.py) clips the f32 gradients before the rule, on the
device: the global norm is sqrt of the sum of the squared per-tensor
norms, as `_global_norm_clip` computes it. `step(apply=...)` takes a 0-d
bool tensor: where it is False the update is suppressed and parameters,
moments and beta powers keep their values bit for bit, decided on the
device (select, don't branch), so the step waits for nothing.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                                      ClipGradByValue)
from paddle_tpu_torch.optimizer import lr
from paddle_tpu_torch.optimizer.lr import LRScheduler

__all__ = ["Adam", "AdamW", "lr", "LRScheduler", "global_grad_norm"]


def global_grad_norm(grads):
    """sqrt(sum of squares) over every entry of the f32 tensors `grads`:
    a 0-d tensor on their device (NaN or Inf when any entry is)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def _clip(policy, grads):
    """The f32 gradients `grads` after the clip `policy` (None: as
    they are)."""
    if policy is None:
        return grads
    if isinstance(policy, ClipGradByGlobalNorm):
        scale = torch.clamp(policy.clip_norm / torch.clamp(
            global_grad_norm(grads), min=1e-12), max=1.0)
        return torch._foreach_mul(grads, scale)
    if isinstance(policy, ClipGradByNorm):
        return [g * torch.clamp(policy.clip_norm / torch.clamp(
            torch.linalg.vector_norm(g), min=1e-12), max=1.0) for g in grads]
    if isinstance(policy, ClipGradByValue):
        return [torch.clamp(g, policy.min, policy.max) for g in grads]
    raise TypeError(f"grad_clip must be a ClipGradBy* policy (got "
                    f"{type(policy).__name__})")


class Adam:
    """`parameters`: (name, tensor) pairs such as
    `model.named_parameters()`; the names key the state and are what
    `apply_decay_param_fun` sees. `weight_decay` is L2 decay added to the
    gradient."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False):
        if parameters is None:
            raise ValueError("the optimizer needs an explicit parameter "
                             "list")
        items = list(parameters)
        self._names = [n for n, _ in items]
        self._params = [p for _, p in items]
        self._learning_rate = (learning_rate
                               if isinstance(learning_rate, LRScheduler)
                               else float(learning_rate))
        self._grad_clip = grad_clip
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._eps = float(epsilon)
        self._weight_decay = float(weight_decay or 0.0)
        self._multi_precision = multi_precision
        self._apply_decay_fun = None
        self.state = {}          # name -> {moment1, moment2, beta*_pow, master}

    def _decoupled(self):
        return False

    def _lr_value(self):
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return self._learning_rate

    def get_lr(self):
        return self._lr_value()

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("optimizer's learning rate is a scheduler; "
                               "call scheduler.step() instead")
        self._learning_rate = float(value)

    def _wd_for(self, name):
        fn = self._apply_decay_fun
        if fn is not None and not fn(name):
            return 0.0
        return self._weight_decay

    def _state_for(self, name, p):
        st = self.state.get(name)
        if st is None:
            f32 = dict(dtype=torch.float32, device=p.device)
            st = {"moment1": torch.zeros(p.shape, **f32),
                  "moment2": torch.zeros(p.shape, **f32),
                  "beta1_pow": torch.ones((), **f32),
                  "beta2_pow": torch.ones((), **f32)}
            if self._multi_precision and p.dtype != torch.float32:
                st["master"] = p.detach().float()
            self.state[name] = st
        return st

    def zero_grad(self):
        for p in self._params:
            p.grad = None

    @torch.no_grad()
    def step(self, learning_rate=None, apply=None):
        """One update of every parameter that has a gradient, at
        `learning_rate` (default: the current rate). `apply`: a 0-d bool
        tensor on the parameters' device; where it is False nothing
        changes (the update runs, and its results are discarded by a
        select on the device)."""
        work = [(n, p) for n, p in zip(self._names, self._params)
                if p.grad is not None]
        if not work:
            return
        states = [self._state_for(n, p) for n, p in work]
        params = [p for _, p in work]
        if apply is not None:
            # a snapshot of everything the update writes, selected back
            # where `apply` is False
            kept = list(params) + [st[k] for st in states for k in
                                   ("moment1", "moment2", "beta1_pow",
                                    "beta2_pow", "master") if k in st]
            old = [t.clone() for t in kept]
        self._update(work, states, params, self._lr_value()
                     if learning_rate is None else float(learning_rate))
        if apply is not None:
            for t, o in zip(kept, old):
                t.copy_(torch.where(apply, t, o))

    def _update(self, work, states, params, lr):
        masters = [st.get("master") for st in states]
        pf = [p.float() if m is None else m for p, m in zip(params, masters)]
        g = _clip(self._grad_clip, [p.grad.float() for p in params])
        wds = [self._wd_for(n) for n, _ in work]
        b1, b2 = self._beta1, self._beta2
        if not self._decoupled() and any(wds):
            g = [gi + wd * pi if wd else gi for gi, wd, pi in zip(g, wds, pf)]
        b1p = [st["beta1_pow"] for st in states]
        b2p = [st["beta2_pow"] for st in states]
        torch._foreach_mul_(b1p, b1)
        torch._foreach_mul_(b2p, b2)
        m1 = [st["moment1"] for st in states]
        m2 = [st["moment2"] for st in states]
        torch._foreach_mul_(m1, b1)
        torch._foreach_add_(m1, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(m2, b2)
        torch._foreach_add_(m2, torch._foreach_mul(
            torch._foreach_mul(g, 1 - b2), g))
        del g
        # 1 - b^t as -(b^t - 1): the same rounding, in place on a copy
        den1 = torch._foreach_sub(b1p, 1.0)
        torch._foreach_neg_(den1)
        den2 = torch._foreach_sub(b2p, 1.0)
        torch._foreach_neg_(den2)
        upd = torch._foreach_div(m1, den1)               # m1_hat
        m2_hat = torch._foreach_div(m2, den2)
        torch._foreach_sqrt_(m2_hat)
        torch._foreach_add_(m2_hat, self._eps)
        torch._foreach_div_(upd, m2_hat)
        del m2_hat
        if self._decoupled():
            for u, wd, pi in zip(upd, wds, pf):
                if wd:
                    u.add_(pi * wd)
        torch._foreach_mul_(upd, lr)
        for p, m, pi, u in zip(params, masters, pf, upd):
            if m is not None:
                m.sub_(u)
                p.copy_(m)
            elif pi is p:
                p.sub_(u)
            else:
                p.copy_(pi - u)


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01);
    `apply_decay_param_fun(name)` returning False exempts a parameter."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision)
        self._apply_decay_fun = apply_decay_param_fun

    def _decoupled(self):
        return True
