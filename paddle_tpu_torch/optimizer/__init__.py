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
norms, as `_global_norm_clip` computes it. A parameter cut over the mp
group (its `_mp_shard`, distributed/fleet/layers.py), over the fsdp
group (its `_fsdp_shard`, distributed/sharding.py) or over both holds a
piece of its gradient: the squares of such pieces are summed over every
group the parameter is cut over (`shard_groups`; one all-reduce a
group) and those of replicated gradients, whole on every rank, are
counted once, so every rank clips by the whole model's norm;
`ClipGradByNorm` takes a cut tensor's norm over its groups the same way.
A pipeline stage's optimizer holds its stage's parameters only
(`split_over`): the global norm adds the other stages' squares over the
pp group, a tied embedding's second copy left out.
The update runs on each rank's pieces. `step(apply=...)` takes a 0-d
bool tensor: where it is False the update is suppressed and parameters,
moments and beta powers keep their values bit for bit, decided on the
device (select, don't branch), so the step waits for nothing.

Offload (`park_state()`, which the Trainer calls for
`TrainStepConfig.offload_opt_state` on the card): moment1, moment2 and
any master live in pinned host memory between steps. Each update runs
over chunks of the parameters (`PARK_CHUNK_BYTES` of parked state
each): a chunk's state is copied to the device, updated there by the
same arithmetic, and copied back, so the device holds one chunk's state
at a time. The copies are queued on the current stream; `sync_state()`
waits for the last one before the host reads the state (checkpoints).
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                                      ClipGradByValue)
from paddle_tpu_torch.optimizer import lr
from paddle_tpu_torch.optimizer.lr import LRScheduler

__all__ = ["Adam", "AdamW", "lr", "LRScheduler", "global_grad_norm",
           "shard_groups", "PARK_CHUNK_BYTES"]

# parked state (moments and masters) copied to the device at a time
PARK_CHUNK_BYTES = 1 << 29
_PARKED = ("moment1", "moment2", "master")


def shard_groups(params):
    """Each parameter's groups it is cut over, in cut order: () for a
    replicated one, (mp,) (fsdp,) or (mp, fsdp)."""
    out = []
    for p in params:
        cuts = (getattr(p, "_mp_shard", None), getattr(p, "_fsdp_shard", None))
        out.append(tuple(c.group for c in cuts
                         if c is not None and c.dim is not None))
    return out


def _as_groups(g):
    """A tensor's groups: None (replicated), one group or a tuple."""
    return () if g is None else g if isinstance(g, tuple) else (g,)


def _group_sums(sq, groups):
    """(indices of the replicated tensors, {groups' ids: (indices, their
    squares all-reduced over each of those groups)}) from per-tensor
    squares `sq`; `groups[i]` is None, a group or a tuple of groups."""
    from paddle_tpu_torch.distributed import collective
    rep, by_groups = [], {}
    for i, g in enumerate(groups):
        gs = _as_groups(g)
        if not gs:
            rep.append(i)
            continue
        by_groups.setdefault(tuple(id(x) for x in gs), (gs, []))[1].append(i)
    sums = {}
    for key, (gs, idx) in by_groups.items():
        part = sq[idx].clone()
        for g in gs:
            collective.all_reduce(part, group=g)
        sums[key] = (idx, part)
    return rep, sums


def global_grad_norm(grads, groups=None, across=None, counted=None):
    """sqrt(sum of squares) over every entry of the f32 tensors `grads`:
    a 0-d tensor on their device (NaN or Inf when any entry is). With
    `groups` (`shard_groups` of their parameters: a tuple of groups, or
    one group, or None, a tensor), a cut tensor's squares are summed over
    its groups and a replicated one's counted once. `across`: a group
    whose ranks hold the model's other tensors (a pipeline's stages):
    the total is summed over it too; `counted` (a bool a tensor): False
    leaves a tensor out (a copy another rank of `across` counts)."""
    norms = torch.stack(torch._foreach_norm(grads))
    cut = groups is not None and any(_as_groups(g) for g in groups)
    if across is None and counted is None and not cut:
        return torch.linalg.vector_norm(norms)
    sq = norms * norms
    if counted is not None:
        sq = torch.where(torch.tensor(counted, device=sq.device), sq,
                         torch.zeros_like(sq))
    if cut:
        rep, sums = _group_sums(sq, groups)
        total = sq[rep].sum()
        for _, part in sums.values():
            total = total + part.sum()
    else:
        total = sq.sum()
    if across is not None:
        from paddle_tpu_torch.distributed import collective
        total = collective.all_reduce(total.reshape(1), group=across)[0]
    return torch.sqrt(total)


def _tensor_norms(grads, groups):
    """Each tensor's own norm, a cut one's over its groups."""
    norms = torch.stack(torch._foreach_norm(grads))
    _, sums = _group_sums(norms * norms, groups)
    for idx, part in sums.values():
        norms[idx] = torch.sqrt(part)
    return list(norms)


def _clip(policy, grads, groups=None, across=None, counted=None):
    """The f32 gradients `grads` after the clip `policy` (None: as
    they are); `groups`: their parameters' `shard_groups`; `across` and
    `counted`: the global norm's (`global_grad_norm`)."""
    if policy is None:
        return grads
    if isinstance(policy, ClipGradByGlobalNorm):
        scale = torch.clamp(policy.clip_norm / torch.clamp(
            global_grad_norm(grads, groups, across, counted), min=1e-12),
            max=1.0)
        return torch._foreach_mul(grads, scale)
    if isinstance(policy, ClipGradByNorm):
        if groups is not None and any(_as_groups(g) for g in groups):
            return [g * torch.clamp(policy.clip_norm / torch.clamp(
                nrm, min=1e-12), max=1.0)
                for g, nrm in zip(grads, _tensor_norms(grads, groups))]
        return [g * torch.clamp(policy.clip_norm / torch.clamp(
            torch.linalg.vector_norm(g), min=1e-12), max=1.0) for g in grads]
    if isinstance(policy, ClipGradByValue):
        return [torch.clamp(g, policy.min, policy.max) for g in grads]
    raise TypeError(f"grad_clip must be a ClipGradBy* policy (got "
                    f"{type(policy).__name__})")


def _park(st):
    """A state's moments and master moved to pinned host memory."""
    for k in _PARKED:
        if k in st and not st[k].is_pinned():
            st[k] = st[k].to("cpu").pin_memory()


def _chunks(states):
    """[lo, hi) runs of `states` holding at most PARK_CHUNK_BYTES of
    parked state each (a larger one alone)."""
    out, lo, size = [], 0, 0
    for i, st in enumerate(states):
        nbytes = sum(st[k].numel() * 4 for k in _PARKED if k in st)
        if i > lo and size + nbytes > PARK_CHUNK_BYTES:
            out.append((lo, i))
            lo, size = i, 0
        size += nbytes
    out.append((lo, len(states)))
    return out


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
        self._parked = False     # park_state(): moments in pinned host memory
        self._parked_done = None     # the last update's copies back
        self._across = None      # split_over(): the other parts' group
        self._uncounted = set()  # ids of parameters the norm leaves out

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
            if self._parked:
                _park(st)
            self.state[name] = st
        return st

    def split_over(self, group, uncounted=()):
        """The parameters are this rank's part of a model whose other
        parts live on the other ranks of `group` (a pipeline's stages,
        parallel/pipeline.py): ClipGradByGlobalNorm's norm adds their
        squares, and the parameters in `uncounted` (copies another rank
        of `group` counts: a tied embedding's last stage) add none."""
        self._across = group
        self._uncounted = {id(p) for p in uncounted}

    def _span(self, params):
        """(`across`, `counted`) of `global_grad_norm` for `params`
        (`split_over`): (None, None) for a whole model."""
        counted = ([id(p) not in self._uncounted for p in params]
                   if self._uncounted else None)
        return self._across, counted

    def park_state(self):
        """Keep moment1, moment2 and any master in pinned host memory
        between steps (module docstring); state made before moves now."""
        self._parked = True
        for st in self.state.values():
            _park(st)

    def sync_state(self):
        """Wait for the parked state's copies back to the host."""
        if self._parked_done is not None:
            self._parked_done.synchronize()
            self._parked_done = None

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
        lr = self._lr_value() if learning_rate is None \
            else float(learning_rate)
        g = _clip(self._grad_clip, [p.grad.float() for p in params],
                  shard_groups(params), *self._span(params))
        if not self._parked:
            self._gated_update(work, states, params, lr, g, apply)
            return
        for lo, hi in _chunks(states):
            dev = [{k: v.to(p.device, non_blocking=True) if k in _PARKED
                    else v for k, v in st.items()}
                   for st, p in zip(states[lo:hi], params[lo:hi])]
            self._gated_update(work[lo:hi], dev, params[lo:hi], lr,
                               g[lo:hi], apply)
            for st, d in zip(states[lo:hi], dev):
                for k in _PARKED:
                    if k in st:
                        st[k].copy_(d[k], non_blocking=True)
        self._parked_done = torch.cuda.Event()
        self._parked_done.record()

    def _gated_update(self, work, states, params, lr, g, apply):
        if apply is not None:
            # a snapshot of everything the update writes, selected back
            # where `apply` is False
            kept = list(params) + [st[k] for st in states for k in
                                   ("moment1", "moment2", "beta1_pow",
                                    "beta2_pow", "master") if k in st]
            old = [t.clone() for t in kept]
        self._update(work, states, params, lr, g)
        if apply is not None:
            for t, o in zip(kept, old):
                t.copy_(torch.where(apply, t, o))

    def _update(self, work, states, params, lr, g):
        masters = [st.get("master") for st in states]
        pf = [p.float() if m is None else m for p, m in zip(params, masters)]
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
