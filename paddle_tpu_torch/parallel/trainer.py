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
- Observability (`observability.enable()`): each step reports the one
  before it to `telemetry` (observability/telemetry.py: tokens/s, MFU,
  the loss `loss_lag` steps late, read without a stream sync), sets
  `train.loss.logits_bytes_saved` for a blockwise-loss model, and counts
  `train.recompiles{shape=...}` at the first step of a batch signature
  (names, shapes and numpy dtype names) the Trainer has not run before,
  the port's counterpart of a jit retrace; the signatures are kept with
  observability off too. `fleet_heartbeat(store, rank, world_size)`
  publishes them into observability/fleet.py's plane. Disabled, the cost
  is one attribute check.
- Chaos (`distributed.chaos`): with chaos enabled, the sites
  `trainer.grad` and `train.grad.nan` multiply the gradients by NaN and
  `train.loss.spike` the loss and the gradients by 100 when they fire,
  decided at each step (the JAX Trainer decides which sites exist when
  it traces its step). Disabled, the cost is one attribute check.
- Checkpoints: `checkpoint_state()` is {"params": {name: tensor}, "opt":
  {name: {moment1, moment2, beta1_pow, beta2_pow[, master]}}} (every
  trainable parameter's optimizer state, created if no step made it
  yet); `save_checkpoint(path)` writes it through distributed/
  checkpoint.py, or through `checkpointer` (an AsyncCheckpointer: the
  call returns after the host snapshot); `load_checkpoint(path)` fills
  the parameters and the state in place.

- Data parallelism (`mesh=`, a distributed/mesh.py ProcessMesh over the
  world's processes, and `plan=`, a parallel/plan.py ShardingPlan, the
  JAX constructor's): every process passes the same global batch; rank
  r keeps its rows along `batch_spec`'s batch axes, 'dp' and 'fsdp'
  (its index over dp x fsdp, dp major; with grad_accum_steps, its share
  of each microbatch, so the microbatches are the JAX loop's), and
  `data_iter` moves only those rows to the device. The loss and the
  gradients are the mean over the GLOBAL valid tokens (labels other
  than -100 after the next-token shift), as GSPMD computes them: each
  microbatch's local mean loss is weighted by this rank's share of the
  batch group's valid tokens (one small all-reduce of the counts before
  the forward; a slice with none adds 0, even where the model's mean
  over no token is NaN), and the gradients and the loss are summed over
  the batch group once a step (distributed/parallel.py GradReducer),
  after the microbatches, before clipping and the update. The returned
  loss is the global one, and the non-finite flags, the probe and the
  loss cap read global values, so every rank takes the same branch. A
  batch group of one rank (a 'dp' axis of extent 1, as the fleet mesh
  has) runs no collective: no reducer and no all-reduce of the counts
  (each microbatch weighs exactly 1, or 0 without a valid label).
  Telemetry counts this rank's tokens: the global batch over the mesh's
  size, as the JAX Trainer reports.
- FSDP (an 'fsdp' axis of extent > 1, or a model that
  distributed/sharding.py `group_sharded_parallel` cut): `plan` cuts
  the parameters it puts on 'fsdp' through `apply_plan` (after any 'mp'
  cut, on the other dim); each module gathers its pieces for its
  forward and the gradient comes back reduce-scattered, already summed
  over the cut's axis. So a gradient is summed over the batch axes its
  cut did not sum over (`sharding.summed_axes`): a replicated one over
  dp x fsdp, an fsdp-cut one over dp only, one that
  `group_sharded_parallel` cut over 'dp' over nothing more. The update
  runs on the pieces; the clip's and the probe's norms add the pieces'
  squares over every group a parameter is cut over, and the non-finite
  flag is taken over those groups.
- Tensor parallelism (an 'mp' axis of extent > 1 in `mesh`): the
  Trainer cuts the model by `plan` through parallel/plan.py
  `apply_plan` (a model that `fleet.distributed_model` cut already is
  taken as it stands; an mp mesh without either raises ValueError).
  Every rank of an mp group holds its shards and sees the same rows: the
  batch is cut by this rank's dp coordinate only, and gradients are
  summed over the dp group only (the mp ranks' gradients are their
  shards', and whole and equal for replicated parameters). The global
  norms of the clip and the probe add the shards' squares over the mp
  group (optimizer/__init__.py), and the non-finite skip's flag is
  taken over it, so every mp rank takes one branch.
  `checkpoint_state()` gathers each cut tensor (parameters, moments,
  masters) into the whole tensor, over fsdp and then mp, so a
  checkpoint is the one a mesh-free Trainer writes, and
  `load_checkpoint` cuts it back. A mesh without a 'dp' or 'fsdp' axis
  gives every rank the whole batch. An 'ep' axis of extent > 1 raises
  NotImplementedError naming the slice it waits for, and a 'pp' axis
  one naming parallel/pipeline.py's PipelineTrainer, which trains it.
- MoE models (models/qwen2_moe.py): mesh-free and on the batch axes
  'dp' / 'fsdp'; the model's own loss carries the router aux term. On a
  batch group of more than one rank the step runs inside nn/moe.py's
  `batch_group`, so the gates take the aux loss's means and the capacity
  path's capacity and buffer positions over the group's tokens, as the
  JAX package does over the global batch; the model's
  `router_aux_loss()`, then this rank's share of the group's, is left
  out of the token weighting (`_weighed`). A plan that places the
  stacked expert weights on 'mp', 'fsdp' or 'ep', an 'sp' axis, and
  parallel/pipeline.py's PipelineTrainer raise NotImplementedError
  naming the expert-parallel slice (parallel/plan.py `refuse_moe`).
- FSDP overlap (`overlap_fsdp`, `overlap_chunks`; on an 'fsdp' axis of
  extent > 1, else nothing): the forward and the backward run inside
  parallel/overlap.py's `overlap_fsdp_guard`, so each fsdp-cut
  projection of the model is a point-to-point ring that streams the
  weight pieces under its products instead of a gather ahead of them
  (the same math); `measure_phase_seconds` then adds the weight
  collectives' seconds and the overlap fraction.
- Context parallelism (an 'sp' axis of extent > 1, with
  `context_parallel` "ring" or "ulysses"; None raises ValueError, since
  the port's flash kernel refuses the sq != sk attention XLA would run):
  rank r of the sp group keeps tokens [r S/n, (r+1) S/n) of its rows
  (contiguous shards, as the JAX package lays them out). The labels are
  shifted over the whole sequence before the cut (a shard's last
  position scores the next shard's first label) and the model takes
  them with `label_shift=False`; `position_ids` carry the shard's
  global positions; the forward and backward run inside
  distributed/context_parallel.py's guard, so the causal attention
  spans the whole sequence; and 'sp' joins the batch group: the valid
  tokens, the loss and every gradient are summed over dp x fsdp x sp.
- Pipeline parallelism is parallel/pipeline.py's PipelineTrainer, a
  subclass: its optimizer holds one stage (`split_over`), and the
  probe's norm and the non-finite skip's flag span the stages as the
  clip's norm does.
- `offload_opt_state` (or the `_sharding_offload` hint that
  `group_sharded_parallel(offload=True)` leaves on the model): on the
  card, the optimizer's moments and masters live in pinned host memory
  between steps and are copied to the device a chunk at a time for the
  update (optimizer/__init__.py `park_state`). On the CPU, as the JAX
  Trainer off the TPU, it warns (naming `pinned_host`) and turns the flag
  off on the Trainer's private copy of the config.

Making the model trainable (every parameter requires a gradient,
training mode) is the Trainer's job: a model built for serving carries
no autograd graph.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from dataclasses import dataclass
from typing import Any

import torch

from paddle_tpu_torch import observability
from paddle_tpu_torch.distributed import chaos, collective
from paddle_tpu_torch.distributed.sharding import (cut_whole, cuts_of,
                                                   gather_whole, whole_shape)
from paddle_tpu_torch.io.prefetch import DevicePrefetcher
from paddle_tpu_torch.optimizer import global_grad_norm, shard_groups

__all__ = ["TrainStepConfig", "Trainer", "NonFiniteGradError",
           "ContextParallelRequired"]

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
    # keep Adam's moments (and masters) in pinned host memory between
    # steps, copied to the card for the update: frees 8 bytes a
    # parameter of device memory for a host round trip a step
    offload_opt_state: bool = False
    # cut each row's sequence over 'sp' (the port cuts it to run 'sp')
    shard_batch_seq: bool = True
    # the attention over an 'sp' axis: "ring" | "ulysses"
    # (distributed/context_parallel.py)
    context_parallel: str | None = None
    # the fsdp-cut projections as point-to-point rings over 'fsdp' that
    # stream the weight pieces under the products (parallel/overlap.py);
    # overlap_chunks = sub-chunks per resident piece
    overlap_fsdp: bool = False
    overlap_chunks: int = 1


class ContextParallelRequired(ValueError, NotImplementedError):
    """An 'sp' axis of extent > 1 without `context_parallel`: a bad
    configuration, and what the port does not run (the attention XLA
    would run there takes sq != sk)."""


class NonFiniteGradError(RuntimeError):
    """max_consecutive_nonfinite steps in a row produced Inf/NaN
    gradients: the run has diverged."""


class Trainer:
    def __init__(self, model, optimizer, config: TrainStepConfig | None = None,
                 mesh=None, plan=None, checkpointer=None):
        self.model = model
        self.optimizer = optimizer
        # optional distributed.async_checkpoint.AsyncCheckpointer:
        # save_checkpoint() then returns after the host snapshot
        self.checkpointer = checkpointer
        # a private copy: the Trainer turns offload_opt_state on (the
        # model's hint) or off (off the card)
        self.config = dataclasses.replace(config) if config is not None \
            else TrainStepConfig()
        if getattr(model, "_sharding_offload", False):
            self.config.offload_opt_state = True
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
        # step telemetry, built on the first step with observability on
        self._telemetry = None
        self._tel_last_t = None
        self._tel_prev = None
        # batch signatures already run (train.recompiles)
        self._seen_batches = set()
        self.mesh, self.plan = mesh, plan
        self._dp = None if mesh is None else self._parallel(mesh, plan)
        model.requires_grad_(True)
        model.train()
        if self.config.offload_opt_state:
            if self.device.type == "cuda":
                optimizer.park_state()
            else:
                warnings.warn(
                    "offload_opt_state: parking the optimizer state in "
                    "pinned_host memory needs the model on a CUDA device "
                    f"(it is on {self.device.type}); keeping the optimizer "
                    "state where it is")
                self.config.offload_opt_state = False

    def _parallel(self, mesh, plan):
        """{"size", "index": this rank's row group (dp x fsdp) and its
        index in it, "sp": (extent, this rank's coordinate) of an 'sp'
        axis of extent > 1 or None, "group": the batch group, the row
        group times 'sp' (None for one rank), "batch": its axes, "sums":
        [(axes, GradReducer, parameters)], each parameter's gradient
        summed over the batch axes its cut did not sum over} for a mesh
        whose axes of extent > 1 are 'dp', 'fsdp', 'sp' and 'mp'; the
        model cut by `plan`."""
        from paddle_tpu_torch.distributed import sharding
        from paddle_tpu_torch.distributed.fleet.layers import _PARALLEL
        from paddle_tpu_torch.distributed.parallel import GradReducer
        from paddle_tpu_torch.parallel.plan import (WAITS, apply_plan,
                                                    refuse_moe)
        axes = dict(zip(mesh.dim_names, mesh.shape))
        others = {a: n for a, n in axes.items()
                  if a not in ("dp", "fsdp", "sp", "mp") and n > 1}
        if others:
            ax = next(iter(others))
            why = ("the plain Trainer runs no pipeline: a 'pp' axis trains "
                   "through parallel/pipeline.py's PipelineTrainer"
                   if ax == "pp" else
                   f"{ax!r} waits for {WAITS.get(ax, 'a later slice')}")
            raise NotImplementedError(
                f"mesh axes {others}: the port's Trainer runs data, "
                f"sharded-data (FSDP), sequence (context) and tensor "
                f"parallelism; {why}")
        refuse_moe(self.model, mesh, plan)
        sp = axes.get("sp", 1)
        if sp > 1 and self.config.context_parallel not in ("ring",
                                                           "ulysses"):
            raise ContextParallelRequired(
                f"an 'sp' axis of extent {sp} needs the context-parallel "
                f"attention, TrainStepConfig.context_parallel 'ring' or "
                f"'ulysses' (got "
                f"{self.config.context_parallel!r}): the JAX package lets "
                "XLA gather K/V and attend at sq != sk, which the port's "
                "flash kernel refuses (ROADMAP.md queue 2 A item 1)")
        if sp > 1 and not self.config.shard_batch_seq:
            raise ValueError(
                f"an 'sp' axis of extent {sp} with shard_batch_seq=False: "
                "the port runs 'sp' by cutting each row's sequence over it")
        mp = axes.get("mp", 1)
        if plan is not None:
            apply_plan(self.model, mesh, plan)
        if mp > 1 and not any(isinstance(m, _PARALLEL) and m.mp_group
                              is not None for m in self.model.modules()):
            raise ValueError(
                f"an mp axis of extent {mp} needs a plan (or a model cut by "
                "fleet.distributed_model); the port never replicates the "
                "whole model over the mp ranks")
        rows = tuple(a for a in ("dp", "fsdp") if axes.get(a, 1) > 1)
        batch = rows + (("sp",) if sp > 1 else ())
        out = {"size": 1, "index": 0, "group": None, "batch": batch,
               "sp": (sp, mesh.coordinate("sp")) if sp > 1 else None,
               "sums": []}
        if not batch:
            return out
        index = 0
        for a in rows:
            index = index * axes[a] + mesh.coordinate(a)
            out["size"] *= axes[a]
        out.update(index=index, group=mesh.get_group(batch))
        by_axes = {batch: []}            # the loss rides the batch group
        for p in self.model.parameters():
            done = sharding.summed_axes(p)
            rest = tuple(a for a in batch if a not in done)
            by_axes.setdefault(rest, []).append(p)
        out["sums"] = [(rest, GradReducer(mesh.get_group(rest)), params)
                       for rest, params in by_axes.items() if rest]
        return out

    @property
    def device(self):
        return next(self.model.parameters()).device

    def _loss(self, batch):
        if self._dp is not None and self._dp.get("sp") is not None \
                and "labels" in batch:
            # the sequence cut shifted the labels over the whole sequence
            batch = dict(batch, label_shift=False)
        if self._dtype is None:
            out = self.model(**batch)
        else:
            params = {n: (p.to(self._dtype) if p.is_floating_point() else p)
                      for n, p in self.model.named_parameters()}
            out = torch.func.functional_call(self.model, params, (), batch)
        loss = out[0] if isinstance(out, (tuple, list)) else out
        return loss.float()

    def _guards(self, overlap=None):
        """The step's parallel contexts, around its forward AND backward
        (a recomputed layer reruns its forward there):
        distributed/context_parallel.py's guard over 'sp',
        parallel/overlap.py's over 'fsdp' (`overlap` overrides
        config.overlap_fsdp; it does nothing without an 'fsdp' axis of
        extent > 1) and nn/moe.py's `batch_group` over a batch group of
        more than one rank."""
        from paddle_tpu_torch.nn.moe import batch_group
        stack = contextlib.ExitStack()
        cfg = self.config
        if self._dp is None:
            return stack
        if self._dp["group"] is not None and self._dp.get("sp") is None:
            stack.enter_context(batch_group(
                self._dp["group"], self._dp["index"], self._dp["size"]))
        if self._dp.get("sp") is not None:
            from paddle_tpu_torch.distributed.context_parallel import (
                context_parallel_guard)
            stack.enter_context(context_parallel_guard(
                self.mesh, axis="sp", mode=cfg.context_parallel))
        if cfg.overlap_fsdp if overlap is None else overlap:
            if "fsdp" in self.mesh.dim_names \
                    and self.mesh.get_dim_size("fsdp") > 1:
                from paddle_tpu_torch.parallel.overlap import (
                    overlap_fsdp_guard)
                stack.enter_context(overlap_fsdp_guard(
                    self.mesh, axis="fsdp",
                    chunks=max(1, cfg.overlap_chunks)))
        return stack

    def _place(self, batch):
        """The batch's leaves as tensors on the model's device; a leaf
        already there (a `data_iter` batch) is used as it is. With a
        mesh, a global batch is cut to this rank's rows first."""
        dev = self.device
        if self._dp is not None and not isinstance(batch, _LocalBatch):
            batch = self._local_rows(batch)
        out = {k: v if isinstance(v, torch.Tensor) and v.device == dev
               else torch.as_tensor(v).to(dev) for k, v in batch.items()}
        return out if self._dp is None else _LocalBatch(out)

    def _local_rows(self, batch):
        """This rank's rows of a global batch: microbatch i of the JAX
        loop is global rows [i B/n, (i+1) B/n), and rank r keeps the r-th
        of its row group's slices; with 'sp', its sequence shard of
        them (`_seq_shard`)."""
        dp, r = self._dp["size"], self._dp["index"]
        n_mb = self._row_groups()
        out = {}
        for k, v in batch.items():
            if getattr(v, "ndim", 0) == 0:
                out[k] = v
                continue
            b = v.shape[0]
            if b % (dp * n_mb):
                raise ValueError(
                    f"batch leaf {k!r} of {b} rows does not split over the "
                    f"batch group's {dp} ranks x {n_mb} microbatches")
            rows = v.reshape((n_mb, dp, b // (dp * n_mb)) + tuple(v.shape[1:]))
            out[k] = rows[:, r].reshape((b // dp,) + tuple(v.shape[1:]))
        if self._dp.get("sp") is not None:
            out = _seq_shard(out, *self._dp["sp"])
        return _LocalBatch(out)

    def _row_groups(self):
        """The microbatches a global batch's rows are cut into before the
        batch group cuts each of them (`_local_rows`)."""
        return self.config.grad_accum_steps

    def _token_scales(self, mbs):
        """(n_mb,) f32: each microbatch's weight on this rank, its valid
        tokens over the batch group's (the loss is the mean over the
        global valid tokens); a group of one rank all-reduces nothing."""
        shifted = self._dp.get("sp") is not None
        counts = torch.stack([_valid_tokens(mb, shifted)
                              for mb in mbs]).float()
        total = counts.clone()
        if self._dp["group"] is not None:
            collective.all_reduce(total, group=self._dp["group"])
        return counts / total.clamp(min=1.0)     # 0 where none is valid

    def _forward_backward(self, batch, backward=True, overlap=None):
        """The mean loss over the microbatches, and, with `backward`,
        their mean gradients in the parameters' `.grad` (with a mesh:
        this rank's share of the global ones), inside `_guards`."""
        with self._guards(overlap):
            return self._microbatches(batch, backward)

    def _microbatches(self, batch, backward):
        n_mb = self.config.grad_accum_steps
        if n_mb == 1:
            mbs = [batch]
        else:
            size = next(iter(batch.values())).shape[0]
            if size % n_mb:
                raise ValueError(f"batch {size} does not split into {n_mb} "
                                 "microbatches")
            chunks = {k: torch.chunk(v, n_mb, dim=0) for k, v in batch.items()}
            mbs = [{k: v[i] for k, v in chunks.items()} for i in range(n_mb)]
        scales = None if self._dp is None else self._token_scales(mbs)
        if n_mb == 1:
            loss = self._loss(batch)
            if scales is not None:
                loss = self._weighed(loss, scales[0])
            if backward:
                loss.backward()
            return loss.detach()
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        for i, mb in enumerate(mbs):
            mb_loss = self._loss(mb)
            if scales is not None:
                mb_loss = self._weighed(mb_loss, scales[i])
            if backward:
                mb_loss.backward()
            loss = loss + mb_loss.detach()
        if backward:
            with torch.no_grad():
                for p in self.model.parameters():
                    if p.grad is not None:
                        p.grad.div_(n_mb)
        return loss / n_mb

    def _weighed(self, loss, scale):
        """The last forward's `loss` weighted by this rank's token share
        (`_weigh`); a MoE model's `router_aux_loss()`, already this
        rank's share of the batch group's, rides unweighted."""
        aux = getattr(self.model, "router_aux_loss", None)
        if aux is None:
            return _weigh(loss, scale)
        aux = aux()
        return _weigh(loss - aux, scale) + aux

    def step(self, batch: dict) -> torch.Tensor:
        """One optimizer step on `batch` ({name: tensor or array}, moved to
        the model's device unless it is there); returns the mean f32 loss
        (0-d tensor)."""
        batch = self._place(batch)
        if observability.ENABLED:
            self._telemetry_tick(batch)
        elif self._tel_last_t is not None:
            # disabled mid-run: drop the stale stamp, so a re-enable
            # does not report the whole gap as one step
            self._tel_last_t = self._tel_prev = None
        key = tuple((k, tuple(v.shape), v.dtype)
                    for k, v in sorted(batch.items()))
        first = key not in self._seen_batches
        if first:
            self._seen_batches.add(key)
        self.optimizer.zero_grad()
        loss = self._forward_backward(batch)
        if self._dp is not None and self._dp["group"] is not None:
            loss = self._reduce_dp(loss)
        if chaos.ENABLED:
            loss = self._chaos_faults(loss)
        self._apply_update(loss)
        if first and observability.ENABLED:
            observability.inc("train.recompiles", shape=_batch_sig(key))
        if self._tel_prev is not None:
            # reported at the next step, read loss_lag steps later
            self._tel_prev[2] = loss
        return loss

    def _reduce_dp(self, loss):
        """Sum each gradient over the batch axes its cut did not sum over,
        the loss over the whole batch group (with the gradients summed
        there, in one set of buckets); returns the global loss."""
        loss = loss.reshape(1).clone()
        with torch.no_grad():
            for axes, reducer, params in self._dp["sums"]:
                grads = [p.grad for p in params if p.grad is not None]
                if axes == self._dp["batch"]:
                    grads.append(loss)
                reducer.all_reduce(grads)
        return loss.reshape(())

    def _chaos_faults(self, loss):
        """The training chaos sites, each consulted only while it has a
        rate: `trainer.grad` and `train.grad.nan` multiply the gradients
        by NaN, `train.loss.spike` the loss and the gradients by its
        factor (JAX `_step_inner`: spike first, then poison)."""
        poison = 1.0
        if chaos.site_rate("trainer.grad") > 0:
            poison *= chaos.grad_poison("trainer.grad")
        if chaos.site_rate("train.grad.nan") > 0:
            poison *= chaos.grad_poison("train.grad.nan")
        spike = (chaos.loss_spike("train.loss.spike")
                 if chaos.site_rate("train.loss.spike") > 0 else 1.0)
        if spike == 1.0 and poison == 1.0:
            return loss
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None]
        with torch.no_grad():
            if spike != 1.0:
                loss = loss * spike
                torch._foreach_mul_(grads, spike)
            if poison != 1.0:
                torch._foreach_mul_(grads, poison)
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
        params = [p for p in self.model.parameters() if p.grad is not None]
        grads = [p.grad.float() for p in params]
        # the groups the model is cut over, and (a pipeline stage's
        # optimizer, optimizer/__init__.py `split_over`) split across
        groups = shard_groups(params)
        across, counted = self.optimizer._span(params)
        if cfg.health_probe:
            # one reduction: the norm carries any NaN / Inf, so it is both
            # the all-finite check and the probe's gradient norm
            gnorm = global_grad_norm(grads, groups, across, counted)
            healthy = (torch.isfinite(loss) & torch.isfinite(gnorm)
                       & (loss <= self._loss_cap))
            self.optimizer.step(lr, apply=healthy)
            self.last_probe = torch.stack([gnorm, healthy.float()])
            return
        finite = _on_every_rank(torch.isfinite(loss) & torch.stack(
            [torch.isfinite(g).all() for g in grads]).all(),
            groups + ([(across,)] if across is not None else []))
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
                if observability.ENABLED:
                    observability.inc("train.nonfinite_skips")
            else:
                self.nonfinite_streak = 0
        if self.nonfinite_streak >= self.config.max_consecutive_nonfinite:
            raise NonFiniteGradError(
                f"{self.nonfinite_streak} consecutive steps produced "
                f"non-finite gradients (limit "
                f"{self.config.max_consecutive_nonfinite}); aborting")

    def _telemetry_tick(self, batch):
        """Report the PREVIOUS step now that its interval is known, then
        stamp this step's token count for the next tick (JAX
        `_telemetry_tick`)."""
        now = time.perf_counter()
        if self._telemetry is None:
            from paddle_tpu_torch.observability.telemetry import (
                TrainingTelemetry)
            self._telemetry = TrainingTelemetry.for_model(self.model)
        if self._tel_prev is not None and self._tel_last_t is not None:
            tokens, seq, loss = self._tel_prev
            self._telemetry.step(tokens, now - self._tel_last_t,
                                 seq_len=seq, loss=loss)
        self._tel_last_t = now
        arr = batch.get("input_ids")
        if arr is None and batch:
            arr = next(iter(batch.values()))
        ndim = getattr(arr, "ndim", 0)
        if ndim >= 2:
            tokens = int(arr.shape[0]) * int(arr.shape[1])
            seq = int(arr.shape[1])
        elif ndim == 1:
            tokens = seq = int(arr.shape[0])
        else:
            tokens = seq = 0
        if self._dp is not None:
            # this rank's rows (and sequence shard) are the global batch
            # over its batch group; its tokens the global batch over the
            # mesh's size
            group = self._dp["group"]
            tokens = tokens * (1 if group is None else group.nranks) \
                / self.mesh.size
        self._tel_prev = [tokens, seq, None]
        self._note_logits_bytes_saved(tokens)

    def _note_logits_bytes_saved(self, tokens):
        """With a blockwise-loss model (loss_chunk > 0), the bytes of
        [tokens, vocab] logits the loss does not build this step."""
        mcfg = getattr(self.model, "config", None)
        chunk = getattr(mcfg, "loss_chunk", 0) or 0
        vocab = getattr(mcfg, "vocab_size", 0) or 0
        if not (chunk and vocab and tokens):
            return
        from paddle_tpu_torch.kernels.blockwise_ce import logits_bytes_saved
        itemsize = self._dtype.itemsize if self._dtype is not None else 4
        observability.set_gauge(
            "train.loss.logits_bytes_saved",
            logits_bytes_saved(
                int(tokens), int(vocab), int(chunk),
                int(getattr(mcfg, "loss_vocab_block", 0) or 0), itemsize))

    def fleet_heartbeat(self, store, rank, world_size, **kw):
        """Publish this process's training telemetry (step, tokens/s,
        MFU, recompiles, pending async saves) into the cross-rank
        heartbeat plane (observability/fleet.py) under
        ``fleet/hb/{rank}``. Returns the started FleetHeartbeat, or None
        when observability is disabled: no thread, no store traffic."""
        if not observability.ENABLED:
            return None
        from paddle_tpu_torch.observability.fleet import FleetHeartbeat
        return FleetHeartbeat(store, rank, world_size, **kw).start()

    @property
    def telemetry(self):
        """The TrainingTelemetry reporter (None until a step ran with
        observability enabled)."""
        return self._telemetry

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
        if self._dp is None:
            return DevicePrefetcher(loader, device=self.device, depth=depth)
        return _LocalPrefetcher((self._local_rows(b) for b in loader),
                                device=self.device, depth=depth)

    def measure_phase_seconds(self, batch: dict, iters: int = 2):
        """Where a step's time goes, as the JAX Trainer attributes it:

            fwd       = t(loss)
            bwd       = t(loss and gradients) - t(loss)
            optimizer = t(full step)          - t(loss and gradients)

        each a mean over `iters` runs after one warm-up, synchronised on
        the card. Returns {"fwd", "bwd", "optimizer", "step"} seconds. The
        full-step timing drives `iters + 1` real optimizer steps.

        With overlap_fsdp on an 'fsdp' axis of extent > 1 two more twin
        pairs run: `propagated` (the ring forced off: gather-at-use) and
        `nocomm` (every fsdp-cut weight whole on each rank, gathered once
        before and cut back after, so no weight collective runs), and the
        result grows {"fwd_comm", "bwd_comm"} (propagated - nocomm per
        phase: the weight collectives' seconds) and {"overlap_fraction"}
        (overlap.py `overlap_fraction_from_spans` over the six timings,
        recorded as `train.overlap.phase` spans). With observability on,
        `train.phase.seconds`, `train.overlap.comm.seconds` and
        `train.overlap.fraction` are recorded."""
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

        def twins(overlap=None):
            def fwd():
                with torch.no_grad():
                    self._forward_backward(batch, backward=False,
                                           overlap=overlap)

            def fwd_bwd():
                self.optimizer.zero_grad()
                self._forward_backward(batch, overlap=overlap)
            return timed(fwd), timed(fwd_bwd)

        t_fwd, t_fwd_bwd = twins()
        self.optimizer.zero_grad()
        t_step = timed(lambda: self.step(batch))
        phases = {"fwd": t_fwd, "bwd": max(0.0, t_fwd_bwd - t_fwd),
                  "optimizer": max(0.0, t_step - t_fwd_bwd), "step": t_step}
        if self.config.overlap_fsdp and self._dp is not None \
                and "fsdp" in self.mesh.dim_names \
                and self.mesh.get_dim_size("fsdp") > 1:
            self._comm_columns(phases, twins)
        if observability.ENABLED:
            for ph in ("fwd", "bwd", "optimizer"):
                observability.observe("train.phase.seconds", phases[ph],
                                      phase=ph)
        return phases

    def _comm_columns(self, phases, twins):
        """`measure_phase_seconds`' overlap columns (its docstring)."""
        from paddle_tpu_torch.observability import trace
        from paddle_tpu_torch.parallel.overlap import (
            overlap_fraction_from_spans)
        t = {"overlapped": (phases["fwd"], phases["fwd"] + phases["bwd"]),
             "propagated": twins(overlap=False)}
        self.optimizer.zero_grad()
        with _whole_fsdp_weights(self.model):
            t["nocomm"] = twins(overlap=False)
            self.optimizer.zero_grad()
        wall = time.perf_counter()
        for variant, (f, fb) in t.items():
            trace.record_span("train.overlap.phase", wall, f * 1e6,
                              attrs={"variant": variant, "phase": "fwd"})
            trace.record_span("train.overlap.phase", wall,
                              max(0.0, fb - f) * 1e6,
                              attrs={"variant": variant, "phase": "bwd"})
        (p_f, p_fb), (n_f, n_fb) = t["propagated"], t["nocomm"]
        phases["fwd_comm"] = max(0.0, p_f - n_f)
        phases["bwd_comm"] = max(0.0, (p_fb - p_f) - (n_fb - n_f))
        phases["overlap_fraction"] = frac = overlap_fraction_from_spans()
        if observability.ENABLED:
            observability.observe("train.overlap.comm.seconds",
                                  phases["fwd_comm"], phase="fwd")
            observability.observe("train.overlap.comm.seconds",
                                  phases["bwd_comm"], phase="bwd")
            if frac is not None:
                observability.set_gauge("train.overlap.fraction", frac)

    # -- checkpoints -------------------------------------------------------
    def sync_to_model(self):
        """The model (the port's parameters live in it already)."""
        return self.model

    def checkpoint_state(self):
        """What a training checkpoint holds: the parameters AND the
        optimizer state, as a nested dict (save_state_dict flattens it)
        of the live tensors, each cut tensor gathered whole over fsdp and
        then mp (a collective: every rank calls it; a parked moment is
        gathered on the card). Resuming parameters without moments would
        restart Adam's bias correction."""
        return _unflat2({k: gather_whole(v.to(dev), c) if c else v
                         for k, (v, c, dev) in self._state_tensors().items()})

    def _state_tensors(self):
        """{("params"|"opt", name[, key]): (live tensor, its cuts (()
        when whole), its parameter's device)} of every checkpointed
        tensor; parked state is waited for."""
        opt = self.optimizer
        opt.sync_state()
        out = {}
        for n, p in self.model.named_parameters():
            out[("params", n)] = (p.detach(), cuts_of(p), p.device)
        for n, p in zip(opt._names, opt._params):
            cuts = cuts_of(p)
            for k, v in opt._state_for(n, p).items():
                out[("opt", n, k)] = (v, cuts if v.dim() else (), p.device)
        return out

    def save_checkpoint(self, path):
        """Save the parameters and optimizer state into `path`. With a
        `checkpointer` this returns after the host snapshot and the
        files are written on its thread; without one, a synchronous
        save. Returns `path`."""
        sd = self.checkpoint_state()
        if self.checkpointer is not None:
            self.checkpointer.save(sd, path)
        else:
            from paddle_tpu_torch.distributed import checkpoint as ckpt
            ckpt.save_state_dict(sd, path)
        return path

    def load_checkpoint(self, path):
        """Restore the parameters and optimizer state that
        save_checkpoint wrote, in place. Flushes the attached
        checkpointer first, so an in-flight save of `path` is never
        half-read. Returns `path`."""
        from paddle_tpu_torch.distributed import checkpoint as ckpt
        if self.checkpointer is not None:
            self.checkpointer.flush()
        live = self._state_tensors()
        sd = _unflat2({k: torch.empty(whole_shape(v, c), dtype=v.dtype,
                                      device=v.device) if c else v
                       for k, (v, c, _) in live.items()})
        ckpt.load_state_dict(sd, path)
        with torch.no_grad():
            # a cut tensor takes this rank's piece; an entry saved in
            # another dtype came back as a new tensor
            for k, (v, c, _) in live.items():
                got = sd[k[0]][k[1]] if k[0] == "params" \
                    else sd["opt"][k[1]][k[2]]
                if c:
                    v.copy_(cut_whole(got, c))
                elif got is not v:
                    v.copy_(got)
        return path


@contextlib.contextmanager
def _whole_fsdp_weights(model):
    """Every fsdp-cut parameter whole on each rank for the block (one
    all-gather each on entry), its modules' gather-at-use hooks idle (no
    cut to gather) and the overlap ring off (no cut to carry); the pieces
    and the cuts come back on exit, the whole copies and their gradients
    dropped."""
    from paddle_tpu_torch.distributed.sharding import gather_full
    mods = [m for m in model.modules() if getattr(m, "_fsdp_cuts", None)]
    saved = []
    with torch.no_grad():
        for m in mods:
            for name, cut in m._fsdp_cuts.items():
                p = m._parameters[name]
                if cut.dim is not None:
                    saved.append((p, p.data))
                    p.data = gather_full(p.data, cut)
            saved.append((m, m._fsdp_cuts))
            m._fsdp_cuts = {}
    try:
        yield
    finally:
        for obj, keep in reversed(saved):
            if isinstance(obj, torch.nn.Module):
                obj._fsdp_cuts = keep
            else:
                obj.data = keep
                obj.grad = None


def _on_every_rank(flag, groups):
    """0-d bool: `flag` holds on every rank of each distinct group in
    `groups` (`shard_groups`: tuples of mp and fsdp groups, and a
    pipeline's pp group; a MIN
    all-reduce a group), so the ranks of a cut model, whose gradient
    pieces differ, take one branch."""
    distinct = {id(g): g for gs in groups for g in gs}
    if not distinct:
        return flag
    f = flag.float().reshape(1)
    for g in distinct.values():
        collective.all_reduce(f, collective.ReduceOp.MIN, g)
    return f.reshape(()) > 0


def _unflat2(flat):
    """{("params", n): t, ("opt", n, k): t} as {"params": {n: t}, "opt":
    {n: {k: t}}}."""
    out = {"params": {}, "opt": {}}
    for key, t in flat.items():
        if key[0] == "params":
            out["params"][key[1]] = t
        else:
            out["opt"].setdefault(key[1], {})[key[2]] = t
    return out


class _LocalBatch(dict):
    """A batch that holds this rank's rows only (`Trainer._local_rows`)."""


class _LocalPrefetcher(DevicePrefetcher):
    """A DevicePrefetcher of this rank's rows, its batches marked so."""

    def __next__(self):
        return _LocalBatch(super().__next__())


def _weigh(loss, scale):
    """`loss` weighted by this rank's token share; a share of 0 gives 0,
    also where the model's mean over a slice with no valid label is NaN
    (torch's cross entropy; its gradient is 0: no target reaches the
    backward)."""
    return torch.where(scale > 0, loss * scale, torch.zeros_like(loss))


def _valid_tokens(batch, shifted=False):
    """0-d count of the tokens a microbatch's loss averages over: labels
    other than -100 after the next-token shift (models/llama.py
    `next_token_loss`; `shifted`: the labels are shifted already), or
    its rows without labels."""
    labels = batch.get("labels")
    if labels is None:
        rows = next(iter(batch.values())).shape[0]
        return torch.tensor(float(rows), device=next(
            iter(batch.values())).device)
    return ((labels if shifted else labels[:, 1:]) != -100).sum()


def _seq_shard(batch, n, r):
    """Rank r of n's tokens [r S/n, (r+1) S/n) of every leaf of two dims
    or more (S: input_ids' dim 1): the labels shifted over the whole
    sequence first (position t scores labels[t + 1], so a shard's last
    position scores the next shard's first label), and position_ids
    (rows, S/n) of the shard's global positions added when the batch has
    none (RoPE at global positions)."""
    from paddle_tpu_torch.models.llama import shift_labels
    ids = torch.as_tensor(batch["input_ids"])
    rows, s = ids.shape[0], ids.shape[1]
    if s % n:
        raise ValueError(f"a sequence of {s} tokens does not split over "
                         f"the 'sp' axis's {n} ranks")
    lo, hi = r * s // n, (r + 1) * s // n
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if k == "labels":
            v = shift_labels(v)
        elif k == "position_ids" and v.ndim == 1:
            v = v.expand(rows, s)
        out[k] = v[:, lo:hi] if v.ndim >= 2 else v
    if "position_ids" not in out:
        out["position_ids"] = torch.arange(lo, hi).expand(rows, hi - lo)
    return out


def _batch_sig(key):
    """The `shape` label of train.recompiles: every leaf's name, dims and
    numpy dtype name, sorted by name (JAX `_batch_sig`)."""
    return ",".join(f"{k}:{'x'.join(str(d) for d in shape)}:"
                    f"{str(dtype).removeprefix('torch.')}"
                    for k, shape, dtype in key)
