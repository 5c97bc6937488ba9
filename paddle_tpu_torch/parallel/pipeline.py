"""Pipeline parallelism over a mesh's 'pp' axis: one stage a rank.

Counterpart of paddle_tpu/parallel/pipeline.py (reference:
fleet/meta_parallel/pipeline_parallel.py:440 forward_backward_pipeline,
:906 PipelineParallelWithInterleave, pp_layers.py:92 SegmentLayers). The
JAX package runs the pipeline as one compiled program: the layer stack
stacked (S·k, ...), its stage dim sharded over 'pp', the stage function
vmapped and the activation buffer rolled one lockstep tick at a time.
The port is multi-controller, as its other parallel slices are: one
process a rank holds its stage's layers only, and the activations and
their gradients cross between stage ranks point to point (collective.py
`_p2p_start`: each unit's send posted together with the next unit's
receive, staged through pinned host memory on gloo, every wait bounded
by HOP_TIMEOUT_S).

- Partition. `detect_layer_stack` finds the stack: the longest
  nn.ModuleList of two or more modules with the same parameter shapes.
  Rank s of the pp group keeps stage s's layers, stage 0 the embedding
  and stage S-1 the final norm and the head (and the embedding too when
  the head is tied to it); the rest leaves the model (a layer becomes
  nn.Identity, a parameter None) and the optimizer, so a rank holds one
  stage. Without `stage_boundaries` and with L % S != 0 the first
  L % S stages take one layer more. No stage is padded (the JAX package
  pads the short stages with masked identity slots).
- Schedules (rank s of S, M microbatches, `schedule_units`): "1f1b"
  (the default) is Megatron's: min(S-1-s, M) warm-up forwards, one
  forward and one backward a step, then the cool-down backwards, so
  stage s holds at most min(M, S-s) microbatches' activations (the JAX
  lockstep buffer holds min(M, 2S-1)); "gpipe" runs every forward, then
  every backward (M held; with `grad_accum_steps` a whole pipeline a
  chunk of the batch). `interleave` v > 1 (VPP): rank s holds chunks
  l = 0..v-1, global stages l·S + s, and walks its units in the tick
  order of `build_interleaved_schedule`'s tables; the wrap from stage
  S-1 to 0 is a hop from the last rank to the first. A stage's backward
  is autograd through the graph its forward kept (the model's
  `recompute` reruns each layer's forward there). `last_schedule` holds
  the last step's peak of held microbatches, hops and bytes; `counts`
  the hops and bytes sent over the run.
- Loss. The default tail is the final norm, the head (the lm_head, or
  the embedding's transpose when tied) and the shifted next-token CE in
  f32, summed over a microbatch and divided by W, the count of valid
  tokens over every microbatch and the dp group, so ragged -100 padding
  weighs as the whole batch's mean does. It is dense, as the JAX
  pipeline's: `loss_chunk` is not read. A custom `tail_fn(params, h,
  batch)` returns a microbatch's mean and each microbatch weighs the
  same (mean-of-means, over the dp ranks too); `embed_fn(params,
  batch)` gives the (rows, seq, hidden) activations; `params` holds the
  rank's parameters outside the stack, in the compute type, by name.
  Every rank returns the global loss.
- The update. A parameter both ends hold (the tied embedding) has its
  gradients summed over the pair {0, S-1} before the update, so both
  copies take the same step. The clip's global norm (the optimizer's
  `split_over`) and the probe's add every stage's squares over the pp
  group, the second copy left out, and the non-finite skip's flag is
  taken over it, so every stage takes one branch. Over 'dp' a stage's
  gradients are summed by the Trainer's GradReducer.
- Not yet (NotImplementedError naming ROADMAP.md queue 1 item 7.3b):
  'pp' with 'fsdp', 'mp' or 'sp' of extent > 1, `overlap_fsdp`,
  `offload_opt_state`, `measure_phase_seconds` and checkpoints.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.distributed import collective
from paddle_tpu_torch.distributed.placement import PartitionSpec as P
from paddle_tpu_torch.parallel.plan import ShardingPlan
from paddle_tpu_torch.parallel.trainer import (Trainer, TrainStepConfig,
                                               _valid_tokens)

__all__ = ["STACK_PREFIX", "detect_layer_stack", "PipelinePlan",
           "PipelineConfig", "PipelineTrainer", "build_interleaved_schedule",
           "schedule_units", "hops_per_step", "counts"]

STACK_PREFIX = "pipeline.layers::"
# hops (activations and gradients sent to another stage rank) and their
# bytes since the process started
counts = {"hops": 0, "bytes": 0}
_LATER = "ROADMAP.md queue 1 item 7.3b"
# seconds a wait for a hop may take before it raises (a stage that never
# sends fails the step instead of hanging the job)
HOP_TIMEOUT_S = 600.0
_FWD, _BWD, _TIE = 0, 1, 2          # point-to-point tags


def detect_layer_stack(model):
    """The pipeline-able layer stack: the longest nn.ModuleList (>= 2
    modules) whose modules all hold the same parameter structure.
    Returns (qualified name, ModuleList). SegmentLayers equivalent
    (reference pp_layers.py:92)."""
    best = None
    for name, sub in model.named_modules():
        if not isinstance(sub, nn.ModuleList) or len(sub) < 2:
            continue
        shapes = [tuple(sorted((n, tuple(t.shape))
                               for n, t in m.state_dict().items()))
                  for m in sub]
        if any(s != shapes[0] for s in shapes[1:]):
            continue
        if best is None or len(sub) > len(best[1]):
            best = (name, sub)
    if best is None:
        raise ValueError(
            "no pipeline-able LayerList found: the model needs a stack of "
            ">=2 structurally-identical layers (e.g. decoder layers)")
    return best


class PipelinePlan(ShardingPlan):
    """Wraps a base plan: a stacked layer name (STACK_PREFIX + the
    layer's own name) gets 'pp' prepended on its stage dim; everything
    else falls through. The port's stages hold whole layers, so its
    models carry no stacked name."""

    def __init__(self, base: ShardingPlan):
        self.base = base
        self.rules = base.rules
        self.default = base.default

    def spec_for(self, name: str, ndim: int | None = None) -> P:
        if name.startswith(STACK_PREFIX):
            sub = self.base.spec_for(name[len(STACK_PREFIX):])
            return P("pp", *tuple(sub))
        return self.base.spec_for(name)


@dataclass
class PipelineConfig(TrainStepConfig):
    num_microbatches: int = 4
    schedule: str = "1f1b"            # "1f1b" | "gpipe"
    interleave: int = 1               # virtual stages per rank (VPP)
    # SegmentLayers-style custom stage split (reference pp_layers.py:92):
    # len S+1 ascending boundaries over the layer stack, e.g. (0, 3, 6,
    # 8, 10) puts layers [0,3) on stage 0 etc. None = uniform.
    stage_boundaries: tuple | None = None

    def __post_init__(self):
        if self.schedule not in ("1f1b", "gpipe"):
            raise ValueError(
                f"unknown pipeline schedule {self.schedule!r}: "
                "expected '1f1b' or 'gpipe'")
        if self.interleave < 1:
            raise ValueError("interleave must be >= 1")
        if self.interleave > 1 and self.schedule != "1f1b":
            raise ValueError(
                "interleave (virtual pipeline) requires schedule='1f1b'")
        if self.stage_boundaries is not None:
            b = tuple(self.stage_boundaries)
            if len(b) < 2 or b[0] != 0 or any(
                    y <= x for x, y in zip(b, b[1:])):
                raise ValueError(
                    "stage_boundaries must be ascending and start at 0, "
                    f"got {b}")
            if self.interleave > 1:
                raise ValueError(
                    "stage_boundaries does not compose with interleave "
                    "(VPP chunks need a uniform stack split)")


def build_interleaved_schedule(S: int, v: int, M: int):
    """Lockstep tick tables for the interleaved-1F1B (VPP) schedule (the
    JAX module's, numpy only).

    Layer chunks: the L layers split into S*v chunks; global stage
    q = l*S + s (device s, local chunk l), so activations make v laps of
    the same device ring, the chunk index incrementing at each S-1 -> 0
    wrap. Device s's unit order is the Megatron chunk-level order
    (reference pipeline_parallel.py:906): microbatches in groups of S,
    each group walking chunks 0..v-1 forward and v-1..0 backward; device
    s's forward unit k runs at tick k+s and its backward unit b at tick
    (vS-1)+(S-1-s)+b.

    Returns (tables, T, warm_end, steady_end, C): per-tick (T, S) arrays
    f_l/f_slot/f_valid + b_l/b_slot/b_valid (chunk index, saved-input
    slot, validity for the forward/backward unit of each device), (T,)
    arrays inject_*/tail_*/emb_* (stage-0 fresh-microbatch injection,
    stage-(S-1) loss-tail microbatch, stage-0 embedding-cotangent
    capture), phase boundaries (ticks [0,warm_end) are forward-only,
    [warm_end,steady_end) mixed, [steady_end,T) backward-only), and C
    the saved-activation slots per device (greedy reuse; equals the
    Megatron in-flight bound, <= (v+1)S-1)."""
    if M % S != 0:
        raise ValueError(
            f"interleaved pipeline needs num_microbatches % pp == 0 "
            f"(got M={M}, pp={S})")
    Sv = S * v
    total = M * v                          # units per device
    T = M * v + (v + 1) * S - 2
    warm_end = v * S - 1
    steady_end = M * v + S - 1
    tab = {
        "f_l": np.zeros((T, S), np.int32),
        "f_slot": np.zeros((T, S), np.int32),
        "f_valid": np.zeros((T, S), bool),
        "b_l": np.zeros((T, S), np.int32),
        "b_slot": np.zeros((T, S), np.int32),
        "b_valid": np.zeros((T, S), bool),
        "inject_m": np.zeros(T, np.int32),
        "inject_valid": np.zeros(T, bool),
        "tail_m": np.zeros(T, np.int32),
        "tail_valid": np.zeros(T, bool),
        "emb_m": np.zeros(T, np.int32),
        "emb_valid": np.zeros(T, bool),
    }
    free = [list(range(total)) for _ in range(S)]
    slot_of: dict = {}
    high = 0
    for t in range(T):
        for s in range(S):               # forwards first (alloc slots)
            k = t - s
            if not (0 <= k < total):
                continue
            g, j = divmod(k, Sv)
            l, mloc = divmod(j, S)
            slot = heapq.heappop(free[s])
            slot_of[(s, k)] = slot
            high = max(high, slot + 1)
            tab["f_l"][t, s] = l
            tab["f_slot"][t, s] = slot
            tab["f_valid"][t, s] = True
            if s == 0 and l == 0:
                tab["inject_m"][t] = g * S + mloc
                tab["inject_valid"][t] = True
            if s == S - 1 and l == v - 1:
                tab["tail_m"][t] = g * S + mloc
                tab["tail_valid"][t] = True
        for s in range(S):               # then backwards (free slots)
            b = t - (v + 1) * S + s + 2
            if not (0 <= b < total):
                continue
            g, j = divmod(b, Sv)
            jl, mloc = divmod(j, S)
            lb = v - 1 - jl
            k_fwd = g * Sv + lb * S + mloc
            slot = slot_of.pop((s, k_fwd))
            heapq.heappush(free[s], slot)
            tab["b_l"][t, s] = lb
            tab["b_slot"][t, s] = slot
            tab["b_valid"][t, s] = True
            if s == 0 and lb == 0:
                tab["emb_m"][t] = g * S + mloc
                tab["emb_valid"][t] = True
    assert not slot_of, "schedule left un-backwarded units"
    return tab, T, warm_end, steady_end, high


def schedule_units(num_stages, stage, num_microbatches, interleave=1,
                   schedule="1f1b"):
    """Stage `stage`'s units in the order it runs them: [("F" | "B",
    microbatch, local chunk)] (module docstring)."""
    S, s, M, v = num_stages, stage, num_microbatches, interleave
    if v > 1:
        tab, T, _, _, _ = build_interleaved_schedule(S, v, M)
        out = []
        for t in range(T):
            if tab["f_valid"][t, s]:
                g, j = divmod(t - s, S * v)
                out.append(("F", g * S + j % S, int(tab["f_l"][t, s])))
            if tab["b_valid"][t, s]:
                g, j = divmod(t - (v + 1) * S + s + 2, S * v)
                out.append(("B", g * S + j % S, int(tab["b_l"][t, s])))
        return out
    if schedule == "gpipe":
        return [("F", m, 0) for m in range(M)] + \
            [("B", m, 0) for m in range(M)]
    warm = min(S - 1 - s, M)
    out = [("F", m, 0) for m in range(warm)]
    for i in range(M - warm):
        out += [("F", warm + i, 0), ("B", i, 0)]
    return out + [("B", m, 0) for m in range(M - warm, M)]


def hops_per_step(num_stages, stage, num_microbatches, interleave=1):
    """The hops stage `stage` sends a step (a pipeline of M
    microbatches): an activation forward from every unit but the last
    global stage's, a gradient back from every unit but the first's."""
    S, s, M, v = num_stages, stage, num_microbatches, interleave
    if S == 1:
        return 0
    return 2 * M * v - M * ((s == S - 1) + (s == 0))


def _take_saved(held, key):
    """The saved (input leaf, output) of unit `key` = (microbatch,
    chunk), out of `held`."""
    return held.pop(key)


class _Chunk(nn.Module):
    """A stage's (or a VPP chunk's) layers in order: the model's own
    modules, each run as its stack runs it (recomputed in the backward
    when the model's config says so; a Llama layer takes the shared RoPE
    tables)."""

    def __init__(self, layers, recompute):
        super().__init__()
        from paddle_tpu_torch.models.llama import LlamaDecoderLayer
        self.layers = nn.ModuleList(layers)
        self.recompute = recompute
        self.llama = all(isinstance(m, LlamaDecoderLayer) for m in layers)

    def forward(self, h, rope=None):
        from paddle_tpu_torch.distributed.recompute import recompute
        for layer in self.layers:
            args = (h, None, None, None, rope, None) if self.llama else (h,)
            h = recompute(layer, *args) if self.recompute \
                and layer.training else layer(*args)
        return h


class PipelineTrainer(Trainer):
    """Trainer whose detected layer stack runs as a pipeline over the
    mesh's 'pp' axis (module docstring). Every process of the mesh
    builds the whole model and passes the same global batch; each keeps
    its stage (and, over 'dp', its rows)."""

    def __init__(self, model, optimizer, mesh, plan,
                 config: PipelineConfig | None = None,
                 embed_fn: Callable | None = None,
                 tail_fn: Callable | None = None):
        if mesh is None:
            raise ValueError("PipelineTrainer needs a mesh (its 'pp' axis "
                             "holds the stages)")
        base_name, stack = detect_layer_stack(model)
        self._layers_base, self._stack = base_name, stack
        self._num_layers = len(stack)
        self._embed_fn, self._tail_fn = embed_fn, tail_fn
        self.last_schedule = None
        cfg = config if config is not None else PipelineConfig()
        super().__init__(model, optimizer, cfg, mesh=mesh,
                         plan=None if plan is None else PipelinePlan(plan))

    # -- stage partitioning (SegmentLayers equivalent) ---------------------
    def _stage_bounds(self, S):
        """(stage boundaries over the stack, even): the JAX
        `_compute_slots`' split, without padding slots."""
        L = self._num_layers
        b = self.config.stage_boundaries
        if b is not None:
            b = tuple(b)
            if len(b) != S + 1 or b[-1] != L:
                raise ValueError(
                    f"stage_boundaries needs len pp+1={S + 1} ending at "
                    f"{L} layers, got {b}")
            return b, False
        q, r = divmod(L, S)
        out = [0]
        for i in range(S):
            out.append(out[-1] + q + (1 if i < r else 0))
        return tuple(out), r == 0

    def _parallel(self, mesh, plan):
        """Cut the model and the optimizer to this rank's stage and
        return the Trainer's batch-group record over 'dp' (its
        GradReducer over the stage's parameters)."""
        from paddle_tpu_torch.distributed.parallel import GradReducer
        from paddle_tpu_torch.parallel.plan import refuse_moe
        refuse_moe(self.model, mesh, plan, pipeline=True)
        axes = dict(zip(mesh.dim_names, mesh.shape))
        others = {a: n for a, n in axes.items()
                  if a not in ("pp", "dp") and n > 1}
        if others:
            raise NotImplementedError(
                f"pipeline parallelism over mesh axes {others}: the port's "
                f"PipelineTrainer composes 'pp' with 'dp' only; 'fsdp', "
                f"'mp' and 'sp' with 'pp' wait for {_LATER}")
        for flag in ("overlap_fsdp", "offload_opt_state"):
            if getattr(self.config, flag):
                raise NotImplementedError(
                    f"{flag} under pipeline parallelism waits for {_LATER}")
        S = axes.get("pp", 1)
        s = mesh.coordinate("pp") if S > 1 else 0
        self._S, self._s = S, s
        self._pp_group = mesh.get_group("pp") if S > 1 else None
        self._partition(S, s)
        dp = axes.get("dp", 1)
        out = {"size": 1, "index": 0, "group": None, "batch": (),
               "sp": None, "sums": []}
        if dp > 1:
            group = mesh.get_group("dp")
            out.update(size=dp, index=mesh.coordinate("dp"), group=group,
                       batch=("dp",), sums=[(("dp",), GradReducer(group),
                                             list(self.model.parameters()))])
        return out

    def _partition(self, S, s):
        """Keep stage s's layers and end parameters (module docstring)."""
        cfg, L = self.config, self._num_layers
        bounds, even = self._stage_bounds(S)
        v = cfg.interleave
        if not even and v > 1:
            raise ValueError(
                "interleave (VPP) needs layers % (pp * interleave) == 0; "
                "uneven/custom stage splits are plain-1F1B only")
        self._vpp_error = None
        if v > 1 and L % (S * v):
            # the JAX pipeline refuses it at its first step
            self._vpp_error = (f"{L} layers not divisible by "
                               f"pp*interleave={S * v}")
        if v > 1 and self._vpp_error is None:
            k = L // (S * v)
            chunks = [list(range((l * S + s) * k, (l * S + s + 1) * k))
                      for l in range(v)]
        else:
            chunks = [list(range(bounds[s], bounds[s + 1]))]
        self._layer_ids = chunks
        keep = {i for c in chunks for i in c}
        for i in range(L):
            if i not in keep:
                self._stack[i] = nn.Identity()

        stack_prefix = self._layers_base + "."
        other = [n for n, _ in self.model.named_parameters()
                 if not n.startswith(stack_prefix)]
        self._ends = {}
        if self._embed_fn is None:
            self._ends["embed"] = self._param_named(
                other, "embed_tokens.weight",
                "embed_tokens.weight not found (pass embed_fn= for "
                "non-Llama models)")
        if self._tail_fn is None:
            self._ends["norm"] = self._param_named(
                other, ".norm.weight", "no final norm (.norm.weight) "
                "outside the layer stack (pass tail_fn=)")
            head = next((n for n in other if n.endswith("lm_head.weight")),
                        None)
            self._ends["head"] = head if head is not None \
                else self._ends.get("embed") or self._param_named(
                    other, "embed_tokens.weight",
                    "no lm_head.weight or embed_tokens.weight (pass "
                    "tail_fn=)")
        first = set(other) if self._embed_fn is not None \
            else {self._ends["embed"]}
        last = set(other) if self._tail_fn is not None \
            else {self._ends["norm"], self._ends["head"]}
        kept = (first if s == 0 else set()) | (last if s == S - 1 else set())
        for name in other:
            if name not in kept:
                mname, _, pname = name.rpartition(".")
                self.model.get_submodule(mname)._parameters[pname] = None
        params = dict(self.model.named_parameters())
        self._shared = [params[n] for n in sorted(first & last)] \
            if S > 1 and s in (0, S - 1) else []

        opt = self.optimizer
        live = {id(p) for p in params.values()}
        pairs = [(n, p) for n, p in zip(opt._names, opt._params)
                 if id(p) in live]
        opt._names, opt._params = [n for n, _ in pairs], [p for _, p in pairs]
        opt.state = {n: st for n, st in opt.state.items() if n in opt._names}
        if S > 1:
            opt.split_over(self._pp_group,
                           self._shared if s == S - 1 else ())
        mcfg = getattr(self.model, "config", None)
        recompute = bool(getattr(mcfg, "recompute", False))
        self._chunks = [_Chunk([self._stack[i] for i in c], recompute)
                        for c in chunks]
        self._other = {n: params[n] for n in other if n in kept}

    @staticmethod
    def _param_named(names, suffix, missing):
        hit = [n for n in names if n.endswith(suffix)]
        if not hit:
            raise KeyError(missing)
        return hit[0]

    def _row_groups(self):
        """A global batch is cut into grad_accum_steps x
        num_microbatches microbatches, and each of them over 'dp' (the
        JAX pipeline's microbatches, each sharded over the dp axis)."""
        cfg = self.config
        return cfg.grad_accum_steps * cfg.num_microbatches

    # -- the step ----------------------------------------------------------
    def _cast(self, t):
        return t.to(self._dtype) if self._dtype is not None \
            and t.is_floating_point() else t

    def _forward_backward(self, batch, backward=True, overlap=None):
        """Run the schedule over this rank's rows: the gradients of its
        stage in `.grad` and the global loss (the mean over the
        grad_accum_steps chunks, each through a whole pipeline)."""
        cfg = self.config
        if self._vpp_error is not None:
            raise ValueError(self._vpp_error)
        if cfg.schedule == "1f1b" and cfg.grad_accum_steps > 1:
            raise NotImplementedError(
                "schedule='1f1b' does not compose with grad_accum_steps; "
                "raise num_microbatches instead (pipeline microbatching "
                "IS gradient accumulation)")
        n_acc, M = cfg.grad_accum_steps, cfg.num_microbatches
        rows = next(v for v in batch.values() if v.ndim >= 1).shape[0]
        if rows % (n_acc * M):
            raise ValueError(f"batch {rows} not divisible by microbatches "
                             f"{n_acc * M}")
        mb = rows // (n_acc * M)

        def part(i):
            return {k: v[i * mb:(i + 1) * mb] if v.ndim >= 1 else v
                    for k, v in batch.items()}
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        self.last_schedule = {"in_flight": 0, "hops": 0, "bytes": 0}
        for a in range(n_acc):
            loss = loss + self._pipeline(
                [part(a * M + m) for m in range(M)], 1.0 / n_acc)
        if self.mesh.size > 1:
            # the last stage's share, summed over the ranks: the global
            # loss on every rank
            loss = collective.all_reduce(loss.reshape(1))[0]
        return loss

    def _weight(self, mbs):
        """W: the tail's divisor (module docstring), on the last stage."""
        if self._tail_fn is not None:
            w = torch.tensor(float(len(mbs)), device=self.device)
        else:
            w = torch.stack([_valid_tokens(m) for m in mbs]).sum().float()
        if self._dp["group"] is not None:
            collective.all_reduce(w.reshape(1), group=self._dp["group"])
        return w.clamp(min=1.0)

    def _rope(self, mb):
        """The RoPE tables a Llama stack shares ((rows x seq) rows), as
        LlamaModel.forward builds them; None without fused_rope."""
        mcfg = getattr(self.model, "config", None)
        if not getattr(mcfg, "fused_rope", False) or \
                not any(c.llama and len(c.layers) for c in self._chunks):
            return None
        from paddle_tpu_torch.kernels.fused_norm import rope_tables
        b, n = mb["input_ids"].shape[:2]
        flat = torch.arange(n, dtype=torch.int32,
                            device=self.device).repeat(b)
        return rope_tables(flat, mcfg.head_dim, mcfg.rope_theta)

    def _embed(self, mb):
        if self._embed_fn is not None:
            return self._embed_fn({n: self._cast(p)
                                   for n, p in self._other.items()}, mb)
        w = self._cast(self._other[self._ends["embed"]])
        return torch.nn.functional.embedding(mb["input_ids"], w)

    def _tail(self, h, mb, weight):
        """The loss share of one microbatch: its CE sum over W (module
        docstring), times `weight` (1 / grad_accum_steps)."""
        if self._tail_fn is not None:
            out = self._tail_fn({n: self._cast(p)
                                 for n, p in self._other.items()}, h, mb)
            return out.float() * weight
        labels = mb.get("labels")
        if labels is None:
            return h.float().sum() * 0.0
        from paddle_tpu_torch.models.llama import shift_labels
        mcfg = self.model.config
        w = self._cast(self._other[self._ends["norm"]])
        if mcfg.fused_norm:
            from paddle_tpu_torch.kernels.fused_norm import rms_norm_residual
            h = rms_norm_residual(h, w, None, mcfg.rms_norm_eps)[0]
        else:
            from paddle_tpu_torch.nn import functional as F
            h = F.rms_norm(h, w, mcfg.rms_norm_eps)
        logits = torch.nn.functional.linear(
            h, self._cast(self._other[self._ends["head"]]))
        ce = torch.nn.functional.cross_entropy(
            logits.float().reshape(-1, logits.shape[-1]),
            shift_labels(labels).reshape(-1).long(), ignore_index=-100,
            reduction="sum")
        return ce * weight

    def _run_chunk(self, l, x, rope):
        chunk = self._chunks[l]
        params = {n: self._cast(p) for n, p in chunk.named_parameters()}
        return torch.func.functional_call(chunk, params, (x, rope))

    def _pipeline(self, mbs, weight):
        """One pipeline over microbatches `mbs`: this rank's units in
        schedule order, each unit's outgoing hop posted with the next
        unit's incoming one. Returns this rank's loss share (0 off the
        last stage)."""
        S, s, v = self._S, self._s, len(self._chunks)
        M, cfg = len(mbs), self.config
        last_q = S * v - 1
        units = schedule_units(S, s, M, v, cfg.schedule)
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        if s == S - 1:
            weight = weight / self._weight(mbs)
        rope = self._rope(mbs[0])
        mcfg = getattr(self.model, "config", None)
        act = ((mbs[0]["input_ids"].shape[0], mbs[0]["input_ids"].shape[1],
                mcfg.hidden_size), self._dtype or next(
                    self.model.parameters()).dtype)
        held, sends, local = {}, [], {_FWD: [], _BWD: []}
        stats = self.last_schedule

        def incoming(unit):
            """(peer, tag) a unit receives its input from, or None."""
            if unit is None:
                return None
            kind, _, l = unit
            q = l * S + s
            if kind == "F":
                return None if q == 0 else ((s - 1) % S, _FWD)
            return None if q == last_q else ((s + 1) % S, _BWD)

        def post(send, unit):
            """Post `send` (tensor, peer, tag) and `unit`'s receive."""
            src = incoming(unit)
            recvs = []
            if send is not None:
                if send[1] == s:           # one stage rank: no hop
                    local[send[2]].append(send[0])
                    send = None
                else:
                    t = send[0]
                    counts["hops"] += 1
                    counts["bytes"] += t.numel() * t.element_size()
                    stats["hops"] += 1
                    stats["bytes"] += t.numel() * t.element_size()
            if src is not None and src[0] != s:
                recvs.append((act[0], act[1], self.device, *src))
            if send is None and not recvs:
                return src
            hops = collective._p2p_start([send] if send else [], recvs,
                                         self._pp_group)
            sends.append(hops)
            return hops if recvs else src

        inbox = post(None, units[0])
        for i, unit in enumerate(units):
            kind, m, l = unit
            q = l * S + s
            x_in = None
            if isinstance(inbox, collective._Hops):
                x_in = inbox.wait(HOP_TIMEOUT_S)[0]
            elif inbox is not None:        # handed over on this rank
                x_in = local[inbox[1]].pop(0)
            send = None
            if kind == "F":
                if q == 0:
                    leaf, x = None, self._embed(mbs[m])
                else:
                    leaf = x = x_in.detach().requires_grad_()
                y = self._run_chunk(l, x, rope)
                if q == last_q:
                    y = self._tail(y, mbs[m], weight)
                    loss = loss + y.detach()
                else:
                    send = (y.detach(), (s + 1) % S, _FWD)
                held[(m, l)] = (leaf, y)
                stats["in_flight"] = max(stats["in_flight"], len(held))
            else:
                leaf, y = _take_saved(held, (m, l))
                if q == last_q:
                    y.backward()
                else:
                    torch.autograd.backward(y, x_in)
                if q > 0:
                    send = (leaf.grad, (s - 1) % S, _BWD)
                del y
            inbox = post(send, units[i + 1] if i + 1 < len(units) else None)
        for hops in sends:
            hops.wait_all(HOP_TIMEOUT_S)
        return loss

    def _reduce_dp(self, loss):
        """The stage's gradients summed over its dp group; the loss is
        global already (`_forward_backward`)."""
        with torch.no_grad():
            for _, reducer, params in self._dp["sums"]:
                reducer.all_reduce([p.grad for p in params
                                    if p.grad is not None])
        return loss

    def _apply_update(self, loss):
        """Sum the tied parameters' gradients over {0, S-1}, then the
        Trainer's update."""
        if self._shared:
            self._tie_grads()
        super()._apply_update(loss)

    def _tie_grads(self):
        S, s = self._S, self._s
        peer = S - 1 if s == 0 else 0
        with torch.no_grad():
            mine = torch.cat([(p.grad if p.grad is not None
                               else torch.zeros_like(p)).reshape(-1)
                              for p in self._shared])
            hops = collective._p2p_start(
                [(mine, peer, _TIE)],
                [(mine.shape, mine.dtype, mine.device, peer, _TIE)],
                self._pp_group)
            total = mine + hops.wait_all(HOP_TIMEOUT_S)[0]
            for p, part in zip(self._shared, total.split(
                    [p.numel() for p in self._shared])):
                p.grad = part.view_as(p).to(p.dtype).clone()

    # -- not yet under pipeline parallelism --------------------------------
    def measure_phase_seconds(self, batch, iters=2):
        raise NotImplementedError(
            f"measure_phase_seconds under pipeline parallelism waits for "
            f"{_LATER}")

    def checkpoint_state(self):
        raise NotImplementedError(
            f"checkpoints of a PipelineTrainer (its stages' pieces, the "
            f"JAX package's stacked pipeline.layers:: entries) wait for "
            f"{_LATER}")

    def save_checkpoint(self, path):
        return self.checkpoint_state()

    def load_checkpoint(self, path):
        return self.checkpoint_state()
