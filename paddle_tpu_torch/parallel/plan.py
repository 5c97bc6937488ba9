"""Declarative sharding plans: parameter-name regex -> PartitionSpec.

Counterpart of paddle_tpu/parallel/plan.py. The plans are data, the same
rules as the JAX module's (Megatron-style column/row splits on 'mp',
ZeRO-3 on 'fsdp', experts on 'ep'; axis conventions: 'dp' data parallel,
'fsdp' data parallel with sharded weights, 'mp' tensor parallel, 'sp'
sequence, 'pp' pipeline, 'ep' experts), over the port's own
`PartitionSpec` (distributed/placement.py).

The specs index the JAX layout: a JAX Linear weight is (in, out) and the
port's nn.Linear weight is its transpose (out, in), so `apply_plan`
maps each spec by meaning: a Linear whose OUTPUT dim the plan puts on
'mp' becomes a column-parallel layer (rank r keeps its rows of the
port's weight), one whose INPUT dim it puts there a row-parallel layer
(its columns), an embedding whose vocab dim it puts there the
vocab-parallel embedding (its rows; the embedding is (V, D) in both
packages). The parameters are cut in place (distributed/fleet/layers.py
`from_linear` / `from_embedding`), so an optimizer built over them keeps
them. A fused projection's shard is not a contiguous cut: rank r's
`qkv_proj` rows are [q_r; k_r; v_r] and its `gate_up_fused_proj` rows
[gate_r; up_r] (the JAX package cuts the fused dim contiguously and
GSPMD reshards to split it: paddle_tpu/models/llama.py:57-62); the
function is the same.

An 'fsdp' entry is mapped the same way (a Linear's JAX dim i is the
port's dim 1 - i; any other parameter's dims are the JAX ones) and cut
after the 'mp' cut, on the other dim, through distributed/sharding.py
`cut_param`: the owning module gathers the whole tensor for its forward
and the gradient comes back reduce-scattered. `P(fsdp, mp)` on q/k/v,
gate/up and lm_head cuts the port's input columns, `P(mp, fsdp)` on
o/down its output rows, and on the (V, D) embedding its D columns; the
norms stay whole.

A dim that does not divide by the mp or the fsdp extent, and fewer kv
(or query) heads than the mp extent, raise ValueError naming the
parameter (the JAX package pads such a dim). A parameter placed on
'sp' or 'pp' of extent > 1 raises NotImplementedError (the sequence axis
cuts activations, never weights: distributed/context_parallel.py; a
pipeline stage holds whole layers: parallel/pipeline.py), and one
placed on 'ep' names the slice it waits for; axes of extent 1
replicate, as the JAX plan does through `_axis`. `refuse_moe` names it
too for the layouts a MoE model (nn/moe.py `MoEMLP`) cannot take yet:
its stacked expert weights on ANY axis of extent > 1, 'mp' and 'fsdp'
included (no layer of the port takes an (E, D, F) cut yet), an 'sp'
axis or a pipeline; `apply_plan` and both Trainers call it.
"""
from __future__ import annotations

import re
from typing import Sequence

from paddle_tpu_torch.distributed.placement import PartitionSpec as P

__all__ = ["ShardingPlan", "llama_sharding_plan", "fsdp_partition",
           "batch_spec", "check_plan", "refuse_moe", "apply_plan", "WAITS"]


class ShardingPlan:
    """Ordered (regex, PartitionSpec) rules; first match wins."""

    def __init__(self, rules: Sequence[tuple[str, P]], default: P = P()):
        self.rules = [(re.compile(pat), spec) for pat, spec in rules]
        self.default = default

    def spec_for(self, name: str, ndim: int | None = None) -> P:
        for pat, spec in self.rules:
            if pat.search(name):
                return spec
        return self.default

    def __repr__(self):
        return "ShardingPlan(\n" + "\n".join(
            f"  {pat.pattern!r}: {spec}" for pat, spec in self.rules) + "\n)"


def _axis(mesh_axes, *names):
    """The first of `names` present in the mesh (else None = replicate),
    so one plan serves pure-DP, TP-only, FSDP+TP, ... meshes."""
    for n in names:
        if n in mesh_axes:
            return n
    return None


def llama_sharding_plan(mesh_axes: Sequence[str]) -> ShardingPlan:
    """Megatron-style TP + ZeRO-3 FSDP plan for the Llama family (the JAX
    module's rules)."""
    mp = _axis(mesh_axes, "mp")
    fsdp = _axis(mesh_axes, "fsdp")
    ep = _axis(mesh_axes, "ep")
    return ShardingPlan([
        (r"embed_tokens\.weight$", P(mp, fsdp)),
        (r"(q_proj|k_proj|v_proj|gate_proj|up_proj"
         r"|qkv_proj|gate_up_fused_proj)\.weight$", P(fsdp, mp)),
        (r"(o_proj|down_proj)\.weight$", P(mp, fsdp)),
        (r"lm_head\.weight$", P(fsdp, mp)),
        (r"experts_(gate|up)_weight$", P(ep, fsdp, mp)),
        (r"experts_down_weight$", P(ep, mp, fsdp)),
        (r"router_weight$", P()),
        (r"(norm|layernorm)\.weight$", P()),
    ], default=P())


def fsdp_partition(plan: ShardingPlan, name: str,
                   axis: str = "fsdp") -> int | None:
    """Which dim of parameter `name` the plan shards over `axis`, or None
    when it leaves the parameter off `axis`."""
    for dim, entry in enumerate(plan.spec_for(name)):
        if axis in (entry if isinstance(entry, tuple) else (entry,)):
            return dim
    return None


def batch_spec(mesh_axes: Sequence[str], seq_sharded: bool = True) -> P:
    """Input batch (B, S): batch over dp+fsdp, seq over sp."""
    batch_axes = tuple(a for a in ("dp", "fsdp") if a in mesh_axes)
    sp = "sp" if (seq_sharded and "sp" in mesh_axes) else None
    return P(batch_axes if batch_axes else None, sp)


# the slice each axis still waits for
WAITS = {"ep": "the expert-parallel slice (ROADMAP.md queue 1 item 7.5)"}


def _axes_of(entry):
    return entry if isinstance(entry, tuple) else (entry,)


def check_plan(names, mesh, plan: ShardingPlan):
    """Raise NotImplementedError when `plan` places any of `names` on an
    axis of `mesh` other than 'mp' and 'fsdp' of extent > 1."""
    for name in names:
        for entry in plan.spec_for(name):
            for ax in _axes_of(entry):
                if ax is not None and ax not in ("mp", "fsdp") \
                        and mesh.get_dim_size(ax) > 1:
                    why = ("the context-parallel axis cuts activations "
                           "(distributed/context_parallel.py), never "
                           "parameters" if ax == "sp" else
                           "a pipeline's stages own whole layers "
                           "(parallel/pipeline.py), never a cut of a "
                           "parameter" if ax == "pp" else "it waits for "
                           + WAITS.get(ax, "a later slice"))
                    raise NotImplementedError(
                        f"{name}: spec {plan.spec_for(name)} on mesh "
                        f"{dict(zip(mesh.dim_names, mesh.shape))}: placing "
                        f"a parameter on {ax!r} of extent > 1: {why}")


def refuse_moe(model, mesh, plan=None, pipeline=False):
    """Raise NotImplementedError naming WAITS['ep'] when `model` holds a
    MoE layer and the layout is one the port cannot train it in yet: a
    pipeline (`pipeline`, or a 'pp' axis of extent > 1), an 'sp' axis of
    extent > 1, or `plan` placing a stacked expert weight on any axis of
    extent > 1. The batch axes ('dp', 'fsdp') are fine: the gates take
    their statistics over the Trainer's batch group (nn/moe.py
    `batch_group`)."""
    from paddle_tpu_torch.nn.moe import MoEMLP
    moes = [n for n, m in model.named_modules() if isinstance(m, MoEMLP)]
    if not moes:
        return
    axes = dict(zip(mesh.dim_names, mesh.shape))
    why = None
    if pipeline or axes.get("pp", 1) > 1:
        why = ("under pipeline parallelism, the last stage's loss would "
               "carry no router aux term")
    elif axes.get("sp", 1) > 1:
        why = ("on an 'sp' axis, each rank would gate its sequence shard "
               "alone, out of the JAX package's token order")
    elif plan is not None:
        names = [f"{m}.{leaf}" if m else leaf for m in moes
                 for leaf in ("experts_gate_weight", "experts_up_weight",
                              "experts_down_weight")]
        why = next((f"{name}: spec {plan.spec_for(name)} would cut the "
                    f"stacked expert weights over {ax!r}"
                    for name in names for entry in plan.spec_for(name)
                    for ax in _axes_of(entry)
                    if ax is not None and axes.get(ax, 1) > 1), None)
    if why is not None:
        raise NotImplementedError(
            f"a MoE model on mesh {axes}: {why}; MoE beyond the batch axes "
            f"waits for {WAITS['ep']}, which cuts the expert weights over "
            "'ep', 'mp' and 'fsdp'")


def _on_mp(spec, dim):
    return dim < len(spec) and "mp" in _axes_of(spec[dim])


def _fused_parts(name, cfg):
    """The parts a fused projection's rows hold (each cut on its own)."""
    if name.endswith("qkv_proj"):
        kv = cfg.num_key_value_heads * cfg.head_dim
        return (cfg.hidden_size, kv, kv)
    if name.endswith("gate_up_fused_proj"):
        return (cfg.intermediate_size, cfg.intermediate_size)
    return None


def _check_cut(name, size, n, what, axis="mp"):
    if size % n:
        raise ValueError(f"{name}: {what} {size} does not divide by the "
                         f"{axis} extent {n} (the JAX package pads it; the "
                         "port refuses it)")


def _check_heads(name, cfg, n):
    """The heads a projection cuts must divide over the mp ranks: a shard
    holds whole heads (kv heads for k/v, query heads for q and o, both
    for a fused qkv)."""
    if cfg is None:
        return
    kv = name.endswith(("k_proj", "v_proj", "qkv_proj"))
    if kv:
        hk = cfg.num_key_value_heads
        if hk < n:
            raise ValueError(
                f"{name}: {hk} kv heads for an mp extent of {n}: each rank "
                "needs at least one whole kv head (the JAX package pads the "
                "heads; the port refuses it)")
        _check_cut(name, hk, n, "kv heads")
    if name.endswith(("q_proj", "o_proj", "qkv_proj")):
        _check_cut(name, cfg.num_attention_heads, n, "query heads")


def _mp_cuts(model, plan, n):
    """[(module name, module, kind, parts)] for the modules whose weight
    the plan puts on 'mp'; kind is "column", "row" or "vocab"."""
    from torch import nn
    from paddle_tpu_torch.distributed.fleet.layers import _PARALLEL
    cfg = getattr(model, "config", None)
    cuts = []
    for mname, mod in model.named_modules():
        if isinstance(mod, _PARALLEL):
            continue                      # cut already (distributed_model)
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            spec = plan.spec_for(name)
            if not any(_on_mp(spec, d) for d in range(len(spec))):
                continue
            if isinstance(mod, nn.Linear) and pname == "weight":
                # the JAX (in, out) spec on the port's (out, in) weight
                if _on_mp(spec, 1) and not _on_mp(spec, 0):
                    parts = None if cfg is None \
                        else _fused_parts(mname, cfg)
                    for size in parts or (p.shape[0],):
                        _check_cut(name, size, n, "output dim")
                    _check_heads(mname, cfg, n)
                    cuts.append((mname, mod, "column", parts))
                    continue
                if _on_mp(spec, 0) and not _on_mp(spec, 1):
                    _check_cut(name, p.shape[1], n, "input dim")
                    _check_heads(mname, cfg, n)
                    cuts.append((mname, mod, "row", None))
                    continue
            if isinstance(mod, nn.Embedding) and pname == "weight" \
                    and _on_mp(spec, 0) and not _on_mp(spec, 1):
                _check_cut(name, p.shape[0], n, "vocab")
                cuts.append((mname, mod, "vocab", None))
                continue
            raise NotImplementedError(
                f"{name}: no tensor-parallel layout for spec {spec} on a "
                f"{type(mod).__name__}")
    return cuts


def _fsdp_cuts(model, plan, n):
    """[(module name, parameter name, port dim)] for the parameters the
    plan puts on 'fsdp' (a Linear weight's JAX dim i is the port's dim
    1 - i); each dim must divide by the fsdp extent `n`. Parameters cut
    over 'fsdp' before are left out."""
    from torch import nn
    cuts = []
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            if hasattr(p, "_fsdp_shard"):
                continue
            name = f"{mname}.{pname}" if mname else pname
            spec = plan.spec_for(name)
            on = [i for i in range(len(spec)) if "fsdp" in _axes_of(spec[i])]
            if not on:
                continue
            dim = on[0]
            if isinstance(mod, nn.Linear) and pname == "weight":
                dim = 1 - dim
            _check_cut(name, p.shape[dim], n, f"dim {dim}", "fsdp")
            cuts.append((mname, pname, dim))
    return cuts


def apply_plan(model, mesh, plan: ShardingPlan):
    """Cut every parameter of `model` that the plan puts on the mesh's
    'mp' axis to this rank's shard, in place, the modules becoming
    fleet/layers.py's tensor-parallel layers, then every parameter it
    puts on 'fsdp' (module docstring); what was cut before is left as it
    is. Every process of the world calls it (the groups are formed
    here). Every dim is checked before anything is cut. Returns the
    model."""
    from paddle_tpu_torch.distributed import sharding
    from paddle_tpu_torch.distributed.fleet import layers
    refuse_moe(model, mesh, plan)
    check_plan([n for n, _ in model.named_parameters()], mesh, plan)
    names = mesh.dim_names
    mp = mesh.get_dim_size("mp") if "mp" in names else 1
    fsdp = mesh.get_dim_size("fsdp") if "fsdp" in names else 1
    cuts = _mp_cuts(model, plan, mp) if mp > 1 else []
    fsdp_cuts = _fsdp_cuts(model, plan, fsdp) if fsdp > 1 else []
    if cuts:
        group = mesh.get_group("mp")
        for mname, mod, kind, parts in cuts:
            if kind == "column":
                new = layers.ColumnParallelLinear.from_linear(mod, group,
                                                              parts=parts)
            elif kind == "row":
                new = layers.RowParallelLinear.from_linear(mod, group)
            else:
                new = layers.VocabParallelEmbedding.from_embedding(mod, group)
            parent, _, leaf = mname.rpartition(".")
            setattr(model.get_submodule(parent) if parent else model, leaf,
                    new)
    if fsdp_cuts:
        group = mesh.get_group("fsdp")
        for mname, pname, dim in fsdp_cuts:
            sharding.cut_param(model.get_submodule(mname), pname,
                               sharding.FSDPShard(group, dim, axis="fsdp"))
    return model
