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

A dim that does not divide by the mp extent, and fewer kv (or query)
heads than the mp extent, raise ValueError naming the parameter (the JAX
package pads such a dim). A parameter placed on 'fsdp', 'sp', 'pp' or
'ep' of extent > 1 raises NotImplementedError naming the slice it waits
for; axes of extent 1 replicate, as the JAX plan does through `_axis`.
"""
from __future__ import annotations

import re
from typing import Sequence

from paddle_tpu_torch.distributed.placement import PartitionSpec as P

__all__ = ["ShardingPlan", "llama_sharding_plan", "fsdp_partition",
           "batch_spec", "check_plan", "apply_plan", "WAITS"]


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
WAITS = {"fsdp": "the FSDP slice (distributed/sharding.py)",
         "sp": "the context-parallel slice (distributed/context_parallel.py)",
         "pp": "the pipeline slice (distributed/pipeline.py)",
         "ep": "the expert-parallel (MoE) slice"}


def _axes_of(entry):
    return entry if isinstance(entry, tuple) else (entry,)


def check_plan(names, mesh, plan: ShardingPlan):
    """Raise NotImplementedError when `plan` places any of `names` on an
    axis of `mesh` other than 'mp' of extent > 1."""
    for name in names:
        for entry in plan.spec_for(name):
            for ax in _axes_of(entry):
                if ax is not None and ax != "mp" \
                        and mesh.get_dim_size(ax) > 1:
                    raise NotImplementedError(
                        f"{name}: spec {plan.spec_for(name)} on mesh "
                        f"{dict(zip(mesh.dim_names, mesh.shape))}: placing "
                        f"a parameter on {ax!r} of extent > 1 waits for "
                        f"{WAITS.get(ax, 'a later slice')}")


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


def _check_cut(name, size, n, what):
    if size % n:
        raise ValueError(f"{name}: {what} {size} does not divide by the mp "
                         f"extent {n} (the JAX package pads it; the port "
                         "refuses it)")


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


def apply_plan(model, mesh, plan: ShardingPlan):
    """Cut every parameter of `model` that the plan puts on the mesh's
    'mp' axis to this rank's shard, in place, the modules becoming
    fleet/layers.py's tensor-parallel layers (module docstring); modules
    cut before are left as they are. Every process of the world calls it
    (the mp group is formed here). Returns the model."""
    from paddle_tpu_torch.distributed.fleet import layers
    check_plan([n for n, _ in model.named_parameters()], mesh, plan)
    if "mp" not in mesh.dim_names or mesh.get_dim_size("mp") <= 1:
        return model
    cuts = _mp_cuts(model, plan, mesh.get_dim_size("mp"))
    if not cuts:
        return model
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
        setattr(model.get_submodule(parent) if parent else model, leaf, new)
    return model
