"""ZeRO / FSDP: parameters cut over a data-parallel group, gathered at use.

Counterpart of paddle_tpu/distributed/sharding.py (reference:
python/paddle/distributed/sharding/group_sharded.py:40
group_sharded_parallel / save_group_sharded_model; the stage wrappers
fleet/meta_parallel/sharding/group_sharded_stage{2,3}.py). The JAX
package shards a parameter over the 'fsdp' (or 'dp') mesh axis and XLA
all-gathers it at use and reduce-scatters its gradient. The port is
multi-controller, one process a device, so it issues those collectives
itself, as parallel/plan.py `apply_plan` and fleet/layers.py do for 'mp':

- a cut parameter keeps only this rank's contiguous piece along one dim
  (`p.data` cut in place: the Parameter object stays, so an optimizer
  built over it keeps it, and its gradient and Adam moments are the
  piece's), and carries `_fsdp_shard`, an `FSDPShard` (the group, the
  dim, the mesh axis);
- the module that owns it gathers it for its forward: a forward
  pre-hook puts the whole tensor, `gather_param`'s autograd Function
  (forward: all-gather along the dim; backward: reduce-scatter of the
  whole gradient back to the piece, summed over the group), in the
  module's place of the piece for the call and a forward hook puts the
  piece back. A read outside the module's own forward (the tied head,
  the blockwise loss's head weight, the fused RMSNorm's weight) goes
  through `gathered(module, name)`.
- a module whose weight the FSDP overlap ring carries (parallel/
  overlap.py `linear` sets `_fsdp_ring` for the call) does not gather
  it: the ring streams its pieces under the products instead.

Under `recompute` a checkpointed layer's gathers run again in the
backward's recomputation, ZeRO-3's re-gather, and the forward keeps only
the pieces. Without recompute the gathered weight is saved for its
product's backward and lives until then.

A parameter may be cut over 'mp' first (`_mp_shard`) and then over
'fsdp' on another dim; `cuts_of`, `gather_whole` and `cut_whole` take
both records, in cut order, for checkpoints and norms.

`group_sharded_parallel(model, optimizer, level, ...)` follows the JAX
rules: the level is "os", "os_g" or "p_g_os" (ValueError otherwise); it
needs a current mesh (distributed/mesh.py `get_mesh`, else
RuntimeError); its axis is 'fsdp' if that has extent > 1, else 'dp',
else the largest axis. At "p_g_os" every parameter of ndim > 0 is cut
along its largest dim that divides by the axis (a parameter with none
stays whole and only its gradient is summed over the group, which GSPMD
does for a replicated one). The port's models are built frozen for
serving (the Trainer makes them trainable), so every parameter counts as
trainable. At "os" and "os_g" nothing is placed: the level is a hint
that no code reads, in both packages. The ranks' gradients are SUMMED
over the group: an eager step (`loss.backward(); opt.step()`) with each
rank's loss summed over its own rows of the global batch is the JAX
step on the whole batch (Paddle's stage 2/3 wrappers scale by
1/nranks instead). `_sharding_level`, `_sharding_axis` and
`_sharding_offload` are set on the model and the optimizer; the Trainer
reads `_sharding_offload` as `TrainStepConfig.offload_opt_state`.

`save_group_sharded_model(model, output, optimizer=None)` writes the
whole weights to `output + ".pdparams"` and the optimizer's state to
`output + ".pdopt"` through framework/io_utils.py `save` (every rank
gathers; rank 0 of the world writes).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from paddle_tpu_torch.distributed import collective
from paddle_tpu_torch.distributed.fleet.layers import (MPShard, _all_reduced,
                                                       gather_full)

__all__ = ["group_sharded_parallel", "save_group_sharded_model",
           "FSDPShard", "gather_param", "gathered", "cut_param", "cuts_of",
           "gather_whole", "cut_whole", "whole_shape", "summed_axes"]

_LEVELS = ("os", "os_g", "p_g_os")


@dataclass(frozen=True)
class FSDPShard(MPShard):
    """A parameter cut over a data-parallel group: rank r of `group`
    holds the r-th of its equal contiguous pieces along `dim` (None: the
    parameter stays whole; only its gradient is summed over the group).
    `axis` is the mesh axis the group runs along."""
    axis: str = "fsdp"

    def local(self, full):
        return full if self.dim is None else super().local(full)


# ---------------------------------------------------------------------------
# the gather with a reduce-scatter gradient
# ---------------------------------------------------------------------------

def _reduce_scattered(g, cut):
    chunks = [c.contiguous() for c in g.chunk(cut.group.nranks, cut.dim)]
    return collective.reduce_scatter(None, chunks, group=cut.group)


class _GatherShard(torch.autograd.Function):
    """Forward: the whole tensor, every rank's piece gathered along the
    cut's dim. Backward: the whole gradient summed over the group, this
    rank keeping its piece (a reduce-scatter); for a whole parameter
    (dim None), identity forward and an all-reduce backward."""

    @staticmethod
    def forward(ctx, piece, cut):
        ctx.cut = cut
        if cut.dim is None:
            return piece.view_as(piece)
        return gather_full(piece, cut)

    @staticmethod
    def backward(ctx, g):
        cut = ctx.cut
        if cut.dim is None:
            return _all_reduced(g, cut.group), None
        return _reduce_scattered(g, cut), None


def gather_param(piece, cut: FSDPShard):
    """The whole tensor from this rank's `piece` (autograd: the gradient
    flows back reduce-scattered); a collective of the cut's group."""
    return _GatherShard.apply(piece, cut)


def _pre_forward(module, args):
    cuts = module._fsdp_cuts
    saved = {name: module._parameters[name] for name in cuts}
    module._fsdp_saved.append(saved)
    # a weight the FSDP overlap ring carries stays cut (parallel/overlap.py)
    ring = getattr(module, "_fsdp_ring", None)
    for name, cut in cuts.items():
        if ring is None or name != "weight":
            module._parameters[name] = gather_param(saved[name], cut)


def _post_forward(module, args, out):
    if module._fsdp_saved:
        module._parameters.update(module._fsdp_saved.pop())


def _install(module):
    if not hasattr(module, "_fsdp_cuts"):
        module._fsdp_cuts = {}
        module._fsdp_saved = []
        module.register_forward_pre_hook(_pre_forward)
        module.register_forward_hook(_post_forward, always_call=True)


def cut_param(module, name, cut: FSDPShard):
    """Cut `module`'s parameter `name` to this rank's piece, in place, and
    have the module gather it for its forward."""
    p = module._parameters[name]
    with torch.no_grad():
        p.data = cut.local(p.data).clone(
            memory_format=torch.contiguous_format)
    p._fsdp_shard = cut
    _install(module)
    module._fsdp_cuts[name] = cut
    return p


def gathered(module, name="weight"):
    """`module`'s tensor `name`, whole: gathered (with the reduce-scatter
    gradient) when it is cut and the module's forward is not running,
    else as it stands. For reads outside the module's own forward."""
    cut = getattr(module, "_fsdp_cuts", {}).get(name)
    if cut is None or module._fsdp_saved:
        return getattr(module, name)
    return gather_param(module._parameters[name], cut)


# ---------------------------------------------------------------------------
# nested cuts: mp, then fsdp
# ---------------------------------------------------------------------------

def cuts_of(p):
    """The records of the cuts of `p` that hold a piece, in cut order:
    its `_mp_shard`, then its `_fsdp_shard`."""
    return tuple(c for c in (getattr(p, "_mp_shard", None),
                             getattr(p, "_fsdp_shard", None))
                 if c is not None and c.dim is not None)


def gather_whole(local, cuts):
    """The whole tensor from every rank's `local` piece of a tensor cut by
    `cuts` (in cut order): gathered over the last cut first (a collective
    of each cut's group)."""
    for c in reversed(cuts):
        local = gather_full(local, c)
    return local


def cut_whole(full, cuts):
    """This rank's piece of the whole tensor `full` under `cuts`."""
    for c in cuts:
        full = c.local(full)
    return full


def whole_shape(local, cuts):
    shape = list(local.shape)
    for c in cuts:
        shape[c.dim] *= c.group.nranks
    return shape


def summed_axes(p):
    """The mesh axes over which the gather of `p` (or the overlap ring
    that carries it) already sums its gradient (the Trainer's reducer
    leaves them out)."""
    cut = getattr(p, "_fsdp_shard", None)
    return () if cut is None else (cut.axis,)


# ---------------------------------------------------------------------------
# the Paddle facade
# ---------------------------------------------------------------------------

def _axis_of(mesh):
    """'fsdp' if it has extent > 1, else 'dp', else the largest axis."""
    shape = dict(zip(mesh.dim_names, mesh.shape))
    for a in ("fsdp", "dp"):
        if shape.get(a, 1) > 1:
            return a
    return max(mesh.dim_names, key=lambda a: shape[a])


def group_sharded_parallel(model, optimizer, level, scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """(reference: group_sharded.py:40) Shard the model's parameters over
    the current mesh's data-parallel axis at "p_g_os" (module docstring);
    returns (model, optimizer, scaler). `group`, `sync_buffers`,
    `buffer_max_size`, `segment_size`, `sync_comm`, `dp_group` and
    `exclude_layer` are the reference's signature, accepted and unused."""
    if level not in _LEVELS:
        raise ValueError(f"level must be one of {_LEVELS}, got {level!r}")
    from paddle_tpu_torch.distributed.mesh import get_mesh
    mesh = get_mesh()
    if mesh is None:
        raise RuntimeError(
            "group_sharded_parallel needs an active mesh: call "
            "dist.init_mesh({'dp': N}) with set_mesh, or fleet.init first")
    axis = _axis_of(mesh)
    n = mesh.get_dim_size(axis)
    if level == "p_g_os" and n > 1:
        grp = mesh.get_group(axis)
        for mod in model.modules():
            for name, p in list(mod.named_parameters(recurse=False)):
                if hasattr(p, "_fsdp_shard"):
                    continue                       # cut before
                if p.dim() == 0:
                    cut = FSDPShard(grp, None, axis=axis)
                else:
                    dims = [(d, s) for d, s in enumerate(p.shape)
                            if s % n == 0]
                    dim = max(dims, key=lambda ds: ds[1])[0] if dims \
                        else None
                    cut = FSDPShard(grp, dim, axis=axis)
                cut_param(mod, name, cut)
    for obj in (model, optimizer):
        obj._sharding_level = level
        obj._sharding_offload = bool(offload)
    model._sharding_axis = axis
    return model, optimizer, scaler


def _opt_state_dict(optimizer):
    """The optimizer's state, every cut tensor gathered whole, as
    {name: {moment1, moment2, beta1_pow, beta2_pow[, master]}}."""
    by_name = dict(zip(optimizer._names, optimizer._params))
    optimizer.sync_state()
    out = {}
    for name, st in optimizer.state.items():
        cuts = cuts_of(by_name[name])
        out[name] = {k: (gather_whole(v.to(by_name[name].device), cuts)
                         if cuts and v.dim() else v).detach().cpu()
                     for k, v in st.items()}
    return out


def save_group_sharded_model(model, output, optimizer=None):
    """(reference: group_sharded.py save_group_sharded_model) The whole
    weights to `output`.pdparams and the optimizer's state to
    `output`.pdopt; every rank gathers, rank 0 of the world writes."""
    from paddle_tpu_torch.framework import io_utils
    sd = {}
    for name, p in model.state_dict(keep_vars=True).items():
        cuts = cuts_of(p)
        sd[name] = (gather_whole(p.detach(), cuts) if cuts
                    else p.detach()).cpu()
    opt = None if optimizer is None else _opt_state_dict(optimizer)
    import torch.distributed as tdist
    if tdist.is_initialized() and tdist.get_rank() != 0:
        return
    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
    io_utils.save(sd, output + ".pdparams")
    if opt is not None:
        io_utils.save(opt, output + ".pdopt")
