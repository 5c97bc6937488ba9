"""Semi-auto parallel API: shard_tensor / reshard / shard_layer /
shard_optimizer / dtensor_from_fn / unshard_dtensor.

Counterpart of paddle_tpu/distributed/api.py (reference:
python/paddle/distributed/auto_parallel/api.py:126 shard_tensor, :304
reshard, :403 shard_layer, :736 shard_optimizer; DistTensor at
paddle/phi/core/distributed/auto_parallel/dist_tensor.h:39). The JAX
module's "DistTensor" is a jax.Array with a NamedSharding; the port's is
a ``torch.distributed.tensor.DTensor`` on the ProcessMesh's torch
DeviceMesh (distributed/mesh.py `device_mesh`), its placements
placement.py's converted by `to_torch_placements`. Every process of the
mesh's world calls these functions with the same arguments (the
multi-controller rule); each holds its own local shard.

- `shard_tensor` with a Partial placement keeps the JAX rule: the value
  is divided by the ranks along the Partial axes, so the implicit sum is
  the original.
- `reshard` redistributes (torch picks the collective); a Partial target
  raises NotImplementedError, as in JAX.
- `shard_layer` swaps each parameter of a layer for a DTensor parameter
  (default: replicated; `shard_fn(name, sublayer, mesh)` decides), and
  `input_fn` / `output_fn` become forward hooks.
- `shard_optimizer` makes the port's Adam / AdamW moments (and f32
  masters) follow their parameters' placements: DTensors of the same
  mesh and placements, created with the state.
- `dtensor_from_fn` calls `fn` on every rank and keeps the rank's shard
  (the JAX module compiles `fn` with output shardings so each device
  computes only its shard; torch has no such lowering).
- The JAX module's `Tensor.placements` / `process_mesh` / `is_dist`
  patches are module functions here (the port has no Tensor class of its
  own): `placements(t)`, `process_mesh(t)`, `is_dist(t)`.

The model path of tensor parallelism does not go through DTensor: the
kernels launch on dense tensors, so distributed/fleet/layers.py keeps
plain local shards.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.distributed.mesh import ProcessMesh, get_mesh
from paddle_tpu_torch.distributed.placement import (Partial, Replicate,
                                                    from_torch_placements,
                                                    to_torch_placements)

__all__ = ["shard_tensor", "reshard", "shard_layer", "shard_optimizer",
           "dtensor_from_fn", "unshard_dtensor", "placements",
           "process_mesh", "is_dist"]

# ProcessMesh of each torch DeviceMesh these functions placed a tensor on
_meshes: dict = {}


def _mesh(mesh):
    mesh = mesh or get_mesh()
    if mesh is None:
        raise ValueError("no mesh: pass one or enter a ProcessMesh context")
    _meshes[id(mesh.device_mesh)] = mesh
    return mesh


def _dtensor():
    from torch.distributed import tensor
    return tensor


def _full(placements, mesh):
    return list(placements if placements is not None
                else [Replicate()] * mesh.ndim)


def shard_tensor(data, mesh: ProcessMesh | None = None, placements=None,
                 dtype=None, place=None, stop_gradient=None):
    """Place `data` (a tensor or array, the whole value on every rank) on
    `mesh` with `placements` (reference: auto_parallel/api.py:126); a
    DTensor holding this rank's shard. `stop_gradient=False` makes it a
    leaf that requires a gradient."""
    tdt = _dtensor()
    mesh = _mesh(mesh)
    t = data.detach() if isinstance(data, torch.Tensor) \
        else torch.as_tensor(data)
    if dtype is not None:
        t = t.to(dtype)
    pls = _full(placements, mesh)
    npartial = 1
    for mesh_dim, p in enumerate(pls):
        if isinstance(p, Partial):
            npartial *= mesh.shape[mesh_dim]
    if npartial > 1:
        t = t / npartial
    dm = mesh.device_mesh
    t = t.to(dm.device_type)
    # Shard / Replicate through torch; a Partial axis holds the divided
    # value on every rank
    plain = [Replicate() if isinstance(p, Partial) else p for p in pls]
    local = tdt.distribute_tensor(t, dm, to_torch_placements(plain)) \
        .to_local()
    out = tdt.DTensor.from_local(local, dm, to_torch_placements(pls),
                                 run_check=False, shape=t.shape,
                                 stride=t.stride())
    if stop_gradient is False or (stop_gradient is None and isinstance(
            data, torch.Tensor) and data.requires_grad):
        out = out.detach().requires_grad_(True)
    return out


def reshard(dist_tensor, mesh: ProcessMesh | None = None, placements=None):
    """Redistribute a DTensor (reference: auto_parallel/api.py:304)."""
    mesh = _mesh(mesh)
    pls = _full(placements, mesh)
    if any(isinstance(p, Partial) for p in pls):
        raise NotImplementedError(
            "reshard to Partial is not supported (Partial is a state a "
            "reduction leaves, not a layout to ask for)")
    return dist_tensor.redistribute(mesh.device_mesh,
                                    to_torch_placements(pls))


def shard_layer(layer, process_mesh: ProcessMesh, shard_fn=None,
                input_fn=None, output_fn=None):
    """Put every parameter of `layer` on `process_mesh` (reference:
    auto_parallel/api.py:403). `shard_fn(name, sublayer, mesh)` decides a
    sublayer's placements (it may call `shard_tensor` and set the
    parameters); the default replicates. `input_fn(inputs, mesh)` and
    `output_fn(outputs, mesh)` become forward hooks."""
    mesh = _mesh(process_mesh)

    def _replicate(name, sublayer, m):
        for pname, p in list(sublayer.named_parameters(recurse=False)):
            if not is_dist(p):
                setattr(sublayer, pname, torch.nn.Parameter(
                    shard_tensor(p, m, [Replicate()] * m.ndim),
                    requires_grad=p.requires_grad))

    fn = shard_fn or _replicate
    for name, sub in list(layer.named_modules()):
        fn(name, sub, mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda lyr, inputs: input_fn(inputs, mesh))
    if output_fn is not None:
        layer.register_forward_hook(
            lambda lyr, inputs, outputs: output_fn(outputs, mesh))
    return layer


def shard_optimizer(optimizer, shard_fn=None):
    """Optimizer states that follow their parameters' placements
    (reference: auto_parallel/api.py:736): each state tensor of a DTensor
    parameter's shape is created as a DTensor of the same mesh and
    placements (`shard_fn(param, placements)` may pick others), so its
    memory is cut as the parameter's is."""
    tdt = _dtensor()
    orig = optimizer._state_for

    def _state_for(name, p):
        fresh = name not in optimizer.state
        st = orig(name, p)
        if fresh and isinstance(p, tdt.DTensor):
            pls = p.placements if shard_fn is None \
                else tuple(shard_fn(p, p.placements))
            for k, v in list(st.items()):
                if not isinstance(v, tdt.DTensor) and v.shape == p.shape:
                    st[k] = tdt.distribute_tensor(v, p.device_mesh, pls)
        return st

    optimizer._state_for = _state_for
    return optimizer


def dtensor_from_fn(fn, mesh: ProcessMesh, placements, *args, **kwargs):
    """A DTensor of `fn(*args, **kwargs)` on `mesh` with `placements`
    (reference: api.py dtensor_from_fn); every rank calls `fn` and keeps
    its shard."""
    return shard_tensor(fn(*args, **kwargs), mesh, placements,
                        stop_gradient=True)


def unshard_dtensor(dist_tensor):
    """The whole value of a DTensor as a plain tensor on every rank
    (reference: api.py unshard_dtensor); any other tensor as it is."""
    tdt = _dtensor()
    if isinstance(dist_tensor, tdt.DTensor):
        return dist_tensor.full_tensor()
    return dist_tensor


def is_dist(t):
    """Whether `t` is a DTensor (the JAX `Tensor.is_dist`)."""
    return isinstance(t, _dtensor().DTensor)


def placements(t):
    """`t`'s placements as placement.py's (None for a plain tensor)."""
    return from_torch_placements(t.placements) if is_dist(t) else None


def process_mesh(t):
    """The ProcessMesh a DTensor lies on (None for a plain tensor)."""
    if not is_dist(t):
        return None
    dm = t.device_mesh
    pm = _meshes.get(id(dm))
    if pm is None:
        pm = ProcessMesh(dm.mesh.tolist(), list(dm.mesh_dim_names)
                         if dm.mesh_dim_names else None)
    return pm
