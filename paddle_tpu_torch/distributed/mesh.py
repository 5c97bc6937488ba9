"""ProcessMesh: named meshes of processes.

Counterpart of paddle_tpu/distributed/mesh.py (reference:
python/paddle/distributed/auto_parallel/process_mesh.py:72). The JAX
ProcessMesh wraps a jax Mesh of devices; the port's is a mesh of process
ranks (one process a device) with named axes, and its torch
``DeviceMesh`` (`device_mesh`, built at first use by every process of
the world) holds one process group an axis (`get_group`).

A mesh of ranks is metadata until a group is asked for: slicing
(`get_mesh_with_dim`, indexing) gives sub-meshes as the JAX class does.
`device_mesh`, `init_mesh` and `auto_mesh` need the mesh to cover the
world (every rank once) and raise otherwise.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

__all__ = ["ProcessMesh", "init_mesh", "auto_mesh", "get_mesh", "set_mesh"]

_current_mesh: list["ProcessMesh"] = []
# meshes that built their torch groups (`_release_groups`)
_built: "weakref.WeakSet[ProcessMesh]" = weakref.WeakSet()


def _default_dim_names(ndim):
    return [f"d{i}" for i in range(ndim)]


def _world():
    from paddle_tpu_torch.distributed import collective, env
    collective._ensure_world()
    dev = env.world_device()
    return (torch.distributed.get_world_size(),
            dev.type if dev is not None else "cpu")


class ProcessMesh:
    """An n-D mesh of process ranks with named axes (reference:
    paddle.distributed.ProcessMesh): `mesh` is a (nested) list or array of
    ranks, or `shape` and flat `process_ids`."""

    def __init__(self, mesh=None, dim_names=None, shape=None,
                 process_ids=None):
        if mesh is None:
            if shape is None or process_ids is None:
                raise ValueError(
                    "ProcessMesh needs mesh=, or shape= + process_ids=")
            mesh = np.asarray(process_ids, dtype=np.int64).reshape(shape)
        arr = np.asarray(mesh, dtype=np.int64)
        if dim_names is None:
            dim_names = _default_dim_names(arr.ndim)
        if len(dim_names) != arr.ndim:
            raise ValueError(
                f"{len(dim_names)} dim_names for mesh of rank {arr.ndim}")
        self._ids = arr
        self._dim_names = [str(n) for n in dim_names]
        self._device_mesh = None
        self._groups = {}

    @property
    def shape(self):
        return list(self._ids.shape)

    @property
    def ndim(self):
        return self._ids.ndim

    @property
    def dim_names(self):
        return list(self._dim_names)

    @property
    def mesh(self):
        return self._ids

    @property
    def process_ids(self):
        return [int(i) for i in self._ids.reshape(-1)]

    @property
    def size(self):
        return int(self._ids.size)

    def get_dim_size(self, name):
        return self._ids.shape[self._dim_names.index(name)]

    @property
    def device_mesh(self):
        """The torch DeviceMesh over these ranks (every process of the
        world builds it, in the same order as its other meshes)."""
        if self._device_mesh is None:
            world, device_type = _world()
            if sorted(self.process_ids) != list(range(world)):
                raise ValueError(
                    f"mesh {self.shape} of ranks {self.process_ids} does not "
                    f"cover the world of {world} processes")
            from torch.distributed.device_mesh import DeviceMesh
            self._device_mesh = DeviceMesh(
                device_type, torch.as_tensor(self._ids),
                mesh_dim_names=tuple(self._dim_names))
            _built.add(self)
        return self._device_mesh

    def get_group(self, dim_name):
        """This process's collective.Group along `dim_name`, or, for a
        tuple of names, over those axes together (the ranks that share
        every other coordinate, e.g. ("dp", "fsdp"): the batch group)."""
        names = dim_name if isinstance(dim_name, tuple) else (dim_name,)
        missing = [n for n in names if n not in self._dim_names]
        if missing:
            raise ValueError(f"mesh axes {self._dim_names} have no "
                             f"{missing[0]!r}")
        if len(names) == 1:
            dim_name = names[0]
        g = self._groups.get(dim_name)
        if g is None:
            from paddle_tpu_torch.distributed import collective
            if len(names) == 1:
                g = collective._adopt(self.device_mesh.get_group(dim_name))
            else:
                g = self._joint_group(names)
            self._groups[dim_name] = g
        return g

    def _joint_group(self, names):
        """One group a combination of the other axes' coordinates, every
        process of the world forming each of them in the same order
        (torch's rule); returns this process's."""
        from paddle_tpu_torch.distributed import collective
        self.device_mesh       # the mesh covers the world; its groups first
        axes = [self._dim_names.index(n) for n in names]
        rest = [d for d in range(self.ndim) if d not in axes]
        ids = np.transpose(self._ids, rest + axes).reshape(
            -1, int(np.prod([self._ids.shape[a] for a in axes])))
        me = torch.distributed.get_rank()
        mine = None
        for ranks in ids.tolist():
            g = collective.new_group(ranks)
            if me in ranks:
                mine = g
        _built.add(self)
        return mine

    def coordinate(self, dim_name):
        """This process's index along `dim_name`."""
        rank = torch.distributed.get_rank()
        where = np.argwhere(self._ids == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in mesh {self.shape}")
        return int(where[0][self._dim_names.index(dim_name)])

    def get_mesh_with_dim(self, dim_name, index=None):
        """Project out one mesh axis (reference: process_mesh.py
        get_mesh_with_dim): the mesh with `dim_name` first, or the slice
        at `index` along it."""
        axis = self._dim_names.index(dim_name)
        perm = [axis] + [i for i in range(self.ndim) if i != axis]
        moved = np.transpose(self._ids, perm)
        names = [self._dim_names[i] for i in perm]
        if index is None:
            return ProcessMesh(moved, names)
        sub = moved[index]
        return ProcessMesh(sub, names[1:]) if sub.ndim else ProcessMesh(
            sub.reshape(1), names[:1])

    def __getitem__(self, idx):
        idx_tuple = idx if isinstance(idx, tuple) else (idx,)
        if any(i is Ellipsis for i in idx_tuple):
            n_explicit = len([i for i in idx_tuple if i is not Ellipsis])
            expanded = []
            for i in idx_tuple:
                if i is Ellipsis:
                    expanded.extend([slice(None)] * (self.ndim - n_explicit))
                else:
                    expanded.append(i)
            idx_tuple = tuple(expanded)
        kept = [self._dim_names[d] for d in range(self.ndim)
                if d >= len(idx_tuple)
                or not isinstance(idx_tuple[d], (int, np.integer))]
        sub = self._ids[idx]
        if sub.ndim == 0:
            return ProcessMesh(sub.reshape(1), [self._dim_names[-1]])
        return ProcessMesh(sub, kept)

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and np.array_equal(self._ids, other._ids)
                and self._dim_names == other._dim_names)

    def __hash__(self):
        return hash((self._ids.tobytes(), tuple(self._dim_names)))

    def __enter__(self):
        _current_mesh.append(self)
        return self

    def __exit__(self, *exc):
        _current_mesh.pop()
        return False

    def __repr__(self):
        return (f"ProcessMesh(shape={self.shape}, "
                f"dim_names={self._dim_names})")


def _release_groups():
    """The world is gone (collective.destroy_process_group): every mesh
    drops its torch groups, to be built again on the next world."""
    for m in list(_built):
        m._device_mesh, m._groups = None, {}
    _built.clear()


def _check_world(mesh):
    world, _ = _world()
    if mesh.size != world:
        raise ValueError(f"a mesh of {mesh.size} processes {mesh.shape} for "
                         f"a world of {world}")
    return mesh


def init_mesh(shape_by_name: dict) -> ProcessMesh:
    """A mesh from `{'dp': 2, 'mp': 4}`-style dims over the world's ranks,
    the first axis varying slowest; its size must be the world size."""
    names = list(shape_by_name)
    dims = [int(shape_by_name[n]) for n in names]
    return _check_world(ProcessMesh(
        np.arange(int(np.prod(dims))).reshape(dims), names))


def auto_mesh(*dim_names) -> ProcessMesh:
    """A 1-D mesh over every process of the world."""
    if len(dim_names) != 1:
        raise ValueError("auto_mesh supports a single axis; use init_mesh")
    world, _ = _world()
    return ProcessMesh(np.arange(world), list(dim_names))


def set_mesh(mesh: ProcessMesh):
    _current_mesh.clear()
    _current_mesh.append(mesh)


def get_mesh() -> ProcessMesh | None:
    return _current_mesh[-1] if _current_mesh else None
