"""`fleet`: the hybrid-parallel facade.

Counterpart of paddle_tpu/distributed/fleet/__init__.py (reference:
python/paddle/distributed/fleet/fleet.py:100,167 init/distributed_model/
distributed_optimizer; base/topology.py:61,174). The JAX `init` builds
one jax Mesh over `jax.device_count()` devices; the port's builds the
same five-axis topology and ProcessMesh ("dp", "pp", "fsdp", "sp", "mp",
the topology's order) over the WORLD's processes, one process a device
(distributed/env.py `init_parallel_env` forms the world first; without
it the world is this one process), and sets it as the current mesh.

`distributed_model` cuts the model's parameters by
`llama_sharding_plan` through parallel/plan.py `apply_plan` (with an mp
degree, the projections, embedding and head become fleet/layers.py's
tensor-parallel layers over this rank's shards; with a sharding degree,
the plan's 'fsdp' entries are cut over the 'fsdp' axis,
distributed/sharding.py) and tags `_fleet_plan` / `_fleet_mesh`; the
Trainer on `get_mesh()` with that plan takes such a model as it stands.
`distributed_optimizer` tags the strategy. Tensor parallelism ('mp'),
data parallelism ('dp') and FSDP ('sharding', the mesh's 'fsdp') run; a
'pp' degree above 1 builds its mesh, which parallel/pipeline.py's
PipelineTrainer takes (with 'dp'; the Trainer refuses it), and a 'sep'
degree above 1 one the Trainer refuses until its slice. `worker_index` /
`worker_num` are the rank and the world size.
"""
from __future__ import annotations

import numpy as np

from paddle_tpu_torch.distributed.fleet import layers  # noqa: F401
from paddle_tpu_torch.distributed.fleet import utils  # noqa: F401
from paddle_tpu_torch.distributed.fleet.strategy import \
    DistributedStrategy  # noqa: F401
from paddle_tpu_torch.distributed.fleet.topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup)
from paddle_tpu_torch.distributed.recompute import recompute  # noqa: F401

__all__ = ["init", "DistributedStrategy", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group",
           "get_mesh", "worker_index", "worker_num", "is_first_worker",
           "CommunicateTopology", "HybridCommunicateGroup"]

_fleet_state = {"inited": False, "strategy": None, "hcg": None,
                "mesh": None}


def _world_size():
    import torch.distributed as tdist
    from paddle_tpu_torch.distributed import collective
    collective._ensure_world()
    return tdist.get_world_size()


def init(role_maker=None, is_collective=True, strategy=None,
         log_level="INFO"):
    """(reference: fleet/fleet.py:167) Build the hybrid topology over the
    world. The hybrid_configs degrees multiply up to the world size; a
    dp_degree of 0 or -1 takes what the others leave."""
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.distributed import mesh as mesh_mod

    strategy = strategy or DistributedStrategy()
    n = _world_size()
    hc = strategy.hybrid_configs
    mp = int(hc.get("mp_degree", 1))
    pp = int(hc.get("pp_degree", 1))
    sharding = int(hc.get("sharding_degree", 1))
    sep = int(hc.get("sep_degree", 1))
    dp = int(hc.get("dp_degree", 0))
    if dp <= 0:  # reference convention: -1 (or 0) means auto-infer
        dp = n // max(mp * pp * sharding * sep, 1)
    if dp * mp * pp * sharding * sep != n:
        raise ValueError(
            f"hybrid degrees dp={dp} x sharding={sharding} x pp={pp} x "
            f"sep={sep} x mp={mp} != world size {n}")

    topo = CommunicateTopology(
        hybrid_group_names=["data", "pipe", "sharding", "sep", "model"],
        dims=[dp, pp, sharding, sep, mp])
    hcg = HybridCommunicateGroup(topo, global_rank=env.get_rank())
    # one mesh, the topology's axis order: rank = the topology's rank
    mesh = mesh_mod.ProcessMesh(
        np.arange(n).reshape(dp, pp, sharding, sep, mp).tolist(),
        dim_names=["dp", "pp", "fsdp", "sp", "mp"])
    mesh_mod.set_mesh(mesh)
    _fleet_state.update(inited=True, strategy=strategy, hcg=hcg, mesh=mesh)
    return None


def _require_init():
    if not _fleet_state["inited"]:
        raise RuntimeError("call fleet.init(...) first")


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    _require_init()
    return _fleet_state["hcg"]


def get_mesh():
    _require_init()
    return _fleet_state["mesh"]


def worker_index():
    from paddle_tpu_torch.distributed import env
    return env.get_rank()


def worker_num():
    from paddle_tpu_torch.distributed import env
    return env.get_world_size()


def is_first_worker():
    return worker_index() == 0


def distributed_model(model):
    """(reference: fleet/model.py:141) Cut the model's parameters onto the
    fleet mesh by `llama_sharding_plan` (parallel/plan.py `apply_plan`, in
    place) and tag the plan and the mesh; returns the model."""
    _require_init()
    from paddle_tpu_torch.parallel.plan import apply_plan, llama_sharding_plan
    mesh = _fleet_state["mesh"]
    plan = llama_sharding_plan(mesh.dim_names)
    model._fleet_plan = plan
    model._fleet_mesh = mesh
    apply_plan(model, mesh, plan)
    return model


def distributed_optimizer(optimizer, strategy=None):
    """(reference: fleet/fleet.py distributed_optimizer) Tag the strategy;
    the port's optimizer reads each parameter's cut itself (its global
    norms add the pieces' squares over the mp and fsdp groups)."""
    _require_init()
    optimizer._fleet_strategy = strategy or _fleet_state["strategy"]
    return optimizer
