"""Hybrid-parallel topology math.

A copy of paddle_tpu/distributed/fleet/topology.py (reference:
python/paddle/distributed/fleet/base/topology.py:61 CommunicateTopology,
:174 HybridCommunicateGroup): pure index arithmetic, so rank-placement
code ports. The `get_*_group()` accessors return rank lists, as in the
JAX module; the torch process groups of the axes come from the mesh that
`fleet.init` builds (`fleet.get_mesh().get_group("mp")`). Without
`global_rank`, HybridCommunicateGroup takes this process's rank
(distributed/env.py `get_rank`).
"""
from __future__ import annotations

import collections
import itertools
from functools import reduce

__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]


class CommunicateTopology:
    def __init__(self, hybrid_group_names=["data", "pipe", "sharding",
                                           "sep", "model"],
                 dims=[1, 1, 1, 1, 1]):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = collections.namedtuple("Coordinate",
                                                 self._parallel_names)
        self._world_size = reduce(lambda x, y: x * y, self._dims, 1)
        ranges = [range(d) for d in self._dims]
        all_coord = [self.coordinate(*x)
                     for x in itertools.product(*ranges)]
        self._coord2rank = dict(zip(all_coord, range(len(all_coord))))
        self._rank2coord = {r: c for c, r in self._coord2rank.items()}

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world_size

    def get_rank(self, **args):
        key = self.coordinate(**args)
        return self._coord2rank[key]

    def get_coord(self, rank):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        ranks = sorted(r for c, r in self._coord2rank.items()
                       if c[axis] == index)
        return ranks

    def get_comm_list(self, axis_name):
        """All groups along `axis_name`: list of rank-lists (reference:
        topology.py get_comm_list)."""
        axis = self._parallel_names.index(axis_name)
        other_ranges = [range(d) for i, d in enumerate(self._dims)
                        if i != axis]
        groups = []
        for other in itertools.product(*other_ranges):
            ranks = []
            for k in range(self._dims[axis]):
                coord = list(other)
                coord.insert(axis, k)
                ranks.append(self._coord2rank[self.coordinate(*coord)])
            groups.append(ranks)
        return groups

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = self.get_coord(global_rank)
        tf = coord._replace(**kwargs)._asdict()
        return self.get_rank(**tf)


class HybridCommunicateGroup:
    """(reference: topology.py:174) per-axis group membership for this
    process's rank."""

    def __init__(self, topology: CommunicateTopology, global_rank=None):
        from paddle_tpu_torch.distributed import env
        self._topo = topology
        self.global_rank = (env.get_rank() if global_rank is None
                            else global_rank)
        self.nranks = topology.world_size()
        self._dp_degree = topology.get_dim("data")
        self._pp_degree = topology.get_dim("pipe")
        self._sharding_degree = topology.get_dim("sharding")
        self._sep_degree = topology.get_dim("sep")
        self._mp_degree = topology.get_dim("model")

    def _axis_info(self, name):
        coord = self._topo.get_coord(self.global_rank)
        idx = getattr(coord, name)
        # ranks that share every coordinate except `name`
        others = {k: v for k, v in coord._asdict().items() if k != name}
        group = sorted(
            self._topo.get_rank(**{**others, name: k})
            for k in range(self._topo.get_dim(name)))
        return idx, group

    # -- degrees -----------------------------------------------------------
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    # -- ranks within each axis --------------------------------------------
    def get_data_parallel_rank(self):
        return self._axis_info("data")[0]

    def get_model_parallel_rank(self):
        return self._axis_info("model")[0]

    def get_stage_id(self):
        return self._axis_info("pipe")[0]

    get_pipe_parallel_rank = get_stage_id

    def get_sharding_parallel_rank(self):
        return self._axis_info("sharding")[0]

    def get_sep_parallel_rank(self):
        return self._axis_info("sep")[0]

    # -- group rank lists ----------------------------------------------------
    def get_data_parallel_group(self):
        return self._axis_info("data")[1]

    def get_model_parallel_group(self):
        return self._axis_info("model")[1]

    def get_pipe_parallel_group(self):
        return self._axis_info("pipe")[1]

    def get_sharding_parallel_group(self):
        return self._axis_info("sharding")[1]

    def get_sep_parallel_group(self):
        return self._axis_info("sep")[1]

    def get_data_parallel_group_src_rank(self):
        return self.get_data_parallel_group()[0]

    def get_model_parallel_group_src_rank(self):
        return self.get_model_parallel_group()[0]

    def topology(self):
        return self._topo

    # pipeline neighbors (reference: topology.py _get_p2p_next/prev_rank)
    def get_p2p_groups(self):
        stage = self.get_stage_id()
        group = self.get_pipe_parallel_group()
        nxt = group[(stage + 1) % len(group)]
        prv = group[(stage - 1) % len(group)]
        return prv, nxt

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1
