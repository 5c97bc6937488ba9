"""DistributedStrategy.

A copy of paddle_tpu/distributed/fleet/strategy.py (reference:
paddle/fluid/framework/distributed_strategy.proto:359 + python
fleet.DistributedStrategy): one plain typed config object in place of
the protobuf, with the same fields and defaults. An unknown attribute
raises AttributeError, like the reference's proto-backed checks;
`hybrid_configs` merges into the defaults instead of replacing them.
"""
from __future__ import annotations


class DistributedStrategy:
    _FIELDS = {
        # feature toggles (proto: distributed_strategy.proto)
        "amp": False, "amp_configs": dict,
        "recompute": False, "recompute_configs": dict,
        "sharding": False, "sharding_configs": dict,
        "pipeline": False, "pipeline_configs": dict,
        "tensor_parallel": False, "tensor_parallel_configs": dict,
        "hybrid_configs": dict,
        "gradient_merge": False, "gradient_merge_configs": dict,
        "lamb": False, "lamb_configs": dict,
        "dgc": False, "localsgd": False, "fp16_allreduce": False,
        "find_unused_parameters": False,
        "fuse_all_reduce_ops": True,
        "fuse_grad_size_in_MB": 32,
        "nccl_comm_num": 1,
        "gradient_scale_configs": dict,
        "heter_ccl_mode": False,
        "without_graph_optimization": True,
    }

    def __init__(self):
        for k, v in self._FIELDS.items():
            object.__setattr__(self, k, {} if v is dict else v)
        # hybrid degrees default: everything 1 -> pure DP
        self.hybrid_configs = {"dp_degree": 0, "mp_degree": 1,
                               "pp_degree": 1, "sharding_degree": 1,
                               "sep_degree": 1}

    def __setattr__(self, k, v):
        if k not in self._FIELDS:
            raise AttributeError(
                f"DistributedStrategy has no field {k!r} "
                f"(known: {sorted(self._FIELDS)})")
        if k == "hybrid_configs" and isinstance(v, dict):
            merged = dict(getattr(self, "hybrid_configs", {}))
            merged.update(v)
            v = merged
        object.__setattr__(self, k, v)

    def __repr__(self):
        on = [k for k in self._FIELDS
              if isinstance(getattr(self, k), bool) and getattr(self, k)]
        return (f"DistributedStrategy(hybrid={self.hybrid_configs}, "
                f"enabled={on})")
