"""Distributed training runtime of the port: the process group and its
collectives (`env`, `collective`), meshes and placements (`mesh`,
`placement`), the semi-auto parallel API over DTensor (`api`: shard_tensor,
reshard, shard_layer, shard_optimizer, ...), data parallelism
(`parallel`: DataParallel and the gradient reducer; `launch`: the job
launcher), tensor parallelism (`fleet`: init, the hybrid topology and
strategy, the Megatron layers, distributed_model; imported at first
use, as the JAX package's), ZeRO / FSDP (`sharding`:
group_sharded_parallel and the gather with a reduce-scatter gradient;
imported at first use too), context parallelism (`context_parallel`: the
flash-kernel ring and Ulysses over 'sp'; imported at first use too),
pipeline parallelism (`pipeline`: PipelineTrainer over 'pp', a
re-export of parallel/pipeline.py; imported at first use too),
checkpoints
(`checkpoint`, `async_checkpoint`), fault injection (`chaos`), retries
(`retries`), the rendezvous store (`store`), hang detection
(`watchdog`), restart and relaunch (`elastic`) and the training anomaly
sentry (`sentry`)."""
from paddle_tpu_torch.distributed import watchdog
from paddle_tpu_torch.distributed.api import (dtensor_from_fn, reshard,
                                              shard_layer, shard_optimizer,
                                              shard_tensor, unshard_dtensor)
from paddle_tpu_torch.distributed.collective import (
    Group, ReduceOp, all_gather, all_reduce, alltoall, barrier, broadcast,
    destroy_process_group, get_group, new_group, pmean, ppermute,
    ppermute_start, psum, recv, reduce, reduce_scatter, scatter, send)
from paddle_tpu_torch.distributed.elastic import (
    ELASTIC_AUTO_PARALLEL_EXIT_CODE, ElasticManager, ElasticSupervisor,
    HaltTraining, StoreHeartbeat, run_resilient, safe_barrier)
from paddle_tpu_torch.distributed.env import (ParallelEnv, get_rank,
                                              get_world_size,
                                              init_parallel_env,
                                              is_initialized,
                                              parallel_device_count)
from paddle_tpu_torch.distributed.mesh import (ProcessMesh, auto_mesh,
                                               get_mesh, init_mesh, set_mesh)
from paddle_tpu_torch.distributed.parallel import DataParallel
from paddle_tpu_torch.distributed.placement import (Partial, Placement,
                                                    Replicate, Shard,
                                                    placements_to_spec,
                                                    spec_to_placements)
from paddle_tpu_torch.distributed.sentry import (SentryConfig,
                                                 SentryQuarantine,
                                                 TrainingSentry)
from paddle_tpu_torch.distributed.store import (Store, StoreConnectionError,
                                                StoreError, StoreKeyError,
                                                StoreTimeoutError, TCPStore)
from paddle_tpu_torch.distributed.watchdog import CommTimeoutError

all_to_all = alltoall   # the torch-style alias the reference also exposes


def __getattr__(name):
    if name in ("fleet", "sharding", "context_parallel", "pipeline"):
        import importlib
        mod = importlib.import_module(f"paddle_tpu_torch.distributed.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(
        f"module 'paddle_tpu_torch.distributed' has no attribute {name!r}")

__all__ = ["watchdog", "ElasticManager", "ElasticSupervisor",
           "StoreHeartbeat", "HaltTraining", "safe_barrier", "run_resilient",
           "ELASTIC_AUTO_PARALLEL_EXIT_CODE", "SentryConfig",
           "SentryQuarantine", "TrainingSentry", "Store", "TCPStore",
           "StoreError", "StoreConnectionError", "StoreTimeoutError",
           "StoreKeyError", "CommTimeoutError",
           "Placement", "Replicate", "Shard", "Partial", "placements_to_spec",
           "spec_to_placements", "ProcessMesh", "init_mesh", "auto_mesh",
           "get_mesh", "set_mesh", "ReduceOp", "Group", "new_group",
           "get_group", "destroy_process_group", "all_reduce", "all_gather",
           "broadcast", "reduce", "reduce_scatter", "alltoall", "all_to_all",
           "scatter", "barrier", "send", "recv", "psum", "pmean", "ppermute",
           "ppermute_start",
           "DataParallel", "init_parallel_env", "is_initialized", "get_rank",
           "get_world_size", "parallel_device_count", "ParallelEnv",
           "shard_tensor", "reshard", "shard_layer", "shard_optimizer",
           "dtensor_from_fn", "unshard_dtensor"]
