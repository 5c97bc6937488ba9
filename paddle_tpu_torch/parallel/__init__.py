"""The port's training parallelism: the declarative sharding plans
(`plan`), the FSDP overlap rings (`overlap`), the Trainer (`trainer`)
and the pipeline over 'pp' (`pipeline`; `Trainer`, `TrainStepConfig`
and the pipeline's names load at first use, since the Trainer imports
the layers that import `overlap`)."""
from paddle_tpu_torch.parallel.overlap import (  # noqa: F401
    current_overlap, overlap_all_gather_matmul, overlap_fraction_from_spans,
    overlap_fsdp_guard, overlap_matmul_reduce_scatter)
from paddle_tpu_torch.parallel.plan import (  # noqa: F401
    ShardingPlan, apply_plan, fsdp_partition, llama_sharding_plan)


_PIPELINE = ("PipelineTrainer", "PipelineConfig", "PipelinePlan",
             "detect_layer_stack", "build_interleaved_schedule",
             "STACK_PREFIX")


def __getattr__(name):
    if name in ("Trainer", "TrainStepConfig"):
        from paddle_tpu_torch.parallel import trainer
        return getattr(trainer, name)
    if name in _PIPELINE:
        from paddle_tpu_torch.parallel import pipeline
        return getattr(pipeline, name)
    raise AttributeError(
        f"module 'paddle_tpu_torch.parallel' has no attribute {name!r}")
