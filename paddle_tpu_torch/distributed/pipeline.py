"""Pipeline-parallel surface under paddle_tpu_torch.distributed
(reference: fleet/meta_parallel/pipeline_parallel.py — 1F1B and
interleaved schedules over NCCL point-to-point), the counterpart of
paddle_tpu/distributed/pipeline.py.

The runtime lives in paddle_tpu_torch.parallel.pipeline: one stage a
rank of the mesh's 'pp' axis, activations and gradients crossing between
stage ranks point to point. This module re-exports it at the reference's
import path.
"""
from paddle_tpu_torch.parallel.pipeline import (  # noqa: F401
    PipelineConfig, PipelinePlan, PipelineTrainer)

__all__ = ["PipelinePlan", "PipelineConfig", "PipelineTrainer"]
