"""Meshes, sharding, pipeline parallelism and sharded checkpoints over
:mod:`torch.distributed` (counterpart of :mod:`pydrobert_tpu.parallel`):
:mod:`~pydrobert_tpu_torch.parallel.mesh` (device meshes, partition specs
as DTensor placements, :func:`shard_params`, :func:`all_reduce_metrics`),
:mod:`~pydrobert_tpu_torch.parallel.pipeline` (GPipe with a hand-scheduled
backward pass) and :mod:`~pydrobert_tpu_torch.parallel.checkpoint`
(``torch.distributed.checkpoint``, synchronous or asynchronous)."""

from .checkpoint import restore_sharded, save_sharded, wait_for_saves
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    PartitionSpec,
    all_reduce_metrics,
    batch_sharding,
    gather_params,
    host_shard_info,
    make_mesh,
    param_partition_specs,
    replicated_sharding,
    sequence_sharding,
    shard_params,
)
from .pipeline import PIPE_AXIS, make_pipeline_mesh, pipeline_apply

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "PartitionSpec",
    "all_reduce_metrics",
    "batch_sharding",
    "gather_params",
    "host_shard_info",
    "make_mesh",
    "make_pipeline_mesh",
    "param_partition_specs",
    "pipeline_apply",
    "replicated_sharding",
    "restore_sharded",
    "save_sharded",
    "sequence_sharding",
    "shard_params",
    "wait_for_saves",
]
