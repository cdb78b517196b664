"""Multi-process data parallelism on ``torch.distributed``: one process per
device, dataset shards, gradients summed over the ranks, loss normalisers
over the global batch, gathered evaluation, rank-0 checkpoints and logs.

The JAX package's ``data_mesh`` and ``make_global_batch`` have no
counterpart: each rank keeps its local batch, and no global array is
assembled. Its ``replicate_to_mesh`` is ``broadcast_parameters`` here (the
JAX function assumes the processes start alike; a broadcast from rank 0
makes sure of it). ``sharding.py``: the ("data", "space") mesh, ZeRO-3
state sharding, the width-sharded backbone and neck with their halo
exchange and the split RetinaNet and FCOS heads (``partition_spatially``:
what GSPMD does for the JAX package from the shardings alone) and the
row-sharded pairwise overlaps.
"""

from .distributed import (
    all_gather_eval_arrays,
    all_gather_objects,
    all_reduce_gradients,
    broadcast_parameters,
    coordination_barrier,
    get_rank,
    get_world_size,
    get_data_rank,
    global_count,
    global_metrics,
    host_local_copy,
    init_distributed,
    loss_replicas,
    process_group,
    set_data_axis,
    sync_global_value,
)
from .sharding import (
    batch_specs,
    fsdp_dims,
    fsdp_spec,
    head_part,
    make_mesh,
    partition_spatially,
    shard_batch_spatial,
    shard_state_fsdp,
    sharded_pairwise_overlaps,
    window_halo,
)

__all__ = [
    "init_distributed",
    "process_group",
    "get_rank",
    "get_world_size",
    "broadcast_parameters",
    "host_local_copy",
    "all_gather_eval_arrays",
    "all_gather_objects",
    "sync_global_value",
    "coordination_barrier",
    "all_reduce_gradients",
    "global_count",
    "global_metrics",
    "set_data_axis",
    "get_data_rank",
    "loss_replicas",
    "make_mesh",
    "batch_specs",
    "shard_batch_spatial",
    "fsdp_spec",
    "fsdp_dims",
    "shard_state_fsdp",
    "partition_spatially",
    "head_part",
    "window_halo",
    "sharded_pairwise_overlaps",
]
