"""Multi-process data parallelism on ``torch.distributed``: one process per
device, dataset shards, gradients summed over the ranks, loss normalisers
over the global batch, gathered evaluation, rank-0 checkpoints and logs.

The JAX package's ``data_mesh`` and ``make_global_batch`` have no
counterpart: each rank keeps its local batch, and no global array is
assembled. Its ``replicate_to_mesh`` is ``broadcast_parameters`` here (the
JAX function assumes the processes start alike; a broadcast from rank 0
makes sure of it). Not ported yet: ``sharding.py``'s ``make_mesh``,
``batch_specs``, ``fsdp_spec``, ``shard_state_fsdp`` and
``sharded_pairwise_overlaps``; not owed: ``shard_batch_spatial`` (the
spatial axis needs a convolution with a halo exchange).
"""

from .distributed import (
    all_gather_eval_arrays,
    all_gather_objects,
    all_reduce_gradients,
    broadcast_parameters,
    coordination_barrier,
    get_rank,
    get_world_size,
    global_count,
    global_metrics,
    host_local_copy,
    init_distributed,
    process_group,
    sync_global_value,
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
]
