from .mesh import (Mesh, all_gather_rows, distributed_init, make_mesh, pad_to_multiple, psum,
                   reduce_scatter_rows)
from .sharding import (HybridShard, ShardPlan, ShardedGraph, ShardedHybrid, dense_blocks,
                       make_sharded_epoch_fn, make_sharded_mips, make_sharded_propagate,
                       make_sharded_train_step, pad_batch, pad_params, remainder_ell,
                       shard_coos, shard_graph, shard_hybrid, shard_hybrid_graph, shard_params,
                       sharded_epoch_plan, unpad_params)

__all__ = [
    "make_mesh", "distributed_init", "Mesh", "all_gather_rows", "reduce_scatter_rows", "psum",
    "pad_to_multiple", "ShardPlan", "ShardedGraph", "shard_graph", "shard_coos",
    "shard_params", "pad_params", "unpad_params", "pad_batch", "make_sharded_train_step",
    "make_sharded_mips", "make_sharded_propagate", "ShardedHybrid", "HybridShard",
    "shard_hybrid_graph", "shard_hybrid", "dense_blocks", "remainder_ell",
    "make_sharded_epoch_fn", "sharded_epoch_plan",
]
