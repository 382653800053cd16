from .mesh import Mesh, all_gather_rows, distributed_init, make_mesh, pad_to_multiple, psum
from .sharding import (ShardPlan, ShardedGraph, make_sharded_mips, make_sharded_propagate,
                       make_sharded_train_step, pad_batch, pad_params, shard_coos,
                       shard_graph, shard_params, unpad_params)

__all__ = [
    "make_mesh", "distributed_init", "Mesh", "all_gather_rows", "psum", "pad_to_multiple",
    "ShardPlan", "ShardedGraph", "shard_graph", "shard_coos", "shard_params",
    "pad_params", "unpad_params", "pad_batch", "make_sharded_train_step",
    "make_sharded_mips", "make_sharded_propagate",
]
