from .mesh import (all_reduce_mean, all_reduce_sum, broadcast_object, destroy_distributed,
                   init_distributed, maybe_init_distributed, shard_batch_size, sync_group,
                   world)

__all__ = ["all_reduce_mean", "all_reduce_sum", "broadcast_object", "destroy_distributed",
           "init_distributed", "maybe_init_distributed", "shard_batch_size", "sync_group",
           "world"]
