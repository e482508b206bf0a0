from .mesh import (Grid, all_reduce_mean, all_reduce_sum, broadcast_object, destroy_distributed,
                   grid, init_distributed, maybe_init_distributed, model_group,
                   parse_mesh_shape, shard_batch_size, sync_group, world)
from .sharding import (gather_state_dict, load_local_state_dict, local_state_dict, plain_name,
                       shard_state_dict, train_state_sharding)
from .tensor import copy_to_model, gather_from_model, reduce_from_model

__all__ = ["Grid", "all_reduce_mean", "all_reduce_sum", "broadcast_object", "copy_to_model",
           "destroy_distributed", "gather_from_model", "gather_state_dict", "grid",
           "init_distributed", "load_local_state_dict", "local_state_dict",
           "maybe_init_distributed", "model_group", "parse_mesh_shape", "plain_name",
           "reduce_from_model", "shard_batch_size", "shard_state_dict", "sync_group",
           "train_state_sharding", "world"]
