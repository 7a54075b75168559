"""The parallel layer (port of the JAX package's ``parallel/``): the device
mesh and its collectives, data-parallel embedding and prediction, the ring
dedup, and tensor parallelism for the ViT towers (float, dynamic int8 and
int8_static)."""
from clip_assisted_data_labeling_tpu_torch.parallel.dedup_sharded import (
    find_duplicate_pairs_sharded,
)
from clip_assisted_data_labeling_tpu_torch.parallel.embed_sharded import ShardedEmbedder
from clip_assisted_data_labeling_tpu_torch.parallel.mesh import (
    device_count,
    get_mesh,
    shard_batch,
)

__all__ = ["ShardedEmbedder", "device_count", "find_duplicate_pairs_sharded", "get_mesh",
           "shard_batch"]
