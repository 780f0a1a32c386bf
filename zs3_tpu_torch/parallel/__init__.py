from zs3_tpu_torch.parallel.spatial import (
    spatial_batch_sharding,
    spatially_sharded_forward,
    spatially_sharded_train_step,
)

__all__ = ["spatial_batch_sharding", "spatially_sharded_forward",
           "spatially_sharded_train_step"]
