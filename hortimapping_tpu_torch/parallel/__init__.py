from hortimapping_tpu_torch.parallel.sharding import (
    FruitMesh,
    fruit_mesh,
    init_multi_host,
    pad_to_multiple,
    shard_joint_opt,
)

__all__ = ["FruitMesh", "fruit_mesh", "init_multi_host", "pad_to_multiple", "shard_joint_opt"]
