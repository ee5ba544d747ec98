from flingbot_tpu_torch.parallel.mesh import (
    EnvSharding,
    init_distributed,
    make_dp_train_step,
    make_env_sharding,
    make_mesh,
    replicate,
    shard_batch,
)

__all__ = ["make_mesh", "shard_batch", "replicate", "make_dp_train_step",
           "init_distributed", "make_env_sharding", "EnvSharding"]
