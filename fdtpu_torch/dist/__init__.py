"""Distribution of the port over several devices (port of ``fdtpu/dist``):
the ``("data", "model")`` device mesh and its placements
(:mod:`fdtpu_torch.dist.mesh`), the batch-axis collectives and sharded draws
(:mod:`fdtpu_torch.dist.parallel`), and the trainer's tensor parallelism
(:mod:`fdtpu_torch.dist.tensor_parallel`)."""

from fdtpu_torch.dist.mesh import (
    MeshConfig,
    create_mesh,
    data_sharding,
    pad_to_multiple,
    replicate,
    shard_batch,
    shard_params,
    tp_param_spec,
)

__all__ = [
    "MeshConfig",
    "create_mesh",
    "shard_batch",
    "replicate",
    "data_sharding",
    "tp_param_spec",
    "shard_params",
    "pad_to_multiple",
]
