"""Meshes, sharded retrieval, the sharded gate step and its scaling model
on torch.distributed."""

from mlis_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    param_shardings,
    replicated,
    shard_batch,
)
