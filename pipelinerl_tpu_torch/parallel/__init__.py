"""The sharded trainer's mesh, rules, collectives and step (dp, cp, tp) on
``torch.distributed``; port of the JAX package's ``parallel/``."""

from .mesh import infer_mesh_shape, make_mesh  # noqa: F401
from .sharding import (  # noqa: F401
    cp_slice,
    param_partition_specs,
    shard_batch,
    shard_params,
    unshard_params,
)
from .train_step import make_sharded_train_step  # noqa: F401
