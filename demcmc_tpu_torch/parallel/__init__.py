"""Device meshes and processes of the port (the JAX package's
``demcmc_tpu.parallel``): ``chain_mesh`` splits a run's groups over
devices (a replicated run's replications: ``shard_replications``),
``data_mesh`` and ``shard_data`` its likelihood's data over a second
axis, and ``distributed`` runs one process per card over
``torch.distributed``."""

from . import distributed
from .mesh import (Mesh, ShardedData, chain_mesh, data_mesh, shard_data,
                   shard_replications)

__all__ = ["Mesh", "ShardedData", "chain_mesh", "data_mesh", "shard_data",
           "shard_replications", "distributed"]
