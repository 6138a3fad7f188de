"""Device meshes of the port (the JAX package's ``demcmc_tpu.parallel``):
``chain_mesh`` splits a run's groups over devices (a replicated run's
replications: ``shard_replications``); ``data_mesh`` and
``shard_data`` raise until a later slice carries them."""

from .mesh import (Mesh, chain_mesh, data_mesh, shard_data,
                   shard_replications)

__all__ = ["Mesh", "chain_mesh", "data_mesh", "shard_data",
           "shard_replications"]
