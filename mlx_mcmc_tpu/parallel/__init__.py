"""Parallel execution layer: device meshes, sharded chains, collectives.

The reference is single-device/single-chain with no communication layer
(SURVEY.md §2.3: no NCCL/MPI/Gloo anywhere; multi-chain is a roadmap item,
README.md:212-214). This package is the compiled replacement: chains are a
sharded axis of a ``jax.sharding.Mesh``, warmup adaptation statistics ride
``lax.pmean``/``psum`` collectives over the interconnect, and multi-host runs
initialize through ``jax.distributed``.
"""

from mlx_mcmc_tpu.parallel.mesh import chain_mesh, data_chain_mesh
from mlx_mcmc_tpu.parallel.sharded import (
    clear_sharded_runner_cache,
    sample_sharded,
)
from mlx_mcmc_tpu.parallel.distributed import initialize_distributed

__all__ = [
    "chain_mesh",
    "data_chain_mesh",
    "sample_sharded",
    "clear_sharded_runner_cache",
    "initialize_distributed",
]
