"""Device mesh construction helpers.

Chains map to a data-parallel mesh axis ('chains'); very large observation
sets can additionally shard the likelihood over a 'data' axis (the MCMC
analog of sequence/tensor parallelism — SURVEY.md §5.7). The GPUs of one
host are joined all to all by NVLink, so every placement of the axes costs
the same and the mesh is a plain reshape of ``jax.devices()``: it follows
the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def chain_mesh(num_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh with a single 'chains' axis over all (or given) devices."""
    if devices is None:
        devices = jax.devices()
        if num_devices is not None:
            devices = devices[:num_devices]
    return Mesh(np.asarray(devices), ("chains",))


def data_chain_mesh(
    chains: int,
    data: int,
    devices=None,
) -> Mesh:
    """2-D ('chains', 'data') mesh: chains x data-shards, a plain reshape of
    the first ``chains * data`` devices (or of ``devices``).

    The 'data' axis carries the per-leapfrog log-likelihood psum; the
    'chains' axis only communicates once per warmup draw.
    """
    if devices is None:
        devices = jax.devices()[: chains * data]
    return Mesh(np.asarray(devices).reshape(chains, data), ("chains", "data"))
