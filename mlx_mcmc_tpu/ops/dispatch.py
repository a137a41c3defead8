"""Where a likelihood op runs, and how it is batched over chains.

This module is the one place that asks JAX which device it is on. On the
GPU the hand-written kernels run compiled; on the CPU, the test platform,
the plain ``jnp`` path runs (the kernels themselves are tested there in
interpret mode). Any other platform is an error: a path that quietly runs
something else on an unknown device is not offered.
"""

from __future__ import annotations

from typing import Callable

import jax


def use_kernel(covered: bool = True) -> bool:
    """True on the GPU (run the compiled kernel), False on the CPU (run the
    plain ``jnp`` path). Raises on any other platform.

    ``covered`` is the kernel's own shape rule, measured against the plain
    path on the card (PERF.md): where the kernel does not cover a shape,
    the plain path runs on the GPU too."""
    platform = jax.default_backend()
    if platform == "gpu":
        return covered
    if platform == "cpu":
        return False
    raise RuntimeError(
        f"no likelihood path for platform {platform!r}: this package runs "
        "its kernels on an NVIDIA GPU and its plain jnp path on the CPU"
    )


def value_precision(dtype):
    """Precision for a value-path product whose operands have ``dtype``.

    float32 operands get full float32 (``HIGHEST``): a default-precision
    float32 product may run in TF32 on the GPU, whose rounding of the
    linear predictor costs more log-likelihood accuracy than the sampler's
    budget allows (docs/DESIGN.md §4b). Narrower operands (bfloat16) get
    the default: their products are exact in the float32 accumulator."""
    return jax.lax.Precision.HIGHEST if dtype == jax.numpy.float32 else None


def chain_batched(batched: Callable, name: str) -> Callable:
    """Turn ``batched(Z, *args) -> (ll (C,), grad (C, D))`` into a per-chain
    ``vag(z, *args)`` whose ``vmap`` over ``z`` calls ``batched`` once for
    the whole chain batch (the engine's chain axis), instead of once per
    chain.

    Only ``z`` may be batched: a vmap over the data arguments (a batch of
    datasets) is refused loudly rather than misread as shared data."""

    @jax.custom_batching.custom_vmap
    def vag(z, *args):
        ll, g = batched(z[None], *args)
        return ll[0], g[0]

    @vag.def_vmap
    def _vag_vmap(axis_size, in_batched, Z, *args):
        del axis_size
        z_batched, *args_batched = in_batched
        if not z_batched or any(jax.tree_util.tree_leaves(args_batched)):
            raise NotImplementedError(
                f"{name}'s custom_vmap rule supports only vmap-over-z with "
                "replicated data (the engine's chain batching); got "
                f"in_batched={in_batched!r}"
            )
        return batched(Z, *args), (True, True)

    return vag
