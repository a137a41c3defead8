"""Dict-of-params <-> flat-vector conversion.

The public model API is the reference's dict-of-params ``log_prob`` contract
(reference: mlx_mcmc/inference/mcmc.py:20-31, README.md:61-77): a user model is
a function ``log_prob(params: dict[str, array]) -> scalar``.

Design delta: the samplers never integrate Hamiltonian dynamics over Python
dicts (the reference does per-param dict comprehensions inside leapfrog,
mlx_mcmc/kernels/hmc.py:69-100). Here the position is a single flat f32 vector
living in device memory — one fused elementwise update per leapfrog half-step — and the
dict view only exists inside the user's ``log_prob`` closure via ``unravel``.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree


def _as_float_array(x: Any) -> jnp.ndarray:
    """Convert leaves to floating-point jnp arrays (ints become the default float)."""
    arr = jnp.asarray(x)
    if not jnp.issubdtype(arr.dtype, jnp.floating):
        arr = arr.astype(jnp.result_type(float))
    return arr


def ravel_params(params: Any) -> Tuple[jnp.ndarray, Callable[[jnp.ndarray], Any]]:
    """Flatten a pytree (typically ``dict[str, array]``) into one float vector.

    Returns ``(flat, unravel)`` where ``unravel(flat)`` reproduces the original
    structure. All leaves are promoted to floating point so the flat vector is
    differentiable.
    """
    params = jax.tree_util.tree_map(_as_float_array, params)
    flat, unravel = ravel_pytree(params)
    return flat, unravel


def make_flat_logprob(
    log_prob_fn: Callable[..., jnp.ndarray],
    example_params: Any,
    data_aware: bool = False,
) -> Tuple[Callable[..., jnp.ndarray], jnp.ndarray, Callable[[jnp.ndarray], Any]]:
    """Wrap a dict-of-params log-prob into a flat-vector log-prob.

    Returns ``(flat_log_prob, initial_flat, unravel)``. ``flat_log_prob`` maps a
    flat position vector to a scalar log-density and is safe to ``jit``/``grad``/
    ``vmap`` (provided the user model is traceable).

    With ``data_aware=True`` the model is ``log_prob_fn(params, data)`` and the
    returned wrapper is ``flat_log_prob(z, data)`` — data flows as a runtime
    argument instead of a closure constant.
    """
    initial_flat, unravel = ravel_params(example_params)

    def _sanitize(out):
        # NaN log-densities (e.g. a user model evaluating Normal with a
        # negative scale) are sanitized to -inf so accept/reject logic can
        # never get stuck on a NaN state.
        out = jnp.asarray(out).reshape(())
        return jnp.where(jnp.isnan(out), -jnp.inf, out)

    if data_aware:

        def flat_log_prob(z: jnp.ndarray, data) -> jnp.ndarray:
            return _sanitize(log_prob_fn(unravel(z), data))

    else:

        def flat_log_prob(z: jnp.ndarray) -> jnp.ndarray:
            return _sanitize(log_prob_fn(unravel(z)))

    return flat_log_prob, initial_flat, unravel
