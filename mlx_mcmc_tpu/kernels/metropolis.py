"""Random-walk Metropolis-Hastings kernel.

Reference parity: mlx_mcmc/kernels/metropolis.py:6-101 — Gaussian random-walk
proposal, accept if ``log u < Δlogp``. Design deltas: the per-iteration
Python loop with host ``float()`` accept branches (metropolis.py:64-92) is
replaced by a pure ``step`` (the accept is a traced ``jnp.where`` select) that
runs under ``lax.scan``/``vmap``; the proposal is one fused vector update
shaped by ``sqrt(inv_mass_diag)`` so mass-matrix adaptation also tunes the
random walk.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from mlx_mcmc_tpu.kernels.base import TransitionInfo, Tunables


class MetropolisState(NamedTuple):
    position: jnp.ndarray  # (D,)
    log_prob: jnp.ndarray  # ()


def make_metropolis_kernel(
    flat_log_prob: Callable[[jnp.ndarray], jnp.ndarray],
) -> Tuple[Callable, Callable]:
    """Build ``(init_fn, step_fn)`` for random-walk Metropolis."""

    def init_fn(position: jnp.ndarray) -> MetropolisState:
        return MetropolisState(position=position, log_prob=flat_log_prob(position))

    def step_fn(key, state: MetropolisState, tunables: Tunables):
        key_prop, key_accept = jax.random.split(key)
        noise = jax.random.normal(key_prop, state.position.shape, state.position.dtype)
        scale = tunables.step_size * jnp.sqrt(tunables.inv_mass_diag)
        proposal = state.position + scale * noise
        log_prob_prop = flat_log_prob(proposal)

        delta = log_prob_prop - state.log_prob
        # -inf current log-prob (invalid start) must always move: -inf - -inf
        # would be NaN, so treat it as +inf improvement.
        delta = jnp.where(jnp.isneginf(state.log_prob), jnp.inf, delta)
        log_u = jnp.log(jax.random.uniform(key_accept, (), state.position.dtype))
        accept = log_u < delta

        new_state = MetropolisState(
            position=jnp.where(accept, proposal, state.position),
            log_prob=jnp.where(accept, log_prob_prop, state.log_prob),
        )
        info = TransitionInfo(
            accept_prob=jnp.exp(jnp.minimum(delta, 0.0)),
            is_accepted=accept,
            is_divergent=jnp.asarray(False),
            energy=-new_state.log_prob,
            log_prob=new_state.log_prob,
            num_integration_steps=jnp.asarray(0, jnp.int32),
            tree_depth=jnp.asarray(0, jnp.int32),
            step_size=tunables.step_size,
        )
        return new_state, info

    return init_fn, step_fn
