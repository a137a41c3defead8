"""Hamiltonian Monte Carlo kernel.

Reference parity: mlx_mcmc/kernels/hmc.py:7-206 — momentum refresh, L leapfrog
steps, Metropolis accept on the energy difference. Design deltas: the inner
leapfrog loop is a ``lax.scan`` (one compiled region; the reference loops in
Python re-tracing per-param ``mx.grad`` twice per step, hmc.py:132-133), the
mass matrix is a diagonal estimate rather than hardcoded identity
(hmc.py:110), and the accept branch is a traced select instead of a host
``float()`` comparison (hmc.py:149-153).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from mlx_mcmc_tpu.kernels.base import TransitionInfo, Tunables
from mlx_mcmc_tpu.kernels.integrators import (
    IntegratorState,
    make_leapfrog,
    sample_momentum,
    total_energy,
)


class HMCState(NamedTuple):
    position: jnp.ndarray  # (D,)
    log_prob: jnp.ndarray  # ()
    grad: jnp.ndarray  # (D,) cached d log_prob/dz — saves one grad per draw


def make_hmc_kernel(
    flat_log_prob: Callable[[jnp.ndarray], jnp.ndarray],
    num_leapfrog_steps: int = 10,
    max_delta_energy: float = 1000.0,
    value_and_grad_fn=None,
) -> Tuple[Callable, Callable]:
    """Build ``(init_fn, step_fn)`` for HMC with a static leapfrog count."""
    leapfrog = make_leapfrog(flat_log_prob, value_and_grad_fn)
    value_and_grad = value_and_grad_fn or jax.value_and_grad(flat_log_prob)

    def init_fn(position: jnp.ndarray) -> HMCState:
        log_prob, grad = value_and_grad(position)
        return HMCState(position=position, log_prob=log_prob, grad=grad)

    def step_fn(key, state: HMCState, tunables: Tunables):
        key_momentum, key_accept = jax.random.split(key)
        r0 = sample_momentum(key_momentum, tunables.inv_mass_diag)
        start = IntegratorState(state.position, r0, state.log_prob, state.grad)
        energy0 = total_energy(start, tunables.inv_mass_diag)

        def one_step(integ, _):
            return leapfrog(integ, tunables.step_size, tunables.inv_mass_diag), None

        end, _ = jax.lax.scan(one_step, start, None, length=num_leapfrog_steps)
        energy1 = total_energy(end, tunables.inv_mass_diag)

        delta = energy0 - energy1  # log accept ratio
        delta = jnp.where(jnp.isnan(delta), -jnp.inf, delta)
        is_divergent = -delta > max_delta_energy
        accept_prob = jnp.exp(jnp.minimum(delta, 0.0))
        log_u = jnp.log(jax.random.uniform(key_accept, (), state.position.dtype))
        accept = log_u < delta

        new_state = HMCState(
            position=jnp.where(accept, end.z, state.position),
            log_prob=jnp.where(accept, end.log_prob, state.log_prob),
            grad=jnp.where(accept, end.grad, state.grad),
        )
        info = TransitionInfo(
            accept_prob=accept_prob,
            is_accepted=accept,
            is_divergent=is_divergent,
            energy=energy0,
            log_prob=new_state.log_prob,
            num_integration_steps=jnp.asarray(num_leapfrog_steps, jnp.int32),
            tree_depth=jnp.asarray(0, jnp.int32),
            step_size=tunables.step_size,
        )
        return new_state, info

    return init_fn, step_fn
