"""Metropolis-adjusted Langevin algorithm (MALA) kernel.

Beyond the reference (its three kernels are MH / HMC / NUTS,
mlx_mcmc/kernels/metropolis.py, hmc.py, nuts.py): MALA sits between them —
one gradient evaluation per draw like random-walk MH's single log_prob, but
the proposal drifts up the gradient, so it mixes far better per evaluation
on smooth targets. Structurally it is a single preconditioned Euler step of
the Langevin diffusion with the Hastings correction for the asymmetric
proposal density.

Compiled shape: one fused value+grad evaluation (optionally the Pallas GLM
kernel), all-vector elementwise updates, traced accept select — scans and vmaps like
every other kernel here. The diagonal mass-matrix estimate preconditions the
proposal: covariance ``eps^2 * M^{-1}``, drift ``(eps^2 / 2) M^{-1} grad``
(Roberts & Tweedie 1996; optimal-scaling acceptance target 0.574).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from mlx_mcmc_tpu.kernels.base import TransitionInfo, Tunables


class MALAState(NamedTuple):
    position: jnp.ndarray  # (D,)
    log_prob: jnp.ndarray  # ()
    grad: jnp.ndarray  # (D,) cached d log_prob/dz — one grad per draw total


def make_mala_kernel(
    flat_log_prob: Callable[[jnp.ndarray], jnp.ndarray],
    max_delta_energy: float = 1000.0,
    value_and_grad_fn=None,
) -> Tuple[Callable, Callable]:
    """Build ``(init_fn, step_fn)`` for preconditioned MALA."""
    value_and_grad = value_and_grad_fn or jax.value_and_grad(flat_log_prob)

    def init_fn(position: jnp.ndarray) -> MALAState:
        log_prob, grad = value_and_grad(position)
        return MALAState(position=position, log_prob=log_prob, grad=grad)

    def step_fn(key, state: MALAState, tunables: Tunables):
        key_prop, key_accept = jax.random.split(key)
        eps = tunables.step_size
        inv_mass = tunables.inv_mass_diag
        drift = 0.5 * eps * eps * inv_mass

        # Nonfinite cached gradients (e.g. a chain started outside the
        # support) would poison the proposal mean; fall back to pure noise.
        grad0 = jnp.where(jnp.isfinite(state.grad), state.grad, 0.0)
        mean_fwd = state.position + drift * grad0
        noise = jax.random.normal(key_prop, state.position.shape, state.position.dtype)
        proposal = mean_fwd + eps * jnp.sqrt(inv_mass) * noise
        log_prob_prop, grad_prop = value_and_grad(proposal)

        # Hastings correction: q(a | b) = N(a; b + drift*grad(b), eps^2 M^-1).
        # Forward density reduces to -0.5*||noise||^2; both constants cancel.
        grad1 = jnp.where(jnp.isfinite(grad_prop), grad_prop, 0.0)
        mean_rev = proposal + drift * grad1
        inv_var = 1.0 / (eps * eps * inv_mass)
        log_q_fwd = -0.5 * jnp.sum(noise * noise)
        log_q_rev = -0.5 * jnp.sum(
            (state.position - mean_rev) ** 2 * inv_var
        )

        delta = log_prob_prop - state.log_prob + log_q_rev - log_q_fwd
        # -inf current log-prob (invalid start) must always move; NaN deltas
        # (e.g. inf - inf) must always reject.
        delta = jnp.where(jnp.isneginf(state.log_prob), jnp.inf, delta)
        delta = jnp.where(jnp.isnan(delta), -jnp.inf, delta)
        is_divergent = -delta > max_delta_energy
        accept_prob = jnp.exp(jnp.minimum(delta, 0.0))
        log_u = jnp.log(jax.random.uniform(key_accept, (), state.position.dtype))
        accept = log_u < delta

        new_state = MALAState(
            position=jnp.where(accept, proposal, state.position),
            log_prob=jnp.where(accept, log_prob_prop, state.log_prob),
            grad=jnp.where(accept, grad_prop, state.grad),
        )
        info = TransitionInfo(
            accept_prob=accept_prob,
            is_accepted=accept,
            is_divergent=is_divergent,
            energy=-new_state.log_prob,
            log_prob=new_state.log_prob,
            num_integration_steps=jnp.asarray(1, jnp.int32),
            tree_depth=jnp.asarray(0, jnp.int32),
            step_size=tunables.step_size,
        )
        return new_state, info

    return init_fn, step_fn
