"""Symplectic integrators over flat position/momentum vectors.

Reference parity: the leapfrog half-kick/drift/half-kick structure of
mlx_mcmc/kernels/hmc.py:69-100 and the Hamiltonian of hmc.py:102-111 —
rebuilt as fused elementwise updates on flat vectors with a diagonal mass matrix
(the reference hardcodes identity mass and per-param Python dicts).

Gradient convention: ``grad`` is d(log_prob)/dz, so the momentum kick is
``r += 0.5 * eps * grad``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class IntegratorState(NamedTuple):
    z: jnp.ndarray  # position (D,)
    r: jnp.ndarray  # momentum (D,)
    log_prob: jnp.ndarray  # scalar log density at z
    grad: jnp.ndarray  # d log_prob / dz at z


def kinetic_energy(r: jnp.ndarray, inv_mass_diag: jnp.ndarray) -> jnp.ndarray:
    """0.5 * r^T M^{-1} r for diagonal M."""
    return 0.5 * jnp.sum(inv_mass_diag * r * r)


def total_energy(state: IntegratorState, inv_mass_diag: jnp.ndarray) -> jnp.ndarray:
    """Hamiltonian H = -log_prob + kinetic. NaN-poisoned values map to +inf
    so downstream accept/divergence logic stays well-defined."""
    energy = kinetic_energy(state.r, inv_mass_diag) - state.log_prob
    return jnp.where(jnp.isnan(energy), jnp.inf, energy)


def sample_momentum(key, inv_mass_diag: jnp.ndarray) -> jnp.ndarray:
    """Draw r ~ N(0, M): std per dim is 1/sqrt(inv_mass)."""
    eps = jax.random.normal(key, inv_mass_diag.shape, inv_mass_diag.dtype)
    return eps * jax.lax.rsqrt(inv_mass_diag)


def make_leapfrog(
    flat_log_prob: Callable[[jnp.ndarray], jnp.ndarray],
    value_and_grad_fn=None,
) -> Callable[[IntegratorState, jnp.ndarray, jnp.ndarray], IntegratorState]:
    """Build a single-step leapfrog for ``flat_log_prob``.

    One gradient evaluation per step: the closing half-kick of step ``k``
    reuses the gradient that opens step ``k+1`` (the reference recomputes the
    gradient twice per step, hmc.py:81-94).

    ``value_and_grad_fn`` optionally replaces ``jax.value_and_grad`` with a
    hand-fused implementation (e.g. the Pallas GLM kernel,
    ops/pallas/glm.py) — the sampler hot op.
    """
    value_and_grad = value_and_grad_fn or jax.value_and_grad(flat_log_prob)

    def leapfrog(state: IntegratorState, eps, inv_mass_diag) -> IntegratorState:
        r_half = state.r + 0.5 * eps * state.grad
        z_new = state.z + eps * (inv_mass_diag * r_half)
        log_prob_new, grad_new = value_and_grad(z_new)
        r_new = r_half + 0.5 * eps * grad_new
        return IntegratorState(z_new, r_new, log_prob_new, grad_new)

    return leapfrog
