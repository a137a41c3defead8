"""Tempered sequential Monte Carlo (SMC sampler).

A whole capability class absent from the reference (SURVEY.md §2 — MH/HMC/
NUTS only): anneal a particle population from a simple start distribution
q0 to the posterior p through the geometric path

    pi_beta(z) ∝ q0(z)^(1-beta) · p(z)^beta,     beta: 0 -> 1,

reweighting, resampling, and MCMC-mutating at each stage (Del Moral, Doucet
& Jasra 2006). Unlike MCMC it gives a **normalizing-constant estimate**
(log Z — the model-evidence quantity WAIC/LOO can't provide) and handles
multimodal targets by populating modes in proportion to their mass.

Compiled mapping: particles are the batch axis (every stage is a batched
log_prob over the (P, D) population — matmul-friendly for data-heavy models);
the adaptive temperature ladder is a ``lax.while_loop`` whose next beta is
solved *on device* by bisection on the ESS of the incremental weights
(Chopin & Papaspiliopoulos 2020, adaptive tempering); systematic resampling
is a cumsum + searchsorted — all static shapes, one ``jit`` for the whole
run. Mutation is K random-walk MH steps whose proposal is shaped by the
current population covariance diagonal (scale-adaptive, gradient-free).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mlx_mcmc_tpu.inference.api import _as_key
from mlx_mcmc_tpu.ops.ravel import make_flat_logprob

_LOG_2PI = float(np.log(2.0 * np.pi))


@dataclass
class SMCResult:
    """Final particle population + evidence estimate.

    ``particles``: dict name -> (num_particles, *event) equally-weighted
    posterior draws. ``log_evidence``: estimate of log ∫ p(z) dz relative
    to the normalized q0 (for a normalized ``log_prob`` this estimates the
    log marginal likelihood).
    """

    particles: Dict[str, Any]
    log_evidence: float
    num_stages: int
    final_accept_rate: float
    num_particles: int
    final_beta: float = 1.0  # < 1.0 means the ladder hit max_stages early
    _flat: jnp.ndarray = field(repr=False, default=None)


def _systematic_resample(key, log_weights):
    """Systematic (low-variance) resampling: one uniform, P strata.
    Returns ancestor indices (gather, don't recompute, the log-densities)."""
    n = log_weights.shape[0]
    w = jax.nn.softmax(log_weights)
    cum = jnp.cumsum(w)
    u = (jax.random.uniform(key) + jnp.arange(n, dtype=jnp.float32)) / n
    idx = jnp.searchsorted(cum, u)
    return jnp.clip(idx, 0, n - 1)


def sample_smc(
    log_prob_fn: Callable[..., jnp.ndarray],
    initial_params: Any,
    *,
    num_particles: int = 1024,
    num_mutations: int = 5,
    ess_target: float = 0.5,
    max_stages: int = 100,
    q0_scale: float = 1.0,
    seed=0,
    data=None,
    transforms: Optional[dict] = None,
) -> SMCResult:
    """Run adaptive tempered SMC from N(z0, q0_scale²·I) to the posterior.

    Args:
        log_prob_fn: dict-of-params model (binary with ``data``), same
            contract as :func:`mlx_mcmc_tpu.sample`.
        num_particles: population size (the device batch axis; use powers of
            two ≥ 512 on real chips).
        num_mutations: MH mutation steps per tempering stage.
        ess_target: the next temperature is chosen so the effective sample
            size of the incremental weights is this fraction of the
            population (0.5 is standard).
        max_stages: hard cap on ladder length (static upper bound for the
            device loop).
        q0_scale: std of the Gaussian start distribution around the user's
            (unconstrained) init — the annealing source q0.
        transforms: optional unconstraining transforms; annealing runs in
            unconstrained space, particles return constrained.

    Returns:
        :class:`SMCResult` with equally-weighted particles and the
        log-evidence estimate Σ_stages log mean exp(incremental weights).
    """
    if not 0.0 < ess_target < 1.0:
        raise ValueError("ess_target must be in (0, 1)")

    user_log_prob_fn = log_prob_fn
    to_constrained = None
    if transforms:
        from mlx_mcmc_tpu.distributions.transforms import (
            make_transformed_logprob,
        )

        log_prob_fn, to_constrained, to_unconstrained = make_transformed_logprob(
            log_prob_fn, transforms, data_aware=data is not None
        )
        initial_params = to_unconstrained(
            jax.tree_util.tree_map(
                lambda x: jnp.asarray(x, jnp.result_type(float)), initial_params
            )
        )
    flat_log_prob, z0, unravel = make_flat_logprob(
        log_prob_fn, initial_params, data_aware=data is not None
    )
    dim = z0.shape[0]
    key = _as_key(seed)

    def run(key, z0, data):
        if data is None:
            lp_one = flat_log_prob
        else:
            lp_one = lambda z: flat_log_prob(z, data)  # noqa: E731
        batch_lp = jax.vmap(lp_one)

        def log_q0(z):
            return jnp.sum(
                -0.5 * ((z - z0) / q0_scale) ** 2
                - jnp.log(q0_scale)
                - 0.5 * _LOG_2PI,
                axis=-1,
            )

        k_init, k_loop = jax.random.split(key)
        particles = z0 + q0_scale * jax.random.normal(
            k_init, (num_particles, dim), z0.dtype
        )
        lp = batch_lp(particles)
        lq = log_q0(particles)

        def next_beta(beta, delta_lp):
            """Bisection: largest step with ESS(incremental) >= target."""
            target = ess_target * num_particles

            def ess_of(delta):
                lw = delta * delta_lp
                lw = lw - jnp.max(lw)
                w = jnp.exp(lw)
                return jnp.square(jnp.sum(w)) / jnp.sum(jnp.square(w))

            def body(_, lohi):
                lo, hi = lohi
                mid = 0.5 * (lo + hi)
                ok = ess_of(mid) >= target
                return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

            lo, hi = jax.lax.fori_loop(
                0, 30, body, (jnp.float32(0.0), 1.0 - beta)
            )
            # if even the full remaining step keeps ESS above target, finish
            full_ok = ess_of(1.0 - beta) >= target
            delta = jnp.where(full_ok, 1.0 - beta, lo)
            return jnp.maximum(delta, 1e-6)

        def tempered_lp(lp, lq, beta):
            return (1.0 - beta) * lq + beta * lp

        def mutate(key, particles, lp, lq, beta):
            """K random-walk MH steps at pi_beta, proposal shaped by the
            population's per-dimension spread (2.38/sqrt(d) scaling)."""
            std = jnp.std(particles, axis=0) + 1e-6
            scale = 2.38 / jnp.sqrt(jnp.float32(dim)) * std

            def one(carry, k):
                particles, lp, lq, acc = carry
                k1, k2 = jax.random.split(k)
                prop = particles + scale * jax.random.normal(
                    k1, particles.shape, particles.dtype
                )
                lp_p = batch_lp(prop)
                lq_p = log_q0(prop)
                log_alpha = tempered_lp(lp_p, lq_p, beta) - tempered_lp(
                    lp, lq, beta
                )
                log_alpha = jnp.where(
                    jnp.isnan(log_alpha), -jnp.inf, log_alpha
                )
                accept = (
                    jnp.log(jax.random.uniform(k2, (num_particles,)))
                    < log_alpha
                )
                particles = jnp.where(accept[:, None], prop, particles)
                lp = jnp.where(accept, lp_p, lp)
                lq = jnp.where(accept, lq_p, lq)
                acc = acc + jnp.mean(accept.astype(jnp.float32))
                return (particles, lp, lq, acc), None

            ks = jax.random.split(key, num_mutations)
            (particles, lp, lq, acc), _ = jax.lax.scan(
                one, (particles, lp, lq, jnp.float32(0.0)), ks
            )
            return particles, lp, lq, acc / num_mutations

        def cond(state):
            beta, _, _, _, _, stage, _, _ = state
            return (beta < 1.0) & (stage < max_stages)

        def body(state):
            beta, particles, lp, lq, log_z, stage, _, key = state
            key, k_rs, k_mut = jax.random.split(key, 3)
            delta_lp = lp - lq
            delta = next_beta(beta, delta_lp)
            lw = delta * delta_lp
            m = jnp.max(lw)
            log_z = log_z + m + jnp.log(jnp.mean(jnp.exp(lw - m)))
            idx = _systematic_resample(k_rs, lw)
            particles, lp, lq = particles[idx], lp[idx], lq[idx]
            beta = beta + delta
            particles, lp, lq, acc = mutate(k_mut, particles, lp, lq, beta)
            return (beta, particles, lp, lq, log_z, stage + 1, acc, key)

        state = (
            jnp.float32(0.0),
            particles,
            lp,
            lq,
            jnp.float32(0.0),
            jnp.int32(0),
            jnp.float32(1.0),
            k_loop,
        )
        beta, particles, lp, lq, log_z, stages, acc, _ = jax.lax.while_loop(
            cond, body, state
        )
        return particles, log_z, stages, acc, beta

    # Reuse the traced program across calls (api._reuse_jit contract: every
    # closure constant of `run` is in the key; key/z0/data are arguments).
    from mlx_mcmc_tpu.inference.api import _hashable, _param_spec, _reuse_jit

    t_key = (
        None
        if not transforms
        else tuple(sorted(transforms.items(), key=lambda kv: kv[0]))
    )
    if t_key is None or all(_hashable(v) for _, v in t_key):
        jrun = _reuse_jit(
            "smc",
            (
                id(user_log_prob_fn),
                t_key,
                _param_spec(initial_params),
                data is not None,
                int(num_particles),
                int(num_mutations),
                float(ess_target),
                int(max_stages),
                float(q0_scale),
            ),
            run,
            pin=user_log_prob_fn,
        )
    else:
        jrun = jax.jit(run)
    particles_flat, log_z, stages, acc, beta = jrun(key, z0, data)
    particles = jax.vmap(unravel)(particles_flat)
    if to_constrained is not None:
        particles = to_constrained(particles)
    final_beta = float(beta)
    if final_beta < 1.0:
        import warnings

        warnings.warn(
            f"tempered SMC hit max_stages={max_stages} at beta="
            f"{final_beta:.4f} < 1.0: particles target an intermediate "
            "tempered distribution, NOT the posterior. Raise max_stages or "
            "lower ess_target.",
            RuntimeWarning,
            stacklevel=2,
        )
    return SMCResult(
        particles=particles,
        log_evidence=float(log_z),
        num_stages=int(stages),
        final_accept_rate=float(acc),
        num_particles=num_particles,
        final_beta=final_beta,
        _flat=particles_flat,
    )
