"""Affine-invariant ensemble sampler (Goodman & Weare stretch move).

A gradient-free sampler the reference does not have (its only gradient-free
kernel is random-walk Metropolis, mlx_mcmc/kernels/metropolis.py): an
ensemble of walkers whose proposals are built from the spread of the
ensemble itself, making the sampler invariant to affine reparameterizations
— no step-size or mass-matrix tuning at all, and strong performance on
skewed/correlated posteriors where an untuned random walk crawls.

Compiled mapping: walkers ARE the batch axis. The classic serial algorithm
updates one walker at a time; here we use the parallel complementary-halves
formulation (emcee's "red-black" scheme): split the ensemble into two fixed
halves, update all walkers of one half simultaneously against the *other*
half (which preserves detailed balance), then swap. Each half-update is one
batched ``log_prob`` evaluation — an (W/2, D) matrix op that tiles onto the
tensor cores for data-heavy models — and the whole run is warmup scan + sampling scan
under a single ``jit``, exactly like the engine's gradient kernels.

Stretch move (Goodman & Weare 2010): partner X_j drawn from the complement,
scale z ~ g(z) ∝ 1/sqrt(z) on [1/a, a], proposal Y = X_j + z (X_k - X_j),
accepted with probability min(1, z^(D-1) p(Y)/p(X_k)).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from mlx_mcmc_tpu.inference.api import MCMCResult, _as_key
from mlx_mcmc_tpu.kernels.base import TransitionInfo, Tunables
from mlx_mcmc_tpu.ops.ravel import make_flat_logprob


def _half_update(key, active, active_lp, other, a, batch_log_prob):
    """Stretch-move update of one half-ensemble against the other half."""
    n_half, dim = active.shape
    k_part, k_z, k_acc = jax.random.split(key, 3)
    partners = jax.random.randint(k_part, (n_half,), 0, other.shape[0])
    x_j = other[partners]
    # z ~ g(z) ∝ 1/sqrt(z) on [1/a, a] via inverse-CDF: z = ((a-1)u + 1)² / a
    u = jax.random.uniform(k_z, (n_half,))
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    proposal = x_j + z[:, None] * (active - x_j)
    proposal_lp = batch_log_prob(proposal)
    log_accept = (dim - 1) * jnp.log(z) + proposal_lp - active_lp
    log_accept = jnp.where(jnp.isnan(log_accept), -jnp.inf, log_accept)
    log_u = jnp.log(jax.random.uniform(k_acc, (n_half,)))
    accepted = log_u < log_accept
    new = jnp.where(accepted[:, None], proposal, active)
    new_lp = jnp.where(accepted, proposal_lp, active_lp)
    accept_prob = jnp.exp(jnp.minimum(log_accept, 0.0))
    return new, new_lp, accepted, accept_prob


def sample_ensemble(
    log_prob_fn: Callable[..., jnp.ndarray],
    initial_params: Any,
    *,
    num_walkers: int = 64,
    num_samples: int = 1000,
    num_warmup: int = 500,
    thin: int = 1,
    a: float = 2.0,
    seed=0,
    jitter: float = 0.1,
    data=None,
    transforms: Optional[dict] = None,
) -> MCMCResult:
    """Run the affine-invariant ensemble sampler.

    Args:
        log_prob_fn: dict-of-params model (binary ``(params, data)`` when
            ``data`` is given) — same contract as :func:`mlx_mcmc_tpu.sample`.
        num_walkers: ensemble size; must be even and should be ≥ 2·dim
            (the complement half must span the parameter space for the
            stretch move to propose in all directions).
        a: stretch scale (>1). 2.0 is the standard choice; larger values
            propose bolder moves at lower acceptance.
        jitter: std of the Gaussian ball the walkers start in. Walkers MUST
            be distinct (coincident walkers make degenerate proposals), so
            unlike :func:`sample` this default is nonzero.
        transforms: optional unconstraining transforms (sampling happens in
            unconstrained space; draws return constrained).

    Returns:
        :class:`MCMCResult` with walkers on the chains axis — ``summary``,
        ``diagnostics`` (R-hat/ESS treat walkers as chains) and the rest of
        the result surface work unchanged.
    """
    if num_walkers < 4 or num_walkers % 2 != 0:
        raise ValueError("num_walkers must be even and >= 4")
    if a <= 1.0:
        raise ValueError("stretch scale a must be > 1")

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
    half = num_walkers // 2

    key = _as_key(seed)
    key_init, key_run = jax.random.split(key)

    def run(key_init, key_run, z0, data):
        if data is None:
            lp_one = flat_log_prob
        else:
            lp_one = lambda z: flat_log_prob(z, data)  # noqa: E731
        batch_log_prob = jax.vmap(lp_one)

        walkers = z0 + jitter * jax.random.normal(
            key_init, (num_walkers, dim), z0.dtype
        )
        lps = batch_log_prob(walkers)

        def one_step(carry, t):
            walkers, lps = carry
            k0, k1 = jax.random.split(jax.random.fold_in(key_run, t))
            first, second = walkers[:half], walkers[half:]
            lp_first, lp_second = lps[:half], lps[half:]
            first, lp_first, acc0, ap0 = _half_update(
                k0, first, lp_first, second, a, batch_log_prob
            )
            second, lp_second, acc1, ap1 = _half_update(
                k1, second, lp_second, first, a, batch_log_prob
            )
            walkers = jnp.concatenate([first, second])
            lps = jnp.concatenate([lp_first, lp_second])
            info = TransitionInfo(
                accept_prob=jnp.concatenate([ap0, ap1]),
                is_accepted=jnp.concatenate([acc0, acc1]),
                is_divergent=jnp.zeros((num_walkers,), bool),
                energy=-lps,
                log_prob=lps,
                num_integration_steps=jnp.ones((num_walkers,), jnp.int32),
                tree_depth=jnp.zeros((num_walkers,), jnp.int32),
                step_size=jnp.full((num_walkers,), a, jnp.float32),
            )
            return (walkers, lps), info

        carry = (walkers, lps)
        if num_warmup > 0:
            def warmup_body(c, t):
                c, _ = one_step(c, t)
                return c, None

            carry, _ = jax.lax.scan(
                warmup_body, carry, jnp.arange(num_warmup, dtype=jnp.int32)
            )

        def sample_body(c, t0):
            if thin == 1:
                c, info = one_step(c, t0)
            else:
                ts = t0 + jnp.arange(thin, dtype=jnp.int32)
                c, infos = jax.lax.scan(one_step, c, ts)
                info = jax.tree_util.tree_map(lambda x: x[-1], infos)
            return c, (c[0], info)

        sample_steps = jnp.arange(
            num_warmup, num_warmup + num_samples * thin, thin, dtype=jnp.int32
        )
        _, (positions, infos) = jax.lax.scan(sample_body, carry, sample_steps)
        # (draws, walkers, ...) -> (walkers, draws, ...)
        positions = jnp.swapaxes(positions, 0, 1)
        infos = jax.tree_util.tree_map(
            lambda x: jnp.swapaxes(x, 0, 1), infos
        )
        return positions, infos

    # Reuse the traced program across calls (see api._reuse_jit contract:
    # every closure constant of `run` appears in the key; keys/z0/data are
    # arguments). Unhashable transform values fall back to a fresh jit.
    from mlx_mcmc_tpu.inference.api import _hashable, _param_spec, _reuse_jit

    t_key = (
        None
        if not transforms
        else tuple(sorted(transforms.items(), key=lambda kv: kv[0]))
    )
    if t_key is None or all(_hashable(v) for _, v in t_key):
        jrun = _reuse_jit(
            "ensemble",
            (
                id(user_log_prob_fn),
                t_key,
                _param_spec(initial_params),
                data is not None,
                num_walkers,
                int(num_samples),
                int(num_warmup),
                int(thin),
                float(a),
                float(jitter),
            ),
            run,
            pin=user_log_prob_fn,
        )
    else:
        jrun = jax.jit(run)
    positions, infos = jrun(key_init, key_run, z0, data)
    samples = jax.vmap(jax.vmap(unravel))(positions)
    if to_constrained is not None:
        samples = to_constrained(samples)
    return MCMCResult(
        samples=samples,
        info=infos,
        tunables=Tunables(
            step_size=jnp.asarray(a, jnp.float32),
            inv_mass_diag=jnp.ones((dim,), jnp.float32),
        ),
        num_chains=num_walkers,
        num_samples=num_samples,
        kernel="ensemble",
    )
