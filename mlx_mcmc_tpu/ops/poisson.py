"""Hierarchical Poisson regression value+grad in one XLA expression.

The non-collapsible "Large model" row (models/poisson.py, covariate_dim>0):
with per-observation covariates the likelihood

    y_{g,i} ~ Poisson(exp(theta_g + x_{g,i} . beta))

must touch all N = G*n observations per gradient evaluation — the
exponential-family collapse of the rate-only model (ops/suffstats.py) does
not apply.

The value and gradient are written out by hand instead of by autodiff, so
that XLA sees one chain of elementwise work and reductions per chain:

    s       = theta_g + sum_k x_k beta_k      K broadcast multiply-adds
    r       = y - exp(s)                      residual, d ll / d s
    ll      = sum y (s - shat_g) - (exp(s) - lamhat_g)   (centred, below)
    dtheta  = per-group sums of r             contiguous (G, n) layout
    dbeta   = sum r x_k                       one reduction per covariate

PRECISION is the load-bearing decision (docs/DESIGN.md §4b): a linear
predictor whose operands are rounded to bfloat16 (or to TF32 by a
default-precision float32 matmul on the GPU) injects nats of
state-dependent log-likelihood noise at this observation and count scale,
which collapses NUTS adaptation outright (step size driven towards zero,
accept far below target, every tree at the depth cap). The predictor is
therefore K float32 multiply-adds, exact in float32, and the per-row terms
are summed CENTRED on per-group baseline rates so the partial sums stay
O(residual) instead of O(count). The gradient tolerates rounding (a
deterministic force field keeps leapfrog reversible), the value does not.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from mlx_mcmc_tpu.ops.dispatch import chain_batched


def prepare_fused_poisson_data(y, X) -> dict:
    """Pack (G, n) counts + (G, n, K) covariates for the vag.

    The covariates are stored one contiguous (G, n) plane per component,
    ``X`` (K, G, n). Per-group baseline rates ``lamhat_g = mean(y_g)``
    (clamped away from 0: an all-zero group would give ``shat = -inf``)
    centre the per-row terms; their constant part and ``-sum log(y!)``
    fold into ``c0``.
    """
    y = jnp.asarray(y, jnp.float32)
    X = jnp.asarray(X, jnp.float32)
    lamhat = jnp.maximum(jnp.mean(y, axis=1), 1e-3)  # (G,)
    shat = jnp.log(lamhat)
    center_const = jnp.sum(y * shat[:, None] - lamhat[:, None])
    return {
        "X": jnp.moveaxis(X, -1, 0),
        "y": y,
        "shat": shat,
        "lamhat": lamhat,
        "c0": -jnp.sum(jax.scipy.special.gammaln(y + 1.0)) + center_const,
    }


def make_fused_poisson_vag(
    prior_mu_scale: float = 5.0,
    prior_log_tau_scale: float = 1.0,
):
    """``value_and_grad`` of the non-centered hierarchical Poisson
    REGRESSION log-posterior over the flat vector
    ``z = [beta(K), log_tau, mu, theta_raw(G)]`` (ravel_pytree's
    alphabetical dict order for models/poisson.py params), consuming
    :func:`prepare_fused_poisson_data` output: ``vag(z, data)``.

    The data terms (ll, dll/dtheta, dll/dbeta) get the non-centered chain
    rule (theta = mu + tau * theta_raw) and the standard priors, all (C, G)
    elementwise. Same custom_vmap chain-batching contract as the GLM vag.
    """
    inv_mu_var = 1.0 / (prior_mu_scale * prior_mu_scale)
    inv_lt_var = 1.0 / (prior_log_tau_scale * prior_log_tau_scale)
    log_norm = -math.log(prior_mu_scale) - math.log(prior_log_tau_scale)

    def batched(Z, data):
        X, y = data["X"], data["y"]  # (K, G, n), (G, n)
        K, G, _ = X.shape
        beta = Z[:, :K]  # (C, K)
        log_tau = Z[:, K]
        mu = Z[:, K + 1]
        theta_raw = Z[:, K + 2:]  # (C, G)
        tau = jnp.exp(log_tau)
        theta = mu[:, None] + tau[:, None] * theta_raw  # (C, G)

        s = theta[:, :, None]  # (C, G, 1) -> (C, G, n)
        for k in range(K):
            s = s + X[k][None] * beta[:, k, None, None]
        lam = jnp.exp(s)
        r = y[None] - lam
        t = y[None] * (s - data["shat"][None, :, None]) - (
            lam - data["lamhat"][None, :, None]
        )
        # Sibling reductions over the contiguous observation axis (one pass
        # for XLA to fuse), then small sums over groups: partial sums stay
        # per-group.
        ll = jnp.sum(jnp.sum(t, axis=2), axis=1)
        r_theta = jnp.sum(r, axis=2)  # (C, G)
        g_beta = jnp.stack(
            [jnp.sum(jnp.sum(r * X[k][None], axis=2), axis=1)
             for k in range(K)],
            axis=-1,
        )

        # The state-dependent terms are summed first and the constants
        # (c0, the prior normalisers) join in ONE final addition: at
        # |lp| ~ 1e5 every float32 addition rounds by up to ulp/2 ~ 0.008
        # nats, so each extra addition at that magnitude spends budget.
        half_log2pi = 0.5 * math.log(2.0 * math.pi)
        const = data["c0"] + (
            log_norm
            - 0.5 * K * math.log(2.0 * math.pi)  # beta prior norm
            - (2.0 + G) * half_log2pi
        )
        lp = (
            ll
            - 0.5 * inv_mu_var * mu * mu
            - 0.5 * inv_lt_var * log_tau * log_tau
            - 0.5 * jnp.sum(theta_raw * theta_raw, axis=-1)
            - 0.5 * jnp.sum(beta * beta, axis=-1)
        ) + const
        g_mu = jnp.sum(r_theta, axis=-1) - inv_mu_var * mu
        g_log_tau = (
            tau * jnp.sum(r_theta * theta_raw, axis=-1)
            - inv_lt_var * log_tau
        )
        g_theta_raw = tau[:, None] * r_theta - theta_raw
        g_beta = g_beta - beta
        grad = jnp.concatenate(
            [g_beta, g_log_tau[:, None], g_mu[:, None], g_theta_raw], axis=1
        )
        return lp, grad

    return chain_batched(batched, "make_fused_poisson_vag")


def make_fused_poisson_model(
    prior_mu_scale: float = 5.0,
    prior_log_tau_scale: float = 1.0,
):
    """``(log_prob, value_and_grad_fn)`` bound to one set of prior scales
    (same contract as the ops/suffstats.py factories — the density and
    gradient halves cannot diverge)."""
    vag = make_fused_poisson_vag(
        prior_mu_scale=prior_mu_scale,
        prior_log_tau_scale=prior_log_tau_scale,
    )

    def log_prob(params, data):
        from mlx_mcmc_tpu.ops.ravel import ravel_params

        z, _ = ravel_params(params)
        ll, _ = vag(z, data)
        return ll

    return log_prob, vag
