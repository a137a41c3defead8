"""Hierarchical Poisson event-rate models — the reference's "event rates"
scenario (reference examples/04_event_rates.py:29-35: a single Exponential/
Gamma rate fit to 50 waiting times) grown to the "Large model" class its
README claims (reference README.md:105-113): 1000 groups x 100 observed
counts, hierarchical log-rates.

Two variants:

- ``covariate_dim=0`` (pure event rates): y_{g,i} ~ Poisson(exp(theta_g)),
  theta_g = mu + tau * theta_raw_g. The Poisson is an exponential family, so
  the data enters ONLY through per-group sufficient statistics
  (S_g = sum_i y_{g,i} and the count n) — the answer is the exact
  O(N) -> O(G) collapse in :mod:`mlx_mcmc_tpu.ops.suffstats`
  (``make_poisson_rates_model``), same as the Gaussian hier1000 row.

- ``covariate_dim=K>0`` (Poisson regression): y_{g,i} ~
  Poisson(exp(theta_g + x_{g,i} . beta)) with per-OBSERVATION covariates.
  The term exp(x_{g,i} . beta) destroys the sufficient-statistic structure:
  every density/gradient evaluation must touch all N observations. This is
  the honest non-collapsible "Large model" row
  (ops/poisson.py holds its hand-written value and gradient).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from mlx_mcmc_tpu.distributions import Normal


class PoissonSpec(NamedTuple):
    log_prob: callable
    initial_params: dict
    y: jnp.ndarray  # (G, n) integer counts, as f32
    X: Optional[jnp.ndarray]  # (G, n, K) covariates or None
    truth: dict


def make_poisson_event_rates(
    num_groups: int = 1000,
    obs_per_group: int = 100,
    covariate_dim: int = 0,
    seed: int = 0,
    true_mu: float = 1.0,
    true_tau: float = 0.5,
) -> PoissonSpec:
    """Hierarchical Poisson counts, non-centered log-rates:

        mu ~ N(0, 5);  log_tau ~ N(0, 1);  theta_raw_g ~ N(0, 1)
        theta_g = mu + tau * theta_raw_g
        y_{g,i} ~ Poisson(exp(theta_g + x_{g,i} . beta))

    with ``beta ~ N(0, 1)`` per component when ``covariate_dim > 0`` (true
    beta drawn at scale 0.3 so rates stay moderate).

    The returned ``log_prob`` is the fully vectorized full-data density
    (one jnp reduction over all G*n observations — never a per-observation
    Python loop, the reference's biggest model-side inefficiency,
    SURVEY.md §3.4).
    """
    key = jax.random.PRNGKey(seed)
    k_theta, k_x, k_beta, k_y = jax.random.split(key, 4)
    true_theta = true_mu + true_tau * jax.random.normal(
        k_theta, (num_groups,)
    )
    if covariate_dim > 0:
        X = 0.5 * jax.random.normal(
            k_x, (num_groups, obs_per_group, covariate_dim)
        )
        true_beta = 0.3 * jax.random.normal(k_beta, (covariate_dim,))
        log_rate = true_theta[:, None] + X @ true_beta
    else:
        X, true_beta = None, None
        log_rate = jnp.broadcast_to(
            true_theta[:, None], (num_groups, obs_per_group)
        )
    y = jax.random.poisson(k_y, jnp.exp(log_rate)).astype(jnp.float32)

    # Data constant of the Poisson pmf: -sum log(y!) (independent of params).
    log_y_fact = jnp.sum(jax.scipy.special.gammaln(y + 1.0))

    def log_prob(params):
        mu, log_tau = params["mu"], params["log_tau"]
        theta_raw = params["theta_raw"]
        tau = jnp.exp(log_tau)
        theta = mu + tau * theta_raw  # (G,)
        s = theta[:, None]
        lp = Normal(0.0, 5.0).log_prob(mu)
        lp += Normal(0.0, 1.0).log_prob(log_tau)
        lp += jnp.sum(Normal(0.0, 1.0).log_prob(theta_raw))
        if covariate_dim > 0:
            beta = params["beta"]
            # precision=HIGHEST: a predictor with rounded operands (bf16,
            # or TF32 from a default-precision float32 product on the GPU)
            # injects O(nats) log-likelihood noise at 100K-obs count scale,
            # which collapses NUTS adaptation (see ops/poisson.py). The
            # contraction is tiny (K per obs).
            s = s + jnp.dot(
                X, beta, precision=jax.lax.Precision.HIGHEST
            )  # (G, n)
            lp += jnp.sum(Normal(0.0, 1.0).log_prob(beta))
        lp += jnp.sum(y * s - jnp.exp(s)) - log_y_fact
        return lp

    initial = {
        "mu": 0.0,
        "log_tau": 0.0,
        "theta_raw": jnp.zeros(num_groups),
    }
    truth = {"mu": true_mu, "tau": true_tau}
    if covariate_dim > 0:
        initial["beta"] = jnp.zeros(covariate_dim)
        truth["beta"] = true_beta
    return PoissonSpec(
        log_prob=log_prob, initial_params=initial, y=y, X=X, truth=truth
    )
