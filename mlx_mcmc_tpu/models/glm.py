"""Generalized linear models — the matmul-heavy benchmark family.

These are the "100 params / 10K obs" and "1000 params / 100K obs" workloads
the reference only *names* in its performance table (README.md:105-113)
without shipping code. Design decisions:

- the design matrix ``X`` lives in device memory once; each log-density
  evaluation is one ``X @ beta`` product — and under ``vmap`` over chains
  it becomes an ``(N, D) @ (D, C)`` matmul for the tensor cores (contrast
  with the reference's per-observation Python loops, examples/01:46-48);
- data can optionally be stored in bfloat16 to halve the bytes each
  evaluation reads (the dominant cost for large N) while accumulating in
  f32. float32 data gets a full-precision product
  (:func:`~mlx_mcmc_tpu.ops.dispatch.value_precision`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mlx_mcmc_tpu.distributions import Normal
from mlx_mcmc_tpu.ops.dispatch import value_precision


class GLMSpec(NamedTuple):
    """A generated GLM problem: model + data + truth."""

    log_prob: callable
    initial_params: dict
    X: jnp.ndarray
    y: jnp.ndarray
    true_beta: jnp.ndarray


def _design_matrix(key, num_obs, num_features, dtype):
    # Columns scaled so X @ beta stays O(1) as num_features grows.
    X = jax.random.normal(key, (num_obs, num_features), jnp.float32)
    return (X / jnp.sqrt(jnp.asarray(num_features, jnp.float32))).astype(dtype)


def make_logistic_regression(
    num_features: int = 100,
    num_obs: int = 10_000,
    seed: int = 0,
    prior_scale: float = 1.0,
    data_dtype=jnp.float32,
) -> GLMSpec:
    """Bayesian logistic regression: beta ~ N(0, prior_scale), y ~ Bernoulli(sigmoid(X beta))."""
    key = jax.random.PRNGKey(seed)
    key_x, key_beta, key_y = jax.random.split(key, 3)
    X = _design_matrix(key_x, num_obs, num_features, data_dtype)
    true_beta = jax.random.normal(key_beta, (num_features,), jnp.float32)
    logits = (X.astype(jnp.float32) @ true_beta).astype(jnp.float32)
    y = jax.random.bernoulli(key_y, jax.nn.sigmoid(logits)).astype(jnp.float32)

    def log_prob(params):
        beta = params["beta"]
        s = jnp.dot(X, beta.astype(X.dtype), precision=value_precision(X.dtype),
                    preferred_element_type=jnp.float32)
        # Bernoulli log-lik: y*s - softplus(s), stable for large |s|.
        log_lik = jnp.sum(y * s - jax.nn.softplus(s))
        log_prior = jnp.sum(Normal(0.0, prior_scale).log_prob(beta))
        return log_lik + log_prior

    return GLMSpec(
        log_prob=log_prob,
        initial_params={"beta": jnp.zeros(num_features)},
        X=X,
        y=y,
        true_beta=true_beta,
    )


def make_linear_regression(
    num_features: int = 100,
    num_obs: int = 10_000,
    noise_scale: float = 1.0,
    seed: int = 0,
    prior_scale: float = 1.0,
    data_dtype=jnp.float32,
) -> GLMSpec:
    """Bayesian linear regression with known noise scale (Gaussian posterior,
    so moments are analytically checkable)."""
    key = jax.random.PRNGKey(seed)
    key_x, key_beta, key_y = jax.random.split(key, 3)
    X = _design_matrix(key_x, num_obs, num_features, data_dtype)
    true_beta = jax.random.normal(key_beta, (num_features,), jnp.float32)
    y = (
        X.astype(jnp.float32) @ true_beta
        + noise_scale * jax.random.normal(key_y, (num_obs,), jnp.float32)
    )

    def log_prob(params):
        beta = params["beta"]
        mu = jnp.dot(X, beta.astype(X.dtype), precision=value_precision(X.dtype),
                     preferred_element_type=jnp.float32)
        resid = y - mu
        log_lik = -0.5 * jnp.sum(resid * resid) / (noise_scale**2)
        log_prior = -0.5 * jnp.sum(beta * beta) / (prior_scale**2)
        return log_lik + log_prior

    return GLMSpec(
        log_prob=log_prob,
        initial_params={"beta": jnp.zeros(num_features)},
        X=X,
        y=y,
        true_beta=true_beta,
    )
