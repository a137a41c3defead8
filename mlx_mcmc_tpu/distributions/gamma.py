"""Gamma distribution (shape/rate parameterization).

Reference parity: mlx_mcmc/distributions/gamma.py:9-149 (shape-rate at :24,
``log_prob`` :61-88, ``sample`` :90-117 with a shape-scale conversion, moments
:119-149). Design deltas: ``gammaln`` is traced on-device (reference uses
host scipy, gamma.py:55-59) and sampling is ``jax.random.gamma`` scaled by
``1/rate`` (reference escapes to numpy, gamma.py:107-117).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from mlx_mcmc_tpu.distributions.base import Distribution
from mlx_mcmc_tpu.ops.math import safe_where_log_prob


class Gamma(Distribution):
    """Gamma distribution with shape ``alpha`` and rate ``beta`` (mean ``alpha/beta``)."""

    def __init__(self, alpha, beta):
        self.alpha = alpha
        self.beta = beta

    @property
    def batch_shape(self):
        return jnp.broadcast_shapes(jnp.shape(self.alpha), jnp.shape(self.beta))

    def log_prob(self, value):
        value = jnp.asarray(value)
        a, b = self.alpha, self.beta

        def _lp(x):
            return a * jnp.log(b) + (a - 1.0) * jnp.log(x) - b * x - gammaln(a)

        return safe_where_log_prob(value > 0.0, value, 1.0, _lp)

    def sample(self, key, shape=()):
        out_shape = self._sample_shape(shape)
        return jax.random.gamma(key, self.alpha, shape=out_shape) / self.beta

    def mean(self):
        return self.alpha / self.beta

    def variance(self):
        return self.alpha / jnp.square(self.beta)

    def mode(self):
        """Mode for alpha >= 1; NaN where the density is unbounded at 0."""
        a = jnp.asarray(self.alpha, jnp.result_type(float))
        return jnp.where(a >= 1.0, (a - 1.0) / self.beta, jnp.nan)

    def __repr__(self):  # pragma: no cover
        return f"Gamma(alpha={self.alpha}, beta={self.beta})"
