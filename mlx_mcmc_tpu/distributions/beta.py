"""Beta distribution on (0, 1).

Reference parity: mlx_mcmc/distributions/beta.py:9-151 (``log_prob`` :59-91,
``sample`` :93-119, moments :121-151). Design deltas: the log-normalizer
``log B(a, b)`` is traced on-device via ``jax.scipy.special.betaln`` (the
reference calls host scipy ``gammaln`` at construction, beta.py:53-57, which
would break under traced parameters), and sampling is on-device
``jax.random.beta`` (the reference escapes to a host numpy RNG, beta.py:110-119).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import betaln, digamma

from mlx_mcmc_tpu.distributions.base import Distribution
from mlx_mcmc_tpu.ops.math import safe_where_log_prob


class Beta(Distribution):
    """Beta distribution with concentration parameters ``alpha``, ``beta``."""

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
            return (a - 1.0) * jnp.log(x) + (b - 1.0) * jnp.log1p(-x) - betaln(a, b)

        in_support = (value > 0.0) & (value < 1.0)
        return safe_where_log_prob(in_support, value, 0.5, _lp)

    def sample(self, key, shape=()):
        out_shape = self._sample_shape(shape)
        return jax.random.beta(key, self.alpha, self.beta, shape=out_shape)

    def mean(self):
        return self.alpha / (self.alpha + self.beta)

    def variance(self):
        s = self.alpha + self.beta
        return self.alpha * self.beta / (s * s * (s + 1.0))

    def mode(self):
        """Mode for alpha, beta > 1; NaN where the density is unbounded."""
        a, b = jnp.asarray(self.alpha, jnp.result_type(float)), jnp.asarray(
            self.beta, jnp.result_type(float)
        )
        interior = (a > 1.0) & (b > 1.0)
        safe_denom = jnp.where(interior, a + b - 2.0, 1.0)
        return jnp.where(interior, (a - 1.0) / safe_denom, jnp.nan)

    def entropy(self):
        a, b = self.alpha, self.beta
        s = a + b
        return (
            betaln(a, b)
            - (a - 1.0) * digamma(a)
            - (b - 1.0) * digamma(b)
            + (s - 2.0) * digamma(s)
        )

    def __repr__(self):  # pragma: no cover
        return f"Beta(alpha={self.alpha}, beta={self.beta})"
