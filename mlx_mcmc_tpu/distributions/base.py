"""Abstract distribution contract.

Reference parity: mlx_mcmc/distributions/base.py:6-50 defines ``Distribution``
with ``log_prob(value)`` and ``sample(key, shape=())``.

Design deltas:
- every method is a pure traced function — safe under ``jit``/``grad``/``vmap``/
  ``pjit`` with traced parameters (the reference computes Beta/Gamma
  normalizers on host via scipy at construction, beta.py:53-57/gamma.py:55-59,
  and samples Beta/Gamma through numpy, beta.py:110-119/gamma.py:107-117 —
  nothing here ever leaves the device);
- parameters broadcast: scalar, batched, or traced arrays all work;
- sampling uses ``jax.random`` counter-based keys exclusively.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


class Distribution:
    """Base class for probability distributions.

    Subclasses implement ``log_prob`` and ``sample``; moments
    (``mean``/``variance``/...) where closed forms exist.
    """

    def log_prob(self, value) -> jnp.ndarray:
        """Elementwise log-density (log-mass) at ``value``.

        Returns ``-inf`` outside the support, with NaN-safe gradients at the
        boundary (zero, not NaN).
        """
        raise NotImplementedError

    def sample(self, key, shape: Tuple[int, ...] = ()) -> jnp.ndarray:
        """Draw samples of shape ``shape + batch_shape`` using a JAX PRNG key."""
        raise NotImplementedError

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return ()

    def _sample_shape(self, shape) -> Tuple[int, ...]:
        if isinstance(shape, int):
            shape = (shape,)
        return tuple(shape) + self.batch_shape

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"{type(self).__name__}()"
