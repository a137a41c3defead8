"""Categorical distribution over {0, ..., K-1}.

Reference parity: mlx_mcmc/distributions/categorical.py:7-150 (XOR
``probs``/``logits`` constructor :53-65, gather-based ``log_prob`` :69-93 with
invalid-index masking, ``sample`` :95-128, ``entropy``/``mode`` :130-150).
Design deltas: sampling is one vectorized ``jax.random.categorical``
(Gumbel-max on-device) instead of the reference's uniform+cumsum comparison
loop, and batched category axes are supported via ``take_along_axis``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mlx_mcmc_tpu.distributions.base import Distribution


class Categorical(Distribution):
    """Categorical distribution parameterized by ``probs`` XOR ``logits``.

    The category axis is the last axis; leading axes are batch axes.
    """

    def __init__(self, probs=None, logits=None):
        if (probs is None) == (logits is None):
            raise ValueError("Provide exactly one of `probs` or `logits`.")
        if probs is not None:
            probs = jnp.asarray(probs, jnp.result_type(float))
            probs = probs / jnp.sum(probs, axis=-1, keepdims=True)
            self._log_probs = jnp.log(probs)
        else:
            logits = jnp.asarray(logits, jnp.result_type(float))
            self._log_probs = jax.nn.log_softmax(logits, axis=-1)

    @property
    def logits(self):
        return self._log_probs

    @property
    def probs(self):
        return jnp.exp(self._log_probs)

    @property
    def num_categories(self) -> int:
        return self._log_probs.shape[-1]

    @property
    def batch_shape(self):
        return self._log_probs.shape[:-1]

    def log_prob(self, value):
        value = jnp.asarray(value)
        k = self.num_categories
        idx = jnp.clip(value.astype(jnp.int32), 0, k - 1)
        if self._log_probs.ndim == 1:
            gathered = jnp.take(self._log_probs, idx)
        else:
            gathered = jnp.take_along_axis(
                self._log_probs, idx[..., None], axis=-1
            ).squeeze(-1)
        valid = (value >= 0) & (value <= k - 1) & (value == jnp.floor(value))
        return jnp.where(valid, gathered, -jnp.inf)

    def sample(self, key, shape=()):
        if isinstance(shape, int):
            shape = (shape,)
        out_shape = tuple(shape) + self.batch_shape
        return jax.random.categorical(key, self._log_probs, axis=-1, shape=out_shape)

    def entropy(self):
        p = jnp.exp(self._log_probs)
        return -jnp.sum(jnp.where(p > 0, p * self._log_probs, 0.0), axis=-1)

    def mode(self):
        return jnp.argmax(self._log_probs, axis=-1)

    def __repr__(self):  # pragma: no cover
        return f"Categorical(num_categories={self.num_categories})"
