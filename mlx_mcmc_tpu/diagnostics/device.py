"""Device-resident diagnostics: split R-hat and ESS as traced jnp ops.

These run *inside* compiled programs — including under ``shard_map`` with the
chain axis sharded across a mesh, where cross-chain moments ride
``lax.pmean``/``psum`` collectives (SURVEY.md §2.3). Only the thin (P,)
statistics leave the device, never the (chains, draws, P) draw tensor: for a
1000-param x 100K-draw x many-host run that's the difference between moving
kilobytes and moving the whole sample store between hosts.

Semantics match ``diagnostics/stats.py`` (numpy reference): split-chain
R-hat, FFT autocovariance + Geyer initial monotone positive sequence ESS.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def _pmean(x, axis_name: Optional[str]):
    return jax.lax.pmean(x, axis_name) if axis_name else x


def device_rhat(x: jnp.ndarray, axis_name: Optional[str] = None) -> jnp.ndarray:
    """Split R-hat. ``x``: (chains_local, draws, ...) -> shape ``(...)``.

    With ``axis_name`` the chain statistics are pooled across that mesh axis
    (all shards must hold the same number of chains).
    """
    c, n = x.shape[0], x.shape[1]
    half = n // 2
    x = jnp.concatenate([x[:, :half], x[:, half : 2 * half]], axis=0)
    m_local, n = 2 * c, half

    chain_means = jnp.mean(x, axis=1)  # (m_local, ...)
    chain_vars = jnp.var(x, axis=1, ddof=1)
    within = _pmean(jnp.mean(chain_vars, axis=0), axis_name)

    grand_mean = _pmean(jnp.mean(chain_means, axis=0), axis_name)
    sq = jnp.mean((chain_means - grand_mean) ** 2, axis=0)
    world = jax.lax.psum(1, axis_name) if axis_name else 1
    m_total = m_local * world
    # unbiased between-chain variance of means, pooled across all shards
    between = _pmean(sq, axis_name) * m_total / jnp.maximum(m_total - 1, 1) * n

    var_plus = (n - 1) / n * within + between / n
    return jnp.sqrt(var_plus / within)


def device_ess(x: jnp.ndarray, axis_name: Optional[str] = None) -> jnp.ndarray:
    """Combined-chain ESS. ``x``: (chains_local, draws, ...) -> ``(...)``.

    Vectorized Geyer truncation: pair sums, a ``cumprod`` positivity mask and
    a ``cummin`` monotone pass — no data-dependent control flow, so it
    compiles into the same program as the sampler.
    """
    m_local, n = x.shape[0], x.shape[1]
    world = jax.lax.psum(1, axis_name) if axis_name else 1
    m = m_local * world

    centered = x - jnp.mean(x, axis=1, keepdims=True)
    pad = 1 << (2 * n - 1).bit_length()
    f = jnp.fft.rfft(centered, n=pad, axis=1)
    acov = jnp.fft.irfft(f * jnp.conj(f), n=pad, axis=1)[:, :n].real / n

    chain_var = acov[:, 0] * n / (n - 1.0)
    mean_var = _pmean(jnp.mean(chain_var, axis=0), axis_name)  # W
    var_plus = mean_var * (n - 1.0) / n
    chain_means = jnp.mean(x, axis=1)
    grand_mean = _pmean(jnp.mean(chain_means, axis=0), axis_name)
    if m > 1:
        sq = jnp.mean((chain_means - grand_mean) ** 2, axis=0)
        between = _pmean(sq, axis_name) * m / (m - 1.0)
        var_plus = var_plus + between

    rho = 1.0 - (mean_var[None] - _pmean(jnp.mean(acov, axis=0), axis_name)) / var_plus[None]
    rho = rho.at[0].set(1.0)

    max_pairs = n // 2
    pair = rho[: 2 * max_pairs]
    pair = pair.reshape((max_pairs, 2) + rho.shape[1:]).sum(axis=1)
    keep = jnp.cumprod(pair > 0.0, axis=0).astype(bool)
    pair = jnp.where(keep, pair, 0.0)
    pair = jax.lax.associative_scan(jnp.minimum, pair, axis=0)
    pair = jnp.maximum(pair, 0.0)
    tau = -1.0 + 2.0 * jnp.sum(pair, axis=0)
    ess = m * n / jnp.maximum(tau, 1e-12)
    cap = m * n * jnp.log10(jnp.maximum(float(m * n), 10.0))
    return jnp.minimum(ess, cap)
