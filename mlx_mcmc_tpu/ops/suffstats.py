"""Sufficient-statistic collapse for Gaussian group likelihoods.

The hierarchical benchmark's likelihood (models/hierarchical.py, the
reference's "Large model" class, README.md:105-113) is

    y_{g,i} ~ N(theta_g, sigma),   theta = mu + tau * theta_raw

For a *Gaussian* likelihood with per-group means, the data enters the
log-density only through per-group sufficient statistics — so the compiled-engine
"fused kernel" for this model is to hoist the entire O(N) data reduction out
of the hot loop at data-prep time. With group means ``ybar_g`` and counts
``n_g``:

    ll(theta) = -0.5/sigma^2 * sum_g n_g (theta_g - ybar_g)^2 + C0
    d ll / d theta_g = n_g (ybar_g - theta_g) / sigma^2

where ``C0 = -0.5/sigma^2 (sum y^2 - sum_g n_g ybar_g^2) - N log(sigma
sqrt(2 pi))`` is a data constant. One leapfrog's likelihood work drops from
O(chains * N) to O(chains * G) — 100x fewer FLOPs at 100 obs/group — and the
collapse is EXACT (same posterior; the quadratic is expanded around ybar_g,
so every term is O(posterior scale) and there is no large-sum cancellation —
the failure mode that sank the hoisted GLM epilogue, see
docs/DESIGN.md §4b).

After the collapse the per-leapfrog op is a few (chains, G) elementwise
passes — far below compute/HBM limits — so no Pallas kernel is warranted: the
hier1000 benchmark becomes NUTS-bookkeeping-bound, which is the correct
hardware outcome for a model with closed-form sufficient statistics.

Flat layout: the engine flattens the param dict with ``ravel_pytree``, which
orders dict keys alphabetically — {"log_tau", "mu", "theta_raw"} maps to
``z = [log_tau, mu, theta_raw_0..G-1]`` (validated against autodiff in
tests/test_suffstats.py).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def prepare_hier_normal_data(
    y: jnp.ndarray, noise_scale: float = 1.0
) -> dict:
    """Collapse a (num_groups, obs_per_group) observation matrix to its
    sufficient statistics for :func:`make_hier_normal_vag`.

    Returns a small pytree for ``sample(..., data=...)`` — ~8 KB for the
    998-group benchmark instead of the 40 MB raw matrix.
    """
    y = jnp.asarray(y, jnp.float32)
    num_groups, obs_per_group = y.shape
    n_total = num_groups * obs_per_group
    ybar = jnp.mean(y, axis=1)  # (G,)
    # residual sum of squares around the group means, f32-accumulated once
    rss = jnp.sum((y - ybar[:, None]) ** 2)
    inv_var = 1.0 / (noise_scale * noise_scale)
    c0 = -0.5 * inv_var * rss - n_total * math.log(
        noise_scale * math.sqrt(2.0 * math.pi)
    )
    return {
        "ybar": ybar,
        "n_per_group": jnp.asarray(float(obs_per_group), jnp.float32),
        "c0": jnp.asarray(c0, jnp.float32),
        "inv_noise_var": jnp.asarray(inv_var, jnp.float32),
    }


def make_hier_normal_vag(
    prior_mu_scale: float = 5.0,
    prior_log_tau_scale: float = 1.0,
):
    """``value_and_grad`` of the non-centered hierarchical-normal
    log-posterior over the flat vector ``z = [log_tau, mu, theta_raw...]``
    (models/hierarchical.py priors: mu ~ N(0, 5), log_tau ~ N(0, 1),
    theta_raw ~ N(0, 1)), consuming :func:`prepare_hier_normal_data` output.

    Closed-form gradient (no autodiff pass): with ``r_g = n_g (ybar_g -
    theta_g) / sigma^2`` the chain rule through ``theta = mu + tau *
    theta_raw`` gives ``d/dmu = sum r``, ``d/dlog_tau = tau * sum(r *
    theta_raw)``, ``d/dtheta_raw = tau * r``. Everything is (chains, G)
    elementwise + one small reduction; a ``custom_vmap`` rule batches the
    engine's chain vmap directly.
    """
    inv_mu_var = 1.0 / (prior_mu_scale * prior_mu_scale)
    inv_lt_var = 1.0 / (prior_log_tau_scale * prior_log_tau_scale)
    log_norm = -math.log(prior_mu_scale) - math.log(prior_log_tau_scale)

    def _batched(Z, data):
        # Z: (C, D) with D = 2 + G
        log_tau = Z[:, 0]
        mu = Z[:, 1]
        theta_raw = Z[:, 2:]  # (C, G)
        g = theta_raw.shape[1]
        tau = jnp.exp(log_tau)
        theta = mu[:, None] + tau[:, None] * theta_raw  # (C, G)

        n = data["n_per_group"]
        inv_var = data["inv_noise_var"]
        resid = data["ybar"][None, :] - theta  # (C, G), O(posterior scale)
        ll = data["c0"] - 0.5 * n * inv_var * jnp.sum(resid * resid, axis=-1)
        r = (n * inv_var) * resid  # d ll / d theta

        # priors (with normalizing constants, matching the Normal class)
        half_log2pi = 0.5 * math.log(2.0 * math.pi)
        lp = (
            ll
            + log_norm
            - (2.0 + g) * half_log2pi
            - 0.5 * inv_mu_var * mu * mu
            - 0.5 * inv_lt_var * log_tau * log_tau
            - 0.5 * jnp.sum(theta_raw * theta_raw, axis=-1)
        )
        g_mu = jnp.sum(r, axis=-1) - inv_mu_var * mu
        g_log_tau = tau * jnp.sum(r * theta_raw, axis=-1) - inv_lt_var * log_tau
        g_theta_raw = tau[:, None] * r - theta_raw
        grad = jnp.concatenate(
            [g_log_tau[:, None], g_mu[:, None], g_theta_raw], axis=1
        )
        return lp, grad

    @jax.custom_batching.custom_vmap
    def vag(z, data):
        ll, g = _batched(z[None], data)
        return ll[0], g[0]

    @vag.def_vmap
    def _vag_vmap(axis_size, in_batched, Z, data):
        del axis_size
        # The rule assumes the engine's batching pattern: chains batch the
        # position, data is replicated. Anything else (batched data, an
        # unbatched z next to another batched arg) would silently compute
        # wrong values if we just assumed — fail loudly instead.
        z_batched, data_batched = in_batched
        if not z_batched or any(jax.tree_util.tree_leaves(data_batched)):
            raise NotImplementedError(
                "make_hier_normal_vag's custom_vmap rule supports only "
                "vmap-over-z with replicated data (the engine's chain "
                f"batching); got in_batched={in_batched!r}"
            )
        ll, g = _batched(Z, data)
        return (ll, g), (True, True)

    return vag


def make_hier_normal_model(
    prior_mu_scale: float = 5.0,
    prior_log_tau_scale: float = 1.0,
):
    """One factory for BOTH halves of the sufficient-statistic model:
    ``(log_prob, value_and_grad_fn)`` bound to the *same* prior scales.

    :func:`hier_suffstat_log_prob` and :func:`make_hier_normal_vag` take
    independent scale kwargs that must agree — a mismatch makes density-only
    paths (metropolis, MAP/ADVI init) evaluate a different posterior than the
    gradient path with no error. Constructing both through this factory makes
    that divergence impossible.
    """
    import functools

    log_prob = functools.partial(
        hier_suffstat_log_prob,
        prior_mu_scale=prior_mu_scale,
        prior_log_tau_scale=prior_log_tau_scale,
    )
    vag = make_hier_normal_vag(
        prior_mu_scale=prior_mu_scale,
        prior_log_tau_scale=prior_log_tau_scale,
    )
    return log_prob, vag


def prepare_poisson_rates_data(y: jnp.ndarray) -> dict:
    """Collapse a (num_groups, obs_per_group) count matrix to the Poisson
    sufficient statistics for :func:`make_poisson_rates_model`.

    The Poisson with a shared per-group rate is an exponential family: with
    ``theta_g`` the group log-rate,

        ll(theta) = sum_g [ S_g theta_g - n exp(theta_g) ] - sum log(y!)

    where ``S_g = sum_i y_{g,i}``. The whole O(N) data reduction hoists to
    data-prep time — O(chains * G) per leapfrog instead of O(chains * N),
    exactly (same posterior; the reference's event-rate scenario at scale,
    reference examples/04_event_rates.py:29-35 / README.md:105-113).
    """
    y = jnp.asarray(y, jnp.float32)
    num_groups, obs_per_group = y.shape
    return {
        "S": jnp.sum(y, axis=1),  # (G,)
        "n_per_group": jnp.asarray(float(obs_per_group), jnp.float32),
        "c0": -jnp.sum(jax.scipy.special.gammaln(y + 1.0)),
    }


def make_poisson_rates_model(
    prior_mu_scale: float = 5.0,
    prior_log_tau_scale: float = 1.0,
):
    """``(log_prob, value_and_grad_fn)`` of the non-centered hierarchical
    Poisson event-rate log-posterior (models/poisson.py, covariate_dim=0)
    over the sufficient statistics from :func:`prepare_poisson_rates_data`,
    bound to one set of prior scales (the density and gradient halves cannot
    diverge — same contract as :func:`make_hier_normal_model`).

    Flat layout ``z = [log_tau, mu, theta_raw...]`` (ravel_pytree orders
    dict keys alphabetically). Closed-form gradient: with ``r_g = S_g -
    n exp(theta_g)`` (= d ll / d theta_g), the non-centered chain rule gives
    ``d/dmu = sum r``, ``d/dlog_tau = tau * sum(r * theta_raw)``,
    ``d/dtheta_raw = tau * r`` — all (chains, G) elementwise + two small
    reductions, far below compute/HBM limits, so (as with the Gaussian collapse)
    no Pallas kernel is warranted.
    """
    inv_mu_var = 1.0 / (prior_mu_scale * prior_mu_scale)
    inv_lt_var = 1.0 / (prior_log_tau_scale * prior_log_tau_scale)
    log_norm = -math.log(prior_mu_scale) - math.log(prior_log_tau_scale)

    def _batched(Z, data):
        log_tau = Z[:, 0]
        mu = Z[:, 1]
        theta_raw = Z[:, 2:]  # (C, G)
        g = theta_raw.shape[1]
        tau = jnp.exp(log_tau)
        theta = mu[:, None] + tau[:, None] * theta_raw  # (C, G)

        n = data["n_per_group"]
        lam = jnp.exp(theta)
        ll = data["c0"] + jnp.sum(
            data["S"][None, :] * theta - n * lam, axis=-1
        )
        r = data["S"][None, :] - n * lam  # d ll / d theta

        half_log2pi = 0.5 * math.log(2.0 * math.pi)
        lp = (
            ll
            + log_norm
            - (2.0 + g) * half_log2pi
            - 0.5 * inv_mu_var * mu * mu
            - 0.5 * inv_lt_var * log_tau * log_tau
            - 0.5 * jnp.sum(theta_raw * theta_raw, axis=-1)
        )
        g_mu = jnp.sum(r, axis=-1) - inv_mu_var * mu
        g_log_tau = tau * jnp.sum(r * theta_raw, axis=-1) - inv_lt_var * log_tau
        g_theta_raw = tau[:, None] * r - theta_raw
        grad = jnp.concatenate(
            [g_log_tau[:, None], g_mu[:, None], g_theta_raw], axis=1
        )
        return lp, grad

    @jax.custom_batching.custom_vmap
    def vag(z, data):
        ll, g = _batched(z[None], data)
        return ll[0], g[0]

    @vag.def_vmap
    def _vag_vmap(axis_size, in_batched, Z, data):
        del axis_size
        z_batched, data_batched = in_batched
        if not z_batched or any(jax.tree_util.tree_leaves(data_batched)):
            raise NotImplementedError(
                "make_poisson_rates_model's custom_vmap rule supports only "
                "vmap-over-z with replicated data (the engine's chain "
                f"batching); got in_batched={in_batched!r}"
            )
        ll, g = _batched(Z, data)
        return (ll, g), (True, True)

    def log_prob(params, data):
        mu, log_tau = params["mu"], params["log_tau"]
        theta_raw = params["theta_raw"]
        tau = jnp.exp(log_tau)
        theta = mu + tau * theta_raw
        n = data["n_per_group"]
        ll = data["c0"] + jnp.sum(data["S"] * theta - n * jnp.exp(theta))
        g = theta_raw.shape[0]
        half_log2pi = 0.5 * math.log(2.0 * math.pi)
        return (
            ll
            + log_norm
            - (2.0 + g) * half_log2pi
            - 0.5 * inv_mu_var * mu * mu
            - 0.5 * inv_lt_var * log_tau * log_tau
            - 0.5 * jnp.sum(theta_raw * theta_raw)
        )

    return log_prob, vag


def hier_suffstat_log_prob(
    params: dict,
    data: dict,
    *,
    prior_mu_scale: float = 5.0,
    prior_log_tau_scale: float = 1.0,
) -> jnp.ndarray:
    """Dict-level log-posterior over the sufficient statistics — the value
    twin of :func:`make_hier_normal_vag` for engine paths that evaluate the
    density directly (MAP/ADVI init, metropolis).

    The prior scales MUST match the ones passed to
    :func:`make_hier_normal_vag`, or the density-only paths would evaluate
    a different posterior than the gradient path. With non-default scales
    bind them first: ``functools.partial(hier_suffstat_log_prob,
    prior_mu_scale=s1, prior_log_tau_scale=s2)`` (the engine calls the
    model as a binary ``(params, data)``).
    """
    mu, log_tau = params["mu"], params["log_tau"]
    theta_raw = params["theta_raw"]
    tau = jnp.exp(log_tau)
    theta = mu + tau * theta_raw
    resid = data["ybar"] - theta
    n = data["n_per_group"]
    ll = data["c0"] - 0.5 * n * data["inv_noise_var"] * jnp.sum(resid * resid)
    g = theta_raw.shape[0]
    half_log2pi = 0.5 * math.log(2.0 * math.pi)
    return (
        ll
        - math.log(prior_mu_scale)
        - math.log(prior_log_tau_scale)
        - (2.0 + g) * half_log2pi
        - 0.5 * (mu * mu) / (prior_mu_scale * prior_mu_scale)
        - 0.5 * (log_tau * log_tau)
        / (prior_log_tau_scale * prior_log_tau_scale)
        - 0.5 * jnp.sum(theta_raw * theta_raw)
    )
