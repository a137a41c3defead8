"""ADVI: automatic differentiation variational inference (mean-field).

The reference has no variational inference at all (SURVEY.md §2 — kernels
are MH/HMC/NUTS only, mlx_mcmc/kernels/*). This module adds a fully
compiled mean-field Gaussian ADVI fit:

    q(z) = N(mu, diag(exp(log_sigma)^2))   over the flat parameter vector

maximized by reparameterized stochastic gradients of the ELBO under one
``jit``: a single ``lax.scan`` over Adam steps, ``vmap`` over Monte-Carlo
samples. No host round-trips inside the loop — the compiled analog of the
reference's host-loop pathology fix, applied to VI.

Two uses:
1. Standalone: ``fit_advi(log_prob, initial_params) -> ADVIResult`` with
   ``sample_posterior``/``summary`` mirroring the MCMC result surface.
2. Warm start: ``sample(..., init_strategy='advi')`` draws the chains'
   starting points from the fitted q and seeds the diagonal mass matrix
   with q's variances — warmup starts in the typical set with a
   near-correct metric instead of from a point mass.

Gradient estimator: "sticking the landing" (Roeder et al., 2017) — the
entropy term enters through the sampled path only (``stop_gradient`` on
the variational parameters inside log q), which makes the estimator's
variance vanish as q approaches a local optimum.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mlx_mcmc_tpu.ops.ravel import make_flat_logprob

_LOG_2PI = float(np.log(2.0 * np.pi))


def fit_advi_flat(
    flat_log_prob: Callable[[jnp.ndarray], jnp.ndarray],
    z0: jnp.ndarray,
    key,
    *,
    num_steps: int = 1000,
    num_mc_samples: int = 8,
    learning_rate: float = 0.05,
    init_log_sigma: float = -1.0,
    data=None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Fit a mean-field Gaussian to a flat log-density.

    Returns ``(mu, log_sigma, elbo_trace)`` — all device arrays; the whole
    optimization is one compiled scan.

    Non-finite gradients (a Monte-Carlo draw landing outside the support of
    a constrained model) are zeroed per-step rather than poisoning Adam's
    moment estimates.
    """
    import optax

    from mlx_mcmc_tpu.inference.api import _reuse_jit

    data_aware = data is not None
    base_lp = flat_log_prob

    z0 = jnp.asarray(z0, jnp.float32)
    dim = z0.shape[0]
    mu0 = z0
    log_sigma0 = jnp.full((dim,), init_log_sigma, jnp.float32)

    # key and data are jit ARGUMENTS (not closure constants): a captured
    # dataset would be serialized into the program (bloating compilation
    # for big arrays), and a captured key would freeze the fit's randomness
    # into the cached trace.
    def fit(var_params0, key, data):
        lp_one = (lambda z: base_lp(z, data)) if data_aware else base_lp
        d = var_params0[0].shape[0]  # from the ARG, not the closure: a
        # cached trace must re-derive shapes when jit retraces on new args

        def neg_elbo(var_params, eps):
            mu, log_sigma = var_params
            sigma = jnp.exp(log_sigma)
            z = mu + sigma * eps  # (M, D) reparameterized draws
            logp = jax.vmap(lp_one)(z)
            # Sticking the landing: score q at stop_gradient'ed variational
            # params so only the path derivative flows — zero-variance at
            # optima.
            mu_s = jax.lax.stop_gradient(mu)
            ls_s = jax.lax.stop_gradient(log_sigma)
            logq = jnp.sum(
                -0.5 * ((z - mu_s) * jnp.exp(-ls_s)) ** 2
                - ls_s
                - 0.5 * _LOG_2PI,
                axis=-1,
            )
            return -jnp.mean(logp - logq)

        opt = optax.adam(learning_rate)
        grad_fn = jax.value_and_grad(neg_elbo)

        def body(carry, t):
            var_params, opt_state = carry
            eps = jax.random.normal(
                jax.random.fold_in(key, t), (num_mc_samples, d), jnp.float32
            )
            loss, grads = grad_fn(var_params, eps)
            grads = jax.tree_util.tree_map(
                lambda g: jnp.where(jnp.isfinite(g), g, 0.0), grads
            )
            updates, opt_state = opt.update(grads, opt_state, var_params)
            var_params = optax.apply_updates(var_params, updates)
            return (var_params, opt_state), -loss

        (var_params, _), elbo_trace = jax.lax.scan(
            body,
            (var_params0, opt.init(var_params0)),
            jnp.arange(num_steps, dtype=jnp.int32),
        )
        return var_params, elbo_trace

    jfit = _reuse_jit(
        "advi_mf",
        (
            id(base_lp),
            int(num_steps),
            int(num_mc_samples),
            float(learning_rate),
            float(init_log_sigma),
            data_aware,
        ),
        fit,
        pin=base_lp,
    )
    (mu, log_sigma), elbo_trace = jfit((mu0, log_sigma0), key, data)
    return mu, log_sigma, elbo_trace


def fit_advi_fullrank_flat(
    flat_log_prob: Callable[[jnp.ndarray], jnp.ndarray],
    z0: jnp.ndarray,
    key,
    *,
    num_steps: int = 1000,
    num_mc_samples: int = 8,
    learning_rate: float = 0.05,
    init_log_sigma: float = -1.0,
    data=None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Full-rank Gaussian ADVI: q(z) = N(mu, L Lᵀ), L lower-triangular with
    softplus-positive diagonal.

    Captures posterior correlations the mean-field family cannot (its
    marginal variances shrink as 1-ρ² on correlated targets). Cost per step
    is O(D²) parameters and one (M, D)·(D, D) matmul — tensor-core friendly; use
    for D up to a few thousand.

    Returns ``(mu, scale_tril, elbo_trace)``.
    """
    import optax

    from mlx_mcmc_tpu.inference.api import _reuse_jit

    data_aware = data is not None
    base_lp = flat_log_prob

    z0 = jnp.asarray(z0, jnp.float32)
    dim = z0.shape[0]
    # raw params: packed lower triangle; diagonal passes through softplus
    tril_idx = jnp.tril_indices(dim)
    diag_slot = jnp.arange(dim)

    def build_L(raw_diag, raw_off):
        L = jnp.zeros((dim, dim), jnp.float32).at[tril_idx].set(raw_off)
        return L.at[diag_slot, diag_slot].set(jax.nn.softplus(raw_diag))

    sigma0 = float(np.exp(init_log_sigma))
    raw_diag0 = jnp.full((dim,), np.log(np.expm1(sigma0)), jnp.float32)
    # packed lower triangle incl. diagonal slots (which build_L overwrites)
    raw_off0 = jnp.zeros((dim * (dim + 1)) // 2, jnp.float32)

    # key/data are jit arguments (see fit_advi_flat); dim-shaped index
    # arrays are closure constants, so dim is part of the cache key.
    def fit(var_params0, key, data):
        lp_one = (lambda z: base_lp(z, data)) if data_aware else base_lp

        def neg_elbo(var_params, eps):
            mu, raw_diag, raw_off = var_params
            L = build_L(raw_diag, raw_off)
            z = mu + eps @ L.T  # (M, D)
            logp = jax.vmap(lp_one)(z)
            # sticking-the-landing: log q at stop_grad'ed variational params
            mu_s = jax.lax.stop_gradient(mu)
            L_s = jax.lax.stop_gradient(L)
            diff = z - mu_s
            y = jax.scipy.linalg.solve_triangular(L_s, diff.T, lower=True).T
            logq = (
                -0.5 * jnp.sum(y**2, axis=-1)
                - jnp.sum(jnp.log(jnp.diag(L_s)))
                - 0.5 * dim * _LOG_2PI
            )
            return -jnp.mean(logp - logq)

        opt = optax.adam(learning_rate)
        grad_fn = jax.value_and_grad(neg_elbo)

        def body(carry, t):
            var_params, opt_state = carry
            eps = jax.random.normal(
                jax.random.fold_in(key, t), (num_mc_samples, dim), jnp.float32
            )
            loss, grads = grad_fn(var_params, eps)
            grads = jax.tree_util.tree_map(
                lambda g: jnp.where(jnp.isfinite(g), g, 0.0), grads
            )
            updates, opt_state = opt.update(grads, opt_state, var_params)
            var_params = optax.apply_updates(var_params, updates)
            return (var_params, opt_state), -loss

        (var_params, _), elbo_trace = jax.lax.scan(
            body,
            (var_params0, opt.init(var_params0)),
            jnp.arange(num_steps, dtype=jnp.int32),
        )
        mu, raw_diag, raw_off = var_params
        return mu, build_L(raw_diag, raw_off), elbo_trace

    jfit = _reuse_jit(
        "advi_fr",
        (
            id(base_lp),
            int(num_steps),
            int(num_mc_samples),
            float(learning_rate),
            float(init_log_sigma),
            data_aware,
            dim,
        ),
        fit,
        pin=base_lp,
    )
    mu, scale_tril, elbo_trace = jfit((z0, raw_diag0, raw_off0), key, data)
    return mu, scale_tril, elbo_trace


@dataclass
class ADVIResult:
    """Fitted Gaussian posterior approximation (mean-field or full-rank).

    ``mu`` is q's mean over the *flat, unconstrained* vector. Mean-field
    fits carry ``log_sigma``; full-rank fits carry ``scale_tril`` (the
    Cholesky factor of q's covariance). ``sample_posterior`` maps draws
    back to the user's dict of (constrained) parameters.
    """

    mu: jnp.ndarray
    log_sigma: jnp.ndarray
    elbo_trace: jnp.ndarray
    _unravel: Callable[[jnp.ndarray], Any] = field(repr=False)
    _to_constrained: Optional[Callable[[Any], Any]] = field(
        default=None, repr=False
    )
    scale_tril: Optional[jnp.ndarray] = None  # full-rank fits only

    @property
    def elbo(self) -> float:
        """Final-step ELBO estimate."""
        return float(self.elbo_trace[-1])

    def sample_posterior(self, seed=0, num_samples: int = 1000) -> Dict[str, Any]:
        """Draw ``num_samples`` from q, returned as the model's param dict
        (constrained space if the fit used transforms)."""
        key = (
            jax.random.PRNGKey(seed)
            if isinstance(seed, (int, np.integer))
            else seed
        )
        eps = jax.random.normal(
            key, (num_samples,) + self.mu.shape, self.mu.dtype
        )
        if self.scale_tril is not None:
            z = self.mu + eps @ self.scale_tril.T
        else:
            z = self.mu + jnp.exp(self.log_sigma) * eps
        samples = jax.vmap(self._unravel)(z)
        if self._to_constrained is not None:
            samples = self._to_constrained(samples)
        return samples

    def posterior_mean(self) -> Dict[str, Any]:
        """q's mean, mapped through unravel (NOTE: for transformed params
        this is the push-forward of the unconstrained mean, i.e. the
        constrained-space *median*, not the mean)."""
        mean = self._unravel(self.mu)
        if self._to_constrained is not None:
            mean = self._to_constrained(mean)
        return mean

    def summary(self, seed=0, num_samples: int = 4000) -> Dict[str, Dict[str, float]]:
        """Moment summary of q via Monte Carlo (exact for untransformed
        params; MC for transformed ones), matching the MCMC summary keys."""
        from mlx_mcmc_tpu.diagnostics.stats import summary_stats

        draws = self.sample_posterior(seed, num_samples)
        out: Dict[str, Dict[str, float]] = {}
        for k, v in draws.items():
            arr = np.asarray(v)[None, ...]  # (1 "chain", draws, *event)
            if arr.ndim == 2:
                out[k] = summary_stats(arr, 0.95)
            else:
                flat_event = arr.reshape(1, arr.shape[1], -1)
                for i in range(flat_event.shape[-1]):
                    out[f"{k}[{i}]"] = summary_stats(flat_event[..., i], 0.95)
        return out


def fit_advi(
    log_prob_fn: Callable[..., jnp.ndarray],
    initial_params: Any,
    *,
    method: str = "meanfield",
    num_steps: int = 1000,
    num_mc_samples: int = 8,
    learning_rate: float = 0.05,
    seed=0,
    data=None,
    transforms: Optional[dict] = None,
) -> ADVIResult:
    """Fit ADVI against a dict-of-params model.

    Same model contract as :func:`mlx_mcmc_tpu.sample` — dict-of-params
    ``log_prob`` (optionally binary with ``data``), optional unconstraining
    ``transforms`` (the Gaussian q lives in unconstrained space; draws are
    returned constrained).

    ``method``: 'meanfield' (diagonal q — fast, shrinks correlated
    marginals) or 'fullrank' (Cholesky-parameterized dense covariance —
    O(D²) parameters, exact on Gaussian targets).
    """
    if method not in ("meanfield", "fullrank"):
        raise ValueError(f"Unknown ADVI method: {method!r}")
    key = (
        jax.random.PRNGKey(seed) if isinstance(seed, (int, np.integer)) else seed
    )
    # Memoize the flat/transformed closures per (model identity, transforms,
    # param structure) so repeated fits hand the SAME flat_log_prob object to
    # fit_advi_*_flat — whose _reuse_jit caches key on its id. Initial
    # parameter VALUES flow through per call below.
    from mlx_mcmc_tpu.inference.api import (
        _RUNNER_CACHE,
        _RUNNER_CACHE_MAX,
        _hashable,
        _param_spec,
    )
    from mlx_mcmc_tpu.ops.ravel import ravel_params

    t_key = (
        None
        if not transforms
        else tuple(sorted(transforms.items(), key=lambda kv: kv[0]))
    )
    cacheable = t_key is None or all(_hashable(v) for _, v in t_key)
    flp_key = hit = None
    if cacheable:
        flp_key = (
            "advi_flp",
            id(log_prob_fn),
            t_key,
            _param_spec(initial_params),
            data is not None,
        )
        hit = _RUNNER_CACHE.get(flp_key)
    if hit is not None:
        flat_log_prob, unravel, to_constrained, to_unconstrained, _pin = hit
        if to_unconstrained is not None:
            initial_params = to_unconstrained(
                jax.tree_util.tree_map(
                    lambda x: jnp.asarray(x, jnp.result_type(float)),
                    initial_params,
                )
            )
        z0 = ravel_params(initial_params)[0]
    else:
        to_constrained = to_unconstrained = None
        if transforms:
            from mlx_mcmc_tpu.distributions.transforms import (
                make_transformed_logprob,
            )

            log_prob_fn2, to_constrained, to_unconstrained = (
                make_transformed_logprob(
                    log_prob_fn, transforms, data_aware=data is not None
                )
            )
            initial_params = to_unconstrained(
                jax.tree_util.tree_map(
                    lambda x: jnp.asarray(x, jnp.result_type(float)),
                    initial_params,
                )
            )
        else:
            log_prob_fn2 = log_prob_fn
        flat_log_prob, z0, unravel = make_flat_logprob(
            log_prob_fn2, initial_params, data_aware=data is not None
        )
        if cacheable:
            if len(_RUNNER_CACHE) >= _RUNNER_CACHE_MAX:
                _RUNNER_CACHE.pop(next(iter(_RUNNER_CACHE)))
            _RUNNER_CACHE[flp_key] = (
                flat_log_prob, unravel, to_constrained, to_unconstrained,
                log_prob_fn,
            )
    fit_kwargs = dict(
        num_steps=num_steps,
        num_mc_samples=num_mc_samples,
        learning_rate=learning_rate,
        data=data,
    )
    if method == "fullrank":
        mu, scale_tril, elbo_trace = fit_advi_fullrank_flat(
            flat_log_prob, z0, key, **fit_kwargs
        )
        # marginal stds = row norms of L (so posterior_stddev-style
        # consumers keep working on full-rank fits)
        log_sigma = 0.5 * jnp.log(jnp.sum(scale_tril**2, axis=1))
    else:
        mu, log_sigma, elbo_trace = fit_advi_flat(
            flat_log_prob, z0, key, **fit_kwargs
        )
        scale_tril = None
    return ADVIResult(
        mu=mu,
        log_sigma=log_sigma,
        elbo_trace=elbo_trace,
        _unravel=unravel,
        _to_constrained=to_constrained,
        scale_tril=scale_tril,
    )


def advi_initialize(
    flat_log_prob: Callable[..., jnp.ndarray],
    z0_batch: jnp.ndarray,
    key,
    *,
    num_steps: int = 500,
    num_mc_samples: int = 8,
    learning_rate: float = 0.05,
    data=None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Chain-initialization hook for ``sample(..., init_strategy='advi')``.

    Fits q from the (single) user init, then returns
    ``(z0_batch', inv_mass_diag)``: per-chain starts drawn from q and q's
    variances as the initial diagonal inverse mass matrix — warmup begins in
    the typical set with a near-correct metric. Falls back to the original
    starts for any chain whose draw lands outside the support.
    """
    key_fit, key_draw = jax.random.split(key)
    mu, log_sigma, _ = fit_advi_flat(
        flat_log_prob,
        z0_batch[0],
        key_fit,
        num_steps=num_steps,
        num_mc_samples=num_mc_samples,
        learning_rate=learning_rate,
        data=data,
    )
    eps = jax.random.normal(key_draw, z0_batch.shape, z0_batch.dtype)
    starts = mu + jnp.exp(log_sigma) * eps
    lp_fn = flat_log_prob if data is None else (lambda z: flat_log_prob(z, data))
    lp = jax.jit(jax.vmap(lp_fn))(starts)
    ok = jnp.isfinite(lp)
    z0_new = jnp.where(ok[:, None], starts, z0_batch)
    inv_mass_diag = jnp.exp(2.0 * log_sigma)
    return z0_new, inv_mass_diag
