"""Hierarchical-Poisson-regression value+grad tests (ops/poisson.py; on the
card chip_smoke.py checks it at full width). Oracles: autodiff through the
full-data model (models/poisson.py, covariate_dim>0 — the non-collapsible
Large-model row) and a float64 numpy density.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlx_mcmc_tpu.models import make_poisson_event_rates
from mlx_mcmc_tpu.ops.poisson import (
    make_fused_poisson_model,
    make_fused_poisson_vag,
    prepare_fused_poisson_data,
)
from mlx_mcmc_tpu.ops.ravel import make_flat_logprob


@pytest.fixture(scope="module")
def pspec():
    return make_poisson_event_rates(
        num_groups=12, obs_per_group=20, covariate_dim=2, seed=3
    )


@pytest.fixture(scope="module")
def pdata(pspec):
    return prepare_fused_poisson_data(pspec.y, pspec.X)


class TestFusedPoissonVag:
    def test_fallback_matches_autodiff(self, pspec, pdata):
        vag = make_fused_poisson_vag()
        flat_lp, z0, _ = make_flat_logprob(
            lambda p: pspec.log_prob(p), pspec.initial_params
        )
        oracle = jax.vmap(jax.value_and_grad(flat_lp))
        rng = np.random.default_rng(0)
        Z = jnp.asarray(
            rng.normal(scale=0.3, size=(8, z0.shape[0])).astype(np.float32)
        )
        ll, g = jax.vmap(lambda z: vag(z, pdata))(Z)
        ll_ref, g_ref = oracle(Z)
        np.testing.assert_allclose(
            np.asarray(ll), np.asarray(ll_ref), rtol=3e-5
        )
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(g_ref), rtol=2e-4, atol=2e-3
        )

    def test_value_matches_f64_reference(self):
        # The value path's log-likelihood against a float64 numpy reference,
        # at a tolerance that a bf16-rounded linear predictor fails (checked
        # below on the same data): the precision rule of docs/DESIGN.md §4b.
        spec = make_poisson_event_rates(
            num_groups=50, obs_per_group=100, covariate_dim=4, seed=5
        )
        data = prepare_fused_poisson_data(spec.y, spec.X)
        rng = np.random.default_rng(2)
        G, K = 50, 4
        Z = np.concatenate([
            rng.normal(0.0, 0.3, (6, K)),
            np.full((6, 1), np.log(0.5)),
            np.full((6, 1), 1.0),
            rng.normal(0.0, 1.0, (6, G)),
        ], axis=1).astype(np.float32)
        lp, _ = jax.vmap(make_fused_poisson_vag(), in_axes=(0, None))(
            jnp.asarray(Z), data
        )

        def data_ll(Z, X):
            Z = Z.astype(np.float64)
            y = np.asarray(spec.y, np.float64)
            theta = Z[:, K + 1, None] + np.exp(Z[:, K, None]) * Z[:, K + 2:]
            s = theta[:, :, None] + np.einsum("gnk,ck->cgn", X, Z[:, :K])
            return np.sum(y * s - np.exp(s), axis=(1, 2))

        def log_prior(Z):  # the vag's priors, up to a constant
            Z = Z.astype(np.float64)
            mu = Z[:, K + 1]
            return -0.5 * np.sum(Z**2, axis=1) + 0.5 * mu**2 * (1 - 1 / 25.0)

        def centred(v):  # differences from chain 0: constants cancel
            return v - v[0]

        ref = centred(data_ll(Z, np.asarray(spec.X, np.float64)) + log_prior(Z))
        tol = 1e-2
        err = np.abs(centred(np.asarray(lp, np.float64)) - ref).max()
        assert err < tol, err
        # a predictor with bf16-rounded operands misses the same budget
        Xb = np.asarray(jnp.asarray(spec.X).astype(jnp.bfloat16), np.float64)
        Zb = Z.copy()
        Zb[:, :K] = np.asarray(jnp.asarray(Z[:, :K]).astype(jnp.bfloat16))
        rounded = centred(data_ll(Zb, Xb) + log_prior(Z))
        assert np.abs(rounded - ref).max() > tol

    def test_model_factory_halves_agree(self, pspec, pdata):
        log_prob, vag = make_fused_poisson_model(
            prior_mu_scale=2.0, prior_log_tau_scale=0.5
        )
        flat_lp, z0, _ = make_flat_logprob(
            log_prob, pspec.initial_params, data_aware=True
        )
        z = z0 + 0.2
        ll, _ = vag(z, pdata)
        np.testing.assert_allclose(
            float(ll), float(flat_lp(z, pdata)), rtol=1e-5
        )

    def test_batched_data_rejected(self, pdata):
        vag = make_fused_poisson_vag()
        Z = jnp.zeros((4, 2 + 2 + 12))
        bd = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (4,) + jnp.shape(x)), pdata
        )
        with pytest.raises(NotImplementedError, match="replicated data"):
            jax.vmap(vag)(Z, bd)

    def test_sampling_recovers_beta(self, pspec, pdata):
        from mlx_mcmc_tpu import sample

        log_prob, vag = make_fused_poisson_model()
        res = sample(
            log_prob,
            pspec.initial_params,
            data=pdata,
            value_and_grad_fn=vag,
            num_warmup=300,
            num_samples=300,
            num_chains=8,
            kernel="nuts",
            max_tree_depth=6,
            target_accept=0.9,
            seed=0,
        )
        beta_hat = np.mean(np.asarray(res.samples["beta"]), axis=(0, 1))
        np.testing.assert_allclose(
            beta_hat, np.asarray(pspec.truth["beta"]), atol=0.25
        )
