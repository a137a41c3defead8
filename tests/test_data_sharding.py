"""Observation-sharded likelihood tests (SURVEY.md §5.7, library API).

The data axis shards the dataset over a second mesh axis; every energy /
gradient evaluation psums the shard-local likelihood contributions. These
tests check the sharded posterior against the replicated-data path on the
8-device virtual CPU mesh for every kernel — hmc/chees/mala/metropolis are
statically scheduled by construction, nuts via its fixed-trip-count tree
build (auto-enabled on the data axis) — including the fused value+grad
protocol.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlx_mcmc_tpu import Normal, sample
from mlx_mcmc_tpu.models import make_logistic_regression
from mlx_mcmc_tpu.parallel import data_chain_mesh, sample_sharded


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()


# Local likelihood contribution (summed over this shard's observations) and
# the prior, passed separately so it is counted exactly once across shards.
def _local_loglik(params, data):
    s = jnp.dot(data["X"], params["beta"], preferred_element_type=jnp.float32)
    return jnp.sum(data["y"] * s - jax.nn.softplus(s))


def _log_prior(params):
    return jnp.sum(Normal(0.0, 1.0).log_prob(params["beta"]))


def _full_model(params, data):
    return _local_loglik(params, data) + _log_prior(params)


def _spec(num_features=8, num_obs=64):
    return make_logistic_regression(
        num_features=num_features, num_obs=num_obs, seed=0
    )


class TestDataSharding:
    @pytest.mark.parametrize("kernel", ["hmc", "chees", "mala", "metropolis"])
    def test_matches_replicated_short_run(self, eight_devices, kernel):
        """Data-sharded == replicated-data posterior, draw for draw, up to
        the float reduction order of the likelihood sum (psum of shard
        partials vs one jnp.sum)."""
        spec = _spec()
        data = {"X": spec.X, "y": spec.y}
        kwargs = dict(
            num_samples=5,
            num_warmup=5,
            num_chains=4,
            kernel=kernel,
            seed=0,
            step_size=0.05,
            adapt_step_size=False,
            adapt_mass_matrix=False,
        )
        if kernel == "hmc":
            kwargs["num_leapfrog_steps"] = 4
        sharded = sample_sharded(
            _local_loglik,
            spec.initial_params,
            mesh=data_chain_mesh(2, 4),
            data=data,
            data_axis="data",
            log_prior_fn=_log_prior,
            **kwargs,
        )
        replicated = sample(
            _full_model, spec.initial_params, data=data, **kwargs
        )
        np.testing.assert_allclose(
            np.asarray(sharded.samples["beta"]),
            np.asarray(replicated.samples["beta"]),
            rtol=2e-3,
            atol=2e-4,
        )

    def test_hmc_posterior_recovery_with_adaptation(self, eight_devices):
        # Gaussian conjugate model: y ~ N(mu, 1), mu ~ N(0, 10); analytic
        # posterior mean/var to check the psum'd likelihood is counted once.
        n = 64
        y = np.random.default_rng(0).normal(2.0, 1.0, size=n).astype(np.float32)
        post_var = 1.0 / (n + 1.0 / 100.0)
        post_mean = post_var * y.sum()

        res = sample_sharded(
            lambda p, d: jnp.sum(Normal(p["mu"], 1.0).log_prob(d["y"])),
            {"mu": 0.0},
            mesh=data_chain_mesh(2, 4),
            data={"y": jnp.asarray(y)},
            data_axis="data",
            log_prior_fn=lambda p: Normal(0.0, 10.0).log_prob(p["mu"]),
            num_samples=500,
            num_warmup=300,
            num_chains=4,
            kernel="hmc",
            seed=0,
        )
        draws = np.asarray(res.samples["mu"]).ravel()
        assert abs(draws.mean() - post_mean) < 4 * np.sqrt(post_var)
        assert abs(draws.std() - np.sqrt(post_var)) < 0.5 * np.sqrt(post_var)

    def test_chees_data_sharded_2d_mesh(self, eight_devices):
        """ChEES's jittered trajectory lengths are shared across chains
        (layout-invariant Halton of the global step index), so its collective
        schedule stays static — it must run data-sharded (CLAUDE.md claim,
        VERDICT r1 item 9)."""
        spec = _spec()
        res = sample_sharded(
            _local_loglik,
            spec.initial_params,
            mesh=data_chain_mesh(2, 4),
            data={"X": spec.X, "y": spec.y},
            data_axis="data",
            log_prior_fn=_log_prior,
            num_samples=200,
            num_warmup=200,
            num_chains=4,
            kernel="chees",
            seed=0,
        )
        beta = np.asarray(res.samples["beta"])
        assert np.isfinite(beta).all()
        # Posterior concentrates near the truth for this well-posed GLM.
        err = np.abs(beta.reshape(-1, 8).mean(axis=0) - np.asarray(spec.true_beta))
        assert err.mean() < 1.0

    def test_fused_vag_data_sharded(self, eight_devices):
        """The fused value+grad protocol under observation sharding: vag
        returns likelihood-only shard terms (include_prior=False), pad_const
        is pre-divided by the shard count, markers replicate via
        fused_data_specs."""
        from mlx_mcmc_tpu.ops.pallas.glm import (
            fused_data_specs,
            make_fused_logistic_vag,
            prepare_fused_logistic_data,
        )

        spec = _spec(num_features=6, num_obs=60)  # 60 -> padded to 64: pad rows
        # Short run: the fused batched matmul sums in a different order than
        # the replicated per-chain path, so tiny rounding differences seed
        # trajectory drift; protocol errors (prior double-count, pad_const
        # over-correction) would show up as O(1) disagreement immediately.
        kwargs = dict(
            num_samples=3,
            num_warmup=2,
            num_chains=4,
            kernel="hmc",
            num_leapfrog_steps=2,
            seed=0,
            step_size=0.05,
            adapt_step_size=False,
            adapt_mass_matrix=False,
        )
        data = prepare_fused_logistic_data(spec.X, spec.y, tile_n=8, num_shards=4)
        assert float(data["pad_const"]) > 0.0  # pad rows present
        sharded = sample_sharded(
            lambda params, d: _fused_value_only(params, d),
            spec.initial_params,
            mesh=data_chain_mesh(2, 4),
            data=data,
            data_axis="data",
            data_specs=fused_data_specs(data, "data"),
            log_prior_fn=_log_prior,
            value_and_grad_fn=make_fused_logistic_vag(
                data_aware=True, include_prior=False
            ),
            **kwargs,
        )
        # Compare against the UNSHARDED fused path (identical within-chain
        # float ordering): any protocol error — prior double-count, pad_const
        # over-correction, local-only gradient — would be O(1) off; only the
        # psum's reduction order separates these two programs.
        data1 = prepare_fused_logistic_data(spec.X, spec.y, tile_n=8)
        replicated = sample(
            lambda params, d: _fused_value_only(params, d) + _log_prior(params),
            spec.initial_params,
            data=data1,
            value_and_grad_fn=make_fused_logistic_vag(
                data_aware=True, include_prior=True
            ),
            **kwargs,
        )
        np.testing.assert_allclose(
            np.asarray(sharded.samples["beta"]),
            np.asarray(replicated.samples["beta"]),
            rtol=1e-5,
            atol=1e-6,
        )

    def test_nuts_data_sharded_matches_replicated(self, eight_devices):
        """Data-sharded NUTS rides the static-schedule tree build (auto-set):
        the per-leapfrog psum count is uniform across chain rows, and the
        draws match the replicated-data run (whose static_schedule draws are
        in turn bit-identical to dynamic NUTS, test_nuts.py)."""
        spec = _spec()
        data = {"X": spec.X, "y": spec.y}
        kwargs = dict(
            num_samples=5,
            num_warmup=5,
            num_chains=4,
            kernel="nuts",
            max_tree_depth=4,
            seed=0,
            step_size=0.05,
            adapt_step_size=False,
            adapt_mass_matrix=False,
        )
        sharded = sample_sharded(
            _local_loglik,
            spec.initial_params,
            mesh=data_chain_mesh(2, 4),
            data=data,
            data_axis="data",
            log_prior_fn=_log_prior,
            **kwargs,
        )
        replicated = sample(
            _full_model, spec.initial_params, data=data, **kwargs
        )
        np.testing.assert_allclose(
            np.asarray(sharded.samples["beta"]),
            np.asarray(replicated.samples["beta"]),
            rtol=2e-3,
            atol=2e-4,
        )

    def test_nuts_dynamic_schedule_rejected_on_data_axis(self, eight_devices):
        spec = _spec()
        with pytest.raises(ValueError, match="static"):
            sample_sharded(
                _local_loglik,
                spec.initial_params,
                mesh=data_chain_mesh(2, 4),
                data={"X": spec.X, "y": spec.y},
                data_axis="data",
                log_prior_fn=_log_prior,
                kernel="nuts",
                static_schedule=False,
                num_samples=2,
                num_warmup=2,
                num_chains=4,
            )

    def test_data_axis_requires_data(self, eight_devices):
        with pytest.raises(ValueError, match="requires data"):
            sample_sharded(
                lambda p: Normal(0.0, 1.0).log_prob(p["x"]),
                {"x": 0.0},
                mesh=data_chain_mesh(2, 4),
                data_axis="data",
                kernel="hmc",
                num_chains=4,
            )

    def test_unknown_data_axis_raises(self, eight_devices):
        with pytest.raises(ValueError, match="not in mesh axes"):
            sample_sharded(
                _local_loglik,
                _spec().initial_params,
                mesh=data_chain_mesh(4, 2),
                data={"y": jnp.zeros(8)},
                data_axis="obs",
                kernel="hmc",
                num_chains=4,
            )


def _fused_value_only(params, data):
    """Shard-local likelihood value matching the fused vag's density (used by
    the engine for energy evaluations outside the integrator)."""
    beta = params["beta"]
    d = data["dim"].shape[0]
    s = jnp.dot(
        data["Xp"][:, :d],
        beta.astype(data["Xp"].dtype),
        preferred_element_type=jnp.float32,
    )
    return jnp.sum(data["yp"][:, 0] * s - jax.nn.softplus(s)) + data["pad_const"]
