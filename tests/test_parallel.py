"""Sharded-chain tests on the 8-device virtual CPU mesh (SURVEY.md §4
test plan items (a)/(b): multi-device CI without accelerators, and layout-equivalence
between shardings)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlx_mcmc_tpu import Normal, sample
from mlx_mcmc_tpu.parallel import chain_mesh, sample_sharded


def _model(params):
    return jnp.sum(Normal(1.0, 2.0).log_prob(params["x"]))


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()


class TestSharded:
    def test_posterior_recovery_sharded(self, eight_devices):
        res = sample_sharded(
            _model,
            {"x": jnp.zeros(3)},
            num_samples=1000,
            num_warmup=500,
            num_chains=8,
            kernel="nuts",
            seed=0,
        )
        xs = np.asarray(res.samples["x"]).reshape(-1, 3)
        assert np.all(np.abs(xs.mean(axis=0) - 1.0) < 0.2)
        assert np.all(np.abs(xs.std(axis=0) - 2.0) < 0.25)

    def test_fixed_tunables_bitwise_matches_vmap(self, eight_devices):
        kwargs = dict(
            num_samples=100,
            num_warmup=50,
            num_chains=8,
            kernel="nuts",
            seed=0,
            step_size=0.5,
            adapt_step_size=False,
            adapt_mass_matrix=False,
        )
        sharded = sample_sharded(_model, {"x": jnp.zeros(2)}, **kwargs)
        local = sample(_model, {"x": jnp.zeros(2)}, **kwargs)
        np.testing.assert_array_equal(
            np.asarray(sharded.samples["x"]), np.asarray(local.samples["x"])
        )

    def test_layouts_bitwise_equal(self, eight_devices):
        # 8 shards x 1 chain == 4 shards x 2 chains, bit for bit.
        kwargs = dict(
            num_samples=50,
            num_warmup=20,
            num_chains=8,
            kernel="hmc",
            seed=3,
            step_size=0.3,
            adapt_step_size=False,
            adapt_mass_matrix=False,
        )
        a = sample_sharded(_model, {"x": jnp.zeros(2)}, **kwargs)
        b = sample_sharded(
            _model, {"x": jnp.zeros(2)}, mesh=chain_mesh(num_devices=4), **kwargs
        )
        np.testing.assert_array_equal(
            np.asarray(a.samples["x"]), np.asarray(b.samples["x"])
        )

    def test_collective_adaptation_shares_tunables(self, eight_devices):
        res = sample_sharded(
            _model,
            {"x": jnp.zeros(2)},
            num_samples=100,
            num_warmup=300,
            num_chains=8,
            kernel="nuts",
            seed=0,
        )
        # One shared adapted mass matrix; should approximate target variance 4.
        inv_mass = np.asarray(res.tunables.inv_mass_diag)
        assert inv_mass.shape == (2,)
        assert np.all(inv_mass > 1.0) and np.all(inv_mass < 12.0)

    def test_statistically_equivalent_to_vmap_when_adapting(self, eight_devices):
        # Adaptive runs differ bitwise across layouts (float reduction order)
        # but must agree statistically.
        kwargs = dict(
            num_samples=1000, num_warmup=500, num_chains=8, kernel="nuts", seed=0
        )
        a = sample_sharded(_model, {"x": jnp.zeros(2)}, **kwargs)
        b = sample(_model, {"x": jnp.zeros(2)}, **kwargs)
        ma = np.asarray(a.samples["x"]).mean()
        mb = np.asarray(b.samples["x"]).mean()
        assert abs(ma - mb) < 0.15

    def test_indivisible_chains_raises(self, eight_devices):
        with pytest.raises(ValueError, match="not divisible"):
            sample_sharded(
                _model, {"x": jnp.zeros(2)}, num_chains=6, num_samples=10,
                num_warmup=0,
            )


class TestGraftEntry:
    def test_entry_compiles_single_device(self):
        import __graft_entry__ as ge

        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        pos, accept = out
        assert np.asarray(pos).shape[0] == 8
        assert np.isfinite(np.asarray(accept)).all()

    def test_dryrun_multichip(self, eight_devices):
        import __graft_entry__ as ge

        ge.dryrun_multichip(8)

    def test_dryrun_multichip_odd(self, eight_devices):
        import __graft_entry__ as ge

        ge.dryrun_multichip(3)
