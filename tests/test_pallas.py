"""Fused GLM value+grad tests.

On the CPU the Triton kernel runs in interpret mode (the same Pallas body,
evaluated by JAX's interpreter) and its CUDA lowering is checked by
exporting it for the ``cuda`` platform. The compiled kernel itself runs in
the ``gpu``-marked tests, which chip_smoke.py runs on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlx_mcmc_tpu.ops.pallas import glm
from mlx_mcmc_tpu.ops.pallas.glm import (
    _reference_value_and_grad,
    fused_logistic_value_and_grad,
    make_fused_logistic_vag,
)


def _problem(n, d, c, seed=0):
    kx, ky, kz = jax.random.split(jax.random.PRNGKey(seed), 3)
    X = jax.random.normal(kx, (n, d), jnp.float32)
    y = jax.random.bernoulli(ky, 0.4, (n,)).astype(jnp.float32)
    Z = 0.3 * jax.random.normal(kz, (c, d), jnp.float32)
    return X, y, Z


@pytest.fixture(scope="module")
def problem():
    return _problem(300, 17, 5)  # deliberately unaligned shapes


class TestFusedKernel:
    # n=300 is not a multiple of the 32-row block; 130 chains span three
    # chain tiles with a padded last tile.
    @pytest.mark.parametrize("d", [17, 100])
    @pytest.mark.parametrize("c", [1, 5, 130])
    def test_matches_xla_value_and_grad(self, c, d):
        X, y, Z = _problem(300, d, c, seed=c + d)
        ll_ref, g_ref = _reference_value_and_grad(X, y, Z)
        ll, g = fused_logistic_value_and_grad(X, y, Z, tile_n=128, interpret=True)
        assert ll.shape == (c,) and g.shape == (c, d)
        np.testing.assert_allclose(np.asarray(ll), np.asarray(ll_ref),
                                   rtol=2e-5, atol=1e-3)
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(g_ref), rtol=2e-4, atol=5e-5
        )

    def test_padding_constant_correction(self, problem):
        # n not a multiple of tile_n: zero-row padding must not shift ll.
        X, y, Z = problem
        ll_a, _ = fused_logistic_value_and_grad(X, y, Z, tile_n=256, interpret=True)
        ll_b, _ = fused_logistic_value_and_grad(X, y, Z, tile_n=128, interpret=True)
        np.testing.assert_allclose(np.asarray(ll_a), np.asarray(ll_b), rtol=1e-5)

    def test_single_row_batch(self, problem):
        X, y, Z = problem
        ll, g = fused_logistic_value_and_grad(X, y, Z[:1], tile_n=128, interpret=True)
        assert ll.shape == (1,) and g.shape == (1, X.shape[1])

    def test_bf16_design_matches_plain_path(self, problem):
        # bf16 X: kernel and plain path both take bf16 operands with f32
        # accumulation, so they agree to f32 summation order.
        X, y, Z = problem
        Xb = X.astype(jnp.bfloat16)
        Xp, yp = glm._pad_data(Xb, y, 128)
        ll_k, g_k = glm._batched_vag(Xp, yp, Z, likelihood="logistic",
                                     impl="pallas", interpret=True)
        ll_x, g_x = glm._batched_vag(Xp, yp, Z, likelihood="logistic",
                                     impl="xla")
        np.testing.assert_allclose(np.asarray(ll_k), np.asarray(ll_x), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(g_k), np.asarray(g_x),
                                   rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("c, block_c", [(1, 16), (5, 16), (20, 32),
                                            (130, 64), (4096, 64)])
    def test_chain_block_choice(self, c, block_c):
        # Chains pad to the kernel's chain block (a power of two >= 16 for
        # the tensor cores), not to a fixed 128.
        assert glm._tile_config(c)["block_c"] == block_c

    def test_wide_design_rejected_by_kernel(self):
        # The kernel covers 128 padded features; wider designs are the
        # plain path's (the dispatch rule), and the kernel refuses them.
        X, y, Z = _problem(300, 200, 5)
        with pytest.raises(ValueError, match="kernel covers"):
            fused_logistic_value_and_grad(X, y, Z, tile_n=128, interpret=True)

    def test_dispatch_picks_plain_path_for_wide_designs(self, monkeypatch):
        # On the GPU, d_pad > 128 runs the plain path: pretend to be one.
        from mlx_mcmc_tpu.ops import dispatch
        from mlx_mcmc_tpu.ops.pallas.glm import prepare_fused_logistic_data

        seen = []
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        real = glm._batched_vag
        monkeypatch.setattr(glm, "_batched_vag", lambda *a, impl, **k: (
            seen.append(impl) or real(*a, impl="xla", **k)))
        vag = make_fused_logistic_vag(data_aware=True)
        for d in (100, 200):
            X, y, Z = _problem(300, d, 3)
            vag(Z[0], prepare_fused_logistic_data(X, y, tile_n=128))
        assert seen == ["pallas", "xla"]
        assert dispatch.use_kernel(False) is False

    @pytest.mark.parametrize("n_blocks, c_tiles", [(160, 64), (1568, 4),
                                                   (6, 3), (1, 1), (7, 1)])
    def test_row_splits_divide_rows(self, n_blocks, c_tiles):
        s = glm._row_splits(n_blocks, c_tiles)
        assert n_blocks % s == 0
        # enough programs to fill the card when the rows allow it
        assert c_tiles * s >= glm._TARGET_PROGRAMS // 2 or s == n_blocks

    @pytest.mark.parametrize("d, c", [(100, 4096), (17, 5)])
    def test_kernel_lowers_for_cuda(self, d, c):
        # The Pallas -> Triton lowering runs here without a card; only the
        # Triton -> PTX step is left for the GPU.
        Xp, yp = glm._pad_data(jnp.zeros((1000, d), jnp.bfloat16),
                               jnp.zeros(1000), 1024)
        f = jax.jit(lambda Xp, yp, Z: glm._batched_vag(
            Xp, yp, Z, likelihood="logistic", impl="pallas"))
        exported = jax.export.export(
            f, platforms=["cuda"],
            disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
                "__gpu$xla.gpu.triton")],
        )(Xp, yp, jax.ShapeDtypeStruct((c, d), jnp.float32))
        assert "__gpu$xla.gpu.triton" in exported.mlir_module()

    @pytest.mark.gpu
    def test_compiled_kernel_matches_plain_path(self, gpu):
        del gpu
        X, y, Z = _problem(3000, 100, 300)
        Xp, yp = glm._pad_data(X.astype(jnp.bfloat16), y, 1024)
        ll_k, g_k = glm._batched_vag(Xp, yp, Z, likelihood="logistic",
                                     impl="pallas")
        ll_x, g_x = glm._batched_vag(Xp, yp, Z, likelihood="logistic",
                                     impl="xla")
        np.testing.assert_allclose(np.asarray(ll_k), np.asarray(ll_x),
                                   rtol=1e-5, atol=1e-2)
        np.testing.assert_allclose(np.asarray(g_k), np.asarray(g_x),
                                   rtol=1e-3, atol=1e-2)


class TestVagWrapper:
    def test_scalar_and_vmap_paths_agree(self, problem):
        X, y, Z = problem
        vag = make_fused_logistic_vag(X, y, prior_scale=2.0)
        ll_s, g_s = vag(Z[0])
        ll_b, g_b = jax.vmap(vag)(Z)
        np.testing.assert_allclose(float(ll_s), float(ll_b[0]), rtol=1e-5)
        np.testing.assert_allclose(
            np.asarray(g_s), np.asarray(g_b[0]), rtol=1e-5, atol=1e-6
        )

    def test_matches_model_logprob(self, problem):
        # The fused posterior must equal the model's log_prob + grad.
        X, y, Z = problem
        from mlx_mcmc_tpu.distributions import Normal

        def log_prob(z):
            s = X @ z
            return jnp.sum(y * s - jax.nn.softplus(s)) + jnp.sum(
                Normal(0.0, 2.0).log_prob(z)
            )

        vag = make_fused_logistic_vag(X, y, prior_scale=2.0)
        ll, g = vag(Z[0])
        ll_ref, g_ref = jax.value_and_grad(log_prob)(Z[0])
        np.testing.assert_allclose(float(ll), float(ll_ref), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-4)

    def test_sampler_integration(self, problem):
        # End to end: NUTS with the fused vag (plain path on the CPU)
        # recovers the same posterior as plain XLA autodiff.
        X, y, Z = problem
        from mlx_mcmc_tpu import sample
        from mlx_mcmc_tpu.distributions import Normal

        def log_prob(params):
            z = params["beta"]
            s = X @ z
            return jnp.sum(y * s - jax.nn.softplus(s)) + jnp.sum(
                Normal(0.0, 1.0).log_prob(z)
            )

        vag = make_fused_logistic_vag(X, y, prior_scale=1.0)
        kwargs = dict(num_samples=300, num_warmup=300, num_chains=2, seed=0)
        res_fused = sample(
            log_prob,
            {"beta": jnp.zeros(X.shape[1])},
            kernel="nuts",
            value_and_grad_fn=vag,
            **kwargs,
        )
        res_plain = sample(
            log_prob, {"beta": jnp.zeros(X.shape[1])}, kernel="nuts", **kwargs
        )
        a = np.asarray(res_fused.samples["beta"]).reshape(-1, X.shape[1])
        b = np.asarray(res_plain.samples["beta"]).reshape(-1, X.shape[1])
        # identical up to float reassociation inside the fused contraction
        np.testing.assert_allclose(a.mean(axis=0), b.mean(axis=0), atol=0.08)

    def test_batched_data_rejected(self, problem):
        # A vmap over the data (a batch of datasets) must fail loudly, not
        # be read as one shared dataset.
        X, y, Z = problem
        from mlx_mcmc_tpu.ops.pallas.glm import prepare_fused_logistic_data

        vag = make_fused_logistic_vag(data_aware=True)
        data = prepare_fused_logistic_data(X, y, tile_n=128)
        batched = jax.tree_util.tree_map(
            lambda v: jnp.broadcast_to(v, (Z.shape[0],) + v.shape), data
        )
        with pytest.raises(NotImplementedError, match="replicated data"):
            jax.vmap(vag)(Z, batched)

    def test_unknown_impl_rejected(self):
        with pytest.raises(ValueError, match="impl"):
            make_fused_logistic_vag(data_aware=True, impl="mosaic")


class TestDataAwarePath:
    def test_data_arg_matches_closure(self, problem):
        X, y, Z = problem
        from mlx_mcmc_tpu.ops.pallas.glm import prepare_fused_logistic_data

        vag_c = make_fused_logistic_vag(X, y, prior_scale=1.5)
        vag_d = make_fused_logistic_vag(prior_scale=1.5, data_aware=True)
        data = prepare_fused_logistic_data(X, y, tile_n=128)
        ll_c, g_c = vag_c(Z[0])
        ll_d, g_d = vag_d(Z[0], data)
        np.testing.assert_allclose(float(ll_c), float(ll_d), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(g_c), np.asarray(g_d), rtol=1e-4)
        # batched rule
        ll_b, g_b = jax.vmap(lambda z: vag_d(z, data))(Z)
        np.testing.assert_allclose(float(ll_b[0]), float(ll_d), rtol=1e-5)

    def test_sample_with_data_argument(self, problem):
        X, y, Z = problem
        from mlx_mcmc_tpu import sample
        from mlx_mcmc_tpu.distributions import Normal

        def log_prob(params, data):
            s = data["X"] @ params["beta"]
            return jnp.sum(data["y"] * s - jax.nn.softplus(s)) + jnp.sum(
                Normal(0.0, 1.0).log_prob(params["beta"])
            )

        res = sample(
            log_prob,
            {"beta": jnp.zeros(X.shape[1])},
            data={"X": X, "y": y},
            num_samples=200,
            num_warmup=200,
            num_chains=2,
            kernel="nuts",
            seed=0,
        )
        draws = np.asarray(res.samples["beta"])
        assert draws.shape == (2, 200, X.shape[1])
        assert np.isfinite(draws).all()


class TestLinearKernel:
    def test_matches_analytic_value_and_grad(self):
        from mlx_mcmc_tpu.ops.pallas.glm import (
            make_fused_linear_vag,
            prepare_fused_linear_data,
        )
        from mlx_mcmc_tpu.distributions import Normal

        key = jax.random.PRNGKey(3)
        kx, ky, kz = jax.random.split(key, 3)
        n, d = 257, 19
        X = jax.random.normal(kx, (n, d), jnp.float32)
        beta_true = jax.random.normal(kz, (d,))
        y = X @ beta_true + 0.5 * jax.random.normal(ky, (n,))
        z = 0.2 * jax.random.normal(kz, (d,))

        def log_prob(z):
            return jnp.sum(Normal(X @ z, 0.5).log_prob(y)) + jnp.sum(
                Normal(0.0, 2.0).log_prob(z)
            )

        vag = make_fused_linear_vag(prior_scale=2.0)
        data = prepare_fused_linear_data(X, y, noise_scale=0.5, tile_n=128)
        ll, g = vag(z, data)
        ll_ref, g_ref = jax.value_and_grad(log_prob)(z)
        np.testing.assert_allclose(float(ll), float(ll_ref), rtol=1e-4)
        np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-3)

    def test_sampler_recovers_analytic_posterior(self):
        from mlx_mcmc_tpu.ops.pallas.glm import (
            make_fused_linear_vag,
            prepare_fused_linear_data,
        )
        from mlx_mcmc_tpu import sample
        from mlx_mcmc_tpu.distributions import Normal

        key = jax.random.PRNGKey(4)
        kx, ky, kz = jax.random.split(key, 3)
        n, d = 400, 8
        X = jax.random.normal(kx, (n, d), jnp.float32)
        beta_true = jax.random.normal(kz, (d,))
        y = X @ beta_true + jax.random.normal(ky, (n,))

        vag = make_fused_linear_vag(prior_scale=1.0)
        data = prepare_fused_linear_data(X, y, tile_n=128)

        def log_prob(params, data):
            dd = data["dim"].shape[0]
            mu = data["Xp"][:, :dd] @ params["beta"]
            r = data["yp"][:, 0] - mu
            return (-0.5 * jnp.sum(r * r) + data["ll_norm"]
                    + jnp.sum(Normal(0.0, 1.0).log_prob(params["beta"])))

        res = sample(log_prob, {"beta": jnp.zeros(d)}, data=data,
                     value_and_grad_fn=vag, num_samples=1500, num_warmup=500,
                     num_chains=2, kernel="nuts", seed=0)
        draws = np.asarray(res.samples["beta"]).reshape(-1, d)
        Xn, yn = np.asarray(X, np.float64), np.asarray(y, np.float64)
        cov = np.linalg.inv(Xn.T @ Xn + np.eye(d))
        mean = cov @ (Xn.T @ yn)
        np.testing.assert_allclose(draws.mean(axis=0), mean, atol=0.06)

    @pytest.mark.parametrize("d", [17, 100])
    def test_linear_kernel_interpret_matches_reference(self, d):
        # Execute the actual Pallas body (interpret mode) vs plain jnp.
        from mlx_mcmc_tpu.ops.pallas.glm import fused_linear_value_and_grad

        key = jax.random.PRNGKey(7)
        kx, ky, kz = jax.random.split(key, 3)
        n, c = 300, 5
        X = jax.random.normal(kx, (n, d), jnp.float32)
        y = X @ jax.random.normal(kz, (d,)) + jax.random.normal(ky, (n,))
        Z = 0.3 * jax.random.normal(kz, (c, d))
        ll, g = fused_linear_value_and_grad(X, y, Z, tile_n=128, interpret=True)
        s = jnp.dot(Z, X.T, precision=jax.lax.Precision.HIGHEST)
        r = y[None] - s
        ll_ref = -0.5 * jnp.sum(r * r, axis=-1)
        g_ref = jnp.dot(r, X, precision=jax.lax.Precision.HIGHEST)
        np.testing.assert_allclose(np.asarray(ll), np.asarray(ll_ref), rtol=2e-5)
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(g_ref), rtol=2e-4, atol=2e-3
        )

    def test_tile_mismatch_raises(self):
        # Data padded to a 16-row tile, kernel asked for 32-row blocks: must
        # raise, not silently drop rows.
        from mlx_mcmc_tpu.ops.pallas.glm import (
            _kernel_call,
            prepare_fused_linear_data,
        )

        data = prepare_fused_linear_data(
            jnp.zeros((257, 8)), jnp.zeros(257), tile_n=16
        )
        assert data["tile"].shape[0] == 16
        with pytest.raises(ValueError, match="row block"):
            _kernel_call(
                data["Xp"], data["yp"], jnp.zeros((128, 64)),
                likelihood="linear", block_n=32, block_c=64, num_warps=4,
                num_stages=2, interpret=True,
            )
