"""Tests for ravel/unravel utilities and Welford accumulators."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlx_mcmc_tpu.ops import (
    make_flat_logprob,
    ravel_params,
    welford_batch_update,
    welford_finalize,
    welford_init,
    welford_update,
)
from mlx_mcmc_tpu.ops.math import welford_merge


class TestRavel:
    def test_roundtrip_mixed_shapes(self):
        params = {"a": 1.0, "b": jnp.arange(3.0), "c": jnp.ones((2, 2))}
        flat, unravel = ravel_params(params)
        assert flat.shape == (8,)
        back = unravel(flat)
        for k in params:
            np.testing.assert_allclose(
                np.asarray(back[k]), np.asarray(params[k], dtype=np.float32)
            )

    def test_int_and_python_scalars_promoted(self):
        flat, unravel = ravel_params({"x": 3, "y": 1.5})
        assert jnp.issubdtype(flat.dtype, jnp.floating)
        assert float(unravel(flat)["x"]) == 3.0

    def test_flat_logprob_grad(self):
        def log_prob(params):
            return -0.5 * params["x"] ** 2 - 0.5 * jnp.sum(params["y"] ** 2)

        f, z0, unravel = make_flat_logprob(log_prob, {"x": 1.0, "y": jnp.ones(2)})
        assert z0.shape == (3,)
        g = jax.grad(f)(z0)
        np.testing.assert_allclose(np.asarray(g), -np.ones(3), atol=1e-6)


class TestWelford:
    def test_streaming_matches_numpy(self):
        rng = np.random.default_rng(0)
        xs = rng.normal(size=(500, 4)).astype(np.float32) * np.array(
            [1.0, 2.0, 0.5, 3.0], dtype=np.float32
        )
        state = welford_init(4)
        for x in xs:
            state = welford_update(state, jnp.asarray(x))
        var = np.asarray(welford_finalize(state, regularize=False))
        np.testing.assert_allclose(var, xs.var(axis=0, ddof=1), rtol=1e-4)

    def test_batch_update_matches_streaming(self):
        rng = np.random.default_rng(1)
        xs = rng.normal(size=(64, 3)).astype(np.float32)
        s1 = welford_init(3)
        for x in xs:
            s1 = welford_update(s1, jnp.asarray(x))
        s2 = welford_init(3)
        for chunk in np.split(xs, 4):
            s2 = welford_batch_update(s2, jnp.asarray(chunk))
        np.testing.assert_allclose(float(s1.count), float(s2.count))
        np.testing.assert_allclose(np.asarray(s1.mean), np.asarray(s2.mean), atol=1e-5)
        np.testing.assert_allclose(np.asarray(s1.m2), np.asarray(s2.m2), rtol=1e-4)

    def test_merge_matches_pooled(self):
        rng = np.random.default_rng(2)
        xs = rng.normal(size=(100, 2)).astype(np.float32)
        a = welford_batch_update(welford_init(2), jnp.asarray(xs[:30]))
        b = welford_batch_update(welford_init(2), jnp.asarray(xs[30:]))
        merged = welford_merge(a, b)
        var = np.asarray(welford_finalize(merged, regularize=False))
        np.testing.assert_allclose(var, xs.var(axis=0, ddof=1), rtol=1e-4)

    def test_regularization_shrinks_toward_unit(self):
        state = welford_batch_update(
            welford_init(1), jnp.full((10, 1), 0.0)
        )  # zero variance
        var = float(welford_finalize(state, regularize=True)[0])
        assert 0 < var < 1  # shrunk toward 1e-3*5/(n+5), not exactly 0


class _H100:
    device_kind = "NVIDIA H100 80GB HBM3"


class TestRoofline:
    def test_roofline_report_known_device(self):
        from mlx_mcmc_tpu.utils.roofline import roofline_report

        # 1e13 flops in 1s at AI 2048 (bf16 operands) -> compute bound at
        # the 989 TFLOP/s bf16 tensor-core peak.
        rep = roofline_report(1e13, 1e13 / 2048, 1.0, _H100())
        assert rep["achieved_tflops"] == 10.0
        assert rep["peak"] == "bf16" and rep["peak_tflops"] == 989.0
        assert rep["roofline_bound_tflops"] == 989.0
        assert abs(rep["mfu_pct"] - 1000.0 / 989.0) < 0.01

    def test_roofline_bandwidth_bound(self):
        from mlx_mcmc_tpu.utils.roofline import roofline_report

        # AI = 1 flop/byte -> bound = 3350 GB/s * 1 = 3.35 TFLOP/s.
        rep = roofline_report(1e12, 1e12, 0.5, _H100())
        assert rep["roofline_bound_tflops"] == 3.4
        assert rep["hbm_gbs"] == 3350.0
        assert rep["roofline_frac_pct"] > 50.0

    def test_unknown_device_raises(self):
        from mlx_mcmc_tpu.utils.roofline import device_peaks, roofline_report

        class FakeDevice:
            device_kind = "Mystery Accelerator"

        with pytest.raises(ValueError, match="device_kind"):
            roofline_report(1e12, 1e9, 1.0, FakeDevice())
        with pytest.raises(ValueError, match="device_kind"):
            device_peaks(FakeDevice())

    @pytest.mark.parametrize("dtype, highest, peak, tflops", [
        ("bfloat16", False, "bf16", 989.0),
        ("float32", False, "tf32", 495.0),
        ("float32", True, "f32", 67.0),
    ])
    def test_peak_follows_operands(self, dtype, highest, peak, tflops):
        from mlx_mcmc_tpu.utils.roofline import roofline_report

        rep = roofline_report(1e12, 1e9, 1.0, _H100(), operand_dtype=dtype,
                              highest_precision=highest)
        assert rep["peak"] == peak and rep["peak_tflops"] == tflops

    def test_bound_seconds_side(self):
        from mlx_mcmc_tpu.utils.roofline import bound_seconds

        t, side = bound_seconds(989e12, 1.0, _H100())
        assert side == "compute" and abs(t - 1.0) < 1e-9
        t, side = bound_seconds(1.0, 3.35e12, _H100())
        assert side == "memory" and abs(t - 1.0) < 1e-9

    def test_glm_flop_byte_models(self):
        from mlx_mcmc_tpu.utils.roofline import glm_vag_bytes, glm_vag_flops

        assert glm_vag_flops(1000, 100, chains=2) == 4 * 1000 * 100 * 2
        assert glm_vag_bytes(1000, 100, itemsize=2) == 2 * 1000 * 100
        assert glm_vag_bytes(1000, 100, itemsize=4, x_reads=2) == 8 * 1000 * 100
