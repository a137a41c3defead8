"""Distribution unit tests: analytic log_probs, support masking, moments.

Test strategy ported from the reference's tests/test_distributions.py and
tests/test_new_distributions.py (analytic points, -inf outside support,
10k-sample moment matching, constructor validation), plus engine-specific
additions: NaN-safe gradients at support boundaries and traced-parameter
log-normalizers (which the reference's host-scipy path could not support).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as sps

from mlx_mcmc_tpu import (
    Beta,
    Categorical,
    Exponential,
    Gamma,
    HalfNormal,
    Normal,
)


def key(i=0):
    return jax.random.PRNGKey(i)


# ---------------------------------------------------------------------------
# Analytic log_prob values
# ---------------------------------------------------------------------------


class TestAnalyticLogProb:
    def test_standard_normal_at_mean(self):
        lp = Normal(0.0, 1.0).log_prob(0.0)
        assert np.isclose(float(lp), -0.5 * math.log(2 * math.pi), atol=1e-6)

    @pytest.mark.parametrize("x", [-2.0, -0.5, 0.0, 1.3, 4.0])
    def test_normal_matches_scipy(self, x):
        lp = Normal(1.2, 2.5).log_prob(x)
        assert np.isclose(float(lp), sps.norm(1.2, 2.5).logpdf(x), atol=1e-5)

    @pytest.mark.parametrize("x", [0.0, 0.7, 2.1])
    def test_halfnormal_matches_scipy(self, x):
        lp = HalfNormal(1.7).log_prob(x)
        assert np.isclose(float(lp), sps.halfnorm(scale=1.7).logpdf(x), atol=1e-5)

    @pytest.mark.parametrize("x", [0.1, 0.5, 0.9])
    def test_beta_matches_scipy(self, x):
        lp = Beta(2.0, 5.0).log_prob(x)
        assert np.isclose(float(lp), sps.beta(2.0, 5.0).logpdf(x), atol=1e-5)

    @pytest.mark.parametrize("x", [0.2, 1.0, 3.5])
    def test_gamma_matches_scipy(self, x):
        # shape-rate parameterization (reference gamma.py:24)
        lp = Gamma(3.0, 2.0).log_prob(x)
        assert np.isclose(float(lp), sps.gamma(3.0, scale=0.5).logpdf(x), atol=1e-5)

    def test_exponential_at_zero_is_log_rate(self):
        lp = Exponential(3.0).log_prob(0.0)
        assert np.isclose(float(lp), math.log(3.0), atol=1e-6)

    def test_categorical_probs(self):
        d = Categorical(probs=[0.5, 0.3, 0.2])
        assert np.isclose(float(d.log_prob(0)), math.log(0.5), atol=1e-6)
        assert np.isclose(float(d.log_prob(2)), math.log(0.2), atol=1e-6)

    def test_categorical_logits_normalized(self):
        d = Categorical(logits=[0.0, 0.0, 0.0, 0.0])
        assert np.isclose(float(d.log_prob(1)), math.log(0.25), atol=1e-6)

    def test_categorical_probs_renormalized(self):
        d = Categorical(probs=[2.0, 2.0])
        assert np.isclose(float(d.log_prob(0)), math.log(0.5), atol=1e-6)

    def test_vectorized_log_prob(self):
        xs = jnp.linspace(-3, 3, 50)
        lp = Normal(0.0, 1.0).log_prob(xs)
        assert lp.shape == (50,)
        np.testing.assert_allclose(
            np.asarray(lp), sps.norm.logpdf(np.asarray(xs)), atol=1e-5
        )

    def test_batched_params_broadcast(self):
        locs = jnp.array([0.0, 1.0, 2.0])
        lp = Normal(locs, 1.0).log_prob(jnp.array([0.0, 1.0, 2.0]))
        assert lp.shape == (3,)
        assert np.allclose(np.asarray(lp), sps.norm.logpdf(0.0), atol=1e-5)


# ---------------------------------------------------------------------------
# Support edges -> -inf, with finite gradients (engine addition)
# ---------------------------------------------------------------------------


class TestSupport:
    @pytest.mark.parametrize(
        "dist,bad",
        [
            (HalfNormal(1.0), -0.5),
            (Beta(2.0, 2.0), -0.1),
            (Beta(2.0, 2.0), 1.1),
            (Beta(2.0, 2.0), 0.0),
            (Beta(2.0, 2.0), 1.0),
            (Gamma(2.0, 1.0), -1.0),
            (Gamma(2.0, 1.0), 0.0),
            (Exponential(1.0), -0.01),
        ],
    )
    def test_outside_support_is_neg_inf(self, dist, bad):
        assert float(dist.log_prob(bad)) == -np.inf

    def test_categorical_invalid_index(self):
        d = Categorical(probs=[0.5, 0.5])
        assert float(d.log_prob(-1)) == -np.inf
        assert float(d.log_prob(2)) == -np.inf

    @pytest.mark.parametrize(
        "dist,bad",
        [
            (HalfNormal(1.0), -0.5),
            (Beta(2.0, 2.0), -0.1),
            (Gamma(2.0, 1.0), -1.0),
            (Exponential(1.0), -0.5),
        ],
    )
    def test_gradient_outside_support_is_finite(self, dist, bad):
        # The masked branch must not produce NaN gradients (safe-where).
        g = jax.grad(lambda x: dist.log_prob(x))(bad)
        assert np.isfinite(float(g))

    def test_traced_parameters(self):
        # gammaln/betaln must be traced on-device: grads w.r.t. parameters.
        g = jax.grad(lambda a: Beta(a, 2.0).log_prob(0.3))(2.0)
        assert np.isfinite(float(g))
        g = jax.grad(lambda a: Gamma(a, 2.0).log_prob(0.7))(3.0)
        assert np.isfinite(float(g))


# ---------------------------------------------------------------------------
# Moment matching on 10k samples (reference pattern)
# ---------------------------------------------------------------------------

N = 10_000


class TestSampling:
    @pytest.mark.parametrize(
        "dist,mean,var",
        [
            (Normal(2.0, 3.0), 2.0, 9.0),
            (HalfNormal(2.0), 2.0 * math.sqrt(2 / math.pi), 4.0 * (1 - 2 / math.pi)),
            (Beta(2.0, 5.0), 2 / 7, 10 / (49 * 8)),
            (Gamma(3.0, 2.0), 1.5, 0.75),
            (Exponential(2.0), 0.5, 0.25),
        ],
    )
    def test_moments(self, dist, mean, var):
        xs = np.asarray(dist.sample(key(7), (N,)))
        assert xs.shape == (N,)
        assert np.isclose(xs.mean(), mean, atol=4 * math.sqrt(var / N) + 0.01)
        assert np.isclose(xs.var(), var, rtol=0.15)

    def test_halfnormal_nonnegative(self):
        xs = np.asarray(HalfNormal(1.0).sample(key(1), (N,)))
        assert (xs >= 0).all()

    def test_beta_in_unit_interval(self):
        xs = np.asarray(Beta(0.5, 0.5).sample(key(2), (N,)))
        assert ((xs >= 0) & (xs <= 1)).all()

    def test_categorical_frequencies(self):
        probs = np.array([0.5, 0.3, 0.2])
        xs = np.asarray(Categorical(probs=probs).sample(key(3), (N,)))
        freqs = np.bincount(xs, minlength=3) / N
        np.testing.assert_allclose(freqs, probs, atol=0.02)

    def test_sample_dtype_and_determinism(self):
        d = Normal(0.0, 1.0)
        a = d.sample(key(5), (16,))
        b = d.sample(key(5), (16,))
        assert a.dtype == jnp.float32
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_batched_sample_shape(self):
        d = Normal(jnp.zeros(4), 1.0)
        assert d.sample(key(0), (7,)).shape == (7, 4)
        assert d.sample(key(0)).shape == (4,)


# ---------------------------------------------------------------------------
# Moments API and constructor validation
# ---------------------------------------------------------------------------


class TestMomentsAndValidation:
    def test_closed_form_moments(self):
        assert np.isclose(float(Beta(2.0, 5.0).mean()), 2 / 7)
        assert np.isclose(float(Beta(2.0, 5.0).mode()), 1 / 5)
        assert np.isnan(float(Beta(0.5, 0.5).mode()))
        assert np.isclose(float(Gamma(3.0, 2.0).mode()), 1.0)
        assert np.isnan(float(Gamma(0.5, 2.0).mode()))
        assert np.isclose(float(Exponential(4.0).median()), math.log(2) / 4)
        assert np.isclose(float(Exponential(4.0).mode()), 0.0)

    def test_categorical_requires_xor_args(self):
        with pytest.raises(ValueError):
            Categorical()
        with pytest.raises(ValueError):
            Categorical(probs=[0.5, 0.5], logits=[0.0, 0.0])

    def test_categorical_entropy_mode(self):
        d = Categorical(probs=[0.5, 0.3, 0.2])
        expected = -(0.5 * math.log(0.5) + 0.3 * math.log(0.3) + 0.2 * math.log(0.2))
        assert np.isclose(float(d.entropy()), expected, atol=1e-6)
        assert int(d.mode()) == 0

    def test_normal_entropy(self):
        assert np.isclose(
            float(Normal(0.0, 2.0).entropy()),
            sps.norm(0, 2).entropy(),
            atol=1e-6,
        )


class TestJitVmap:
    def test_log_prob_under_jit_and_vmap(self):
        @jax.jit
        def f(mus, x):
            return jax.vmap(lambda m: Normal(m, 1.0).log_prob(x))(mus)

        out = f(jnp.arange(8.0), 0.5)
        assert out.shape == (8,)
        assert np.all(np.isfinite(np.asarray(out)))

    def test_model_style_usage(self):
        # The dict-of-params model contract (reference README.md:61-77).
        data = jax.random.normal(key(0), (100,)) * 2.0 + 5.0

        def log_prob(params):
            mu, sigma = params["mu"], params["sigma"]
            lp = Normal(0.0, 10.0).log_prob(mu)
            lp += HalfNormal(5.0).log_prob(sigma)
            return lp + jnp.sum(Normal(mu, sigma).log_prob(data))

        val = jax.jit(log_prob)({"mu": 0.0, "sigma": 1.0})
        assert np.isfinite(float(val))
        grads = jax.grad(log_prob)({"mu": 4.0, "sigma": 2.0})
        assert np.isfinite(float(grads["mu"]))
        assert np.isfinite(float(grads["sigma"]))
