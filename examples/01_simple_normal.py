"""Example 01: estimate a normal distribution's mean and std.

Port of reference examples/01_simple_normal.py (same scenario: seed 42,
true mu=5.0, sigma=2.0, n=100 — BASELINE.md ground truth), rebuilt as one compiled program:
the likelihood is one batched vectorized log_prob over the whole data array
(the reference loops per observation, examples/01:46-48) and sampling runs as
a single compiled program with 8 parallel chains.
"""

import numpy as np
import jax.numpy as jnp

from mlx_mcmc_tpu import MCMC, HalfNormal, Normal
from examples._plotting import maybe_plot_trace


def main():
    print("=" * 70)
    print("Example 01: Simple Normal Model (Metropolis-Hastings)")
    print("=" * 70)

    np.random.seed(42)
    true_mu, true_sigma, n_obs = 5.0, 2.0, 100
    data = jnp.asarray(np.random.normal(true_mu, true_sigma, n_obs).astype(np.float32))
    print(f"  True mu={true_mu}, sigma={true_sigma}; n={n_obs}")
    print(f"  Sample mean={float(data.mean()):.3f}, std={float(data.std()):.3f}")

    def log_prob(params):
        mu, sigma = params["mu"], params["sigma"]
        log_prior = Normal(0, 10).log_prob(mu) + HalfNormal(5).log_prob(sigma)
        log_likelihood = jnp.sum(Normal(mu, sigma).log_prob(data))
        return log_prior + log_likelihood

    mcmc = MCMC(log_prob)
    samples = mcmc.run(
        {"mu": 0.0, "sigma": 1.0},
        num_samples=5000,
        num_warmup=1000,
        method="metropolis",
        proposal_scale=0.15,
        num_chains=8,
        verbose=True,
    )
    mcmc.print_summary()

    assert abs(samples["mu"].mean() - float(data.mean())) < 0.2
    assert abs(samples["sigma"].mean() - float(data.std())) < 0.25
    maybe_plot_trace(samples, {"mu": true_mu, "sigma": true_sigma}, "01_simple_normal")
    print("\n✅ Example 01 complete: posterior matches the data moments.")


if __name__ == "__main__":
    main()
