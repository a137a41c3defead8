"""Example 15: hierarchical Poisson event rates at the "Large model" scale.

The reference's event-rate scenario (examples/04_event_rates.py: ONE
Exponential rate, 50 observations, a per-observation Python loop) grown to
the model class its README table only promises (README.md:105-113): 1000
group rates, 100 observed counts each, partial pooling through a
non-centered log-rate hierarchy.

Compiled-engine-first twice over:
 1. the likelihood is an exponential family, so the O(N)=100K data
    reduction collapses EXACTLY to per-group sufficient statistics at
    data-prep time (ops/suffstats.py make_poisson_rates_model) — each
    leapfrog costs O(G)=1000 per chain instead of O(N);
 2. the whole warmup+sampling program is one compiled scan over 512
    parallel chains.
"""

import numpy as np

from mlx_mcmc_tpu import sample
from mlx_mcmc_tpu.models import make_poisson_event_rates
from mlx_mcmc_tpu.ops.suffstats import (
    make_poisson_rates_model,
    prepare_poisson_rates_data,
)


def main():
    print("=" * 70)
    print("Example 15: Hierarchical Poisson Event Rates (1000 groups)")
    print("=" * 70)

    spec = make_poisson_event_rates(
        num_groups=1000, obs_per_group=100, seed=0
    )
    print(f"  {spec.y.shape[0]} groups x {spec.y.shape[1]} counts; "
          f"true mu={spec.truth['mu']}, tau={spec.truth['tau']}")

    data = prepare_poisson_rates_data(spec.y)
    log_prob, vag = make_poisson_rates_model()

    res = sample(
        log_prob,
        spec.initial_params,
        data=data,
        value_and_grad_fn=vag,
        num_warmup=300,
        num_samples=500,
        num_chains=512,
        kernel="nuts",
        max_tree_depth=6,
        target_accept=0.9,
        seed=0,
    )

    mu_hat = float(np.mean(np.asarray(res.samples["mu"])))
    tau_hat = float(np.mean(np.exp(np.asarray(res.samples["log_tau"]))))
    print(f"  posterior mu  = {mu_hat:.3f}  (true {spec.truth['mu']})")
    print(f"  posterior tau = {tau_hat:.3f}  (true {spec.truth['tau']})")
    print(f"  divergences   = {res.divergences}")
    assert abs(mu_hat - spec.truth["mu"]) < 0.2
    print("  OK")


if __name__ == "__main__":
    main()
