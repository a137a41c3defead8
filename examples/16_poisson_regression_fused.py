"""Example 16: hierarchical Poisson REGRESSION with a hand-written value+grad.

The non-collapsible sibling of example 15: per-observation covariates
(rate = exp(theta_g + x . beta)) destroy the sufficient-statistic
structure, so every gradient evaluation must touch all 100K observations —
the honest full-data "Large model" workload.

Two lessons are load-bearing here (ops/poisson.py):

 1. PRECISION: at this scale a linear predictor with rounded operands
    (bf16, or TF32 from a default-precision float32 matmul on the GPU)
    injects nats of state-dependent log-likelihood noise — enough to
    collapse NUTS adaptation outright (step size driven towards zero,
    every tree at the depth cap). The vag builds the predictor from K
    exact float32 multiply-adds and sums per-row terms centered on
    per-group baseline rates; an equivalent model written with a matmul
    needs ``precision=jax.lax.Precision.HIGHEST`` on it.
 2. FUSION: value, per-group gradient (a reshape-and-sum over contiguous
    groups) and covariate gradient are written out by hand, so XLA fuses
    the whole elementwise chain into its reductions.
"""

import numpy as np

from mlx_mcmc_tpu import sample
from mlx_mcmc_tpu.models import make_poisson_event_rates
from mlx_mcmc_tpu.ops.poisson import (
    make_fused_poisson_model,
    prepare_fused_poisson_data,
)


def main():
    print("=" * 70)
    print("Example 16: Hierarchical Poisson Regression (hand-written vag)")
    print("=" * 70)

    spec = make_poisson_event_rates(
        num_groups=1000, obs_per_group=100, covariate_dim=4, seed=0
    )
    print(f"  1000 group rates + 4 covariate effects; "
          f"N = {spec.y.size} observed counts")

    data = prepare_fused_poisson_data(spec.y, spec.X)
    log_prob, vag = make_fused_poisson_model()

    res = sample(
        log_prob,
        spec.initial_params,
        data=data,
        value_and_grad_fn=vag,
        num_warmup=300,
        num_samples=300,
        num_chains=256,
        kernel="nuts",
        max_tree_depth=8,
        target_accept=0.9,
        seed=0,
        store_dtype="bfloat16",
    )

    beta_hat = np.mean(
        np.asarray(res.samples["beta"], dtype=np.float32), axis=(0, 1)
    )
    beta_true = np.asarray(spec.truth["beta"])
    mu_hat = float(np.mean(np.asarray(res.samples["mu"], np.float32)))
    print(f"  posterior mu    = {mu_hat:.3f}  (true {spec.truth['mu']})")
    for k in range(4):
        print(f"  posterior b[{k}]  = {beta_hat[k]:+.3f}  "
              f"(true {float(beta_true[k]):+.3f})")
    acc = float(np.asarray(res.info.accept_prob).mean())
    print(f"  mean accept     = {acc:.3f} (target 0.9)")
    print(f"  divergences     = {res.divergences}")
    assert abs(mu_hat - spec.truth["mu"]) < 0.2
    assert np.all(np.abs(beta_hat - beta_true) < 0.1)
    assert acc > 0.8
    print("  OK")


if __name__ == "__main__":
    main()
