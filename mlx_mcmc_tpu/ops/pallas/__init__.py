"""Pallas GPU kernels for the sampler hot path (SURVEY.md §7 design delta #7).

The hot op of every gradient-based kernel is ``value_and_grad(log_prob)``
inside the leapfrog integrator. For GLM-family likelihoods the plain
version writes the (chains, observations) linear predictor and residual
to device memory and reads them back; the fused kernel here keeps both on
chip while each block of the design matrix feeds both contractions.
"""

from mlx_mcmc_tpu.ops.pallas.glm import (
    fused_linear_value_and_grad,
    fused_logistic_value_and_grad,
    make_fused_linear_vag,
    make_fused_logistic_vag,
    prepare_fused_linear_data,
    prepare_fused_logistic_data,
)

__all__ = [
    "fused_linear_value_and_grad",
    "fused_logistic_value_and_grad",
    "make_fused_logistic_vag",
    "prepare_fused_logistic_data",
    "make_fused_linear_vag",
    "prepare_fused_linear_data",
]
