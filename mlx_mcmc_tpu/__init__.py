"""mlx-mcmc-tpu: a compiled Bayesian MCMC inference engine for the GPU.

A from-scratch JAX/XLA/Pallas/pjit framework with the capabilities of the
reference ``mlx_mcmc`` library (mlx_mcmc/__init__.py:24-46 export surface):
six distributions, Metropolis-Hastings / HMC / NUTS kernels, and the ``MCMC``
facade — rebuilt as one compiled program: whole-sampler ``lax.scan`` (no host loops), iterative
fixed-depth NUTS, vmapped chains sharded over a device mesh, cross-chain
warmup adaptation via collectives, and R-hat/ESS diagnostics.

Example:
    >>> import jax.numpy as jnp
    >>> from mlx_mcmc_tpu import Normal, HalfNormal, MCMC
    >>>
    >>> def log_prob(params):
    ...     return Normal(0, 10).log_prob(params['mu']) + \\
    ...            HalfNormal(5).log_prob(params['sigma'])
    >>>
    >>> mcmc = MCMC(log_prob)
    >>> samples = mcmc.run({'mu': 0.0, 'sigma': 1.0}, num_samples=1000)
"""

__version__ = "0.1.0"

from mlx_mcmc_tpu.distributions import (
    Distribution,
    Normal,
    HalfNormal,
    Beta,
    Gamma,
    Exponential,
    Categorical,
    Bernoulli,
    Binomial,
    NegativeBinomial,
    Laplace,
    Cauchy,
    Uniform,
    LogNormal,
    StudentT,
    Poisson,
    Dirichlet,
    MultivariateNormal,
    make_transformed_logprob,
)
from mlx_mcmc_tpu.kernels import hmc, metropolis_hastings, nuts
from mlx_mcmc_tpu.inference import (
    MCMC,
    MCMCResult,
    TemperedResult,
    ADVIResult,
    fit_advi,
    SMCResult,
    clear_runner_cache,
    sample,
    sample_posterior_predictive,
    sample_ensemble,
    sample_smc,
    sample_tempered,
)

__all__ = [
    "Distribution",
    "Normal",
    "HalfNormal",
    "Beta",
    "Gamma",
    "Exponential",
    "Categorical",
    "Bernoulli",
    "Binomial",
    "NegativeBinomial",
    "Laplace",
    "Cauchy",
    "Uniform",
    "LogNormal",
    "StudentT",
    "Poisson",
    "Dirichlet",
    "MultivariateNormal",
    "make_transformed_logprob",
    "metropolis_hastings",
    "hmc",
    "nuts",
    "MCMC",
    "MCMCResult",
    "sample",
    "sample_posterior_predictive",
    "clear_runner_cache",
    "TemperedResult",
    "sample_tempered",
    "ADVIResult",
    "fit_advi",
    "sample_ensemble",
    "SMCResult",
    "sample_smc",
]
