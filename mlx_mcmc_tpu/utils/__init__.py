"""Utilities: typed configs, profiling helpers, roofline/MFU accounting,
the persistent compile cache."""

from mlx_mcmc_tpu.utils.compile_cache import enable_compile_cache
from mlx_mcmc_tpu.utils.config import (
    AdaptationConfig,
    MeshConfig,
    SamplerConfig,
)
from mlx_mcmc_tpu.utils.profiling import gradient_evals, trace_to
from mlx_mcmc_tpu.utils.roofline import (
    device_peaks,
    glm_vag_bytes,
    glm_vag_flops,
    roofline_report,
)

__all__ = [
    "SamplerConfig",
    "AdaptationConfig",
    "MeshConfig",
    "trace_to",
    "gradient_evals",
    "device_peaks",
    "glm_vag_flops",
    "glm_vag_bytes",
    "roofline_report",
    "enable_compile_cache",
]
