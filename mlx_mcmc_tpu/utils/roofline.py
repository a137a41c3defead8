"""Roofline / MFU accounting for sampler hot ops.

The reference has no performance tooling at all (SURVEY.md §5.1 — ad-hoc
``time.time()`` calls in examples). Here the bench and user code share one
accounting path: published single-card peaks keyed by ``device_kind``,
flop/byte models for the GLM value+grad hot op, and a report combining
achieved throughput with the bandwidth-or-compute roofline bound.

Peaks are NVIDIA's H100 SXM data sheet figures (dense, no sparsity, at the
700 W power limit): 989 TFLOP/s bf16 on the tensor cores, 495 TFLOP/s
TF32, 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM3. A
share is taken against the peak that the matmul's operands can reach:
bf16 operands against the bf16 peak, float32 at default precision (which
the GPU may run in TF32) against TF32, float32 at HIGHEST precision
against the float32 peak. A device that is not in the table is an error.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# device_kind substring -> peak TFLOP/s per operand class, and HBM GB/s.
DEVICE_PEAKS = {
    "H100 80GB HBM3": {
        "bf16": 989.0, "tf32": 495.0, "f32": 67.0, "hbm_gbs": 3350.0,
    },
}


def device_peaks(device) -> dict:
    """The peak table entry for a jax Device; raises for an unknown one."""
    kind = getattr(device, "device_kind", "")
    for sub, peaks in DEVICE_PEAKS.items():
        if sub in kind:
            return peaks
    raise ValueError(
        f"no published peaks for device_kind {kind!r}; add its data-sheet "
        "figures to mlx_mcmc_tpu.utils.roofline.DEVICE_PEAKS"
    )


def peak_class(operand_dtype, highest_precision: bool = False) -> str:
    """Which peak a matmul with these operands is measured against."""
    dt = np.dtype(operand_dtype)
    if dt.itemsize <= 2:
        return "bf16"
    return "f32" if highest_precision else "tf32"


def glm_vag_flops(num_obs: int, num_features: int, chains: int = 1) -> float:
    """Flops of ONE GLM value+grad evaluation: forward (N,D)@(D,C)
    plus backward X^T r — 4*N*D per chain."""
    return 4.0 * num_obs * num_features * chains


def glm_vag_bytes(
    num_obs: int, num_features: int, itemsize: int = 4, x_reads: float = 1.0
) -> float:
    """Dominant device-memory bytes of one evaluation: the design-matrix
    stream. ``x_reads``: 1 for the fused single-pass kernel, 2 for the
    plain path (the forward and the backward product each read X)."""
    return num_obs * num_features * itemsize * x_reads


def roofline_report(
    flops: float,
    bytes_accessed: float,
    wall_seconds: float,
    device,
    operand_dtype="bfloat16",
    highest_precision: bool = False,
) -> dict:
    """Achieved TFLOP/s, MFU %, arithmetic intensity, and the roofline bound
    ``min(peak, AI * bandwidth)`` with the achieved fraction of that bound.
    ``peak`` names the peak the shares are taken against."""
    peaks = device_peaks(device)
    name = peak_class(operand_dtype, highest_precision)
    peak_tflops, hbm_gbs = peaks[name], peaks["hbm_gbs"]
    achieved_tflops = flops / wall_seconds / 1e12
    ai = flops / max(bytes_accessed, 1.0)
    bound = min(peak_tflops, ai * hbm_gbs / 1e3)
    return {
        "achieved_tflops": round(achieved_tflops, 2),
        "peak": name,
        "peak_tflops": peak_tflops,
        "hbm_gbs": hbm_gbs,
        "mfu_pct": round(100.0 * achieved_tflops / peak_tflops, 2),
        "arithmetic_intensity": round(ai, 1),
        "roofline_bound_tflops": round(bound, 1),
        "roofline_frac_pct": round(100.0 * achieved_tflops / bound, 2),
    }


def bound_seconds(flops: float, bytes_accessed: float, device,
                  operand_dtype="bfloat16",
                  highest_precision: bool = False) -> Tuple[float, str]:
    """Least time the card could take for this work, and which side of
    the roofline bounds it ("compute" or "memory")."""
    peaks = device_peaks(device)
    t_compute = flops / (peaks[peak_class(operand_dtype, highest_precision)]
                         * 1e12)
    t_memory = bytes_accessed / (peaks["hbm_gbs"] * 1e9)
    if t_compute >= t_memory:
        return t_compute, "compute"
    return t_memory, "memory"
