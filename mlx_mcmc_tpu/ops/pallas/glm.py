"""Fused GLM log-likelihood + gradient: one Pallas-Triton kernel for the GPU.

For a chain batch ``Z`` of coefficient vectors it computes

    s      = X @ z                     (per chain)
    ll     = sum_i t(s_i, y_i)         t = y s - softplus(s)   (logistic)
                                       t = -(y - s)^2 / 2      (linear)
    grad   = X^T r                     r = dt/ds

with ``s`` and ``r`` kept on chip. The plain ``jnp`` version writes the
(C, N) float32 ``s`` to device memory, reads it back for the epilogue,
writes ``r`` and reads it again for ``X^T r``; the kernel moves none of
those bytes.

Kernel layout (grid ``(chain tiles, row splits)``):

- each program owns one tile of ``block_c`` chains and one contiguous
  slice of the rows, which a loop walks in blocks of ``block_n`` rows;
- per block: ``s = X_blk @ B`` on the tensor cores (operands in X's dtype,
  float32 accumulation), the epilogue in registers, then ``X_blk^T r``
  while the block is on chip;
- each program writes its own partial ll and gradient, and XLA sums the
  partials. Nothing carries between programs, and every partial sum stays
  O(rows per program): the absolute-accuracy rule of docs/DESIGN.md §4b.

The kernel covers up to ``KERNEL_D = 128`` padded features, where the
(128, chain block) gradient tile lives in registers for the whole row
loop. Wider designs run the plain XLA version: a D-chunked variant that
accumulated the gradient in its own output slice measured 7x slower than
XLA at 1000 features (PERF.md), and was removed.

Zero padding instead of masking: rows padded with ``X=0, y=0`` have
``s=0`` whatever ``z`` is, so they add nothing to the (centred) value and
nothing to the gradient. Chains pad to the kernel's chain block.

``make_fused_logistic_vag`` / ``make_fused_linear_vag`` return a drop-in
``value_and_grad`` with a ``custom_vmap`` rule, so the engine's chain
``vmap`` becomes one batched call. Which path runs is decided by
:func:`mlx_mcmc_tpu.ops.dispatch.use_kernel`.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from mlx_mcmc_tpu.ops.dispatch import chain_batched, use_kernel, value_precision

KERNEL_D = 128  # padded features the kernel covers; features pad to multiples
_DEFAULT_TILE_N = 1024  # row padding unit of the prepared data
_TARGET_PROGRAMS = 264  # two programs for each of the H100's 132 SMs
_IMPLS = ("pallas", "xla")
_LOG2 = float(np.log(2.0))


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _epilogue(likelihood: str, s, y):
    """Per-row log-likelihood term ``t`` and residual ``r = dt/ds``.

    Shared by the kernel and the plain path, so both evaluate the same
    arithmetic. The logistic form is the stable one: ``e = exp(-|s|)``
    gives ``softplus(s) = max(s, 0) + log1p(e)`` and ``sigmoid(s)`` with
    no overflow for any ``s``. Its term is CENTRED by ``+log 2`` (the term
    of a row with ``s = 0``): a zero-padded row then adds exactly 0, and
    the sum over 10^5 rows stays several times smaller than the raw ll,
    which keeps its float32 rounding inside the docs/DESIGN.md §4b budget.
    Callers subtract ``log 2`` per row once, as a constant."""
    if likelihood == "logistic":
        e = jnp.exp(-jnp.abs(s))
        inv = 1.0 / (1.0 + e)
        sig = jnp.where(s >= 0.0, inv, e * inv)
        t = y * s - (jnp.maximum(s, 0.0) + jnp.log1p(e)) + _LOG2
        return t, y - sig
    r = y - s
    return -0.5 * r * r, r


def _vag_kernel(x_ref, y_ref, b_ref, ll_ref, g_ref, *, likelihood, block_n,
                blocks_per_split):
    split = pl.program_id(1)
    first = split * blocks_per_split

    def rows(k):
        return pl.ds(pl.multiple_of((first + k) * block_n, block_n), block_n)

    b = b_ref[...]  # (d_pad, block_c); the gradient tile lives in registers

    def body(k, carry):
        ll, g = carry
        x = x_ref[rows(k), :]
        t, r = _epilogue(likelihood, pl.dot(x, b), y_ref[rows(k), :])
        g = g + pl.dot(x, r.astype(x.dtype), trans_a=True)
        return ll + jnp.sum(t, axis=0), g

    ll, g = jax.lax.fori_loop(
        0, blocks_per_split, body,
        (jnp.zeros(b.shape[1:], jnp.float32), jnp.zeros(b.shape, jnp.float32)),
    )
    ll_ref[...] = ll
    g_ref[...] = g


def _tile_config(c: int) -> dict:
    """Kernel block sizes for ``c`` chains: a chain block of up to 64 (a
    power of two, at least 16 for the tensor cores), 32-row blocks, four
    warps. Chosen by a sweep on the H100 at the glm100_fused shape (PERF.md):
    wider tiles spill the (128, block_c) gradient tile out of registers."""
    block_c = min(64, max(16, pl.next_power_of_2(c)))
    return dict(block_n=32, block_c=block_c, num_warps=4, num_stages=2)


def _row_splits(n_blocks: int, c_tiles: int) -> int:
    """Row splits per chain tile: a divisor of ``n_blocks`` that brings the
    grid near ``_TARGET_PROGRAMS`` programs, preferring fewer splits (each
    split adds one partial gradient for XLA to sum)."""
    want = max(1, -(-_TARGET_PROGRAMS // c_tiles))
    divisors = [s for s in range(1, n_blocks + 1) if n_blocks % s == 0]
    below = [s for s in divisors if s <= want]
    if below and 2 * below[-1] >= want:
        return below[-1]
    return next((s for s in divisors if s >= want), n_blocks)


def _kernel_call(Xp, yp, Bt, *, likelihood, block_n, block_c, num_warps,
                 num_stages, interpret):
    """The kernel on pre-padded operands: Xp (n_pad, d_pad), yp (n_pad, 1),
    Bt (d_pad, c_pad) with c_pad a multiple of ``block_c``. Returns the
    summed (ll (c_pad,), g (d_pad, c_pad))."""
    n_pad, d_pad = Xp.shape
    c_pad = Bt.shape[1]
    if n_pad % block_n != 0:
        raise ValueError(
            f"padded rows ({n_pad}) not a multiple of the row block "
            f"{block_n}; the data was prepared with a smaller tile"
        )
    if d_pad != KERNEL_D or c_pad % block_c != 0:
        raise ValueError(
            f"bad padded shapes: d_pad={d_pad} (the kernel covers "
            f"{KERNEL_D}), c_pad={c_pad} (need a multiple of {block_c})"
        )
    n_blocks = n_pad // block_n
    c_tiles = c_pad // block_c
    splits = _row_splits(n_blocks, c_tiles)
    kernel = functools.partial(
        _vag_kernel, likelihood=likelihood, block_n=block_n,
        blocks_per_split=n_blocks // splits,
    )
    ll, g = pl.pallas_call(
        kernel,
        grid=(c_tiles, splits),
        in_specs=[
            pl.BlockSpec((n_pad, d_pad), lambda j, i: (0, 0)),
            pl.BlockSpec((n_pad, 1), lambda j, i: (0, 0)),
            pl.BlockSpec((d_pad, block_c), lambda j, i: (0, j)),
        ],
        out_specs=[
            pl.BlockSpec((None, block_c), lambda j, i: (i, j)),
            pl.BlockSpec((None, d_pad, block_c), lambda j, i: (i, 0, j)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((splits, c_pad), jnp.float32),
            jax.ShapeDtypeStruct((splits, d_pad, c_pad), jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        name=f"glm_{likelihood}_vag",
    )(Xp, yp, Bt)
    return jnp.sum(ll, axis=0), jnp.sum(g, axis=0)


def _xla_call(Xp, yp, Z, *, likelihood):
    """The plain ``jnp`` version of the kernel on the same padded operands:
    operands in X's dtype, float32 accumulation, and the value-path
    precision rule of :func:`~mlx_mcmc_tpu.ops.dispatch.value_precision`
    for ``s``."""
    d = Z.shape[1]
    Zp = jnp.pad(Z.astype(Xp.dtype), ((0, 0), (0, Xp.shape[1] - d)))
    s = jnp.dot(Zp, Xp.T, precision=value_precision(Xp.dtype),
                preferred_element_type=jnp.float32)  # (C, n_pad)
    t, r = _epilogue(likelihood, s, yp[:, 0][None, :])
    g = jnp.dot(r.astype(Xp.dtype), Xp, preferred_element_type=jnp.float32)
    # Sum in two levels, as the kernel's per-program partials do: blocks of
    # rows first, then the block sums. The barrier keeps XLA from merging
    # the two into one long reduction, whose float32 error at 10^5 rows
    # reached the §4b budget on the H100.
    n_pad = Xp.shape[0]
    block = math.gcd(n_pad, 1024)
    partial = jnp.sum(t.reshape(t.shape[0], n_pad // block, block), axis=-1)
    return jnp.sum(jax.lax.optimization_barrier(partial), axis=-1), g[:, :d]


def _batched_vag(Xp, yp, Z, *, likelihood, impl, interpret=False,
                 block_n=None):
    """(ll (C,), grad (C, d)) of the data terms for a chain batch Z (C, d);
    ``block_n`` caps the kernel's row block at the data's row tile."""
    if impl == "xla":
        return _xla_call(Xp, yp, Z, likelihood=likelihood)
    c, d = Z.shape
    cfg = _tile_config(c)
    if block_n is not None:
        cfg["block_n"] = min(cfg["block_n"], block_n)
    block_c = cfg.pop("block_c")
    c_pad = _round_up(c, block_c)
    Bt = jnp.zeros((Xp.shape[1], c_pad), Xp.dtype).at[:d, :c].set(
        Z.astype(Xp.dtype).T
    )
    ll, g = _kernel_call(
        Xp, yp, Bt, likelihood=likelihood, block_c=block_c,
        interpret=interpret, **cfg,
    )
    return ll[:c], g[:d, :c].T


def _check_impl(impl):
    if impl is not None and impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS} or None, got {impl!r}")


def _pad_data(X, y, tile_n: int):
    """One-time zero padding of the design matrix (hoisted out of the hot
    loop). Rows pad to ``tile_n``, features to the kernel's D-chunk. X
    keeps its dtype: bfloat16 halves the bytes every evaluation reads."""
    n, d = X.shape
    n_pad = _round_up(max(n, 8), tile_n)
    d_pad = _round_up(d, KERNEL_D)
    Xp = jnp.zeros((n_pad, d_pad), X.dtype).at[:n, :d].set(X)
    yp = jnp.zeros((n_pad, 1), jnp.float32).at[:n, 0].set(y.astype(jnp.float32))
    return Xp, yp


def _padded_entry(likelihood, X, y, Z, tile_n, interpret):
    n = X.shape[0]
    Xp, yp = _pad_data(jnp.asarray(X), jnp.asarray(y), tile_n)
    ll, g = _batched_vag(
        Xp, yp, Z, likelihood=likelihood, impl="pallas", interpret=interpret,
    )
    if likelihood == "logistic":
        ll = ll - n * _LOG2  # undo the per-row centring of the real rows
    return ll, g


@functools.partial(jax.jit, static_argnames=("tile_n", "interpret"))
def fused_logistic_value_and_grad(
    X: jnp.ndarray,
    y: jnp.ndarray,
    Z: jnp.ndarray,
    tile_n: int = _DEFAULT_TILE_N,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched Bernoulli log-likelihood and gradient through the kernel.

    Convenience entry that pads per call; a sampler uses
    :func:`make_fused_logistic_vag`, which pads the data once.

    Args:
        X: (N, D) design matrix (float32 or bfloat16).
        y: (N,) 0/1 outcomes.
        Z: (C, D) chain batch of coefficients.

    Returns:
        (ll (C,), grad (C, D)).
    """
    return _padded_entry("logistic", X, y, Z, tile_n, interpret)


@functools.partial(jax.jit, static_argnames=("tile_n", "interpret"))
def fused_linear_value_and_grad(
    X: jnp.ndarray,
    y: jnp.ndarray,
    Z: jnp.ndarray,
    tile_n: int = _DEFAULT_TILE_N,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched Gaussian sum of squares and gradient through the kernel
    (unscaled: ``-0.5 sum (y - Xz)^2`` and ``X^T (y - Xz)`` per chain)."""
    return _padded_entry("linear", X, y, Z, tile_n, interpret)


def _reference_value_and_grad(X, y, Z):
    """Autodiff oracle for tests: the logistic log-likelihood and gradient
    of each row of Z, by ``jax.value_and_grad``."""

    def one(z):
        s = jnp.dot(X, z, precision=jax.lax.Precision.HIGHEST)
        return jnp.sum(y * s - jax.nn.softplus(s))

    return jax.vmap(jax.value_and_grad(one))(Z)


def fused_data_specs(data: dict, data_axis: str):
    """PartitionSpec tree for a fused-GLM data pytree under observation
    sharding (``sample_sharded(..., data_axis=..., data_specs=...)``): the
    row-major operands (``Xp``, ``yp``) shard their leading axis; the
    scalar/marker leaves replicate — the default leading-axis heuristic
    would wrongly shard the shape markers."""
    from jax.sharding import PartitionSpec as P

    return {
        k: (P(data_axis) if k in ("Xp", "yp") else P()) for k in data
    }


def prepare_fused_logistic_data(
    X, y, tile_n: int = _DEFAULT_TILE_N, num_shards: int = 1,
) -> dict:
    """One-time packing of a logistic-GLM dataset for the fused vag.

    Returns a pytree suitable for ``sample(..., data=...)``: passing the
    (possibly multi-GB) design matrix as a runtime argument keeps it out
    of the compiled program. X keeps its dtype; pass bfloat16 X to halve
    the bytes each evaluation reads (sampling then targets the posterior
    of the bf16-rounded design, a model-level rounding).

    ``num_shards``: for data-sharded sampling set this to the data-axis
    size. Rows pad to ``num_shards * tile_n`` (each shard's local rows stay
    a tile multiple) and the pad-row correction is divided by
    ``num_shards``, so the psum over shards adds it back exactly once.
    """
    X = jnp.asarray(X)
    n, d = X.shape
    Xp, yp = _pad_data(X, jnp.asarray(y), tile_n * num_shards)
    return {
        "Xp": Xp,
        "yp": yp,
        "pad_const": jnp.asarray(
            (Xp.shape[0] - n) * np.log(2.0) / num_shards, jnp.float32
        ),
        "dim": jnp.zeros((d,), jnp.float32),  # shape-only marker for d
        "tile": jnp.zeros((tile_n, 0), jnp.int8),  # zero-byte tile marker
    }


def prepare_fused_linear_data(
    X, y, noise_scale: float = 1.0, tile_n: int = _DEFAULT_TILE_N,
    num_shards: int = 1,
) -> dict:
    """Pack a linear-regression dataset for :func:`make_fused_linear_vag`.

    The noise scale and tile size travel inside the data pytree (``tile``
    is a zero-byte shape marker), so the vag always agrees with the
    padding. ``num_shards`` as in :func:`prepare_fused_logistic_data`;
    zero rows add exactly nothing to a Gaussian sum of squares, and the
    log-normaliser is divided by ``num_shards``.
    """
    X = jnp.asarray(X)
    n, d = X.shape
    Xp, yp = _pad_data(X, jnp.asarray(y), tile_n * num_shards)
    ll_norm = -0.5 * n * math.log(2.0 * math.pi * noise_scale**2) / num_shards
    return {
        "Xp": Xp,
        "yp": yp,
        "ll_norm": jnp.asarray(ll_norm, jnp.float32),
        "inv_noise_var": jnp.asarray(1.0 / noise_scale**2, jnp.float32),
        "dim": jnp.zeros((d,), jnp.float32),
        "tile": jnp.zeros((tile_n, 0), jnp.int8),
    }


def _data_terms(data, Z, likelihood, impl):
    Xp = data["Xp"]
    if impl is None:
        impl = "pallas" if use_kernel(Xp.shape[1] == KERNEL_D) else "xla"
    return _batched_vag(
        Xp, data["yp"], Z, likelihood=likelihood, impl=impl,
        block_n=data["tile"].shape[0],
    )


def make_fused_linear_vag(
    prior_scale: float = 1.0,
    impl: str | None = None,
    include_prior: bool = True,
):
    """``value_and_grad`` of a Gaussian linear-regression log-posterior
    (N(0, prior_scale) prior), data-aware: ``vag(z, data)`` with ``data``
    from :func:`prepare_fused_linear_data`.

    ``include_prior=False`` returns likelihood-only terms, as data-sharded
    sampling (``sample_sharded(..., data_axis=...)``) needs: the framework
    psums the local terms and adds the prior once via ``log_prior_fn``.
    ``impl`` forces ``"pallas"`` or ``"xla"``; None asks
    :func:`~mlx_mcmc_tpu.ops.dispatch.use_kernel`."""
    _check_impl(impl)
    inv_prior_var = 1.0 / (prior_scale * prior_scale)

    def batched(Z, data):
        ll, g = _data_terms(data, Z, "linear", impl)
        inv_noise_var = data["inv_noise_var"]
        ll = ll * inv_noise_var + data["ll_norm"]
        g = g * inv_noise_var
        if not include_prior:
            return ll, g
        d = Z.shape[1]
        log_prior_norm = -0.5 * d * math.log(2.0 * math.pi * prior_scale**2)
        ll = ll + log_prior_norm - 0.5 * inv_prior_var * jnp.sum(Z * Z, axis=-1)
        return ll, g - inv_prior_var * Z

    return chain_batched(batched, "make_fused_linear_vag")


def make_fused_logistic_vag(
    X: jnp.ndarray = None,
    y: jnp.ndarray = None,
    prior_scale: float = 1.0,
    tile_n: int = _DEFAULT_TILE_N,
    impl: str | None = None,
    data_aware: bool = False,
    include_prior: bool = True,
) -> Callable:
    """Build ``value_and_grad`` of the full logistic log-posterior
    (likelihood + N(0, prior_scale) prior), with a custom_vmap rule that
    routes the engine's chain-vmap into one batched call.
    ``include_prior=False`` returns likelihood-only terms (for data-sharded
    sampling, where the prior is added once outside the psum).

    Two modes:
    - closure mode (default): pass ``X``/``y`` here; returns ``vag(z)``.
      Fine for small data; large arrays become compile-time constants.
    - ``data_aware=True``: returns ``vag(z, data)`` with ``data`` from
      :func:`prepare_fused_logistic_data`, for use with
      ``sample(..., data=...)`` — the path for big datasets.

    ``impl`` forces ``"pallas"`` (the kernel) or ``"xla"`` (the plain
    ``jnp`` version); None asks
    :func:`~mlx_mcmc_tpu.ops.dispatch.use_kernel`: the kernel on the GPU,
    the plain version on the CPU.
    """
    _check_impl(impl)
    inv_var = 1.0 / (prior_scale * prior_scale)

    def batched(Z, data):
        ll, g = _data_terms(data, Z, "logistic", impl)
        # One addition of one constant: the per-row centring of all local
        # rows undone, the zero rows' -log 2 (pad_const) kept.
        ll = ll + (data["pad_const"] - data["Xp"].shape[0] * _LOG2)
        if not include_prior:
            return ll, g
        d = Z.shape[1]
        log_norm = -0.5 * d * math.log(2.0 * math.pi * prior_scale * prior_scale)
        prior = log_norm - 0.5 * inv_var * jnp.sum(Z * Z, axis=-1)
        return ll + prior, g - inv_var * Z

    vag = chain_batched(batched, "make_fused_logistic_vag")
    if data_aware:
        return vag
    data = prepare_fused_logistic_data(X, y, tile_n=tile_n)
    return lambda z: vag(z, data)
