"""Mesh-sharded multi-chain sampling with collective warmup adaptation.

The distributed execution path (SURVEY.md §2.3 "native equivalents"):
chains shard over a mesh axis via ``shard_map``; each shard runs the same
compiled engine (``inference/engine.py``) with its local chain block, and the
warmup adaptation statistics — mean acceptance for dual averaging, Welford
moments for the mass matrix — are pooled across shards with
``lax.pmean``/``psum`` every warmup step, giving all chains one shared step
size and mass matrix exactly as a single-device run would compute them.

Because per-chain RNG is keyed by *global* chain index (engine
``make_chain_keys``), a sharded run is bit-identical to the equivalent
single-device vmapped run.

Observation sharding (SURVEY.md §5.7; reference README.md:105-113 "Large
model" row): with ``data_axis`` set, the dataset is additionally sharded over
a second mesh axis and every log-density (and fused value+grad) evaluation
reduces the shard-local likelihood contributions with an in-loop
``lax.psum`` — the MCMC analog of tensor/sequence parallelism, for datasets
that exceed one chip's HBM. Every kernel on the data axis must have a static
collective schedule: a collective inside NUTS's data-dependent tree loop
would let collective counts diverge across chain rows, which deadlocks
collective matching (XLA CPU deadlocks outright). hmc/chees/mala/metropolis
are static by construction; nuts is automatically switched to its
fixed-trip-count tree build (``static_schedule=True``, bit-identical draws,
see kernels/nuts.py).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mlx_mcmc_tpu.inference.api import (
    MCMCResult,
    _as_key,
    _hashable,
    _lru_get,
    _lru_put,
    _param_spec,
)
from mlx_mcmc_tpu.inference.engine import (
    build_sampler,
    make_chain_keys,
    prepare_initial_positions,
    resolve_step_size,
)
from mlx_mcmc_tpu.ops.ravel import make_flat_logprob, ravel_params
from mlx_mcmc_tpu.parallel.mesh import chain_mesh

from jax import shard_map  # public API since jax 0.8

# Compiled-runner cache, same rationale and identity semantics as
# ``inference.api._RUNNER_CACHE``: re-tracing the sharded program is pure
# host work (seconds at production shapes); seed/data/initial values are jit
# runtime arguments. Keyed additionally on the Mesh and partition specs.
from collections import OrderedDict

_SHARDED_CACHE: "OrderedDict" = OrderedDict()
_SHARDED_CACHE_MAX = 32


def clear_sharded_runner_cache() -> None:
    """Drop all cached compiled sharded runners. (The package-level
    :func:`mlx_mcmc_tpu.clear_runner_cache` clears this cache too.)"""
    _SHARDED_CACHE.clear()


def _sharded_engine_run(
    log_prob_fn: Callable[[Any], jnp.ndarray],
    initial_params: Any,
    *,
    num_samples: int,
    num_warmup: int,
    num_chains: int,
    kernel: str,
    seed,
    mesh: Optional[Mesh],
    axis: str,
    step_size,
    adapt_step_size: bool,
    adapt_mass_matrix: bool,
    target_accept: Optional[float],
    jitter: float,
    device_diagnostics: bool,
    data,
    data_axis: Optional[str],
    data_specs,
    log_prior_fn: Optional[Callable[[Any], jnp.ndarray]],
    warmup_start: int = 0,
    warmup_stop: Optional[int] = None,
    resume_state=None,
    z0_batch_override=None,
    sample_start: int = 0,
    **kernel_kwargs,
):
    """Shared driver behind :func:`sample_sharded` and the sharded
    mid-warmup checkpoint path (io/checkpoint.py ``run_warmup(...,
    mesh=...)``): runs the engine segment ``[warmup_start, warmup_stop)``
    (+ ``num_samples`` draws when the segment completes warmup) under
    ``shard_map``, and additionally returns the final adaptation pytrees
    (identical on every shard after the collectives) so a caller can
    checkpoint mid-warmup."""
    step_size = resolve_step_size(step_size, kernel, adapt_step_size)
    if mesh is None:
        mesh = chain_mesh()
    axis_size = mesh.shape[axis]
    if num_chains % axis_size != 0:
        raise ValueError(
            f"num_chains={num_chains} not divisible by mesh axis "
            f"'{axis}' of size {axis_size}"
        )

    if data_axis is not None:
        if data is None:
            raise ValueError("data_axis requires data=... to shard")
        if data_axis not in mesh.shape:
            raise ValueError(
                f"data_axis {data_axis!r} not in mesh axes {tuple(mesh.shape)}"
            )
        if kernel == "nuts" and kernel_kwargs.get("static_schedule") is False:
            raise ValueError(
                "kernel='nuts' with data_axis requires the static "
                "schedule (static_schedule=True, the default here): a "
                "data-dependent tree loop would desynchronize the "
                "per-leapfrog psum across chain rows"
            )

    # --- compiled-runner cache lookup (see _SHARDED_CACHE above) ---
    # The whole key construction + lookup is guarded: an unhashable leaf
    # anywhere in the key (an exotic mesh, a numpy array smuggled into
    # data_specs, an unhashable warmup_stop) falls back to the uncached
    # build path instead of raising — mirroring api.sample()'s behavior.
    cacheable = (
        _hashable(target_accept)
        and _hashable(step_size)
        and all(_hashable(v) for v in kernel_kwargs.values())
    )
    entry = cache_key = None
    if cacheable:
        specs_key = None
        if data_specs is not None:
            ds_leaves, ds_tree = jax.tree_util.tree_flatten(
                data_specs, is_leaf=lambda x: isinstance(x, P)
            )
            specs_key = (ds_tree, tuple(ds_leaves))
        cache_key = (
            id(log_prob_fn),
            None if log_prior_fn is None else id(log_prior_fn),
            _param_spec(initial_params),
            None if data is None else _param_spec(data),
            mesh,
            axis,
            data_axis,
            specs_key,
            kernel,
            int(num_samples),
            int(num_warmup),
            step_size,
            bool(adapt_step_size),
            bool(adapt_mass_matrix),
            target_accept,
            bool(device_diagnostics),
            int(warmup_start),
            warmup_stop,
            tuple(sorted(kernel_kwargs.items(), key=lambda kv: kv[0])),
        )
        try:
            entry = _lru_get(_SHARDED_CACHE, cache_key)
        except TypeError:  # unhashable leaf in the key
            cacheable, cache_key = False, None

    if entry is None:
        entry = _build_sharded_runner(
            log_prob_fn,
            initial_params,
            kernel=kernel,
            num_samples=num_samples,
            num_warmup=num_warmup,
            step_size=step_size,
            adapt_step_size=adapt_step_size,
            adapt_mass_matrix=adapt_mass_matrix,
            target_accept=target_accept,
            mesh=mesh,
            axis=axis,
            device_diagnostics=device_diagnostics,
            data=data,
            data_axis=data_axis,
            data_specs=data_specs,
            log_prior_fn=log_prior_fn,
            warmup_start=warmup_start,
            warmup_stop=warmup_stop,
            kernel_kwargs=kernel_kwargs,
        )
        if cacheable:
            _lru_put(_SHARDED_CACHE, cache_key, entry, _SHARDED_CACHE_MAX)

    key = _as_key(seed)
    key_init, key_run = jax.random.split(key)
    if z0_batch_override is not None:
        z0_batch = jnp.asarray(z0_batch_override)
    else:
        # ravel_params applies the same float conversion make_flat_logprob
        # used at build time, so z0 matches the traced program's dtype.
        z0_batch = prepare_initial_positions(
            ravel_params(initial_params)[0], num_chains, key_init, jitter
        )
    chain_keys = make_chain_keys(key_run, num_chains)

    positions, info, tiled_tunables, final_state, tiled_adapt, stats = entry[
        "jitted"
    ](
        chain_keys, z0_batch, data, resume_state, entry["sched"],
        jnp.asarray(sample_start, jnp.int32),
    )
    tunables = jax.tree_util.tree_map(lambda x: x[0], tiled_tunables)
    # Adaptation pytrees stay TILED with their leading (shards,) axis: the
    # Welford moments are per-shard state (see shard_run), so a mid-warmup
    # checkpoint must round-trip all of them, not shard 0's.
    adapt, traj = tiled_adapt
    if device_diagnostics:
        stats = jax.tree_util.tree_map(lambda x: x[0], stats)
    return (
        positions, info, tunables, final_state, adapt, traj, stats,
        entry["unravel"], entry["dim"],
    )


def _build_sharded_runner(
    log_prob_fn,
    initial_params,
    *,
    kernel,
    num_samples,
    num_warmup,
    step_size,
    adapt_step_size,
    adapt_mass_matrix,
    target_accept,
    mesh,
    axis,
    device_diagnostics,
    data,
    data_axis,
    data_specs,
    log_prior_fn,
    warmup_start,
    warmup_stop,
    kernel_kwargs,
):
    """Trace-and-jit the sharded engine program (the expensive host work
    ``_SHARDED_CACHE`` amortizes). Uses ``initial_params``/``data`` only for
    structure and partition specs — values flow in at call time."""
    kernel_kwargs = dict(kernel_kwargs)  # never mutate the caller's dict
    if data_axis is not None:
        if kernel == "nuts":
            # NUTS's dynamic tree loop has a data-dependent trip count; a
            # psum inside it fires a per-chain-row number of times, which
            # breaks collective matching. The static-schedule variant runs
            # every draw at the depth cap (2^max_tree_depth - 1 masked
            # leapfrogs, bit-identical draws), making the psum schedule
            # uniform — mandatory on the data axis. Cost: ~(2^d - 1)/mean
            # leaves more likelihood math; keep max_tree_depth modest (6-8).
            kernel_kwargs["static_schedule"] = True
        user_log_prob = log_prob_fn

        def log_prob_fn(params, shard):  # noqa: F811 - deliberate rebind
            ll = jax.lax.psum(user_log_prob(params, shard), data_axis)
            if log_prior_fn is not None:
                ll = ll + log_prior_fn(params)
            return ll

    flat_log_prob, z0, unravel = make_flat_logprob(
        log_prob_fn, initial_params, data_aware=data is not None
    )
    dim = z0.shape[0]

    if data_axis is not None and kernel != "metropolis":
        # Differentiating THROUGH the in-value psum is a footgun: with the
        # varying-axes check off (check_vma=False below), JAX does not insert
        # the pbroadcast whose transpose would psum the gradient, so
        # jax.grad(psum(local)) silently returns only the shard-LOCAL
        # gradient — each data shard would integrate different (wrong)
        # trajectories. Gradient kernels therefore always get an explicit
        # value_and_grad_fn that psums both the value and the gradient.
        user_vag = kernel_kwargs.get("value_and_grad_fn")
        if user_vag is None:
            flat_local, _, _ = make_flat_logprob(
                user_log_prob, initial_params, data_aware=True
            )
            user_vag = jax.value_and_grad(flat_local)
        if log_prior_fn is not None:
            prior_vag = jax.value_and_grad(
                lambda z: jnp.asarray(log_prior_fn(unravel(z))).reshape(())
            )

        def sharded_vag(z, shard):
            v, g = user_vag(z, shard)
            v = jax.lax.psum(v, data_axis)
            g = jax.lax.psum(g, data_axis)
            if log_prior_fn is not None:
                pv, pg = prior_vag(z)
                v, g = v + pv, g + pg
            return jnp.where(jnp.isnan(v), -jnp.inf, v), g

        kernel_kwargs["value_and_grad_fn"] = sharded_vag

    run = build_sampler(
        flat_log_prob,
        dim,
        kernel=kernel,
        num_warmup=num_warmup,
        num_samples=num_samples,
        step_size=step_size,
        adapt_step_size=adapt_step_size,
        adapt_mass_matrix=adapt_mass_matrix,
        target_accept=target_accept,
        axis_name=axis,
        warmup_start=warmup_start,
        warmup_stop=warmup_stop,
        **kernel_kwargs,
    )

    def shard_run(
        chain_keys_shard, z0_shard, data_shard, resume_rep, sched,
        sample_start,
    ):
        if resume_rep is not None:
            # resume_rep arrives tiled with a leading (shards,) axis and
            # in_spec P(axis): each shard slices out ITS row. The dual-
            # averaging scalars are identical across rows, but the Welford
            # mass-matrix moments are genuinely SHARD-LOCAL (each shard
            # accumulates its own chains; the psum merge only happens at
            # window ends) — restoring shard 0's moments everywhere would
            # corrupt the next window-end merge.
            resume_rep = jax.tree_util.tree_map(lambda x: x[0], resume_rep)
        result = run(
            chain_keys_shard, z0_shard, data_shard, resume_rep, sched,
            sample_start,
        )
        # Tunables (and device diagnostics) are identical on every shard
        # after the collectives; emit one leading shard axis so out_specs can
        # declare them sharded, then take shard 0 outside. The adaptation
        # pytrees keep their full per-shard tiling (see resume_rep above).
        tiled_tunables = jax.tree_util.tree_map(
            lambda x: x[None], result.final_tunables
        )
        tiled_adapt = jax.tree_util.tree_map(
            lambda x: x[None], (result.final_adapt, result.final_traj)
        )
        if device_diagnostics:
            from mlx_mcmc_tpu.diagnostics.device import device_ess, device_rhat

            stats = {
                "r_hat": device_rhat(result.positions, axis_name=axis)[None],
                "n_eff": device_ess(result.positions, axis_name=axis)[None],
            }
        else:
            stats = {}
        return (
            result.positions,
            result.info,
            tiled_tunables,
            result.final_state,
            tiled_adapt,
            stats,
        )

    if data_axis is None:
        data_in_spec = P()
    elif data_specs is not None:
        data_in_spec = data_specs
    elif isinstance(data, dict) and {"Xp", "yp", "dim", "tile"} <= set(data):
        # A fused-GLM data pytree (ops/pallas/glm.py prepare_fused_*_data):
        # apply its known spec automatically — the generic heuristic would
        # shard the zero-byte shape markers and fail with an opaque
        # divisibility error.
        from mlx_mcmc_tpu.ops.pallas.glm import fused_data_specs

        data_in_spec = fused_data_specs(data, data_axis)
    else:
        # Shard each non-scalar leaf's leading axis when it divides the data
        # axis; otherwise replicate (with a warning) — small replicated
        # vectors and shape-marker leaves must not be force-sharded.
        import warnings

        n_shards = mesh.shape[data_axis]
        replicated = []

        def leaf_spec(path, leaf):
            if jnp.ndim(leaf) >= 1 and jnp.shape(leaf)[0] % n_shards == 0 and jnp.shape(leaf)[0] > 0:
                return P(data_axis)
            if jnp.ndim(leaf) >= 1:
                replicated.append(jax.tree_util.keystr(path))
            return P()

        data_in_spec = jax.tree_util.tree_map_with_path(leaf_spec, data)
        if replicated:
            warnings.warn(
                "sample_sharded: replicating data leaves whose leading axis "
                f"is not divisible by the {data_axis!r} mesh axis "
                f"({n_shards}): {replicated}. Pass data_specs to control "
                "this explicitly.",
                stacklevel=2,
            )

    sharded = shard_map(
        shard_run,
        mesh=mesh,
        in_specs=(P(axis), P(axis), data_in_spec, P(axis), P(), P()),
        out_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(axis)),
        # Kernel while-loop carries mix shard-invariant literals with
        # shard-varying state; skip the varying-axes check rather than
        # pcast-annotating every carry.
        check_vma=False,
    )

    return {
        "jitted": jax.jit(sharded),
        "sched": run.sched,
        "unravel": unravel,
        "dim": dim,
        # pin function identities so their ids can't be recycled while cached
        "pin": (log_prob_fn, log_prior_fn, kernel_kwargs),
    }


def sample_sharded(
    log_prob_fn: Callable[[Any], jnp.ndarray],
    initial_params: Any,
    *,
    num_samples: int = 1000,
    num_warmup: int = 1000,
    num_chains: int = 8,
    kernel: str = "nuts",
    seed=0,
    mesh: Optional[Mesh] = None,
    axis: str = "chains",
    step_size="auto",
    adapt_step_size: bool = True,
    adapt_mass_matrix: bool = True,
    target_accept: Optional[float] = None,
    jitter: float = 0.0,
    device_diagnostics: bool = False,
    data=None,
    data_axis: Optional[str] = None,
    data_specs=None,
    log_prior_fn: Optional[Callable[[Any], jnp.ndarray]] = None,
    store_dtype=None,
    draw_chunk: Optional[int] = None,
    **kernel_kwargs,
) -> MCMCResult:
    """Run chains sharded over ``mesh[axis]`` with collective adaptation.

    ``num_chains`` must be divisible by the mesh axis size. Returns the same
    :class:`MCMCResult` as :func:`mlx_mcmc_tpu.sample`, with sample arrays
    sharded over chains (gather happens lazily on numpy conversion).

    With ``device_diagnostics=True``, split R-hat and ESS per flat dimension
    are computed *inside* the sharded program with psum/pmean collectives and
    attached as ``result.device_stats`` — only (D,) statistics cross the
    host boundary, never the draw tensor.

    ``data`` follows the ``sample(..., data=...)`` protocol: a pytree passed
    at run time to a binary model ``log_prob_fn(params, data)``; it is
    replicated across the chain axis.

    ``data_axis`` names a second mesh axis to shard the *observations* over
    (pass a 2-D mesh, e.g. :func:`mlx_mcmc_tpu.parallel.data_chain_mesh`).
    The model contract changes: ``log_prob_fn(params, data)`` must return the
    shard-LOCAL log-likelihood contribution (the sum over its slice of
    observations) and the prior moves to ``log_prior_fn(params)`` so it is
    counted once, not once per shard; the engine psums the local terms every
    gradient/energy evaluation. The same contract applies to a fused
    ``value_and_grad_fn`` (build it with ``include_prior=False``).
    ``data_specs`` optionally gives per-leaf PartitionSpecs for ``data``; by
    default every non-scalar leaf shards its leading axis.

    On the data axis every kernel runs a static collective schedule; nuts is
    automatically switched to ``static_schedule=True`` (a fixed
    ``2**max_tree_depth - 1`` masked-leapfrog tree build, bit-identical
    draws) so the per-leapfrog psum count is uniform across chain rows —
    pass a modest ``max_tree_depth`` (6-8) to bound the fixed cost.

    ``thin=k`` keeps every k-th draw; ``store_dtype`` (e.g. ``'bfloat16'``)
    down-casts only the STORED draws while all sampling arithmetic stays f32
    — at pod scale the bf16 store halves the dominant
    (chains, draws, D) HBM footprint (same semantics as
    :func:`mlx_mcmc_tpu.sample`).

    ``draw_chunk=k`` scans the sampling phase in chunks of ``k`` draws,
    fetching each chunk to host memory (one cross-shard gather per chunk)
    before the next runs, so the full sharded draw store never has to fit
    HBM. Draws and diagnostics are bit-identical to the unchunked sharded
    run (the engine keys every step by its global index);
    ``MCMCResult.samples`` holds numpy arrays. Incompatible with
    ``device_diagnostics`` (device R-hat/ESS need all draws resident).

    Mid-warmup checkpoint/resume for sharded runs goes through
    ``io.run_warmup(..., mesh=...)`` / ``io.resume_warmup(..., mesh=...)``,
    which drive the same engine segments over the same mesh (bit-identical
    composition, tests/test_checkpoint.py). Post-warmup, an int-seeded
    result carries a ``resume_payload`` exactly like :func:`sample`:
    ``io.save_checkpoint`` persists it (including the per-shard adaptation
    tiling and the mesh layout) and ``io.resume(..., mesh=...)`` continues
    drawing bit-identically on a mesh of the same layout.

    Caching: repeated calls with the same static configuration reuse a
    compiled sharded runner, keyed — like ``jax.jit`` — by OBJECT IDENTITY
    for ``log_prob_fn``/``log_prior_fn`` and any callables in
    ``kernel_kwargs`` (a fused ``value_and_grad_fn``). Mutating state those
    closures capture silently reuses the stale trace; pass mutable arrays
    via ``data=`` instead, or call
    :func:`~mlx_mcmc_tpu.clear_runner_cache` (clears this cache too) /
    :func:`clear_sharded_runner_cache` after mutation.
    """
    import numpy as np

    if mesh is None:
        mesh = chain_mesh()
    store_key = None if store_dtype is None else str(jnp.dtype(store_dtype))
    if store_key is not None:
        kernel_kwargs["store_dtype"] = jnp.dtype(store_key)
    if draw_chunk is not None:
        if draw_chunk <= 0:
            raise ValueError(f"draw_chunk must be positive, got {draw_chunk}")
        if draw_chunk >= num_samples:
            draw_chunk = None  # one chunk == the unchunked program
    if draw_chunk is not None and device_diagnostics:
        raise ValueError(
            "draw_chunk is incompatible with device_diagnostics: on-device "
            "R-hat/ESS need the full draw store resident; compute host "
            "diagnostics on the chunked result instead (result.diagnostics())"
        )

    common = dict(
        num_chains=num_chains,
        kernel=kernel,
        seed=seed,
        mesh=mesh,
        axis=axis,
        step_size=step_size,
        adapt_step_size=adapt_step_size,
        adapt_mass_matrix=adapt_mass_matrix,
        target_accept=target_accept,
        data=data,
        data_axis=data_axis,
        data_specs=data_specs,
        log_prior_fn=log_prior_fn,
    )

    first_draws = draw_chunk if draw_chunk is not None else num_samples
    (positions, info, tunables, final_state, adapt, traj, stats,
     unravel, dim) = _sharded_engine_run(
        log_prob_fn,
        initial_params,
        num_samples=first_draws,
        num_warmup=num_warmup,
        jitter=jitter,
        device_diagnostics=device_diagnostics,
        **common,
        **kernel_kwargs,
    )

    if draw_chunk is None:
        samples = jax.vmap(jax.vmap(unravel))(positions)
    else:
        # Chunked draw storage (sharded twin of sample(draw_chunk=...)):
        # each segment's draws are gathered to host numpy, freeing their
        # device buffers before the next continuation segment runs from the
        # final kernel positions + tiled per-shard adaptation pytrees.
        def fetch(pos, inf):
            s = jax.tree_util.tree_map(
                np.asarray, jax.vmap(jax.vmap(unravel))(pos)
            )
            return s, jax.tree_util.tree_map(np.asarray, inf)

        sample_chunks, info_chunks = [], []
        s0, i0 = fetch(positions, info)
        sample_chunks.append(s0)
        info_chunks.append(i0)
        offset = first_draws
        while offset < num_samples:
            size = min(draw_chunk, num_samples - offset)
            (positions, info, tunables, final_state, adapt, traj, _st,
             unravel, dim) = _sharded_engine_run(
                log_prob_fn,
                initial_params,
                num_samples=size,
                num_warmup=num_warmup,
                warmup_start=num_warmup,
                warmup_stop=num_warmup,
                jitter=0.0,
                device_diagnostics=False,
                resume_state=(adapt, traj),
                z0_batch_override=final_state.position,
                sample_start=offset,
                **common,
                **kernel_kwargs,
            )
            s, i = fetch(positions, info)
            sample_chunks.append(s)
            info_chunks.append(i)
            offset += size
        samples = jax.tree_util.tree_map(
            lambda *xs: np.concatenate(xs, axis=1), *sample_chunks
        )
        info = jax.tree_util.tree_map(
            lambda *xs: np.concatenate(xs, axis=1), *info_chunks
        )

    resume_payload = None
    if isinstance(seed, (int, np.integer)):
        from mlx_mcmc_tpu.io.checkpoint import (
            _data_fingerprint,
            _mesh_axes_meta,
        )

        payload_kwargs = {
            k: v for k, v in kernel_kwargs.items() if k != "store_dtype"
        }
        resume_payload = {
            "phase": "sampling",
            "flat_position": final_state.position,
            # TILED per-shard adaptation pytrees — the Welford moments are
            # genuinely shard-local (see shard_run); a continuation must
            # restore each shard's own rows.
            "adapt": adapt,
            "traj": traj,
            "inv_mass_diag": tunables.inv_mass_diag,
            "unravel": unravel,
            "num_warmup": int(num_warmup),
            "num_chains": int(num_chains),
            "next_sample_start": int(num_samples),
            "thin": int(kernel_kwargs.get("thin", 1)),
            "kernel": kernel,
            "seed": int(seed),
            "dim": int(dim),
            "step_size": resolve_step_size(step_size, kernel, adapt_step_size),
            "adapt_step_size": bool(adapt_step_size),
            "adapt_mass_matrix": bool(adapt_mass_matrix),
            "target_accept": target_accept,
            "store_dtype": store_key,
            "kernel_kwargs": payload_kwargs,
            "has_transforms": False,
            "data_fingerprint": _data_fingerprint(data),
            # Mesh layout: cross-shard adaptation statistics round
            # differently per layout, so resume refuses a different one.
            "mesh_axes": _mesh_axes_meta(mesh, axis, data_axis),
            "has_log_prior": log_prior_fn is not None,
            "has_data_specs": data_specs is not None,
        }

    result = MCMCResult(
        samples=samples,
        info=info,
        tunables=tunables,
        num_chains=num_chains,
        num_samples=num_samples,
        kernel=kernel,
        resume_payload=resume_payload,
    )
    if device_diagnostics:
        result.device_stats = stats
    return result
