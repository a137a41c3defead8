"""Functional sampling API: ``sample(...) -> MCMCResult``.

The modern entry point of the framework (the class facade in
``inference/mcmc.py`` wraps this for reference API parity). One call builds
and jit-compiles the full warmup+sampling program and executes it on device;
results stay as device arrays until numpy conversion is requested.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mlx_mcmc_tpu.diagnostics.stats import (
    effective_sample_size,
    potential_scale_reduction,
    summary_stats,
)
from mlx_mcmc_tpu.inference.engine import (
    ChainResult,
    build_sampler,
    make_chain_keys,
    prepare_initial_positions,
    resolve_step_size,
)
from mlx_mcmc_tpu.kernels.base import TransitionInfo, Tunables
from mlx_mcmc_tpu.ops.ravel import make_flat_logprob


def _as_key(seed) -> jnp.ndarray:
    if isinstance(seed, (int, np.integer)):
        return jax.random.PRNGKey(seed)
    return seed


def _hashable(v) -> bool:
    try:
        hash(v)
    except TypeError:
        return False
    return True


def _param_spec(tree):
    """Structure key for a params pytree: treedef + leaf shapes/dtypes.

    Never materializes device arrays on the host — only ``.shape``/``.dtype``
    attributes (or ``np.result_type`` for Python scalars/lists) are touched.
    """
    leaves, treedef = jax.tree_util.tree_flatten(tree)

    def spec(leaf):
        if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            return tuple(leaf.shape), str(leaf.dtype)
        return np.shape(leaf), str(np.result_type(leaf))

    return treedef, tuple(spec(leaf) for leaf in leaves)


# Compiled-runner cache: repeated ``sample()`` calls with the same static
# configuration (model fn identity, param structure, kernel settings) reuse
# the traced+jitted program instead of rebuilding it. Re-TRACING the full
# warmup+sampling scan program is pure host work and measures ~6 s at the
# flagship shape (4096 chains, depth-6 NUTS) — most of a warm run's wall.
# Runtime quantities (seed, data, chain count, initial values) are ordinary
# jit arguments, so they never invalidate the cache; jit itself retraces on
# shape changes. Keyed by object identity for functions (as jax.jit is);
# entries pin their functions, so ids cannot be recycled while cached.
# Eviction is LRU (an OrderedDict moved-to-end on every hit), so per-call-
# constructed callables (lambdas, partials) that can never hit again churn
# out the oldest entries first, never the hot ones. NOTE: a cached entry
# pins its model/vag callables and anything their closures capture — callers
# that rebuild such objects per call pay one insertion each time and should
# prefer passing big arrays via ``data=`` (see ``sample``'s caching note).
from collections import OrderedDict

_RUNNER_CACHE: "OrderedDict[Any, Any]" = OrderedDict()
_RUNNER_CACHE_MAX = 64


def clear_runner_cache() -> None:
    """Drop all cached compiled runners — both this module's (sample,
    posterior-predictive, ensemble/smc/tempered/vi) and the sharded cache in
    :mod:`mlx_mcmc_tpu.parallel.sharded`. Call after mutating any object a
    cached model closure captures."""
    _RUNNER_CACHE.clear()
    try:
        from mlx_mcmc_tpu.parallel import sharded as _sharded

        _sharded._SHARDED_CACHE.clear()
    except ImportError:  # pragma: no cover - parallel is always importable
        pass


def _lru_get(cache: "OrderedDict", key):
    """Shared LRU read: hits move to the back of the eviction queue. Used
    by both this module's cache and parallel.sharded's — one eviction
    policy, defined once."""
    hit = cache.get(key)
    if hit is not None:
        cache.move_to_end(key)
    return hit


def _lru_put(cache: "OrderedDict", key, value, max_size: int) -> None:
    if len(cache) >= max_size:
        cache.popitem(last=False)  # evict least-recently-used
    cache[key] = value


def _cache_get(key):
    return _lru_get(_RUNNER_CACHE, key)


def _cache_put(key, value) -> None:
    _lru_put(_RUNNER_CACHE, key, value, _RUNNER_CACHE_MAX)


def _reuse_jit(tag: str, key_items: tuple, fn, pin=()):
    """Memoize ``jax.jit(fn)`` under ``(tag, *key_items)``.

    ``fn`` is rebuilt by the caller every call (cheap); what this avoids is
    re-TRACING, which jax.jit would do for every fresh closure object.
    CORRECTNESS CONTRACT: ``key_items`` must cover every value baked into
    ``fn``'s trace as a constant — anything else must be an argument of
    ``fn``. ``pin`` keeps id()-keyed objects alive while cached. Callers
    must fall back to plain ``jax.jit`` when any key item is unhashable.
    """
    key = (tag,) + tuple(key_items)
    hit = _cache_get(key)
    if hit is None:
        hit = (jax.jit(fn), pin)
        _cache_put(key, hit)
    return hit[0]


@dataclass
class MCMCResult:
    """Posterior draws plus per-draw sampler diagnostics.

    ``samples``: dict name -> array of shape (chains, draws, *event_shape).
    ``info``: TransitionInfo pytree with (chains, draws) leaves.
    ``tunables``: adapted step size and inverse mass diagonal.
    """

    samples: Dict[str, jnp.ndarray]
    info: TransitionInfo
    tunables: Tunables
    num_chains: int
    num_samples: int
    kernel: str = "nuts"
    device_stats: Optional[Dict[str, jnp.ndarray]] = None  # on-device rhat/ess
    # Everything a bit-exact post-warmup resume needs (final kernel state,
    # raw adaptation pytrees, RNG/seed metadata) — populated by sample() when
    # the seed is a plain int; io/checkpoint.py serializes it. None when the
    # run is not exactly resumable (PRNG-key seed).
    resume_payload: Optional[Dict[str, Any]] = field(default=None, repr=False)
    _numpy_cache: Optional[Dict[str, np.ndarray]] = field(default=None, repr=False)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        if self._numpy_cache is None:
            self._numpy_cache = {
                k: np.asarray(v) for k, v in self.samples.items()
            }
        return self._numpy_cache

    @property
    def acceptance_rate(self) -> float:
        """Fraction of accepted proposals (metropolis/hmc); for NUTS the
        trajectory is always advanced, so report the mean Metropolis
        acceptance statistic instead (Stan's 'accept_stat')."""
        if self.kernel == "nuts":
            return float(np.mean(np.asarray(self.info.accept_prob)))
        return float(np.mean(np.asarray(self.info.is_accepted)))

    @property
    def divergences(self) -> int:
        return int(np.sum(np.asarray(self.info.is_divergent)))

    def flat_samples(self) -> Dict[str, np.ndarray]:
        """(chains*draws, *event) numpy arrays — the reference's output shape
        for single-chain runs (mlx_mcmc/inference/mcmc.py:99,125,187)."""
        out = {}
        for k, v in self.to_numpy().items():
            out[k] = v.reshape(-1, *v.shape[2:]) if v.ndim > 2 else v.reshape(-1)
        return out

    def diagnostics(self) -> Dict[str, Dict[str, float]]:
        """Per-parameter split R-hat and effective sample size."""
        out = {}
        for k, v in self.to_numpy().items():
            flat_event = v.reshape(v.shape[0], v.shape[1], -1)
            rhat = potential_scale_reduction(flat_event)
            ess = effective_sample_size(flat_event)
            out[k] = {
                "r_hat": float(np.max(rhat)),
                "n_eff": float(np.min(ess)),
            }
        return out

    def summary(self, credible_interval: float = 0.95) -> Dict[str, Dict[str, float]]:
        out = {}
        for k, v in self.to_numpy().items():
            if v.ndim == 2:
                out[k] = summary_stats(v, credible_interval)
            else:
                # vector parameter: summarize each component as name[i]
                flat_event = v.reshape(v.shape[0], v.shape[1], -1)
                for i in range(flat_event.shape[-1]):
                    out[f"{k}[{i}]"] = summary_stats(
                        flat_event[..., i], credible_interval
                    )
        return out


def sample(
    log_prob_fn: Callable[[Any], jnp.ndarray],
    initial_params: Any,
    *,
    num_samples: int = 1000,
    num_warmup: int = 1000,
    num_chains: int = 1,
    kernel: str = "nuts",
    seed=0,
    step_size="auto",
    adapt_step_size: bool = True,
    adapt_mass_matrix: bool = True,
    target_accept: Optional[float] = None,
    jitter: float = 0.0,
    batched_initial: bool = False,
    transforms: Optional[dict] = None,
    config=None,
    data=None,
    init_strategy: str = "tile",
    store_dtype=None,
    draw_chunk: Optional[int] = None,
    **kernel_kwargs,
) -> MCMCResult:
    """Run compiled multi-chain MCMC against a dict-of-params model.

    ``kernel`` is 'metropolis' | 'hmc' | 'nuts' | 'chees' | 'mala'.
    ``step_size`` defaults to 'auto': gradient kernels start warmup from a
    Stan-style find-reasonable-step-size probe instead of a blind constant
    (explicit floats still work; metropolis and adapt_step_size=False fall
    back to 0.1). Kernel-specific
    options pass through: ``num_leapfrog_steps`` (hmc), ``max_tree_depth``
    (nuts), ``max_leapfrog_steps`` (chees); also ``thin``, ``progress_every``,
    ``value_and_grad_fn``, ``init_inv_mass_diag``.
    With ``batched_initial=True`` every leaf of ``initial_params`` carries a
    leading ``num_chains`` axis (per-chain starting points).

    ``data``: optional pytree passed as a runtime argument to a binary model
    ``log_prob_fn(params, data)`` — use for large datasets (closure constants
    bloat compiled programs). ``init_strategy``: 'tile' (default), 'map'
    (per-chain Adam ascent to the typical set before warmup), or 'advi'
    (mean-field VI fit; chains start from q-draws with q's variances as the
    initial mass matrix — see ``inference/vi.py``).

    ``transforms`` maps parameter names to unconstraining transforms (names
    like 'log'/'logit'/'simplex' or Transform instances): those parameters
    are sampled in unconstrained space with the Jacobian correction applied,
    and draws are returned in constrained space.

    ``config`` (a :class:`mlx_mcmc_tpu.utils.SamplerConfig`) supplies the run
    settings in one typed object; its fields replace the corresponding
    keyword arguments.

    ``store_dtype`` (e.g. ``'bfloat16'``) down-casts only the STORED draws —
    all sampling arithmetic stays f32. Halves the (chains, draws, D) HBM
    draw-store footprint, the usual ceiling at wide chain counts.

    ``draw_chunk=k`` scans the sampling phase in chunks of ``k`` draws,
    fetching each chunk to host memory before the next runs, so the full
    (chains, draws, D) store never has to fit HBM — draw counts are bounded
    by host RAM instead. Draws and diagnostics are bit-identical to the
    unchunked run (the engine keys every step by its global index);
    ``MCMCResult.samples`` holds numpy arrays. The compiled chunk runner
    takes the draw offset as a runtime argument, so every full-size chunk
    reuses one cached program.

    Repeated calls with the same static configuration (same ``log_prob_fn``
    object, parameter structure, kernel settings) reuse a cached compiled
    runner: only the first call pays tracing+compilation; later calls are
    device-bound. Seed, ``data`` and initial parameter *values* are runtime
    arguments and never invalidate the cache. The cache keys functions and
    other id-hashed objects by object identity (like ``jax.jit``) — this
    covers the model closure, any ``value_and_grad_fn`` or other callables
    in ``kernel_kwargs``, and Transform instances in ``transforms``. If you
    mutate state any of those capture, pass it via ``data`` instead, or call
    :func:`clear_runner_cache` (which also clears the sharded cache).
    """
    if config is not None:
        kw = config.to_kwargs()
        kw.update(kernel_kwargs)
        # explicit keyword arguments win over the config's fields
        store_dtype = store_dtype if store_dtype is not None else kw.pop(
            "store_dtype", None
        )
        kw.pop("store_dtype", None)
        draw_chunk = draw_chunk if draw_chunk is not None else kw.pop(
            "draw_chunk", None
        )
        kw.pop("draw_chunk", None)
        return sample(
            log_prob_fn,
            initial_params,
            batched_initial=batched_initial,
            transforms=transforms,
            data=data,
            store_dtype=store_dtype,
            draw_chunk=draw_chunk,
            **kw,
        )
    if init_strategy not in ("tile", "map", "advi"):
        raise ValueError(f"Unknown init_strategy: {init_strategy!r}")
    step_size = resolve_step_size(step_size, kernel, adapt_step_size)

    # Normalize storage/chunking knobs into hashable cache-key form.
    store_key = None if store_dtype is None else str(jnp.dtype(store_dtype))
    store_dt = None if store_key is None else jnp.dtype(store_key)
    if draw_chunk is not None:
        if draw_chunk <= 0:
            raise ValueError(f"draw_chunk must be positive, got {draw_chunk}")
        if draw_chunk >= num_samples:
            draw_chunk = None  # one chunk == the unchunked program

    # --- compiled-runner cache lookup (see _RUNNER_CACHE above) ---
    # 'advi' mutates kernel_kwargs after the key is computed (it injects an
    # init_inv_mass_diag array), so that strategy always rebuilds.
    cacheable = (
        init_strategy != "advi"
        and _hashable(target_accept)
        and _hashable(step_size)
        and all(_hashable(v) for v in kernel_kwargs.values())
        and (
            transforms is None
            or all(_hashable(v) for v in transforms.values())
        )
    )
    entry = cache_key = None
    if cacheable:
        treedef, leafspec = _param_spec(initial_params)
        cache_key = (
            id(log_prob_fn),
            None
            if transforms is None
            else tuple(sorted(transforms.items(), key=lambda kv: kv[0])),
            bool(batched_initial),
            treedef,
            leafspec,
            data is not None,
            kernel,
            int(num_samples),
            int(num_warmup),
            step_size,
            bool(adapt_step_size),
            bool(adapt_mass_matrix),
            target_accept,
            store_key,
            draw_chunk,
            tuple(sorted(kernel_kwargs.items(), key=lambda kv: kv[0])),
        )
        entry = _cache_get(cache_key)

    if entry is not None:
        lp_fn = entry["lp_fn"]
        to_constrained = entry["to_constrained"]
        to_unconstrained = entry["to_unconstrained"]
    elif transforms:
        from mlx_mcmc_tpu.distributions.transforms import make_transformed_logprob

        lp_fn, to_constrained, to_unconstrained = make_transformed_logprob(
            log_prob_fn, transforms, data_aware=data is not None
        )
    else:
        lp_fn, to_constrained, to_unconstrained = log_prob_fn, None, None

    # Per-call VALUE work (initial positions): never cached.
    if to_unconstrained is not None:
        conv = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.result_type(float)), initial_params
        )
        initial_params = (
            jax.vmap(to_unconstrained)(conv)
            if batched_initial
            else to_unconstrained(conv)
        )
    from mlx_mcmc_tpu.ops.ravel import ravel_params

    if batched_initial:
        floated = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.result_type(float)), initial_params
        )
        example = jax.tree_util.tree_map(lambda x: x[0], floated)
        z0 = ravel_params(example)[0]
        z0_batched = jax.vmap(lambda tree: ravel_params(tree)[0])(floated)
    else:
        example = initial_params
        z0 = ravel_params(example)[0]
        z0_batched = None
    dim = z0.shape[0]

    if entry is None:
        flat_log_prob, _, unravel = make_flat_logprob(
            lp_fn, example, data_aware=data is not None
        )
    else:
        flat_log_prob, unravel = entry["flat_log_prob"], entry["unravel"]

    key = _as_key(seed)
    key_init, key_run = jax.random.split(key)
    if z0_batched is not None:
        if z0_batched.shape[0] != num_chains:
            raise ValueError(
                f"batched_initial leaves have leading axis {z0_batched.shape[0]}, "
                f"expected num_chains={num_chains}"
            )
        z0_batch = z0_batched
    else:
        z0_batch = prepare_initial_positions(z0, num_chains, key_init, jitter)
    if init_strategy == "map":
        from mlx_mcmc_tpu.inference.init_strategies import map_initialize

        z0_batch = jax.jit(
            lambda zb, k, d: map_initialize(
                flat_log_prob, zb, k,
                jitter=jitter if jitter > 0 else 1.0, data=d,
            )
        )(z0_batch, key_init, data)
    elif init_strategy == "advi":
        # Warm start: chain positions drawn from a fitted mean-field q and
        # q's variances as the initial diagonal inverse mass matrix.
        from mlx_mcmc_tpu.inference.vi import advi_initialize

        z0_batch, advi_inv_mass = advi_initialize(
            flat_log_prob, z0_batch, key_init, data=data
        )
        # All kernels benefit: metropolis shapes its proposal by
        # sqrt(inv_mass_diag) too (kernels/base.py Tunables contract).
        if "init_inv_mass_diag" not in kernel_kwargs:
            kernel_kwargs["init_inv_mass_diag"] = advi_inv_mass

    if entry is None:
        common = dict(
            kernel=kernel,
            num_warmup=num_warmup,
            step_size=step_size,
            adapt_step_size=adapt_step_size,
            adapt_mass_matrix=adapt_mass_matrix,
            target_accept=target_accept,
            store_dtype=store_dt,
            **kernel_kwargs,
        )
        first_draws = draw_chunk if draw_chunk is not None else num_samples
        run = build_sampler(
            flat_log_prob, dim, num_samples=first_draws, **common
        )
        entry_runs = {"jitted_run": jax.jit(run), "sched": run.sched}
        if draw_chunk is not None:
            # Sampling-only continuation runners: zero-length warmup segment,
            # tunables from the first segment's adaptation state, draw offset
            # as a runtime argument (one compiled program per chunk SIZE).
            seg = dict(common, warmup_start=num_warmup, warmup_stop=num_warmup)
            runc = build_sampler(flat_log_prob, dim, num_samples=draw_chunk,
                                 **seg)
            entry_runs["jitted_chunk"] = jax.jit(runc)
            entry_runs["sched_seg"] = runc.sched
            rem = num_samples % draw_chunk
            if rem:
                runr = build_sampler(flat_log_prob, dim, num_samples=rem,
                                     **seg)
                entry_runs["jitted_rem"] = jax.jit(runr)
        vv_unravel = jax.vmap(jax.vmap(unravel))
        if to_constrained is None:
            post = jax.jit(vv_unravel)
        else:
            post = jax.jit(lambda positions: to_constrained(vv_unravel(positions)))
        entry = {
            "lp_fn": lp_fn,
            "to_constrained": to_constrained,
            "to_unconstrained": to_unconstrained,
            "flat_log_prob": flat_log_prob,
            "unravel": unravel,
            "post": post,
            # pin the user fn so its id() can't be recycled while cached
            "pin": log_prob_fn,
            **entry_runs,
        }
        if cacheable:
            _cache_put(cache_key, entry)

    chain_keys = make_chain_keys(key_run, num_chains)
    result: ChainResult = entry["jitted_run"](
        chain_keys, z0_batch, data, None, entry["sched"]
    )

    if draw_chunk is None:
        samples = entry["post"](result.positions)
        info = result.info
    else:
        # Chunked draw storage: fetch each chunk to host, freeing its device
        # buffers before the next chunk runs — the full (chains, draws, D)
        # store only ever exists in host RAM. Draws are bit-identical to the
        # unchunked program: the continuation runner derives every step key
        # from the same global step index (engine `sample_start`).
        def fetch(res):
            s = jax.tree_util.tree_map(np.asarray, entry["post"](res.positions))
            i = jax.tree_util.tree_map(np.asarray, res.info)
            return s, i

        sample_chunks, info_chunks = [], []
        s0, i0 = fetch(result)
        sample_chunks.append(s0)
        info_chunks.append(i0)
        offset = draw_chunk
        while offset < num_samples:
            size = min(draw_chunk, num_samples - offset)
            runner = (
                entry["jitted_chunk"] if size == draw_chunk
                else entry["jitted_rem"]
            )
            result = runner(
                chain_keys,
                result.final_state.position,
                data,
                (result.final_adapt, result.final_traj),
                entry["sched_seg"],
                offset,
            )
            s, i = fetch(result)
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
        from mlx_mcmc_tpu.io.checkpoint import _data_fingerprint as _fingerprint

        # Everything a bit-exact continuation needs (io/checkpoint.py):
        # final kernel positions, raw adaptation pytrees, and the static
        # config that must match on resume. Device arrays; serialization
        # happens at save time.
        resume_payload = {
            "phase": "sampling",
            "flat_position": result.final_state.position,
            "adapt": result.final_adapt,
            "traj": result.final_traj,
            "inv_mass_diag": result.final_tunables.inv_mass_diag,
            "unravel": entry["unravel"],
            "num_warmup": int(num_warmup),
            "num_chains": int(num_chains),
            "next_sample_start": int(num_samples),
            "thin": int(kernel_kwargs.get("thin", 1)),
            "kernel": kernel,
            "seed": int(seed),
            "dim": int(dim),
            "step_size": step_size,
            "adapt_step_size": bool(adapt_step_size),
            "adapt_mass_matrix": bool(adapt_mass_matrix),
            "target_accept": target_accept,
            "store_dtype": store_key,
            "kernel_kwargs": dict(kernel_kwargs),
            "has_transforms": transforms is not None,
            "data_fingerprint": _fingerprint(data),
        }

    return MCMCResult(
        samples=samples,
        info=info,
        tunables=result.final_tunables,
        num_chains=num_chains,
        num_samples=num_samples,
        kernel=kernel,
        resume_payload=resume_payload,
    )


def sample_posterior_predictive(
    predictive_fn: Callable[..., Any],
    samples: Dict[str, jnp.ndarray],
    seed=0,
    data=None,
) -> Dict[str, Any]:
    """Draw from the posterior predictive: run a user predictive function at
    every posterior draw, under one jit.

    Args:
        predictive_fn: ``(key, params) -> pytree of simulated data`` (or
            ``(key, params, data)`` when ``data`` is given) — typically the
            likelihood's ``sample``, e.g.
            ``lambda key, p: Normal(p['mu'], p['sigma']).sample(key, (n,))``.
        samples: dict of (chains, draws, *event) posterior draws
            (``MCMCResult.samples``).
        seed: int seed or PRNG key; each (chain, draw) gets a folded key so
            results are layout-invariant and reproducible.

    Returns:
        pytree of arrays shaped (chains, draws, *sim_shape) — on device.
    """
    key = _as_key(seed)
    some_leaf = jax.tree_util.tree_leaves(samples)[0]
    num_chains, num_draws = some_leaf.shape[:2]
    keys = jax.vmap(
        lambda c: jax.vmap(
            lambda d: jax.random.fold_in(jax.random.fold_in(key, c), d)
        )(jnp.arange(num_draws))
    )(jnp.arange(num_chains))
    # Same compiled-runner caching as sample(): keyed on the predictive fn's
    # identity; data flows as a jit ARGUMENT (a closure constant would be
    # serialized into the program, which bloats compilation for big datasets).
    cache_key = (id(predictive_fn), data is not None)
    hit = _cache_get(cache_key)
    if hit is None:
        if data is not None:
            pp = jax.jit(
                jax.vmap(
                    jax.vmap(predictive_fn, in_axes=(0, 0, None)),
                    in_axes=(0, 0, None),
                )
            )
        else:
            pp = jax.jit(jax.vmap(jax.vmap(predictive_fn)))
        # the second element pins predictive_fn's id while cached
        _cache_put(cache_key, (pp, predictive_fn))
    else:
        pp = hit[0]
    if data is not None:
        return pp(keys, samples, data)
    return pp(keys, samples)
