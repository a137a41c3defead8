"""Compiled multi-chain sampling engine.

This is the execution core that replaces the reference's host loops
(mlx_mcmc/kernels/*.py per-iteration Python loops with ``float()`` syncs,
SURVEY.md §3): one ``jit`` per (model, kernel) containing

    vmap(init) -> [warmup lax.scan with windowed adaptation] -> [sampling lax.scan]

Chains are a leading vmapped axis (the reference is single-chain only,
README.md:33-35). Cross-chain adaptation statistics are reduced with
``jnp.mean`` locally and optionally ``lax.pmean``/``psum`` over a named mesh
axis, so the same engine serves single-chain, single-chip multi-chain, and
mesh-sharded sampling (``parallel/sharded.py``).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mlx_mcmc_tpu.kernels.adaptation import (
    AdaptationState,
    adaptation_init,
    adaptation_update,
    build_schedule,
    find_reasonable_step_size,
)
from mlx_mcmc_tpu.kernels.integrators import (
    IntegratorState,
    make_leapfrog,
    sample_momentum,
    total_energy,
)
from mlx_mcmc_tpu.kernels.base import TransitionInfo, Tunables
from mlx_mcmc_tpu.kernels.chees import (
    chees_gradient,
    halton_sequence,
    make_chees_kernel,
    trajectory_init,
    trajectory_update,
)
from mlx_mcmc_tpu.kernels.hmc import make_hmc_kernel
from mlx_mcmc_tpu.kernels.mala import make_mala_kernel
from mlx_mcmc_tpu.kernels.metropolis import make_metropolis_kernel
from mlx_mcmc_tpu.kernels.nuts import make_nuts_kernel
from mlx_mcmc_tpu.ops.math import WelfordState

_DEFAULT_TARGET_ACCEPT = {
    "metropolis": 0.234,
    "hmc": 0.8,
    "nuts": 0.65,
    "chees": 0.651,  # harmonic-mean acceptance target of the ChEES paper
    "mala": 0.574,  # optimal-scaling acceptance for Langevin proposals
}


def make_kernel(kernel: str, flat_log_prob: Callable, **kwargs):
    """Kernel factory by name: 'metropolis' | 'hmc' | 'nuts'.

    ``value_and_grad_fn`` (hmc/nuts) swaps in a fused Pallas implementation
    of the leapfrog hot op.
    """
    if kernel == "metropolis":
        return make_metropolis_kernel(flat_log_prob)
    if kernel == "hmc":
        return make_hmc_kernel(
            flat_log_prob,
            num_leapfrog_steps=kwargs.get("num_leapfrog_steps", 10),
            value_and_grad_fn=kwargs.get("value_and_grad_fn"),
        )
    if kernel == "nuts":
        return make_nuts_kernel(
            flat_log_prob,
            max_tree_depth=kwargs.get("max_tree_depth", 10),
            value_and_grad_fn=kwargs.get("value_and_grad_fn"),
            static_schedule=kwargs.get("static_schedule", False),
        )
    if kernel == "mala":
        return make_mala_kernel(
            flat_log_prob,
            value_and_grad_fn=kwargs.get("value_and_grad_fn"),
        )
    if kernel == "chees":
        return make_chees_kernel(
            flat_log_prob,
            max_leapfrog_steps=kwargs.get("max_leapfrog_steps", 1000),
            value_and_grad_fn=kwargs.get("value_and_grad_fn"),
        )
    raise ValueError(f"Unknown kernel: {kernel!r}")


def default_target_accept(kernel: str) -> float:
    return _DEFAULT_TARGET_ACCEPT[kernel]


def resolve_step_size(step_size, kernel: str, adapt_step_size: bool):
    """Resolve the public ``step_size`` argument ('auto' is the default for
    gradient kernels — Stan always runs find-reasonable-step-size; a blind
    0.1 start wastes the fast warmup window on badly scaled targets).

    Falls back to 0.1 where the one-leapfrog probe doesn't apply
    (metropolis has no gradient; adapt_step_size=False pins the value).
    """
    if isinstance(step_size, str):
        if step_size != "auto":
            raise ValueError(
                f"step_size must be a float or 'auto', got {step_size!r}"
            )
        if kernel in ("metropolis", "ensemble") or not adapt_step_size:
            return 0.1
    return step_size


class ChainResult(NamedTuple):
    """Raw engine output, all device-resident.

    ``positions``: (chains, draws, D) post-warmup flat positions.
    ``info``: TransitionInfo pytree with (chains, draws) leaves.
    ``final_tunables``: adapted step size / inverse mass diagonal.
    ``final_state``: kernel state pytree with leading chain axis (for resume).
    ``final_adapt``/``final_traj``: raw adaptation pytrees at the end of the
    executed warmup segment — everything a mid-warmup checkpoint needs
    (io/checkpoint.py); ``final_traj`` is () except for chees.
    """

    positions: jnp.ndarray
    info: TransitionInfo
    final_tunables: Tunables
    final_state: Any
    final_adapt: Any = ()
    final_traj: Any = ()


def _welford_pmean_reduce(axis_name: str):
    """Pool Welford moments across a named mesh axis (exact merge via psum)."""

    def reduce(w: WelfordState) -> WelfordState:
        total = jax.lax.psum(w.count, axis_name)
        safe_total = jnp.maximum(total, 1.0)
        mean_g = jax.lax.psum(w.mean * w.count, axis_name) / safe_total
        m2_g = jax.lax.psum(w.m2 + w.count * (w.mean - mean_g) ** 2, axis_name)
        return WelfordState(total, mean_g, m2_g)

    return reduce


def build_sampler(
    flat_log_prob: Callable[[jnp.ndarray], jnp.ndarray],
    dim: int,
    *,
    kernel: str = "nuts",
    num_warmup: int = 1000,
    num_samples: int = 1000,
    thin: int = 1,
    step_size=0.1,
    adapt_step_size: bool = True,
    adapt_mass_matrix: bool = True,
    target_accept: Optional[float] = None,
    axis_name: Optional[str] = None,
    collect_warmup: bool = False,
    init_inv_mass_diag=None,
    progress_every: Optional[int] = None,
    progress_callback=None,
    warmup_start: int = 0,
    warmup_stop: Optional[int] = None,
    store_dtype=None,
    **kernel_kwargs,
) -> Callable[[jnp.ndarray, jnp.ndarray], ChainResult]:
    """Build a jittable ``run(key, z0_batch) -> ChainResult``.

    ``z0_batch`` has shape (chains, D); every scan and the chain vmap live in
    one traced function. ``axis_name`` names a mesh axis to additionally
    ``pmean`` adaptation statistics over (used by the sharded driver).

    ``warmup_start``/``warmup_stop`` select a warmup *segment* ``[start,
    stop)`` of the full ``num_warmup`` schedule (mid-warmup checkpoint/
    resume, io/checkpoint.py). The schedule and all RNG keys are functions of
    the global step index, so running ``[0, k)`` then ``[k, num_warmup)``
    from the checkpointed adaptation state is bit-identical to one
    uninterrupted run. With ``warmup_start > 0``, ``run`` must be called with
    ``resume_state=(adapt, traj)`` (a prior segment's ``final_adapt``/
    ``final_traj``) and the step-size probe is skipped. Set ``num_samples=0``
    to stop after a partial warmup segment.

    The sampling phase segments the same way: ``run``'s ``sample_start``
    runtime argument (a draw offset) shifts the sampling scan's global step
    indices to ``num_warmup + (sample_start + j) * thin``, so a segment
    ``[o, o + num_samples)`` driven from a prior segment's ``final_state``
    positions and ``final_adapt`` reproduces draws bit-identical to the
    corresponding slice of one uninterrupted run (chunked draw storage,
    ``sample(draw_chunk=...)``; bit-exact post-warmup resume,
    io/checkpoint.py). Being a runtime argument, one compiled runner serves
    every chunk offset.

    ``store_dtype`` (e.g. ``jnp.bfloat16``) down-casts ONLY the stored draw
    positions — kernel state, adaptation, and all step arithmetic stay f32.
    A bf16 store halves the (chains, draws, D) device-memory footprint, the
    usual ceiling at wide chain counts; bf16 keeps about three significant
    digits, so summary statistics on bf16-stored draws add rounding far
    below Monte-Carlo error.
    """
    if target_accept is None:
        target_accept = default_target_accept(kernel)
    auto_step_size = isinstance(step_size, str)
    if auto_step_size and (
        step_size != "auto" or kernel == "metropolis" or not adapt_step_size
    ):
        raise ValueError(
            "step_size='auto' requires a gradient kernel "
            "(hmc/nuts/chees/mala) with adapt_step_size=True"
        )

    if warmup_stop is None:
        warmup_stop = num_warmup
    if not (0 <= warmup_start <= warmup_stop <= num_warmup):
        raise ValueError(
            f"invalid warmup segment [{warmup_start}, {warmup_stop}) for "
            f"num_warmup={num_warmup}"
        )

    schedule = build_schedule(num_warmup, adapt_mass_matrix=adapt_mass_matrix)
    in_slow = jnp.asarray(schedule.in_slow_window[warmup_start:warmup_stop])
    window_end = jnp.asarray(schedule.window_end[warmup_start:warmup_stop])

    welford_reduce = _welford_pmean_reduce(axis_name) if axis_name else None

    def _reduce_mean(x):
        m = jnp.mean(x)
        if axis_name:
            m = jax.lax.pmean(m, axis_name)
        return m

    if progress_every:
        if progress_callback is None:

            def progress_callback(phase, t, accept, eps):  # pragma: no cover
                print(
                    f"  [{phase}] step {int(t):6d}  mean accept {float(accept):.3f}"
                    f"  step size {float(eps):.4f}",
                    flush=True,
                )

        def _maybe_report(phase, t, infos, eps):
            # Host callback fired every `progress_every` steps only — the hot
            # loop stays host-free otherwise (opt-in observability; the
            # reference prints unconditionally from inside its loops).
            jax.lax.cond(
                (t + 1) % progress_every == 0,
                lambda: jax.debug.callback(
                    progress_callback, phase, t, jnp.mean(infos.accept_prob), eps
                ),
                lambda: None,
            )

    else:

        def _maybe_report(phase, t, infos, eps):
            return None

    def _current_tunables(adapt: AdaptationState) -> Tunables:
        if adapt_step_size:
            eps = jnp.exp(adapt.da.log_step)
        else:
            eps = jnp.asarray(step_size, jnp.float32)
        return Tunables(
            step_size=eps,
            inv_mass_diag=adapt.inv_mass_diag,
            trajectory_length=jnp.asarray(1.0, jnp.float32),
        )

    def _final_tunables(adapt: AdaptationState) -> Tunables:
        if adapt_step_size:
            eps = jnp.exp(adapt.da.log_step_avg)
        else:
            eps = jnp.asarray(step_size, jnp.float32)
        return Tunables(
            step_size=eps,
            inv_mass_diag=adapt.inv_mass_diag,
            trajectory_length=jnp.asarray(1.0, jnp.float32),
        )

    def run(
        chain_keys: jnp.ndarray, z0_batch: jnp.ndarray, data=None,
        resume_state=None, sched=None, sample_start=0,
    ) -> ChainResult:
        """``chain_keys``: (chains_local,) PRNG keys, one per chain. Per-step
        keys are ``fold_in(chain_key, t)`` with a global step counter, so the
        random stream of a chain is identical no matter how chains are laid
        out across vmap batches or mesh shards (enables bit-identical
        1-device vs N-device results).

        ``data``: optional pytree forwarded to a binary model
        ``flat_log_prob(z, data)`` (and ``value_and_grad_fn(z, data)``).
        Passing data as a runtime argument rather than a closure constant
        keeps multi-hundred-MB datasets out of the compiled program body
        (serialized-HLO bloat) and lets them carry shardings/donation.

        ``sched``: the warmup flag arrays ``run.sched`` passed as *runtime*
        arguments. As closure constants (the ``None`` default) XLA
        constant-folds the window-end branch away in segments whose flags are
        all-False, compiling numerically different programs — which breaks
        bit-exact mid-warmup resume. Library callers always pass
        ``run.sched`` through the jit boundary.
        """
        if sched is not None:
            in_slow_xs, window_end_xs = sched
        else:
            in_slow_xs, window_end_xs = in_slow, window_end
        if data is None:
            flp_bound, bound_kwargs = flat_log_prob, dict(kernel_kwargs)
        else:
            bound_kwargs = dict(kernel_kwargs)
            vag = bound_kwargs.pop("value_and_grad_fn", None)
            if vag is not None:
                bound_kwargs["value_and_grad_fn"] = lambda z: vag(z, data)
            flp_bound = lambda z: flat_log_prob(z, data)  # noqa: E731
        init_fn, step_fn = make_kernel(kernel, flp_bound, **bound_kwargs)
        states = jax.vmap(init_fn)(z0_batch)

        is_chees = kernel == "chees"
        if resume_state is not None:
            # Continue a prior segment: the checkpointed adaptation state
            # replaces both the probe and adaptation_init.
            adapt, traj = resume_state
            if not is_chees:
                traj = ()
        elif auto_step_size:
            # Stan-style initialization: probe one leapfrog step across all
            # chains, doubling/halving eps until mean accept crosses 0.5.
            inv_mass0 = (
                jnp.ones((dim,), jnp.float32)
                if init_inv_mass_diag is None
                else jnp.asarray(init_inv_mass_diag, jnp.float32)
            )
            leapfrog = make_leapfrog(
                flp_bound, bound_kwargs.get("value_and_grad_fn")
            )
            probe_keys = jax.vmap(
                lambda ck: jax.random.fold_in(ck, 0x7FFFFFFF)
            )(chain_keys)

            def accept_prob_fn(eps):
                def per_chain(key, state):
                    r = sample_momentum(key, inv_mass0)
                    integ = IntegratorState(
                        state.position, r, state.log_prob, state.grad
                    )
                    e0 = total_energy(integ, inv_mass0)
                    e1 = total_energy(
                        leapfrog(integ, eps, inv_mass0), inv_mass0
                    )
                    delta = jnp.where(jnp.isnan(e0 - e1), -jnp.inf, e0 - e1)
                    return jnp.exp(jnp.minimum(delta, 0.0))

                return _reduce_mean(jax.vmap(per_chain)(probe_keys, states))

            eps_init = find_reasonable_step_size(accept_prob_fn)
        else:
            eps_init = step_size
        if resume_state is None:
            if warmup_start > 0:
                raise ValueError(
                    "warmup_start > 0 requires resume_state=(adapt, traj) "
                    "from the prior segment's ChainResult"
                )
            adapt = adaptation_init(dim, eps_init, init_inv_mass_diag)
            traj = trajectory_init(eps_init) if is_chees else ()
        _pmean = (lambda x: jax.lax.pmean(x, axis_name)) if axis_name else None

        def _with_trajectory(tunables: Tunables, traj, t) -> Tunables:
            """ChEES: this draw's jittered integration length (shared by all
            chains — Halton of the global step index, layout-invariant)."""
            if not is_chees:
                return tunables
            u = halton_sequence(t)
            return tunables._replace(
                trajectory_length=u * jnp.exp(traj.log_tau)
            )

        warmup_collect = None
        if warmup_stop > warmup_start:

            def warmup_body(carry, xs):
                states, adapt, traj = carry
                t, slow_flag, end_flag = xs
                keys = jax.vmap(lambda ck: jax.random.fold_in(ck, t))(chain_keys)
                tunables = _with_trajectory(_current_tunables(adapt), traj, t)
                prev_positions = states.position
                states, infos = jax.vmap(step_fn, in_axes=(0, 0, None))(
                    keys, states, tunables
                )
                adapt = adaptation_update(
                    adapt,
                    _reduce_mean(infos.accept_prob),
                    states.position,
                    slow_flag,
                    end_flag,
                    target_accept,
                    welford_reduce=welford_reduce,
                )
                if is_chees:
                    grad = chees_gradient(
                        prev_positions, infos, halton_sequence(t), _pmean
                    )
                    traj = trajectory_update(
                        traj, grad, tunables.step_size,
                        max_leapfrog_steps=kernel_kwargs.get(
                            "max_leapfrog_steps", 1000
                        ),
                    )
                _maybe_report("warmup", t, infos, tunables.step_size)
                out = (states.position, infos) if collect_warmup else None
                return (states, adapt, traj), out

            steps = jnp.arange(warmup_start, warmup_stop, dtype=jnp.int32)
            (states, adapt, traj), warmup_collect = jax.lax.scan(
                warmup_body,
                (states, adapt, traj),
                (steps, in_slow_xs, window_end_xs),
            )

        tunables = _final_tunables(adapt)
        if is_chees:
            # report the adapted base trajectory length (pre-jitter)
            tunables = tunables._replace(trajectory_length=jnp.exp(traj.log_tau))

        def _one_step(states, t):
            keys = jax.vmap(lambda ck: jax.random.fold_in(ck, t))(chain_keys)
            step_tunables = _with_trajectory(tunables, traj, t)
            states, infos = jax.vmap(step_fn, in_axes=(0, 0, None))(
                keys, states, step_tunables
            )
            if is_chees:
                # The endpoint extras are only needed for warmup adaptation;
                # drop them from the stored draws ((S, C, D) would double the
                # sample-store footprint).
                infos = infos._replace(
                    proposal_position=infos.proposal_position[..., :0],
                    end_velocity=infos.end_velocity[..., :0],
                )
            return states, infos

        if store_dtype is None:
            _store = lambda z: z  # noqa: E731
        else:
            _store = lambda z: z.astype(store_dtype)  # noqa: E731

        if thin == 1:

            def sample_body(states, t):
                states, infos = _one_step(states, t)
                _maybe_report("sample", t, infos, tunables.step_size)
                return states, (_store(states.position), infos)

        else:
            # Keep every `thin`-th draw: an inner scan advances the chain,
            # only the block's last state/info are stored — except counters
            # and flags that must aggregate across the whole block (a thinned
            # block can contain divergent transitions whose draws are
            # discarded; dropping the flag would undercount divergences).
            def sample_body(states, t0):
                ts = t0 + jnp.arange(thin, dtype=jnp.int32)
                states, infos = jax.lax.scan(
                    lambda st, t: _one_step(st, t), states, ts
                )
                info_last = jax.tree_util.tree_map(lambda x: x[-1], infos)
                info_last = info_last._replace(
                    is_divergent=jnp.any(infos.is_divergent, axis=0),
                    num_integration_steps=jnp.sum(
                        infos.num_integration_steps, axis=0
                    ),
                )
                _maybe_report("sample", t0, info_last, tunables.step_size)
                return states, (_store(states.position), info_last)

        # Global step of stored draw j: num_warmup + (sample_start + j)*thin.
        # `sample_start` is a traced runtime value, so XLA lowers the step
        # array as iota+add — one compiled program serves every chunk offset.
        sample_steps = (
            jnp.asarray(num_warmup, jnp.int32)
            + (
                jnp.asarray(sample_start, jnp.int32)
                + jnp.arange(num_samples, dtype=jnp.int32)
            )
            * thin
        )
        states, (positions, infos) = jax.lax.scan(sample_body, states, sample_steps)

        # (draws, chains, ...) -> (chains, draws, ...)
        positions = jnp.swapaxes(positions, 0, 1)
        infos = jax.tree_util.tree_map(lambda x: jnp.swapaxes(x, 0, 1), infos)
        result = ChainResult(
            positions=positions,
            info=infos,
            final_tunables=tunables,
            final_state=states,
            final_adapt=adapt,
            final_traj=traj,
        )
        if collect_warmup:
            return result, warmup_collect
        return result

    # The warmup flag arrays, for passing back through the jit boundary as
    # runtime arguments (see the ``sched`` note in ``run``'s docstring).
    run.sched = (
        np.asarray(schedule.in_slow_window[warmup_start:warmup_stop]),
        np.asarray(schedule.window_end[warmup_start:warmup_stop]),
    )
    return run


def make_chain_keys(key, num_chains: int) -> jnp.ndarray:
    """Derive one PRNG key per global chain index (layout-invariant)."""
    return jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.arange(num_chains, dtype=jnp.int32)
    )


def prepare_initial_positions(
    initial_flat: jnp.ndarray,
    num_chains: int,
    key=None,
    jitter: float = 0.0,
) -> jnp.ndarray:
    """Tile a single flat init to (chains, D), optionally jittered."""
    z0 = jnp.broadcast_to(initial_flat, (num_chains,) + initial_flat.shape)
    if jitter > 0.0 and key is not None:
        z0 = z0 + jitter * jax.random.normal(key, z0.shape, z0.dtype)
    return z0
