"""Parallel tempering (replica exchange) over a vmapped temperature ladder.

Beyond the reference (its kernels are single-chain, single-temperature;
multimodal targets are out of reach for all three of mlx_mcmc/kernels/*.py):
R replicas per chain target the tempered densities ``p(z)^beta_r`` for a
ladder ``1 = beta_0 > beta_1 > ... > beta_{R-1} > 0``; hot replicas cross
between modes freely and deterministic even-odd (DEO) swap moves (Okabe et
al. 2001; non-reversible scheme of Syed et al. 2021) transport those
crossings down to the cold chain.

Compiled shape: the ladder is a leading vmapped axis — every replica steps in
lockstep (same compiled kernel, beta enters as a traced scalar through the
closure), and a swap round is a pure gather along the replica axis: partner
indices and accept decisions are computed symmetrically per pair, then every
replica selects ``src = swap_accepted ? partner : self``. No host control
flow, no ragged work — the whole (replicas x chains) block is one
``lax.scan`` under one ``jit``, exactly like the untempered engine.

Swapped kernel states need no re-evaluation: the cached ``log_prob`` and
``grad`` of a tempered density scale *linearly* in beta, so after the gather
they are rescaled by ``beta_self / beta_src`` instead of recomputing the
model (one multiply instead of a gradient evaluation per swap).

Per-replica adaptation: dual averaging and Welford mass estimation run
vmapped over the ladder (hot replicas want larger steps and wider mass), with
acceptance statistics pooled across chains within each rung.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mlx_mcmc_tpu.inference.api import MCMCResult, _as_key
from mlx_mcmc_tpu.inference.engine import (
    default_target_accept,
    make_chain_keys,
    make_kernel,
    prepare_initial_positions,
)
from mlx_mcmc_tpu.kernels.adaptation import (
    adaptation_init,
    adaptation_update,
    build_schedule,
)
from mlx_mcmc_tpu.kernels.base import Tunables
from mlx_mcmc_tpu.ops.ravel import make_flat_logprob

_SWAP_SALT = 0x53574150  # "SWAP": keeps swap randomness disjoint from steps


def geometric_ladder(num_replicas: int, beta_min: float = 0.1) -> jnp.ndarray:
    """Geometric inverse-temperature ladder 1 -> beta_min (cold first)."""
    if num_replicas < 2:
        return jnp.ones((1,), jnp.float32)
    r = jnp.arange(num_replicas, dtype=jnp.float32) / (num_replicas - 1)
    return jnp.asarray(beta_min, jnp.float32) ** r


def _swap_sources(key, betas, lp, parity):
    """One DEO swap round along the ladder for a single chain.

    ``lp``: (R,) *untempered* log densities at each replica's position.
    Returns ``(src, alpha)``: gather indices (R,) such that replica r adopts
    replica ``src[r]``'s state, and per-boundary swap probabilities (R-1,)
    (NaN-free; boundaries inactive this round report alpha computed anyway —
    the caller masks by parity).
    """
    num = betas.shape[0]
    idx = jnp.arange(num)
    # Even rounds pair boundaries 0,2,4,...; odd rounds 1,3,5,... A replica's
    # partner this round (or itself at an inactive endpoint):
    even_partner = jnp.where((idx ^ 1) < num, idx ^ 1, idx)
    odd_raw = jnp.where(idx % 2 == 1, idx + 1, idx - 1)
    odd_partner = jnp.where((idx == 0) | (odd_raw >= num), idx, odd_raw)
    partner = jnp.where(parity == 0, even_partner, odd_partner)

    # Symmetric accept: pair (i, j) shares log-ratio (b_i - b_j)(lp_j - lp_i)
    # and the uniform keyed by min(i, j), so both sides decide identically.
    log_ratio = (betas - betas[partner]) * (lp[partner] - lp)
    log_ratio = jnp.where(jnp.isnan(log_ratio), -jnp.inf, log_ratio)
    pair_lo = jnp.minimum(idx, partner)
    log_u = jnp.log(
        jax.vmap(lambda i: jax.random.uniform(jax.random.fold_in(key, i)))(pair_lo)
    )
    accept = (log_u < log_ratio) & (partner != idx)
    src = jnp.where(accept, partner, idx)

    # Boundary r <-> r+1 statistics (for ladder health / round-trip rate).
    alpha_all = jnp.exp(jnp.minimum(log_ratio, 0.0))
    return src, alpha_all[:-1]


@dataclass
class TemperedResult(MCMCResult):
    """Cold-chain posterior draws plus replica-exchange diagnostics.

    ``swap_acceptance``: (R-1,) mean swap probability per ladder boundary
    (boundary r is between replicas r and r+1; healthy ladders sit ~0.2-0.6).
    ``betas``: the inverse-temperature ladder used.
    ``replica_step_sizes``: (R,) adapted step size per rung.
    """

    swap_acceptance: Optional[np.ndarray] = None
    betas: Optional[np.ndarray] = None
    replica_step_sizes: Optional[np.ndarray] = None


def sample_tempered(
    log_prob_fn: Callable[[Any], jnp.ndarray],
    initial_params: Any,
    *,
    num_samples: int = 1000,
    num_warmup: int = 1000,
    num_chains: int = 1,
    num_replicas: int = 8,
    betas=None,
    beta_min: float = 0.1,
    kernel: str = "hmc",
    seed=0,
    step_size: float = 0.1,
    adapt_step_size: bool = True,
    adapt_mass_matrix: bool = True,
    target_accept: Optional[float] = None,
    jitter: float = 0.0,
    data=None,
    transforms: Optional[dict] = None,
    **kernel_kwargs,
) -> TemperedResult:
    """Sample a (possibly multimodal) posterior with parallel tempering.

    Runs ``num_chains`` independent replica ladders of ``num_replicas``
    temperatures each; returns the beta=1 (cold) draws as a standard
    :class:`MCMCResult` plus swap diagnostics. ``kernel`` is any gradient
    kernel name ('hmc' | 'mala' | 'nuts' | 'chees' is excluded — its
    trajectory adaptation state is global) or 'metropolis'.

    ``betas`` overrides the geometric ladder; entries must be in (0, 1],
    start at 1.0, and decrease. All other options follow
    :func:`mlx_mcmc_tpu.sample`.
    """
    if kernel == "chees":
        raise ValueError(
            "kernel='chees' is not supported under tempering (its trajectory "
            "adaptation is a single global state); use 'hmc', 'mala' or 'nuts'"
        )
    user_log_prob_fn = log_prob_fn
    if transforms:
        from mlx_mcmc_tpu.distributions.transforms import make_transformed_logprob

        log_prob_fn, to_constrained, to_unconstrained = make_transformed_logprob(
            log_prob_fn, transforms, data_aware=data is not None
        )
        initial_params = to_unconstrained(
            jax.tree_util.tree_map(
                lambda x: jnp.asarray(x, jnp.result_type(float)), initial_params
            )
        )
    else:
        to_constrained = None

    if betas is None:
        betas = geometric_ladder(num_replicas, beta_min)
    betas = jnp.asarray(betas, jnp.float32)
    num_replicas = int(betas.shape[0])
    betas_np = np.asarray(betas)
    if not (
        betas_np[0] == 1.0 and (betas_np > 0).all() and (np.diff(betas_np) < 0).all()
    ):
        raise ValueError(
            f"betas must start at 1.0, be positive, and strictly decrease; "
            f"got {betas_np}"
        )
    if target_accept is None:
        target_accept = default_target_accept(kernel)

    flat_log_prob, z0, unravel = make_flat_logprob(
        log_prob_fn, initial_params, data_aware=data is not None
    )
    dim = z0.shape[0]

    schedule = build_schedule(num_warmup, adapt_mass_matrix=adapt_mass_matrix)
    in_slow = jnp.asarray(schedule.in_slow_window)
    window_end = jnp.asarray(schedule.window_end)

    def run(chain_keys, z0_batch, data):
        """chain_keys: (C,) keys; z0_batch: (C, D). All replicas of a chain
        start at the chain's init. Step RNG is keyed by (chain, replica,
        step) folds — layout invariant across vmap/shard layouts."""
        if data is None:
            flp = flat_log_prob
            kw = dict(kernel_kwargs)
        else:
            kw = dict(kernel_kwargs)
            vag = kw.pop("value_and_grad_fn", None)
            if vag is not None:
                _vag = vag
                kw["value_and_grad_fn"] = lambda z: _vag(z, data)
            flp = lambda z: flat_log_prob(z, data)  # noqa: E731

        def replica_init(beta, z0s):
            init_fn, _ = make_kernel(kernel, lambda z: beta * flp(z), **kw)
            return jax.vmap(init_fn)(z0s)

        def replica_step(beta, keys_c, states_c, tunables_r):
            kw_r = dict(kw)
            if kw_r.get("value_and_grad_fn") is not None:
                # A fused value_and_grad computes the *untempered* density;
                # rescale its outputs so cached state stays consistent.
                base_vag = kw_r["value_and_grad_fn"]
                kw_r["value_and_grad_fn"] = lambda z: jax.tree_util.tree_map(
                    lambda t: beta * t, base_vag(z)
                )
            _, step_fn = make_kernel(kernel, lambda z: beta * flp(z), **kw_r)
            return jax.vmap(step_fn, in_axes=(0, 0, None))(
                keys_c, states_c, tunables_r
            )

        # (R, C, D) starting states.
        z0_rep = jnp.broadcast_to(z0_batch, (num_replicas,) + z0_batch.shape)
        states = jax.vmap(replica_init)(betas, z0_rep)

        adapt = jax.vmap(lambda _: adaptation_init(dim, step_size))(
            jnp.arange(num_replicas)
        )

        def step_keys(t):
            # (R, C) keys: fold chain then replica then step.
            def per_chain(ck):
                return jax.vmap(
                    lambda r: jax.random.fold_in(jax.random.fold_in(ck, r), t)
                )(jnp.arange(num_replicas, dtype=jnp.int32))

            return jnp.swapaxes(jax.vmap(per_chain)(chain_keys), 0, 1)

        def swap_keys(t):
            return jax.vmap(
                lambda ck: jax.random.fold_in(
                    jax.random.fold_in(ck, _SWAP_SALT), t
                )
            )(chain_keys)

        def do_swaps(states, t):
            """One DEO round across all chains; returns new states + (R-1,)
            per-boundary mean swap probability (masked to active pairs)."""
            lp_untempered = states.log_prob / betas[:, None]  # (R, C)
            parity = t % 2

            def per_chain(key, lp_c):
                return _swap_sources(key, betas, lp_c, parity)

            src, alpha = jax.vmap(per_chain, in_axes=(0, 1), out_axes=(1, 1))(
                swap_keys(t), lp_untempered
            )  # src: (R, C), alpha: (R-1, C)

            # Gather each state leaf (R, C, ...) along the replica axis.
            def gather(x):
                return jnp.take_along_axis(
                    x, src.reshape(src.shape + (1,) * (x.ndim - 2)), axis=0
                )

            new_states = jax.tree_util.tree_map(gather, states)
            # Tempered log_prob/grad scale linearly in beta: rescale the
            # adopted state from its source rung's beta to this rung's.
            scale = betas[:, None] / betas[src]
            new_states = new_states._replace(
                log_prob=new_states.log_prob * scale
            )
            if hasattr(new_states, "grad"):
                new_states = new_states._replace(
                    grad=new_states.grad * scale[..., None]
                )
            return new_states, jnp.mean(alpha, axis=1), parity

        def warmup_body(carry, xs):
            states, adapt = carry
            t, slow_flag, end_flag = xs
            tunables = jax.vmap(
                lambda a: Tunables(
                    step_size=jnp.exp(a.da.log_step)
                    if adapt_step_size
                    else jnp.asarray(step_size, jnp.float32),
                    inv_mass_diag=a.inv_mass_diag,
                )
            )(adapt)
            states, infos = jax.vmap(replica_step)(
                betas, step_keys(t), states, tunables
            )
            adapt = jax.vmap(
                lambda a, acc, pos: adaptation_update(
                    a, acc, pos, slow_flag, end_flag, target_accept
                )
            )(adapt, jnp.mean(infos.accept_prob, axis=1), states.position)
            states, _, _ = do_swaps(states, t)
            return (states, adapt), None

        if num_warmup > 0:
            steps = jnp.arange(num_warmup, dtype=jnp.int32)
            (states, adapt), _ = jax.lax.scan(
                warmup_body, (states, adapt), (steps, in_slow, window_end)
            )

        final_tunables = jax.vmap(
            lambda a: Tunables(
                step_size=jnp.exp(a.da.log_step_avg)
                if adapt_step_size
                else jnp.asarray(step_size, jnp.float32),
                inv_mass_diag=a.inv_mass_diag,
            )
        )(adapt)

        def sample_body(states, t):
            states, infos = jax.vmap(replica_step)(
                betas, step_keys(t), states, final_tunables
            )
            states, alpha, parity = do_swaps(states, t)
            cold_info = jax.tree_util.tree_map(lambda x: x[0], infos)
            return states, (states.position[0], cold_info, alpha, parity)

        sample_steps = jnp.arange(
            num_warmup, num_warmup + num_samples, dtype=jnp.int32
        )
        states, (positions, infos, alphas, parities) = jax.lax.scan(
            sample_body, states, sample_steps
        )

        # (S, C, D) -> (C, S, D); infos (S, C) -> (C, S)
        positions = jnp.swapaxes(positions, 0, 1)
        infos = jax.tree_util.tree_map(lambda x: jnp.swapaxes(x, 0, 1), infos)
        # Per-boundary swap acceptance over the rounds where it was active:
        # boundary r is proposed on rounds with parity == r % 2.
        active = (
            parities[:, None] == (jnp.arange(num_replicas - 1) % 2)[None, :]
        )  # (S, R-1)
        swap_acc = jnp.sum(
            jnp.where(active, alphas, 0.0), axis=0
        ) / jnp.maximum(jnp.sum(active, axis=0), 1)
        return positions, infos, swap_acc, final_tunables

    key = _as_key(seed)
    key_init, key_run = jax.random.split(key)
    z0_batch = prepare_initial_positions(z0, num_chains, key_init, jitter)
    chain_keys = make_chain_keys(key_run, num_chains)
    # Reuse the traced program across calls (api._reuse_jit contract: every
    # closure constant of `run` — incl. the beta ladder and the warmup
    # schedule's (num_warmup, adapt_mass_matrix) inputs — is in the key;
    # chain_keys/z0_batch/data are arguments).
    from mlx_mcmc_tpu.inference.api import _hashable, _param_spec, _reuse_jit

    t_key = (
        None
        if not transforms
        else tuple(sorted(transforms.items(), key=lambda kv: kv[0]))
    )
    hashable_ok = (
        (t_key is None or all(_hashable(v) for _, v in t_key))
        and all(_hashable(v) for v in kernel_kwargs.values())
        and _hashable(step_size)
    )
    if hashable_ok:
        jrun = _reuse_jit(
            "tempered",
            (
                id(user_log_prob_fn),
                t_key,
                _param_spec(initial_params),
                data is not None,
                kernel,
                tuple(float(b) for b in betas_np),
                int(num_samples),
                int(num_warmup),
                step_size,
                bool(adapt_step_size),
                bool(adapt_mass_matrix),
                float(target_accept),
                tuple(sorted(kernel_kwargs.items(), key=lambda kv: kv[0])),
            ),
            run,
            pin=user_log_prob_fn,
        )
    else:
        jrun = jax.jit(run)
    positions, infos, swap_acc, final_tunables = jrun(
        chain_keys, z0_batch, data
    )

    samples = jax.vmap(jax.vmap(unravel))(positions)
    if to_constrained is not None:
        samples = to_constrained(samples)
    cold_tunables = jax.tree_util.tree_map(lambda x: x[0], final_tunables)
    return TemperedResult(
        samples=samples,
        info=infos,
        tunables=cold_tunables,
        num_chains=num_chains,
        num_samples=num_samples,
        kernel=kernel,
        swap_acceptance=np.asarray(swap_acc),
        betas=np.asarray(betas),
        replica_step_sizes=np.asarray(final_tunables.step_size),
    )
