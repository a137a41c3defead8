"""No-U-Turn Sampler: fixed-depth *iterative* formulation.

Reference parity: mlx_mcmc/kernels/nuts.py:16-358 implements Hoffman & Gelman
(2014) with recursive ``build_tree`` (nuts.py:137-218), host-evaluated U-turn
checks (nuts.py:119-135) and a data-dependent Python doubling loop
(nuts.py:251-280) — a formulation that cannot compile. This module is the
Compiled redesign (SURVEY.md §7 design delta #2):

- the doubling loop is a ``lax.while_loop``; each doubling builds its subtree
  *iteratively* with a checkpoint-array U-turn scheme (popcount-indexed
  ancestor checkpoints, as in NumPyro/Stan's iterative tree build), so memory
  is O(max_tree_depth * D) and control flow is fully traced;
- progressive **multinomial** sampling over leaves (Betancourt 2017) with a
  biased across-doubling transition — the modern variant of the reference's
  slice sampling (nuts.py:166,234-237), same posterior, better statistical
  efficiency and vectorization behavior;
- the generalized U-turn criterion on momentum sums with a diagonal metric
  (the reference's position-difference criterion, nuts.py:128-135, is the
  identity-mass special case);
- divergence detection via ``max_delta_energy = 1000`` matches the
  reference's ``DELTA_MAX`` (nuts.py:13).

Everything runs under ``jit``/``vmap``/``shard_map``; one NUTS draw is one
XLA computation with zero host syncs.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from mlx_mcmc_tpu.kernels.base import TransitionInfo, Tunables
from mlx_mcmc_tpu.kernels.hmc import HMCState
from mlx_mcmc_tpu.kernels.integrators import (
    IntegratorState,
    make_leapfrog,
    sample_momentum,
    total_energy,
)

DELTA_MAX = 1000.0  # max energy error before declaring divergence


def _popcount(x: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.population_count(x.astype(jnp.int32))


def _is_turning(r_sum, r_first, r_last, inv_mass_diag) -> jnp.ndarray:
    """Generalized U-turn criterion: trajectory stops expanding when the
    momentum sum opposes the velocity at either end."""
    v_first = inv_mass_diag * r_first
    v_last = inv_mass_diag * r_last
    return (jnp.dot(r_sum, v_first) <= 0.0) | (jnp.dot(r_sum, v_last) <= 0.0)


class _Proposal(NamedTuple):
    """The candidate next state: position plus its cached density/gradient.

    r3 carried the position ONLY and recomputed (log_prob, grad) with one
    extra value_and_grad per draw after the loop — cheaper when trees run
    deep (the selects cost ~per leaf, the recompute ~once per draw). r4
    reversed this after the flagship moved to shallow adapted trees (~4-5
    pair iterations per draw at 4096 chains): one vag is ~0.21 ms there
    while the four extra (C, D)/(C,) selects per pair measure ~10-20 us —
    carrying wins ~8% of the draw cost, and on the data-sharded path it
    removes a per-draw collective as well (momentum stays untracked: nothing
    consumes it downstream)."""

    z: jnp.ndarray
    log_prob: jnp.ndarray
    grad: jnp.ndarray


class _NutsCarry(NamedTuple):
    """FLAT while-loop state: the sampled trajectory (tree) and the
    in-flight subtree, advanced ONE leapfrog per loop iteration.

    The textbook nested formulation (doubling while-loop around a subtree
    while-loop) pays a loop-boundary cost per doubling, which at thousands
    of vmapped chains can exceed the leapfrog itself. Flattening
    to a single loop makes the iteration count proportional to the leapfrog
    count; subtree completion and tree merging happen branchlessly via masked
    selects inside the body. Each iteration advances one even+odd leaf PAIR
    (two leapfrogs) — the depth-0 root subtree is peeled out of the loop so
    pairs always align with subtree boundaries — which halves both the
    while-loop's fixed per-iteration cost and the per-leaf (T, D) bookkeeping
    passes (checkpoint writes on even leaves, batched U-turn checks on odd).
    """

    # --- whole-trajectory (tree) state ---
    left: IntegratorState
    right: IntegratorState
    proposal: _Proposal
    log_weight: jnp.ndarray  # log sum_leaves exp(E0 - E); root contributes 0
    r_sum: jnp.ndarray  # (D,) momentum sum over all leaves incl. root
    depth: jnp.ndarray  # i32, completed doublings
    turning: jnp.ndarray
    diverging: jnp.ndarray
    sum_accept: jnp.ndarray
    num_leaves: jnp.ndarray  # i32, leapfrog steps taken
    # --- in-flight subtree state ---
    sub_last: IntegratorState  # latest integration point
    sub_proposal: _Proposal
    sub_log_weight: jnp.ndarray
    sub_r_sum: jnp.ndarray
    sub_leaf: jnp.ndarray  # i32 leaves built in the current subtree
    going_right: jnp.ndarray  # bool, direction of the current subtree
    iter_idx: jnp.ndarray  # i32 body-iteration counter (pregen-RNG slot)
    r_ckpts: jnp.ndarray  # (max_tree_depth, D) even-leaf momenta
    r_sum_ckpts: jnp.ndarray  # (max_tree_depth, D) even-leaf prefix sums


def _as_proposal(state: IntegratorState) -> _Proposal:
    return _Proposal(z=state.z, log_prob=state.log_prob, grad=state.grad)


def make_nuts_kernel(
    flat_log_prob: Callable[[jnp.ndarray], jnp.ndarray],
    max_tree_depth: int = 10,
    max_delta_energy: float = DELTA_MAX,
    value_and_grad_fn=None,
    static_schedule: bool = False,
) -> Tuple[Callable, Callable]:
    """Build ``(init_fn, step_fn)`` for iterative multinomial NUTS.

    State is shared with HMC (:class:`HMCState`): position + cached
    log-prob/gradient, so one gradient evaluation per leapfrog step total.

    ``static_schedule=True`` replaces the data-dependent ``while_loop`` with
    a fixed-trip-count scan of ``2**max_tree_depth - 1`` masked iterations
    (finished chains carry through unchanged). The draws are BIT-IDENTICAL
    to the dynamic variant — only the execution schedule changes: every
    chain row executes exactly the same number of likelihood evaluations,
    so collectives inside ``value_and_grad_fn`` (observation sharding's
    per-leapfrog ``psum``, parallel/sharded.py) fire uniformly across the
    mesh instead of a per-row data-dependent number of times. The price is
    running every draw at the depth cap; use a realistic ``max_tree_depth``
    (6-8) rather than the default 10 when enabling this.
    """
    leapfrog = make_leapfrog(flat_log_prob, value_and_grad_fn)
    value_and_grad = value_and_grad_fn or jax.value_and_grad(flat_log_prob)

    def init_fn(position: jnp.ndarray) -> HMCState:
        log_prob, grad = value_and_grad(position)
        return HMCState(position=position, log_prob=log_prob, grad=grad)

    # ------------------------------------------------------------------
    # Flat single-loop tree build (one leapfrog per while iteration)
    # ------------------------------------------------------------------

    def _leaf_turning_check(leaf_idx, r_sum, r_leaf, r_ckpts, r_sum_ckpts, inv_mass):
        """For odd ``leaf_idx``, check U-turns of every subtree that has this
        leaf as its rightmost element, against checkpointed left edges.

        Checkpoint slot of an even leaf ``m`` is ``popcount(m)``; the slots to
        check against for odd ``n`` span ``[idx_max - trailing_ones(n) + 1,
        idx_max]`` with ``idx_max = popcount(n >> 1)``. Every slot in that
        range was written earlier in the SAME subtree, so stale data from a
        previous subtree can never enter the mask — the checkpoint buffers
        need no per-subtree zeroing.

        Evaluated for ALL ``max_tree_depth`` slots at once with a slot mask
        instead of a data-dependent inner while_loop: the batched check is a
        (T, D) elementwise + two (T,) reductions — far cheaper than per-slot
        loop iterations (and under the chain vmap a dynamic slot gather would
        lower to a serialized per-row gather).
        """
        idx_max = _popcount(leaf_idx >> 1)
        trailing_ones = _popcount(leaf_idx ^ (leaf_idx + 1)) - 1
        idx_min = idx_max - trailing_ones + 1

        sub_sum = r_sum[None, :] - r_sum_ckpts + r_ckpts  # (T, D)
        v_first = inv_mass[None, :] * r_ckpts
        v_leaf = inv_mass * r_leaf
        turning_t = (jnp.sum(sub_sum * v_first, axis=-1) <= 0.0) | (
            sub_sum @ v_leaf <= 0.0
        )
        slots = jnp.arange(max_tree_depth, dtype=jnp.int32)
        mask = (slots >= idx_min) & (slots <= idx_max)
        return jnp.any(turning_t & mask)

    def step_fn(key, state: HMCState, tunables: Tunables):
        inv_mass = tunables.inv_mass_diag
        eps = tunables.step_size
        key_momentum, key_loop = jax.random.split(key)

        r0 = sample_momentum(key_momentum, inv_mass)
        start = IntegratorState(state.position, r0, state.log_prob, state.grad)
        energy0 = total_energy(start, inv_mass)
        dim = state.position.shape[-1]
        f32 = jnp.float32

        def leaf_energy(new):
            delta = total_energy(new, inv_mass) - energy0
            leaf_div = delta > max_delta_energy
            log_w = -delta  # multinomial log weight, relative to E0
            accept_stat = jnp.exp(jnp.minimum(-delta, 0.0))
            return leaf_div, log_w, accept_stat

        # ONE threefry invocation per draw: every uniform the tree build can
        # consume is drawn up front into a (2^(d-1), 4) table — row 0 feeds
        # the peeled root, row p the p-th pair iteration. Per-pair
        # ``fold_in`` + ``uniform((4,))`` calls are invocation-overhead-bound
        # at chain width (~30 us each at 4096 vmapped chains, ~6 calls per
        # draw); the one batched draw generates 8x the values but costs a
        # single invocation. Rows past the realized tree are wasted threefry
        # throughput — cheap next to the invocation overhead they replace.
        n_slots = 1 << (max_tree_depth - 1)
        U = jax.random.uniform(key_loop, (n_slots, 4))
        slots_u = jnp.arange(n_slots, dtype=jnp.int32)

        # --- peeled root doubling: the depth-0 subtree is one leaf, so the
        # loop below can process exactly one even+odd leaf PAIR (two
        # leapfrogs) per iteration. Every later subtree has 2^d >= 2 leaves
        # and can only stop early on divergence (turning is detected at odd
        # leaves, i.e. pair ends), so pair alignment holds for the whole
        # trajectory. Halving the iteration count halves the while-loop's
        # fixed per-iteration cost, and the checkpoint-buffer write (even
        # leaves) and batched U-turn check (odd leaves) — the two big (T, D)
        # bookkeeping passes — run once per pair instead of once per leaf.
        u0 = U[0]
        going_right0 = u0[0] < 0.5
        new0 = leapfrog(
            start, jnp.where(going_right0, eps, -eps), inv_mass
        )
        div0, lw0, acc0 = leaf_energy(new0)
        # Singleton subtree: the take is unconditional (only leaf); the
        # across-doubling move uses the biased transition vs the root.
        p_move0 = jnp.exp(jnp.minimum(lw0, 0.0))
        p_move0 = jnp.where(jnp.isnan(p_move0), 0.0, p_move0)
        move0 = ~div0 & (u0[3] < p_move0)
        left0 = jax.tree_util.tree_map(
            lambda n, s: jnp.where(going_right0, s, n), new0, start
        )
        right0 = jax.tree_util.tree_map(
            lambda n, s: jnp.where(going_right0, n, s), new0, start
        )
        r_sum0 = r0 + new0.r
        turning0 = ~div0 & _is_turning(r_sum0, left0.r, right0.r, inv_mass)

        carry0 = _NutsCarry(
            left=left0,
            right=right0,
            proposal=jax.tree_util.tree_map(
                lambda n, s: jnp.where(move0, n, s),
                _as_proposal(new0),
                _as_proposal(start),
            ),
            log_weight=jnp.logaddexp(0.0, lw0),
            r_sum=r_sum0,
            depth=jnp.asarray(1, jnp.int32),
            turning=turning0,
            diverging=div0,
            sum_accept=acc0,
            num_leaves=jnp.asarray(1, jnp.int32),
            sub_last=new0,
            sub_proposal=_as_proposal(new0),
            sub_log_weight=jnp.asarray(-jnp.inf, f32),
            sub_r_sum=jnp.zeros((dim,), r0.dtype),
            sub_leaf=jnp.asarray(0, jnp.int32),
            going_right=jnp.asarray(False),
            iter_idx=jnp.asarray(1, jnp.int32),
            r_ckpts=jnp.zeros((max_tree_depth, dim), r0.dtype),
            r_sum_ckpts=jnp.zeros((max_tree_depth, dim), r0.dtype),
        )

        def cond(c: _NutsCarry):
            return ~c.turning & ~c.diverging & (c.depth < max_tree_depth)

        def body(c: _NutsCarry) -> _NutsCarry:
            starting = c.sub_leaf == 0  # first pair of a new subtree?
            # This pair's four uniforms (direction, two within-subtree takes,
            # across-subtree move) come from the pregenerated table, selected
            # by a masked reduction rather than ``U[c.iter_idx]``: under the
            # chain vmap a per-chain dynamic index lowers to a serialized
            # row gather, while the masked (n_slots, 4) reduce is a ~3 us
            # fully-vectorized pass at 4096 chains.
            u4 = jnp.sum(
                jnp.where((slots_u == c.iter_idx)[:, None], U, 0.0), axis=0
            )
            going_right = jnp.where(starting, u4[0] < 0.5, c.going_right)
            eps_signed = jnp.where(going_right, eps, -eps)

            # Integrate from the tree's outgoing edge when starting a
            # subtree, else from the last integration point. Single fused
            # 3-way select per field (vs two chained 2-way tree_maps).
            base = jax.tree_util.tree_map(
                lambda l, r, s: jnp.where(
                    starting, jnp.where(going_right, r, l), s
                ),
                c.left, c.right, c.sub_last,
            )
            # Leaf A (even index within the subtree).
            new1 = leapfrog(base, eps_signed, inv_mass)
            div1, lw1, acc1 = leaf_energy(new1)
            # Leaf B (odd). If leaf A diverged the unpaired loop would have
            # stopped before B — gate every contribution of B on ~div1 so
            # the pair is semantically identical to two sequential leaves.
            new2 = leapfrog(new1, eps_signed, inv_mass)
            div2, lw2, acc2 = leaf_energy(new2)
            b_valid = ~div1
            div2 = b_valid & div2

            # Progressive uniform-multinomial proposal update, both leaves.
            prev_lw = jnp.where(starting, -jnp.inf, c.sub_log_weight)
            lw_a = jnp.logaddexp(prev_lw, lw1)
            p_take1 = jnp.exp(lw1 - lw_a)
            p_take1 = jnp.where(jnp.isnan(p_take1), 0.0, p_take1)
            take1 = (~div1) & (u4[1] < p_take1)
            lw_b = jnp.logaddexp(lw_a, lw2)
            p_take2 = jnp.exp(lw2 - lw_b)
            p_take2 = jnp.where(jnp.isnan(p_take2), 0.0, p_take2)
            take2 = b_valid & (~div2) & (u4[2] < p_take2)
            sub_lw = jnp.where(b_valid, lw_b, lw_a)
            # One fused 3-way select per field: B's take supersedes A's.
            sub_proposal = jax.tree_util.tree_map(
                lambda b2, a1, p: jnp.where(
                    take2, b2, jnp.where(take1, a1, p)
                ),
                _as_proposal(new2),
                _as_proposal(new1),
                c.sub_proposal,
            )

            leaf_a = jnp.where(starting, 0, c.sub_leaf)  # even leaf index
            leaf_b = leaf_a + 1
            sum_a = jnp.where(starting, 0.0, c.sub_r_sum) + new1.r
            sum_b = sum_a + jnp.where(b_valid, new2.r, 0.0)

            # Checkpoint bookkeeping: leaf A stores, leaf B checks.
            # Stored via a masked full-array write, NOT ``.at[ckpt_idx].set``:
            # under the chain vmap the slot index is a per-chain traced value,
            # so a dynamic-index update lowers to a scatter over
            # (chains, T, D), which serializes and dominated the bookkeeping
            # where it was measured. The masked write is T-times the bytes of
            # one slot but fully vectorized.
            ckpt_idx = _popcount(leaf_a)
            slots = jnp.arange(max_tree_depth, dtype=jnp.int32)
            hit = (slots == ckpt_idx)[:, None]  # (T, 1)
            r_ckpts = jnp.where(hit, new1.r[None, :], c.r_ckpts)
            r_sum_ckpts = jnp.where(hit, sum_a[None, :], c.r_sum_ckpts)
            sub_turn = b_valid & _leaf_turning_check(
                leaf_b, sum_b, new2.r, r_ckpts, r_sum_ckpts, inv_mass
            )

            # Subtree completes when it has 2^depth leaves or stops early.
            target = jnp.left_shift(jnp.asarray(1, jnp.int32), c.depth)
            pair_div = div1 | div2
            complete = (leaf_b + 1 >= target) | sub_turn | pair_div
            valid = ~sub_turn & ~pair_div

            # --- merge into the tree (masked; applies where complete) ---
            # Biased progressive transition: favor the new half-trajectory.
            p_move = jnp.exp(jnp.minimum(sub_lw - c.log_weight, 0.0))
            p_move = jnp.where(jnp.isnan(p_move), 0.0, p_move)
            move = complete & valid & (u4[3] < p_move)
            proposal = jax.tree_util.tree_map(
                lambda a, b: jnp.where(move, a, b), sub_proposal, c.proposal
            )
            # The subtree's outermost point is leaf B. (When leaf A diverged
            # new2 is one leapfrog past a diverged state and may be garbage,
            # but `diverging` exits the loop this iteration and the edges
            # are never consumed afterwards.)
            upd_left = complete & ~going_right
            upd_right = complete & going_right
            left = jax.tree_util.tree_map(
                lambda a, b: jnp.where(upd_left, a, b), new2, c.left
            )
            right = jax.tree_util.tree_map(
                lambda a, b: jnp.where(upd_right, a, b), new2, c.right
            )
            r_sum_tree = jnp.where(complete, c.r_sum + sum_b, c.r_sum)
            turning_full = _is_turning(r_sum_tree, left.r, right.r, inv_mass)
            turning = jnp.where(
                complete, sub_turn | (valid & turning_full), c.turning
            )
            diverging = jnp.where(complete, pair_div, c.diverging)
            log_weight = jnp.where(
                complete, jnp.logaddexp(c.log_weight, sub_lw), c.log_weight
            )

            return _NutsCarry(
                left=left,
                right=right,
                proposal=proposal,
                log_weight=log_weight,
                r_sum=r_sum_tree,
                depth=c.depth + complete.astype(jnp.int32),
                turning=turning,
                diverging=diverging,
                sum_accept=c.sum_accept
                + acc1
                + jnp.where(b_valid, acc2, 0.0),
                num_leaves=c.num_leaves + 1 + b_valid.astype(jnp.int32),
                sub_last=new2,
                sub_proposal=sub_proposal,
                sub_log_weight=sub_lw,
                sub_r_sum=sum_b,
                sub_leaf=jnp.where(complete, 0, leaf_b + 1),
                going_right=going_right,
                iter_idx=c.iter_idx + 1,
                r_ckpts=r_ckpts,
                r_sum_ckpts=r_sum_ckpts,
            )

        if static_schedule:
            # Fixed trip count: run 2^(max_tree_depth-1) - 1 pair iterations
            # always (the peeled root leaf runs unconditionally), freezing
            # the carry once the dynamic loop would have exited. The wasted
            # iterations still evaluate the (masked-out) leapfrogs, keeping
            # any in-likelihood collective schedule uniform: every chain row
            # executes exactly 2 likelihood evaluations per iteration.
            def scan_body(c, _):
                active = cond(c)
                c_next = jax.tree_util.tree_map(
                    lambda a, b: jnp.where(active, a, b), body(c), c
                )
                return c_next, None

            tree, _ = jax.lax.scan(
                scan_body, carry0, None,
                length=(1 << (max_tree_depth - 1)) - 1,
            )
        else:
            tree = jax.lax.while_loop(cond, body, carry0)

        # The proposal carries its cached density/gradient (see _Proposal) —
        # no recompute needed; the data-sharded collective schedule stays
        # uniform (zero extra likelihood evaluations per draw on every row).
        new_state = HMCState(
            position=tree.proposal.z,
            log_prob=tree.proposal.log_prob,
            grad=tree.proposal.grad,
        )
        accept_prob = tree.sum_accept / jnp.maximum(
            tree.num_leaves.astype(jnp.float32), 1.0
        )
        info = TransitionInfo(
            accept_prob=accept_prob,
            is_accepted=tree.num_leaves > 0,
            is_divergent=tree.diverging,
            energy=energy0,
            log_prob=new_state.log_prob,
            num_integration_steps=tree.num_leaves,
            tree_depth=tree.depth,
            step_size=eps,
        )
        return new_state, info

    return init_fn, step_fn
