"""Smoke test of the NUTS engine on one NVIDIA GPU: the quickest proof that
the system still starts on the card and gives right answers there.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --four-gpus  # four cards: only the multi-card path

Phases, in order; any failure fails the script (non-zero exit, no result
line):

1. Device: JAX version, ``device_kind``, and the card's name and power
   limit from ``nvidia-smi`` (run in a child that does not import JAX).
   The tests marked ``gpu`` run next, in a child, before this process
   opens the card (one JAX process on a card at a time).
2. Kernel parity at real widths, against a reference computed at
   ``precision=HIGHEST`` in float32 with the log-likelihood summed in
   float64 on the host, and ms/call of the kernel and of the XLA version.
3. Main path through ``bench.py``'s own ``build_problem``/``_bench_config``:
   ``glm100_fused`` at its full config, then ``poisson1000_cov`` at full
   width with shortened warmup and draws.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
With no GPU the script exits non-zero before any phase; it never falls
back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# docs/DESIGN.md §4b: the value path's absolute log-likelihood error must
# stay near (1 - target_accept) / 10 nats, or dual averaging shrinks the
# step size against noise it cannot reduce.
GLM_LL_TOL = 0.02  # target_accept 0.8 (the GLM cells)
POISSON_LL_TOL = 0.01  # target_accept 0.9 (the Poisson regression cell)
# The gradient's residual is rounded to bf16 before X^T r (relative 2^-9
# per row, independent across rows), so its relative error norm sits well
# below 0.2%; 1e-2 leaves a margin and still catches a wrong term.
GRAD_REL_TOL = 1e-2
ACCEPT_TOL = 0.05
# Multi-card comparisons: the same seeds and settings, compared by the
# posterior they give. Bit-exactness holds on the CPU mesh; on the GPU each
# card's shapes pick their own kernel grid and GEMM algorithms, so chains
# part ways after the first rounding-flipped NUTS/HMC decision (the first
# four-card run matched only 2.9% of draws to 1e-3). Every parameter's mean
# over all draws must agree within MULTI_Z standard errors, where the
# standard error comes from the spread of per-chain means (independent
# across chains whatever the autocorrelation); |z| over ~100 parameters
# stays below ~3.5 for two independent runs. The pooled step sizes, each an
# average over thousands of chains, must agree within MULTI_STEP_RTOL.
MULTI_Z = 5.0
MULTI_STEP_RTOL = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except OSError as e:
        fail(f"nvidia-smi not available ({e}): no GPU here")
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def run_gpu_tests() -> None:
    env = dict(os.environ, MLX_MCMC_TEST_GPU="1")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "-rs"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    tail = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
    log(f"gpu-marked tests: {tail}")
    check(out.returncode == 0 and "skipped" not in tail,
          f"gpu-marked tests failed:\n{out.stdout[-4000:]}{out.stderr[-2000:]}")


def time_ms(fn, *args, reps: int = 20) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


# ---------------------------------------------------------------- phase 2


def glm_parity(n: int, d: int, c: int, seed: int) -> None:
    import jax
    import jax.numpy as jnp

    from mlx_mcmc_tpu.ops.pallas.glm import (
        KERNEL_D,
        make_fused_logistic_vag,
        prepare_fused_logistic_data,
    )

    # Outcomes drawn from true coefficients, and chain states near them:
    # the sampler's typical set, where the §4b budget applies. (At states far
    # from the posterior the bf16 tensor-core product's float32 accumulation
    # leaves a systematic, smooth offset in s that sums to ~0.02 nats at
    # 10^5 rows; near the posterior its weight y - sigmoid(s) averages out.)
    kx, ky, kb, kz = jax.random.split(jax.random.PRNGKey(seed), 4)
    X = (jax.random.normal(kx, (n, d)) / math.sqrt(d)).astype(jnp.bfloat16)
    beta = jax.random.normal(kb, (d,))
    y = jax.random.bernoulli(
        ky, jax.nn.sigmoid(X.astype(jnp.float32) @ beta)
    ).astype(jnp.float32)
    Z = (beta + 0.05 * jax.random.normal(kz, (c, d))).astype(jnp.bfloat16)
    Z = Z.astype(jnp.float32)
    data = prepare_fused_logistic_data(X, y)

    hi = jax.lax.Precision.HIGHEST
    Xf = X.astype(jnp.float32)

    @jax.jit
    def reference(Z):
        s = jnp.dot(Z, Xf.T, precision=hi)  # (C, N)
        t = y * s - jax.nn.softplus(s)
        g = jnp.dot(y - jax.nn.sigmoid(s), Xf, precision=hi)
        return t, g

    t_ref, g_ref = reference(Z)
    ll_ref = np.asarray(t_ref).astype(np.float64).sum(axis=1)
    g_ref = np.asarray(g_ref, np.float64)
    del t_ref
    times = {}
    impls = ("pallas", "xla") if data["Xp"].shape[1] == KERNEL_D else ("xla",)
    for impl in impls:
        vag = make_fused_logistic_vag(
            data_aware=True, include_prior=False, impl=impl
        )
        fn = jax.jit(jax.vmap(vag, in_axes=(0, None)))
        ll, g = fn(Z, data)
        ll_err = float(np.max(np.abs(np.asarray(ll, np.float64) - ll_ref)))
        g_err = float(np.max(
            np.linalg.norm(np.asarray(g, np.float64) - g_ref, axis=1)
            / np.linalg.norm(g_ref, axis=1)
        ))
        times[impl] = time_ms(fn, Z, data)
        log(f"glm parity N={n} D={d} C={c} {impl}: ll abs err {ll_err:.3e} "
            f"(tol {GLM_LL_TOL}), grad rel err {g_err:.3e} "
            f"(tol {GRAD_REL_TOL}), {times[impl]:.4f} ms/call")
        check(ll_err <= GLM_LL_TOL, f"glm {impl} ll error {ll_err}")
        check(g_err <= GRAD_REL_TOL, f"glm {impl} grad error {g_err}")
    log(f"glm N={n} D={d} C={c}: " + ", ".join(
        f"{'kernel' if k == 'pallas' else k} {v:.4f} ms/call"
        for k, v in times.items()))


def poisson_reference_f64(Z, y, X) -> np.ndarray:
    """Full log-posterior of the hierarchical Poisson regression in f64."""
    from scipy.special import gammaln

    Z = np.asarray(Z, np.float64)
    y = np.asarray(y, np.float64)
    X = np.asarray(X, np.float64)  # (G, n, K)
    G, _, K = X.shape
    const = -gammaln(y + 1.0).sum()
    out = np.empty(Z.shape[0])
    half_log2pi = 0.5 * math.log(2.0 * math.pi)
    for i, z in enumerate(Z):
        beta, log_tau, mu, theta_raw = z[:K], z[K], z[K + 1], z[K + 2:]
        s = (mu + math.exp(log_tau) * theta_raw)[:, None] + X @ beta
        ll = (y * s - np.exp(s)).sum() + const
        prior = (
            -math.log(5.0) - half_log2pi - 0.5 * (mu / 5.0) ** 2
            - half_log2pi - 0.5 * log_tau**2
            - G * half_log2pi - 0.5 * (theta_raw**2).sum()
            - K * half_log2pi - 0.5 * (beta**2).sum()
        )
        out[i] = ll + prior
    return out


def poisson_parity(c: int = 512) -> None:
    import jax
    import jax.numpy as jnp

    from mlx_mcmc_tpu.models import make_poisson_event_rates
    from mlx_mcmc_tpu.ops.poisson import (
        make_fused_poisson_vag,
        prepare_fused_poisson_data,
    )
    from mlx_mcmc_tpu.utils.roofline import bound_seconds

    spec = make_poisson_event_rates(
        num_groups=1000, obs_per_group=100, covariate_dim=4, seed=0
    )
    data = prepare_fused_poisson_data(spec.y, spec.X)
    G, n, K = spec.X.shape
    # States near the posterior, where the sampler spends its time: group
    # log-rates at their data estimates, beta and the hyperparameters near
    # the generating values. (Far from it, un-centred residuals make every
    # float32 sum larger than the budget is about.)
    rng = np.random.default_rng(1)
    shat = np.log(np.maximum(np.asarray(spec.y).mean(axis=1), 1e-3))
    mu = 1.0 + rng.normal(0.0, 0.02, (c, 1))
    log_tau = np.log(0.5) + rng.normal(0.0, 0.02, (c, 1))
    Z = np.concatenate([
        np.asarray(spec.truth["beta"]) + rng.normal(0.0, 0.02, (c, K)),
        log_tau,
        mu,
        (shat[None, :] - mu) / np.exp(log_tau) + rng.normal(0.0, 0.05, (c, G)),
    ], axis=1).astype(np.float32)
    fn = jax.jit(jax.vmap(make_fused_poisson_vag(), in_axes=(0, None)))
    lp, g = fn(jnp.asarray(Z), data)
    check(bool(np.all(np.isfinite(np.asarray(g)))), "poisson grad not finite")
    ref = poisson_reference_f64(Z, spec.y, spec.X)
    diff = np.asarray(lp, np.float64) - ref
    # One offset shared by every chain (the float32 rounding of the data
    # constant c0) cancels in every acceptance ratio; what must stay small
    # is the state-dependent part.
    offset = float(np.median(diff))
    err = float(np.max(np.abs(diff - offset)))
    ms = time_ms(fn, jnp.asarray(Z), data)
    N = G * n
    # Bytes the evaluation must move: covariates, counts, centring rates,
    # the chain batch in and the gradient out.
    must_move = 4.0 * (N * K + N + 2 * G + 2 * c * (K + 2 + G))
    flops = 12.0 * N * c  # K multiply-adds, exp, residual and 4 sums
    t_mem = must_move / 3.35e12
    t_bound, side = bound_seconds(flops, must_move, jax.devices()[0],
                                  operand_dtype=np.float32,
                                  highest_precision=True)
    log(f"poisson parity G={G} n={n} K={K} C={c} xla: ll abs err "
        f"{err:.3e} after shared offset {offset:.3e} (tol {POISSON_LL_TOL}), "
        f"{ms:.4f} ms/call; HBM bound of must-move bytes "
        f"{t_mem * 1e3:.4f} ms ({100 * t_mem * 1e3 / ms:.2f}% reached); "
        f"roofline bound {t_bound * 1e3:.4f} ms ({side}, "
        f"{100 * t_bound * 1e3 / ms:.2f}% reached)")
    check(err <= POISSON_LL_TOL, f"poisson ll error {err}")


# ---------------------------------------------------------------- phase 3


def main_path(name: str, target: float, **overrides) -> None:
    import bench

    cfg = dict(bench.CONFIGS[name], **overrides)
    cfg["label"] = cfg["label"].format(chains=cfg["num_chains"])
    m, _ = bench._bench_config(cfg)
    keys = ("min_ess", "wall_seconds", "ess_per_sec", "divergences",
            "mean_accept", "mean_tree_depth", "compile_seconds",
            "peak_bytes_in_use")
    log(f"main path {name} {json.dumps({k: m.get(k) for k in keys})}")
    if "roofline" in m:
        log(f"main path {name} roofline {json.dumps(m['roofline'])}")
    check(math.isfinite(m["min_ess"]) and m["min_ess"] > 0,
          f"{name}: min-ESS {m['min_ess']}")
    check(abs(m["mean_accept"] - target) <= ACCEPT_TOL,
          f"{name}: mean accept {m['mean_accept']} vs target {target}")
    return m


# ------------------------------------------------------------- four cards


def compare_runs(what: str, a, b, step_a, step_b, seconds: float) -> None:
    """Check that two runs sample the same posterior (see MULTI_Z)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    a = a.reshape(a.shape[0], a.shape[1], -1)
    b = b.reshape(b.shape[0], b.shape[1], -1)
    ma, mb = a.mean(axis=1), b.mean(axis=1)  # per-chain means (C, P)
    se = np.sqrt((ma.var(axis=0, ddof=1) + mb.var(axis=0, ddof=1))
                 / ma.shape[0])
    z = float(np.max(np.abs(ma.mean(axis=0) - mb.mean(axis=0)) / se))
    step_rel = abs(float(np.mean(step_a)) / float(np.mean(step_b)) - 1.0)
    same = float(np.mean(np.all(np.abs(a - b) <= 1e-3, axis=-1)))
    log(f"four-gpu {what}: max |z| of posterior means {z:.3f} (tol "
        f"{MULTI_Z}), step size rel diff {step_rel:.2e} (tol "
        f"{MULTI_STEP_RTOL}), {100 * same:.2f}% of draws within 1e-3, "
        f"bit-exact {bool(np.array_equal(a, b))}, {seconds:.1f} s")
    check(z <= MULTI_Z, f"{what}: posterior means differ, max |z| {z}")
    check(step_rel <= MULTI_STEP_RTOL, f"{what}: step sizes differ")


def four_gpus() -> None:
    import jax
    import jax.numpy as jnp

    import bench
    from mlx_mcmc_tpu import sample
    from mlx_mcmc_tpu.ops.pallas.glm import (
        fused_data_specs,
        make_fused_logistic_vag,
        prepare_fused_logistic_data,
    )
    from mlx_mcmc_tpu.parallel import chain_mesh, data_chain_mesh, sample_sharded

    check(len(jax.devices()) >= 4, f"--four-gpus needs 4 cards, JAX sees "
          f"{len(jax.devices())}")
    # The flagship model (bf16 X, fused vag), NUTS with pooled adaptation:
    # the pmean/psum path across cards is what multi-card users rely on.
    cfg = bench.CONFIGS["glm100_fused"]
    log_prob, init, data, extra = bench.build_problem(cfg)
    nuts = dict(num_samples=100, num_warmup=100, num_chains=cfg["num_chains"],
                kernel="nuts", seed=0, max_tree_depth=cfg["max_tree_depth"],
                data=data, **extra)
    t0 = time.time()
    four = sample_sharded(log_prob, init, mesh=chain_mesh(4), **nuts)
    one = sample_sharded(log_prob, init, mesh=chain_mesh(1), **nuts)
    compare_runs(f"NUTS chain mesh, 4 vs 1 card, {cfg['num_chains']} chains",
                 four.samples["beta"], one.samples["beta"],
                 four.tunables.step_size, one.tunables.step_size,
                 time.time() - t0)

    X = data["Xp"][: cfg["num_obs"], : cfg["num_features"]]
    y = data["yp"][: cfg["num_obs"], 0]
    sharded_data = prepare_fused_logistic_data(X, y, num_shards=2)
    single_data = prepare_fused_logistic_data(X, y)

    def prior(params):
        beta = params["beta"]
        return -0.5 * jnp.sum(beta**2) - 0.5 * beta.shape[0] * math.log(
            2 * math.pi
        )

    def local_ll(params, d):
        beta = params["beta"]
        k = d["dim"].shape[0]
        s = jnp.dot(d["Xp"][:, :k], beta.astype(d["Xp"].dtype),
                    preferred_element_type=jnp.float32)
        return jnp.sum(d["yp"][:, 0] * s - jax.nn.softplus(s)) + d["pad_const"]

    hmc = dict(num_samples=100, num_warmup=100, num_chains=512, kernel="hmc",
               num_leapfrog_steps=16, seed=0)
    t0 = time.time()
    sharded = sample_sharded(
        local_ll, init, mesh=data_chain_mesh(2, 2), data=sharded_data,
        data_axis="data", data_specs=fused_data_specs(sharded_data, "data"),
        log_prior_fn=prior,
        value_and_grad_fn=make_fused_logistic_vag(
            data_aware=True, include_prior=False),
        **hmc,
    )
    single = sample(
        lambda p, d: local_ll(p, d) + prior(p), init, data=single_data,
        value_and_grad_fn=make_fused_logistic_vag(
            data_aware=True, include_prior=True),
        **hmc,
    )
    compare_runs("HMC 2x2 ('chains','data') mesh vs 1 card, 512 chains",
                 sharded.samples["beta"], single.samples["beta"],
                 sharded.tunables.step_size, single.tunables.step_size,
                 time.time() - t0)


# ------------------------------------------------------------------- main


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the multi-card path and its one-card "
                         "comparison, on four cards")
    args = ap.parse_args()
    try:
        import jax

        import bench  # noqa: F401
        import mlx_mcmc_tpu  # noqa: F401
    except ImportError as e:
        fail(f"cannot import the program ({e}); run from the repo root")

    log(f"jax {jax.__version__}")
    smi = nvidia_smi()
    log(f"nvidia-smi: {smi}")
    if not args.four_gpus:
        run_gpu_tests()
    devices = jax.devices()
    device = devices[0]
    check(device.platform == "gpu",
          f"JAX found no GPU (platform {device.platform!r})")
    from mlx_mcmc_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    log(f"device_kind {device.device_kind}, {len(devices)} device(s)")

    if args.four_gpus:
        four_gpus()
    else:
        glm_parity(10_000, 100, 4096, seed=0)
        glm_parity(100_000, 1000, 256, seed=1)
        poisson_parity()
        m = main_path("glm100_fused", 0.8)
        check(m["divergences"] == 0,
              f"glm100_fused: {m['divergences']} divergences")
        main_path("poisson1000_cov", 0.9, num_warmup=200, num_samples=200)
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
