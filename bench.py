"""Flagship benchmark: NUTS effective samples/sec/chip on GLM posteriors.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "ess/s", "vs_baseline": N}

Configs (select with BENCH_CONFIG env var or argv[1]):
    glm100_fused (default): 100 params, 10K obs, 4096 chains, bf16 fused
                       value+grad — the flagship
    glm100           : same posterior, plain XLA f32 path
    glm1000 / glm1000_fused : 1000 params, 100K obs — BASELINE.md large
    hier1000 / hier1000_full : 1000-param non-centered hierarchical, ~100K obs
    poisson1000      : 1000-group Poisson rates, suffstat collapse
    poisson1000_cov  : + covariates (non-collapsible), hand-written value+grad
    funnel8          : centered eight-schools funnel (divergence stress)
The default run also measures the funnel stress benchmark and reports it in
the detail (divergence counts keep the friendly-GLM headline honest).

Baseline derivation (see BASELINE.md — the reference publishes no rigorous
numbers): the reference's claimed medium-model wall time (100 params,
10K obs) is 120 s on M3 Pro CPU (README.md:105-113) for a standard
1000-draw run; its measured ESS fraction is ~5.3% (PROGRESS.md:80-82,
264/5000), giving ~53 effective samples / 120 s ~= 0.44 ess/s. The large
config's implied baseline is 30 min for the same run shape ~= 0.03 ess/s
(README.md:105-113 "Large model" row). `vs_baseline` divides by these.

Data is passed to the sampler as a runtime argument (`sample(..., data=...)`)
rather than a closure constant — closure constants are serialized into the
program body, which bloats compilation for multi-hundred-MB design
matrices.

bench.py measures the GPU only: with no GPU it exits non-zero. Run it on
the card as `python bench.py [config]`; `BENCH_VAG_IMPL=xla` runs a fused
config's value+grad as the plain XLA version instead of the kernel.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

CONFIGS = {
    # Same posterior as glm100_fused on the plain path: float32 X and
    # autodiff through the model's log_prob.
    "glm100": dict(
        num_features=100, num_obs=10_000, num_chains=4096,
        num_warmup=500, num_samples=500, max_tree_depth=8,
        baseline_ess_per_sec=0.44, fused=False,
        label="min-ESS/sec/chip, NUTS 100-param logistic GLM (10K obs, {chains} chains)",
    ),
    # FLAGSHIP (default): bf16 design matrix + the fused value+grad
    # (ops/pallas/glm.py), same posterior as glm100.
    # max_tree_depth=6 is a config choice, not a bias: adapted trajectories
    # U-turn at depth 3, so 2^6-1=63 leapfrogs leave ample headroom, and
    # smaller checkpoint buffers cut the while-loop carry.
    # num_warmup=300: with 4096 chains the dual-averaging and Welford
    # statistics are pooled across the whole batch every step, so windowed
    # adaptation converges far faster than single-chain Stan defaults
    # assume; min-ESS was flat across 200-500 warmup steps with 0
    # divergences, and 300 keeps a margin over the shortest validated
    # schedule.
    # num_samples=2000 + bf16 draw store: min-ESS/s amortizes the fixed
    # warmup cost over the draw phase (ESS per draw is constant), so longer
    # runs report the sampler's steady-state throughput. The
    # 4096x2000x100 store is 1.6 GB in bf16 (engine store_dtype); device
    # ESS upcasts per param-chunk.
    "glm100_fused": dict(
        num_features=100, num_obs=10_000, num_chains=4096,
        num_warmup=300, num_samples=2000, max_tree_depth=6,
        baseline_ess_per_sec=0.44, fused=True, store_dtype="bfloat16",
        label=(
            "min-ESS/sec/chip, NUTS 100-param logistic GLM "
            "(10K obs, {chains} chains, bf16 fused value+grad)"
        ),
    ),
    "glm1000": dict(
        num_features=1000, num_obs=100_000, num_chains=16,
        num_warmup=400, num_samples=400, max_tree_depth=8,
        baseline_ess_per_sec=0.03, fused=False,
        label="min-ESS/sec/chip, NUTS 1000-param logistic GLM (100K obs, 16 chains)",
    ),
    # bf16 design matrix at 1000 features: the dispatch sends D_pad = 1024
    # to the plain XLA value+grad (bf16 operands, f32 accumulation); the
    # Triton kernel covers D_pad = 128 only (PERF.md).
    "glm1000_fused": dict(
        num_features=1000, num_obs=100_000, num_chains=256,
        num_warmup=400, num_samples=400, max_tree_depth=8,
        baseline_ess_per_sec=0.03, fused=True,
        label=(
            "min-ESS/sec/chip, NUTS 1000-param logistic GLM "
            "(100K obs, {chains} chains, bf16 fused value+grad)"
        ),
    ),
    # BASELINE.md north-star scaling config: 1000-param non-centered
    # hierarchical (mu + log_tau + 998 group effects, ~100K obs). The
    # reference names this workload (README.md:105-113 "Large model",
    # 30 min => ~0.03 ess/s) but ships no code for it.
    # r4: the Gaussian group likelihood collapses EXACTLY to per-group
    # sufficient statistics (ops/suffstats.py) — the whole O(N)=99.8K data
    # reduction hoists to data prep, so a leapfrog costs O(chains x G)
    # elementwise work with a closed-form gradient. This is the "fused
    # kernel" for this model class; after the collapse the benchmark is
    # NUTS-bookkeeping-bound, not bandwidth-bound (VERDICT r3 #5).
    # hier1000_full keeps the full-data XLA path for comparison.
    # min-ESS is bottlenecked by the slow global params mu/log_tau, so the
    # draw axis (1000 draws) is the cheap ESS lever.
    "hier1000": dict(
        family="hier", num_groups=998, obs_per_group=100, suffstats=True,
        num_chains=512, num_warmup=400, num_samples=1000, max_tree_depth=10,
        baseline_ess_per_sec=0.03, fused=False, store_dtype="bfloat16",
        label=(
            "min-ESS/sec/chip, NUTS 1000-param non-centered hierarchical "
            "(99.8K obs, {chains} chains, sufficient-statistic likelihood)"
        ),
    ),
    "hier1000_full": dict(
        family="hier", num_groups=998, obs_per_group=100, suffstats=False,
        num_chains=128, num_warmup=400, num_samples=400, max_tree_depth=10,
        baseline_ess_per_sec=0.03, fused=False,
        label=(
            "min-ESS/sec/chip, NUTS 1000-param non-centered hierarchical "
            "(99.8K obs, {chains} chains, full-data likelihood)"
        ),
    ),
    # Poisson event rates at the Large-model scale (reference examples/04's
    # scenario x 20,000: 1000 hierarchical group rates, 100 counts each).
    # The shared-rate likelihood is exponential-family, so the O(N)=100K
    # data reduction collapses EXACTLY to per-group sufficient statistics
    # (ops/suffstats.py make_poisson_rates_model) — the Poisson sibling of
    # hier1000. target_accept=0.9 keeps the exp-link curvature divergence
    # rate at zero.
    "poisson1000": dict(
        family="poisson", num_groups=1000, obs_per_group=100,
        num_chains=512, num_warmup=400, num_samples=1000, max_tree_depth=10,
        baseline_ess_per_sec=0.03, fused=False, store_dtype="bfloat16",
        target_accept=0.9,
        label=(
            "min-ESS/sec/chip, NUTS 1000-group hierarchical Poisson rates "
            "(100K obs, {chains} chains, sufficient-statistic likelihood)"
        ),
    ),
    # The NON-collapsible Poisson row: per-observation covariates
    # (exp(theta_g + x.beta)) force full-data evaluations; ops/poisson.py
    # writes value, per-group gradient and covariate gradient as one XLA
    # expression with a float32-exact linear predictor.
    "poisson1000_cov": dict(
        family="poisson", num_groups=1000, obs_per_group=100,
        covariate_dim=4, num_chains=512, num_warmup=400, num_samples=400,
        # healthy trees U-turn at depth 5 with the f32-exact linear
        # predictor (ops/poisson.py: a rounded predictor injects nats of
        # ll noise, collapsing eps and slamming every tree into the cap);
        # depth 8 leaves 8x headroom.
        max_tree_depth=8, baseline_ess_per_sec=0.03, fused=True,
        store_dtype="bfloat16", target_accept=0.9,
        label=(
            "min-ESS/sec/chip, NUTS 1000-group hierarchical Poisson "
            "regression (100K obs, {chains} chains, hand-written value+grad)"
        ),
    ),
    # Funnel-geometry stress benchmark: centered eight schools. Reported
    # alongside the friendly GLM so the headline is not flattered by
    # well-conditioned geometry alone; divergence counts are the point.
    "funnel8": dict(
        family="funnel", num_chains=1024, num_warmup=500, num_samples=500,
        max_tree_depth=10, baseline_ess_per_sec=None, fused=False,
        label=(
            "min-ESS/sec/chip, NUTS centered eight-schools funnel "
            "({chains} chains)"
        ),
    ),
}


def build_problem(cfg):
    """Return (log_prob(params, data), initial_params, data, extra_kwargs)."""
    import jax
    import jax.numpy as jnp

    from mlx_mcmc_tpu.distributions import Normal

    family = cfg.get("family", "glm")
    extra = {}
    if family == "glm":
        from mlx_mcmc_tpu.models import make_logistic_regression

        spec = make_logistic_regression(
            num_features=cfg["num_features"], num_obs=cfg["num_obs"], seed=0
        )
        if cfg["fused"]:
            from mlx_mcmc_tpu.ops.pallas.glm import (
                make_fused_logistic_vag,
                prepare_fused_logistic_data,
            )

            data = prepare_fused_logistic_data(
                spec.X.astype(jnp.bfloat16), spec.y,
                tile_n=cfg.get("tile_n", 1024),
            )
            extra["value_and_grad_fn"] = make_fused_logistic_vag(
                prior_scale=1.0, data_aware=True, impl=cfg.get("impl")
            )

            def log_prob(params, data):
                # value path (init/energy): same density the fused vag computes
                beta = params["beta"]
                d = data["dim"].shape[0]
                s = jnp.dot(
                    data["Xp"][:, :d], beta.astype(data["Xp"].dtype),
                    preferred_element_type=jnp.float32,
                )
                ll = jnp.sum(data["yp"][:, 0] * s - jax.nn.softplus(s))
                return (
                    ll + data["pad_const"]
                    + jnp.sum(Normal(0.0, 1.0).log_prob(beta))
                )

        else:
            from mlx_mcmc_tpu.ops.dispatch import value_precision

            data = {"X": spec.X, "y": spec.y}

            def log_prob(params, data):
                beta = params["beta"]
                s = jnp.dot(
                    data["X"], beta, precision=value_precision(data["X"].dtype),
                    preferred_element_type=jnp.float32,
                )
                return jnp.sum(data["y"] * s - jax.nn.softplus(s)) + jnp.sum(
                    Normal(0.0, 1.0).log_prob(beta)
                )

        return log_prob, spec.initial_params, data, extra

    if family == "hier":
        from mlx_mcmc_tpu.models import make_hierarchical_normal

        spec = make_hierarchical_normal(
            num_groups=cfg["num_groups"],
            obs_per_group=cfg["obs_per_group"],
            seed=0,
        )
        if cfg.get("suffstats"):
            from mlx_mcmc_tpu.ops.suffstats import (
                hier_suffstat_log_prob,
                make_hier_normal_vag,
                prepare_hier_normal_data,
            )

            data = prepare_hier_normal_data(spec.y)
            extra["value_and_grad_fn"] = make_hier_normal_vag()
            return (
                hier_suffstat_log_prob, spec.initial_params, data, extra
            )
        data = {"y": spec.y}  # (G, obs) — runtime arg, not closure constant

        def log_prob(params, data):
            mu, log_tau = params["mu"], params["log_tau"]
            theta_raw = params["theta_raw"]
            tau = jnp.exp(log_tau)
            theta = mu + tau * theta_raw
            lp = Normal(0.0, 5.0).log_prob(mu)
            lp += Normal(0.0, 1.0).log_prob(log_tau)
            lp += jnp.sum(Normal(0.0, 1.0).log_prob(theta_raw))
            lp += jnp.sum(Normal(theta[:, None], 1.0).log_prob(data["y"]))
            return lp

        return log_prob, spec.initial_params, data, extra

    if family == "poisson":
        from mlx_mcmc_tpu.models import make_poisson_event_rates

        spec = make_poisson_event_rates(
            num_groups=cfg["num_groups"],
            obs_per_group=cfg["obs_per_group"],
            covariate_dim=cfg.get("covariate_dim", 0),
            seed=0,
        )
        if cfg.get("covariate_dim", 0) > 0:
            # non-collapsible: hand-written full-data value+grad
            from mlx_mcmc_tpu.ops.poisson import (
                make_fused_poisson_model,
                prepare_fused_poisson_data,
            )

            data = prepare_fused_poisson_data(spec.y, spec.X)
            log_prob, vag = make_fused_poisson_model()
        else:
            # exponential family: exact sufficient-statistic collapse
            from mlx_mcmc_tpu.ops.suffstats import (
                make_poisson_rates_model,
                prepare_poisson_rates_data,
            )

            data = prepare_poisson_rates_data(spec.y)
            log_prob, vag = make_poisson_rates_model()
        extra["value_and_grad_fn"] = vag
        return log_prob, spec.initial_params, data, extra

    if family == "funnel":
        from mlx_mcmc_tpu.models import eight_schools

        spec = eight_schools(centered=True)

        def log_prob(params, data):
            del data
            return spec.log_prob(params)

        return log_prob, spec.initial_params, {}, extra

    raise ValueError(f"unknown family: {family!r}")


def _mfu_detail(result, cfg, data, wall: float, device) -> dict:
    """Roofline accounting for the GLM value+grad hot op
    (``mlx_mcmc_tpu.utils.roofline`` does the device-peak math).

    Counts only *useful* flops (per-chain true leapfrog counts summed from
    ``num_integration_steps``; vmapped NUTS actually runs lockstep to the
    slowest chain, so hardware utilization is >= this). Warmup leapfrogs are
    not recorded (`collect_warmup=False`); they are estimated at the sampling
    phase's mean steps/draw — flagged as an estimate in the output.
    """
    from mlx_mcmc_tpu.utils.roofline import (
        glm_vag_bytes,
        glm_vag_flops,
        roofline_report,
    )

    steps = np.asarray(result.info.num_integration_steps, np.float64)
    sampling_leapfrogs = float(steps.sum())  # sum over (chains, draws)
    # With thin>1 each stored draw aggregates `thin` transitions' counters,
    # so the sampling phase covers num_samples*thin steps.
    scale = 1.0 + cfg["num_warmup"] / (cfg["num_samples"] * cfg.get("thin", 1))
    total_leapfrogs = sampling_leapfrogs * scale
    # Lockstep accounting (VERDICT r3 #1): the vmapped while-loop runs every
    # chain until the LAST chain's tree completes, so the hardware executes
    # `1 + 2 * max_chains(ceil((leaves-1)/2))` leapfrogs per draw (paired-
    # leaf loop: one peeled root + 2 per iteration) while only the per-chain
    # true tree sizes are statistically useful. executed/useful is the
    # lockstep tax; executed_mfu = useful_mfu * tax is what the card actually
    # sustains. Only exact at thin=1 (thinned draws aggregate counters).
    lockstep = None
    if cfg.get("thin", 1) == 1:
        iters = np.ceil(np.maximum(steps - 1.0, 0.0) / 2.0)  # (C, S)
        exec_leaves = float(np.sum(1.0 + 2.0 * iters.max(axis=0)))
        lockstep = exec_leaves * cfg["num_chains"] / sampling_leapfrogs
    if cfg["fused"]:
        X = data["Xp"]  # padded dims: real kernel work
        x_reads = 2.0 if cfg.get("impl") == "xla" else 1.0
    else:
        X = data["X"]
        x_reads = 2.0
    n_eff, d_eff = X.shape
    flops = total_leapfrogs * glm_vag_flops(n_eff, d_eff)
    # X is streamed once per *call* (all chains share it); the fused
    # kernel reads it once per leapfrog, the plain path twice.
    calls = total_leapfrogs / cfg["num_chains"]
    bytes_total = calls * glm_vag_bytes(n_eff, d_eff, X.dtype.itemsize, x_reads)
    out = {
        "total_leapfrogs": int(total_leapfrogs),
        "flop_count": "useful (per-chain true tree sizes; warmup estimated)",
    }
    out.update(roofline_report(
        flops, bytes_total, wall, device, operand_dtype=X.dtype,
        highest_precision=X.dtype == np.float32,
    ))
    if lockstep is not None:
        out["lockstep_tax"] = round(lockstep, 3)
        out["executed_mfu_pct"] = round(out["mfu_pct"] * lockstep, 2)
        out["wasted_leapfrog_pct"] = round(100.0 * (1.0 - 1.0 / lockstep), 1)
    return out


def _bench_config(cfg, target_accept=0.8):
    """Measure one config; returns (metrics dict, result) with warm compile
    excluded and all statistics computed on device (only small vectors are
    fetched — BENCH_HOST_ESS=1 restores the fetch-everything path).
    ``compile_seconds`` is the first (cold) call's wall minus the timed
    warm call's wall."""
    import jax
    from mlx_mcmc_tpu import sample
    from mlx_mcmc_tpu.diagnostics import effective_sample_size

    target_accept = cfg.get("target_accept", target_accept)
    log_prob, initial_params, data, extra = build_problem(cfg)

    def run(seed):
        return sample(
            log_prob,
            initial_params,
            data=data,
            num_samples=cfg["num_samples"],
            num_warmup=cfg["num_warmup"],
            num_chains=cfg["num_chains"],
            kernel="nuts",
            seed=seed,
            max_tree_depth=cfg["max_tree_depth"],
            target_accept=target_accept,
            # thin>1 keeps every thin-th draw: the draw store is the
            # device-memory ceiling at very wide chain counts (8192 chains x
            # 500 draws x 100 params f32 = 1.6GB), so thinning trades stored
            # draws for chains. ESS is computed on the stored draws.
            thin=cfg.get("thin", 1),
            store_dtype=cfg.get("store_dtype"),
            draw_chunk=cfg.get("draw_chunk"),
            **extra,
        )

    host_ess = bool(os.environ.get("BENCH_HOST_ESS"))
    if not host_ess:
        import jax.numpy as jnp
        from mlx_mcmc_tpu.diagnostics.device import device_ess

        @jax.jit
        def ess_fn(samples):
            # min-ESS across EVERY parameter (not just the largest block).
            # The FFT autocovariance materializes a (chains, pad, W)
            # complex64 intermediate per param-chunk; cap that at ~1 GB by
            # slicing the param axis (static python loop inside the jit —
            # works for ANY param count; the old reshape-into-4 path
            # required P % 4 == 0 and OOMed the 998-param hierarchical at
            # 1024 chains: 1024 x 2048pad x 998 c64 = 16 GB). bf16-stored
            # draws upcast per-slice, keeping the f32 copy off the
            # whole-store peak.
            ess_f32 = lambda v: device_ess(v.astype(jnp.float32))  # noqa: E731
            outs = []
            for v in samples.values():
                v3 = v.reshape(v.shape[0], v.shape[1], -1)
                p = v3.shape[-1]
                pad = 1 << (2 * v3.shape[1] - 1).bit_length()
                max_w = max(1, int(5e8 / (v3.shape[0] * pad * 8)))
                if p <= max_w:
                    outs.append(ess_f32(v3))
                else:
                    outs.append(
                        jnp.concatenate(
                            [
                                ess_f32(v3[..., i:i + max_w])
                                for i in range(0, p, max_w)
                            ]
                        )
                    )
            return jnp.concatenate(outs)

    def all_ess_host(samples):
        return np.concatenate(
            [
                effective_sample_size(
                    np.asarray(v).reshape(v.shape[0], v.shape[1], -1)
                )
                for v in samples.values()
            ]
        )

    # Warm the compile cache, then time a fresh run end-to-end (warmup +
    # sampling; ESS counted over post-warmup draws only).
    t_cold = time.time()
    result = run(0)
    if host_ess:
        np.asarray(next(iter(result.samples.values()))).ravel()[0]
    else:
        np.asarray(ess_fn(result.samples))  # warm ESS compile too
    t_cold = time.time() - t_cold

    t0 = time.time()
    result = run(1)
    if host_ess:
        samples = {k: np.asarray(v) for k, v in result.samples.items()}
        wall = time.time() - t0
        ess = all_ess_host(samples)
    else:
        ess = np.asarray(ess_fn(result.samples))  # small fetch only
        wall = time.time() - t0
    min_ess = float(np.min(ess))

    metrics = {
        "wall_seconds": round(wall, 2),
        "min_ess": round(min_ess, 1),
        "median_ess": round(float(np.median(ess)), 1),
        "ess_per_sec": round(min_ess / wall, 2),
        "divergences": result.divergences,
        "divergence_rate": round(
            result.divergences
            / (cfg["num_chains"] * cfg["num_samples"]), 5
        ),
        "mean_accept": round(
            float(np.asarray(result.info.accept_prob).mean()), 3
        ),
        "mean_tree_depth": round(
            float(np.asarray(result.info.tree_depth).mean()), 2
        ),
        "ess_backend": "host" if host_ess else "device",
        "compile_seconds": round(t_cold - wall, 2),
    }
    stats = jax.devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        metrics["peak_bytes_in_use"] = int(stats["peak_bytes_in_use"])
    if cfg.get("family", "glm") == "glm":
        metrics["roofline"] = _mfu_detail(
            result, cfg, data, wall, jax.devices()[0]
        )
    return metrics, result


def main() -> None:
    import jax

    from mlx_mcmc_tpu.utils.compile_cache import enable_compile_cache

    device = jax.devices()[0]
    if device.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {device.platform!r}")
    enable_compile_cache()
    name = os.environ.get("BENCH_CONFIG") or (
        sys.argv[1] if len(sys.argv) > 1 else "glm100_fused"
    )
    cfg = CONFIGS[name]
    if os.environ.get("BENCH_CHAINS"):  # chain-count sweeps without editing
        cfg = dict(cfg, num_chains=int(os.environ["BENCH_CHAINS"]))
    if os.environ.get("BENCH_SAMPLES"):  # draw-count override (storage sweeps)
        cfg = dict(cfg, num_samples=int(os.environ["BENCH_SAMPLES"]))
    if os.environ.get("BENCH_WARMUP"):  # warmup-length override
        cfg = dict(cfg, num_warmup=int(os.environ["BENCH_WARMUP"]))
    if os.environ.get("BENCH_VAG_IMPL"):  # fused configs: "pallas" or "xla"
        cfg = dict(cfg, impl=os.environ["BENCH_VAG_IMPL"])
    if os.environ.get("BENCH_TILE"):  # row padding unit (fused configs)
        cfg = dict(cfg, tile_n=int(os.environ["BENCH_TILE"]))
    if os.environ.get("BENCH_DEPTH"):  # max_tree_depth sweeps
        cfg = dict(cfg, max_tree_depth=int(os.environ["BENCH_DEPTH"]))
    if os.environ.get("BENCH_THIN"):  # draw-store thinning (wide-chain runs)
        cfg = dict(cfg, thin=int(os.environ["BENCH_THIN"]))
    if os.environ.get("BENCH_CHUNK"):  # chunked draw storage (8192-row tests)
        cfg = dict(cfg, draw_chunk=int(os.environ["BENCH_CHUNK"]))
    cfg = dict(cfg, label=cfg["label"].format(chains=cfg["num_chains"]))

    metrics, _ = _bench_config(cfg)
    ess_per_sec = metrics.pop("ess_per_sec")
    detail = dict(
        metrics,
        device={"platform": device.platform, "kind": device.device_kind,
                "count": len(jax.devices())},
    )

    # Alongside the friendly GLM flagship, always measure the funnel-geometry
    # stress benchmark (centered eight schools) unless disabled — the
    # divergence counts and funnel ESS keep the headline honest.
    if cfg.get("family", "glm") == "glm" and not os.environ.get(
        "BENCH_SKIP_FUNNEL"
    ):
        fcfg = dict(CONFIGS["funnel8"], num_chains=512, num_warmup=400,
                    num_samples=400)
        fmetrics, _ = _bench_config(fcfg, target_accept=0.9)
        detail["funnel_eight_schools"] = fmetrics

    baseline = cfg["baseline_ess_per_sec"]
    print(
        json.dumps(
            {
                "metric": cfg["label"],
                "value": round(ess_per_sec, 2),
                "unit": "ess/s",
                "vs_baseline": (
                    round(ess_per_sec / baseline, 1) if baseline else None
                ),
                "detail": detail,
            }
        )
    )


if __name__ == "__main__":
    main()
