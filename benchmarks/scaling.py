"""Scaling-efficiency harness: min-ESS/s vs shard count (BASELINE.md north
star: >= 90% linear scaling of effective samples/s on the 1000-param
hierarchical benchmark).

Weak scaling over the 'chains' mesh axis: chains-per-shard stays fixed, so
ideal scaling doubles min-ESS/s with every doubling of shards. ``efficiency``
is (essps / essps_base) / (shards / shards_base).

On real multi-chip hardware this measures the actual target; on the CPU
virtual mesh (tests, CI) it rehearses the measurement end-to-end — the
harness, collectives and shardings are identical, only the absolute numbers
are meaningless (all "devices" share one socket).

Usage:
    python benchmarks/scaling.py [--shards 1 2 4 8] [--chains-per-shard 8]
        [--model glm|hier] [--kernel nuts]
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np


def measure_scaling(
    shard_counts: Sequence[int],
    *,
    chains_per_shard: int = 8,
    num_warmup: int = 200,
    num_samples: int = 200,
    kernel: str = "nuts",
    seed: int = 0,
    model_fn: Optional[Callable] = None,
    verbose: bool = False,
) -> List[dict]:
    """Run the same workload at each shard count; return per-count metrics.

    ``model_fn() -> (log_prob, initial_params)``; defaults to a 100-group
    non-centered hierarchical normal (funnel-adjacent geometry, the
    BASELINE.md scaling benchmark family).
    """
    import jax

    from mlx_mcmc_tpu.diagnostics.device import device_ess
    from mlx_mcmc_tpu.parallel import chain_mesh, sample_sharded

    if model_fn is None:
        from mlx_mcmc_tpu.models import make_hierarchical_normal

        spec = make_hierarchical_normal(num_groups=100, obs_per_group=10, seed=0)
        model_fn = lambda: (spec.log_prob, spec.initial_params)  # noqa: E731

    log_prob, initial_params = model_fn()
    ess_fn = jax.jit(device_ess)
    rows: List[dict] = []
    for n in shard_counts:
        if n > len(jax.devices()):
            raise ValueError(
                f"shard count {n} exceeds {len(jax.devices())} devices"
            )
        mesh = chain_mesh(num_devices=n)
        num_chains = chains_per_shard * n

        def run(s):
            return sample_sharded(
                log_prob,
                initial_params,
                num_samples=num_samples,
                num_warmup=num_warmup,
                num_chains=num_chains,
                kernel=kernel,
                seed=s,
                mesh=mesh,
            )

        res = run(seed)  # compile + warm
        first = next(iter(res.samples))
        np.asarray(ess_fn(_flat2(res.samples[first])))  # warm ESS program

        t0 = time.time()
        res = run(seed + 1)
        ess = np.concatenate(
            [np.asarray(ess_fn(_flat2(v))) for v in res.samples.values()]
        )
        wall = time.time() - t0  # the ESS fetch synchronizes
        min_ess = float(ess.min())
        rows.append(
            {
                "shards": n,
                "num_chains": num_chains,
                "wall_seconds": round(wall, 3),
                "min_ess": round(min_ess, 1),
                "ess_per_sec": round(min_ess / wall, 2),
            }
        )
        if verbose:
            print(rows[-1], flush=True)

    base = rows[0]
    for row in rows:
        ideal = row["shards"] / base["shards"]
        row["efficiency"] = round(
            (row["ess_per_sec"] / base["ess_per_sec"]) / ideal, 3
        )
    return rows


def _flat2(v):
    """(chains, draws, *event) -> (chains, draws, K) for device_ess."""
    import jax.numpy as jnp

    v = jnp.asarray(v)
    if v.ndim == 2:
        return v[..., None]
    return v.reshape(v.shape[0], v.shape[1], -1)


def main() -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--shards", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--chains-per-shard", type=int, default=8)
    p.add_argument("--num-warmup", type=int, default=200)
    p.add_argument("--num-samples", type=int, default=200)
    p.add_argument("--kernel", default="nuts")
    p.add_argument("--model", choices=["glm", "hier"], default="hier")
    p.add_argument("--cpu", action="store_true",
                   help="force the virtual CPU mesh (8 devices)")
    args = p.parse_args()

    if args.cpu:
        import os

        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        )
        import jax

        jax.config.update("jax_platforms", "cpu")
    from mlx_mcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    model_fn = None
    if args.model == "glm":
        from mlx_mcmc_tpu.models import make_logistic_regression

        spec = make_logistic_regression(num_features=100, num_obs=10_000, seed=0)
        model_fn = lambda: (spec.log_prob, spec.initial_params)  # noqa: E731

    rows = measure_scaling(
        args.shards,
        chains_per_shard=args.chains_per_shard,
        num_warmup=args.num_warmup,
        num_samples=args.num_samples,
        kernel=args.kernel,
        model_fn=model_fn,
        verbose=True,
    )
    print(f"\n{'shards':>7} {'chains':>7} {'wall(s)':>9} {'min-ESS/s':>11} "
          f"{'efficiency':>11}")
    for r in rows:
        print(f"{r['shards']:>7} {r['num_chains']:>7} {r['wall_seconds']:>9.2f} "
              f"{r['ess_per_sec']:>11.1f} {r['efficiency']:>11.3f}")


if __name__ == "__main__":
    main()
