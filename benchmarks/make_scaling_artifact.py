"""Produce the scaling artifact (default ``chiprun_out/scaling.json``).

Two measured tables (BASELINE.md north star: >= 90% linear scaling of
effective samples/s; the reference promises this workload table at
README.md:105-113 but never measured it):

1. ``chain_scaling``: single-chip throughput vs chain count on the flagship
   glm100_fused config, on the GPU. Each row is its own ``bench.py``
   process, run one after another: this parent never opens the card (a
   JAX process reserves most of its memory), and takes the device from
   each child's JSON.
2. ``weak_scaling``: benchmarks/scaling.py weak scaling over the 'chains'
   mesh axis. On real multi-chip hardware this measures the target; on the
   8-device virtual CPU mesh (this environment) it REHEARSES the measurement
   end-to-end — harness, collectives and shardings identical, absolute
   numbers meaningless (all "devices" share one socket); the artifact labels
   which one it is.

Usage: timeout 7200 python benchmarks/make_scaling_artifact.py [out.json]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _checked(out: "subprocess.CompletedProcess", what: str) -> str:
    """Fail loudly with the subprocess stderr — a silent StopIteration from
    a missing output line would otherwise eat the real cause after a
    40-minute artifact run."""
    if out.returncode != 0:
        raise RuntimeError(
            f"{what} failed (exit {out.returncode}):\n{out.stderr[-4000:]}"
        )
    return out.stdout

CHAIN_ROWS = [
    # (chains, num_samples, thin): every row runs thin=1 with the bf16 draw
    # store (bench.py glm100_fused store_dtype). num_samples is fixed at
    # 500 across rows so the warmup amortization is identical.
    (1024, 500, 1),
    (2048, 500, 1),
    (4096, 500, 1),
    (8192, 500, 1),
]


def run_bench_row(chains: int, num_samples: int, thin: int) -> dict:
    env = dict(
        os.environ,
        BENCH_CONFIG="glm100_fused",
        BENCH_CHAINS=str(chains),
        BENCH_SAMPLES=str(num_samples),
        BENCH_THIN=str(thin),
        BENCH_SKIP_FUNNEL="1",
    )
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        env=env, capture_output=True, text=True, timeout=3600,
    )
    stdout = _checked(out, f"bench row chains={chains}")
    line = [ln for ln in stdout.splitlines() if ln.startswith("{")][-1]
    rec = json.loads(line)
    d = rec["detail"]
    return {
        "num_chains": chains,
        "num_samples": num_samples,
        "thin": thin,
        "min_ess_per_sec": rec["value"],
        "wall_seconds": d["wall_seconds"],
        "min_ess": d["min_ess"],
        "divergences": d["divergences"],
        "mfu_pct": d.get("roofline", {}).get("mfu_pct"),
        "device": d["device"],
    }


def collective_overhead_cpu() -> dict:
    """Run the repeated-subtraction collective harness (VERDICT r4 #5:
    N>=20 reps on the only non-oversubscribed layout pair, median +- IQR;
    subprocess because platform selection must precede first backend use)."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks",
                                      "collective_overhead.py"), "--repeat"],
        cwd=REPO, capture_output=True, text=True, timeout=3600,
    )
    lines = _checked(out, "collective_overhead").splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("{"))
    return json.loads("\n".join(lines[start:]))


def weak_scaling_cpu() -> list:
    """Run the weak-scaling harness in a subprocess (platform selection must
    happen before first backend use, so it cannot share this process)."""
    code = (
        "import os, json;"
        "os.environ['XLA_FLAGS']=os.environ.get('XLA_FLAGS','')"
        "+' --xla_force_host_platform_device_count=8';"
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from benchmarks.scaling import measure_scaling;"
        "rows=measure_scaling([1,2,4,8], chains_per_shard=8,"
        " num_warmup=200, num_samples=200, kernel='nuts');"
        "print('ROWS='+json.dumps(rows))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO,
        capture_output=True, text=True, timeout=3600,
    )
    stdout = _checked(out, "weak_scaling")
    line = [ln for ln in stdout.splitlines() if ln.startswith("ROWS=")][-1]
    return json.loads(line[len("ROWS="):])


def main() -> None:
    out_path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        REPO, "chiprun_out", "scaling.json"
    )
    chain_rows = []
    for chains, num_samples, thin in CHAIN_ROWS:
        row = run_bench_row(chains, num_samples, thin)
        chain_rows.append(row)
        print(row, flush=True)
    base = chain_rows[0]
    for row in chain_rows:
        ideal = row["num_chains"] / base["num_chains"]
        row["efficiency_vs_1024"] = round(
            (row["min_ess_per_sec"] / base["min_ess_per_sec"]) / ideal, 3
        )

    weak = weak_scaling_cpu()
    collective = collective_overhead_cpu()
    artifact = {
        "chain_scaling": {
            "config": "glm100_fused (NUTS, 100-param logistic GLM, 10K obs, "
                      "bf16 fused value+grad, max_tree_depth=6)",
            "device": chain_rows[0]["device"],
            "note": "one GPU; ESS on device; efficiency is "
                    "(essps/essps_1024)/(chains/1024)",
            "rows": chain_rows,
        },
        "weak_scaling": {
            "config": "hier100 non-centered hierarchical, NUTS, "
                      "8 chains/shard, shards 1/2/4/8",
            "device": "8-device virtual CPU mesh (rehearsal: collectives and "
                      "shardings identical to multi-chip, absolute numbers "
                      "are not hardware-meaningful)",
            "efficiency_caveat": (
                "this host has 2 PHYSICAL cores: the 4- and 8-shard rows "
                "oversubscribe 2-4x, so the efficiency column measures "
                "host contention, NOT collective cost — it is a harness "
                "rehearsal, not a scaling claim. The isolated collective "
                "cost is in the collective_overhead section."
            ),
            "rows": weak,
        },
        "collective_overhead": collective,
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(artifact, f, indent=1)
    print("wrote", out_path)


if __name__ == "__main__":
    main()
