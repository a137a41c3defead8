"""Multi-process distributed runtime test (SURVEY.md §2.3).

Spawns two OS processes that initialize ``jax.distributed`` over localhost
TCP through :func:`mlx_mcmc_tpu.parallel.initialize_distributed` — the actual
multi-host code path, which the reference lacks entirely
(TECHNICAL_OVERVIEW.md:206-222). Each worker asserts global device
visibility; a cross-process collective additionally runs when the jax build
supports CPU collectives (gloo).
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "_distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_initialize_and_collective():
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    # The workers start from tests/; put the repo root on their path so
    # they import the package from this checkout.
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, env.get("PYTHONPATH")) if p
    )
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(pid), "2", str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for pid in range(2)
    ]
    outputs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outputs.append(out)

    for pid, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"INIT_OK pid={pid} local=2 global=4" in out, out
        assert f"DONE pid={pid}" in out, out
        # The cross-process collective MUST run and verify: this jax build
        # ships gloo CPU collectives (verified 2026-08). A build without them
        # must say so explicitly via MLX_MCMC_TPU_ALLOW_PSUM_SKIP=1 — the
        # §2.3 checkmark is not allowed to hollow out silently.
        if f"PSUM_OK pid={pid}" not in out:
            assert f"PSUM_SKIP pid={pid}" in out, out
            if os.environ.get("MLX_MCMC_TPU_ALLOW_PSUM_SKIP") == "1":
                pytest.skip(f"cross-process psum skipped by worker:\n{out}")
            raise AssertionError(
                "cross-process psum did not run (set "
                "MLX_MCMC_TPU_ALLOW_PSUM_SKIP=1 only for jax builds without "
                f"CPU collectives):\n{out}"
            )
