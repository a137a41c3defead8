"""The entry points' own plumbing: the persistent compile cache and the
chip smoke script's refusal to run anywhere but on a GPU."""

import json
import os
import shutil
import subprocess
import sys

import jax

from mlx_mcmc_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestCompileCache:
    def test_env_var_honoured(self, monkeypatch, tmp_path):
        calls = []
        monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert calls == []  # JAX reads the variable itself

    def test_fixed_default_dir(self, monkeypatch):
        calls = []
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]
        assert compile_cache.enable_compile_cache() == path  # no pid/time

    def test_default_dir_is_git_ignored(self):
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "chip_smoke.py")], cwd=cwd,
        env=env, capture_output=True, text=True, timeout=300,
    )


def _says_ok(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return json.loads(lines[-1]).get("ok") is True
    except ValueError:
        return False


class TestChipSmoke:
    def test_fails_without_gpu(self):
        out = _run_smoke(REPO)
        assert out.returncode != 0
        assert not _says_ok(out.stdout)

    def test_fails_outside_the_repo(self, tmp_path):
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        out = _run_smoke(str(tmp_path))
        assert out.returncode != 0
        assert not _says_ok(out.stdout)
