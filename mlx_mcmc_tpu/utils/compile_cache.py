"""JAX's persistent compilation cache for the entry points.

A cold NUTS program (warmup scan + sampling scan + device ESS) takes long
to compile; the persistent cache lets a second process skip that. Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this module
sets no other directory. Otherwise the cache lives at the fixed path
``<repo>/.jax_cache`` (listed in ``.gitignore``): the path is part of
what makes a later process find the entries, so it never holds a
temporary directory, a process id or a time.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory it uses."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
