"""Where the persistent XLA compilation cache lives.

Entry points (the CLI, bench.py, chip_smoke.py) call
`enable_compile_cache` once before compiling anything.  The directory is
part of the cache's key, so it is a fixed path, never one derived from a
temporary name, a process id or the time.
"""

from __future__ import annotations

import os

import jax

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory.

    `JAX_COMPILATION_CACHE_DIR`, when set, is honoured as it is: JAX
    reads it itself, and nothing else is set.  Otherwise the cache goes
    to `<repo>/.jax_cache` (listed in .gitignore)."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
