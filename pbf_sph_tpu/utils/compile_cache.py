"""Where JAX keeps its persistent compile cache.

`JAX_COMPILATION_CACHE_DIR`, when set, wins: JAX reads the variable itself
and nothing is set in code.  Otherwise the cache lives at a fixed path inside
the checkout (`<repo>/.jax_cache`, git-ignored), so every run of the CLI,
`bench.py`, `chip_smoke.py` or the tests finds what an earlier run compiled —
the path is part of the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir(subdir: str = "") -> str:
    """The cache directory in use: the variable's value if set, else
    `DEFAULT_DIR` (or a fixed `subdir` of it)."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    return str(DEFAULT_DIR / subdir if subdir else DEFAULT_DIR)


def enable_compile_cache(subdir: str = "") -> str:
    """Turn the persistent compile cache on and return its directory."""
    path = compile_cache_dir(subdir)
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
