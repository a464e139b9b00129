"""One persistent XLA compilation cache for every entry point.

``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and wins:
nothing is configured here.  Otherwise the cache lives at
``<repo>/.jax_cache`` (git-ignored), a fixed path, so that repeat runs of
the CLI, the benchmarks and ``chip_smoke.py`` find each other's compiled
executables.
"""

from __future__ import annotations

import os
from typing import Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """``<repo>/.jax_cache``: next to the package directory."""
    import trigenicinteractionpredictor_tpu as pkg

    root = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    return os.path.join(root, ".jax_cache")


def enable_compile_cache() -> Optional[str]:
    """Point JAX at the cache directory; returns the directory in use.

    Sets nothing when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it
    itself).  Touches only configuration, never a backend, so it is safe
    to call before a process decides which device to use.
    """
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    import jax

    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
