"""Where JAX keeps its persistent compilation cache.

Every entry point (bench.py, chip_smoke.py, the apps and the tools) calls
`configure()` before its first compile. If JAX_COMPILATION_CACHE_DIR is set,
JAX reads it itself and no other directory is set; otherwise the cache lives
at `<checkout>/.jax_cache` (listed in .gitignore), a fixed path, so a second
run from the same checkout finds the first run's programs.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_dir(environ=os.environ) -> str:
    return environ.get(ENV) or os.path.join(CHECKOUT, ".jax_cache")


def configure() -> str:
    """Point JAX at `cache_dir()`; returns the directory."""
    import jax

    d = cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", d)
    return d
