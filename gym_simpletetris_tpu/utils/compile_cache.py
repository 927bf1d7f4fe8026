"""The one place that decides where JAX keeps its persistent compile cache.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set. Otherwise the cache lives
at the fixed ``<checkout>/.jax_cache`` (gitignored): a fixed path, never a
temporary or per-process one, so a later process on the same checkout finds
what an earlier one compiled. Entry points (``chip_smoke.py``, ``bench.py``,
``__graft_entry__.py`` and the ``train`` CLIs) call
:func:`enable_compile_cache` before their first compile; library code never
sets a cache.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """The cache directory this process should use."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    and return that path."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
