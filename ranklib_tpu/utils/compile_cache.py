"""Persistent XLA compilation cache.

The fused boosting round is one large XLA program; compiling it costs
seconds per shape class, so every later process (reruns, benchmarks, CV
drivers) should reuse the executable. Where ``JAX_COMPILATION_CACHE_DIR``
is set, JAX places the cache itself and nothing here sets a path.
Otherwise the cache lives at ``<checkout>/.jax_cache`` (listed in
``.gitignore``): a fixed path, so it hits across processes. Off when
``RANKLIB_TPU_NO_CACHE`` is set.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache() -> None:
    if os.environ.get("RANKLIB_TPU_NO_CACHE"):
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        try:
            os.makedirs(DEFAULT_DIR, exist_ok=True)
        except OSError:         # read-only checkout: run uncached
            return
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
