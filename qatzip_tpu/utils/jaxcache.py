"""Persistent XLA compile-cache setup.

The tokenizer compiles one XLA program per (batch-bucket, chunk-size)
pair and each compile takes seconds to minutes, so every process should
hit a warm on-disk cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory. Otherwise the cache lives in ``.jax_cache`` at
the root of the checkout (resolved from the package path, so every
process of one checkout shares it; the directory is git-ignored).

Note: XLA:CPU logs a ``cpu_aot_loader.cc`` "machine type mismatch" error
on persistent-cache loads — the "unsupported features" are XLA's own
injected tuning pseudo-flags (+prefer-no-scatter, +prefer-no-gather), not
real ISA bits. Benign.
"""

from __future__ import annotations

import os

_done = False

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def ensure_compile_cache() -> None:
    global _done
    if _done:
        return
    _done = True
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
