"""Where the persistent XLA compilation cache lives.

One rule for every entry point (the CLI, bench.py, chip_smoke.py): when
JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is set
here; otherwise the cache goes to the fixed path <checkout>/.jax_cache.
The directory is part of what a later run must find again, so it never
depends on the working directory.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
