"""Device tier: the MICW wide-lane rANS container and its decode plan,
the entropy kernel, device encode, reference-format device decode and
mesh-sharded batch decode."""

import os
from pathlib import Path


def enable_compile_cache() -> None:
    """Give the process a persistent compilation cache.  Entry points
    call this; importing the library sets nothing.  When
    ``JAX_COMPILATION_CACHE_DIR`` is set JAX reads it itself and this
    does nothing; otherwise the cache is one fixed directory inside the
    checkout (``.jax_cache``, gitignored), so later runs find it."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    root = Path(__file__).resolve().parents[2]
    jax.config.update("jax_compilation_cache_dir", str(root / ".jax_cache"))
