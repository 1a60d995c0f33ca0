"""JAX's persistent compilation cache at one fixed place.

The cache key includes the cache path, so the directory must not move
between runs: it is ``JAX_COMPILATION_CACHE_DIR`` when that is set (JAX
reads the variable itself, so nothing is set in code), and otherwise
``<root>/.jax_cache`` under the caller's checkout.
"""

from __future__ import annotations

import os

ENV_VAR = 'JAX_COMPILATION_CACHE_DIR'


def compile_cache_dir(root, environ=None):
    """The directory to set in code, or None when ``ENV_VAR`` rules."""
    environ = os.environ if environ is None else environ
    if environ.get(ENV_VAR):
        return None
    return os.path.join(os.path.abspath(root), '.jax_cache')


def enable_compile_cache(root):
    """Turn the persistent cache on; returns the directory in use."""
    import jax
    cache_dir = compile_cache_dir(root)
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update('jax_compilation_cache_dir', cache_dir)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 1.0)
    jax.config.update('jax_persistent_cache_min_entry_size_bytes', -1)
    return cache_dir or os.environ[ENV_VAR]
