"""JAX runtime configuration helpers.

`enable_compilation_cache()` turns on JAX's persistent compilation cache,
so a process that compiles a program another process already compiled
loads it instead.  Where `JAX_COMPILATION_CACHE_DIR` is set, JAX already
uses that directory and nothing is changed; otherwise the cache lives at
a fixed path inside the checkout (`.jax_cache/`, git-ignored).  Called by
the device-path apps and the benchmark before their first jit.
"""
from __future__ import annotations

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CHECKOUT_CACHE_DIR = os.path.join(_REPO, ".jax_cache")

_done = False


def compilation_cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_compilation_cache():
    global _done
    if _done:
        return
    _done = True
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    os.makedirs(CHECKOUT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
