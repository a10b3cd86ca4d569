"""Process-wide JAX settings that every entry point shares.

Importing the package calls ``configure_compile_cache`` once, so
scripts, ``bench.py`` and ``chip_smoke.py`` all keep compiled programs
in the same place.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT = Path(__file__).resolve().parent.parent
DEFAULT_CACHE_DIR = CHECKOUT / ".jax_cache"


def configure_compile_cache() -> str:
    """Persistent compilation cache directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads
    the variable itself; nothing else is set here).  Otherwise the cache
    goes to ``.jax_cache/`` at the root of the checkout — a fixed path,
    since the path is part of what a later process must find again.
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
