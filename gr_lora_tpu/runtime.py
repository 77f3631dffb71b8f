"""Process set-up shared by the entry points (``bench.py``,
``chip_smoke.py`` and the ``apps`` commands): JAX's persistent
compilation cache and the accelerator check of measuring runs."""

from __future__ import annotations

import os
from pathlib import Path

#: The cache's fixed home inside the checkout (listed in .gitignore).  The
#: directory is part of what makes a later process hit the cache, so it
#: never depends on a temporary name, a process id or the time.
REPO_CACHE_DIR = Path(__file__).resolve().parents[1] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here; otherwise the cache goes to ``<repo>/.jax_cache``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)


def require_gpu(what: str):
    """The first JAX device, which must be a GPU: a measuring run that
    finds none stops here rather than timing the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"{what} needs a GPU; JAX found platform {dev.platform!r} "
            f"({dev.device_kind})")
    return dev
