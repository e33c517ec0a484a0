"""JAX process settings shared by the entry points."""

import os

from ..native.build import REPO_ROOT


def pinned_to_cpu():
    """True when the process is pinned to JAX's CPU backend
    (JAX_PLATFORMS=cpu): the tests and CPU-only runs."""
    return os.environ.get("JAX_PLATFORMS", "").strip() == "cpu"


def force_cpu():
    """Pin this process to the CPU backend before JAX is imported (host
    worker processes never touch the card)."""
    os.environ["JAX_PLATFORMS"] = "cpu"


def compile_cache_dir():
    """JAX_COMPILATION_CACHE_DIR when set, else build/jax_cache at the
    repository root (a fixed path, so later runs find their entries)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO_ROOT, "build", "jax_cache"))


def enable_persistent_compilation_cache():
    """Keep compiled launches across runs. JAX reads
    JAX_COMPILATION_CACHE_DIR itself when it is set; otherwise point it at
    compile_cache_dir(). CPU-pinned runs compile little and keep no cache."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR") or pinned_to_cpu():
        return
    import jax
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
