"""
Process setup shared by the entry points (``chip_smoke.py``,
``bench.py``, ``python -m uf3_tpu md``, the scripts in
``benchmarks/``).

  * enable_compile_cache(): persistent XLA compilation cache at a
    fixed path.  Compiling an MD launch takes far longer than running
    it, so compiled executables are kept on disk.  The cache directory
    is part of what an entry is found by, so it never depends on a
    temporary name, a process id or the time.
  * require_gpu(): measurement scripts refuse to run anywhere but on a
    GPU; there is no silent CPU fallback.
"""

import os

import jax

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed here.  Otherwise the cache goes to the
    git-ignored ``<repo>/.jax_cache``.  Call before the first compile.
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR


def require_gpu(count: int = 1):
    """The JAX devices, or SystemExit when JAX finds fewer than
    ``count`` GPUs."""
    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu" or len(devices) < count:
        raise SystemExit(f"needs {count} GPU(s); JAX found "
                         f"{len(devices)} {platform} device(s)")
    return devices
