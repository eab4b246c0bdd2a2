"""Where JAX keeps its persistent compilation cache.

Compiled kernels (whose shapes are bucketed to powers of two throughout
``ops/``) are reused across runs, so only the first run of a checkout pays
the compile time.  One rule for every entry point (CLI, API, benchmark,
chip smoke):

- ``JAX_COMPILATION_CACHE_DIR`` set: the cache goes there and nowhere else;
- unset: the cache goes to ``.jax_cache`` at the root of the checkout, a
  fixed path (never the home directory, a temporary directory, a pid or a
  time), so a later run of the same checkout finds it again.
"""

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def compile_cache_dir() -> str:
    """The directory the cache belongs in, by the rule above."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    :func:`compile_cache_dir` and return that directory.  Takes effect
    for compilations after the call."""
    import jax

    cache_dir = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return cache_dir
