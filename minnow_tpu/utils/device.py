"""Device-path setup shared by the library and the ``--device`` CLIs.

* :func:`ensure_compile_cache` -- where JAX keeps its persistent
  compile cache.
* :func:`announce` -- the one line a ``--device`` CLI prints on stderr
  naming the platform and device kind it runs on.  There is no host
  fallback: if the JAX backend does not come up, the exception from
  ``jax.devices()`` propagates and the CLI fails.
"""

from __future__ import annotations

import os
import sys

__all__ = ["ensure_compile_cache", "announce"]

# <checkout>/.jax_cache (listed in .gitignore): a fixed path, never
# derived from a temp name, pid or time -- the path is part of the
# cache key
_DEFAULT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def ensure_compile_cache() -> None:
    """Point JAX's persistent compile cache at a fixed directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads it itself and
    nothing is set here.  Otherwise the cache goes to
    ``<checkout>/.jax_cache`` with no minimum compile time: the codec
    compiles one small graph per (width, block length) bucket, each
    under a second, and together they dominate a short CLI run."""
    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR") \
            or jax.config.jax_compilation_cache_dir:
        return
    os.makedirs(_DEFAULT_CACHE, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", _DEFAULT_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


def announce(tool: str) -> None:
    """Initialize the default backend and print, on stderr, the platform
    and ``device_kind`` a ``--device`` run uses."""
    import jax

    devs = jax.devices()
    print("%s: --device on %s (%s) x%d"
          % (tool, devs[0].platform, devs[0].device_kind, len(devs)),
          file=sys.stderr)
