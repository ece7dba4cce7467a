"""Device-side (JAX/XLA) codec ops.

Importing this subpackage enables ``jax_enable_x64`` BEFORE any jax
backend initializes: the codec operates on int64 column data and the
container format is defined in terms of 64-bit integers (see the package
docstring).  Host-side paths never import this subpackage.
"""

import jax as _jax

_jax.config.update("jax_enable_x64", True)

from . import bitpack, codec  # noqa: E402
