"""minnow-tpu: a JAX lossless codec framework for block-structured
scientific data.

Capabilities mirror phil-mansfield/minnow (reference: /root/reference):

* the minnow binary container -- interleaved user headers + typed data-block
  groups with a seekable tail index (ref go/writer.go, go/reader.go),
* bounded-precision float quantization, per-block min-subtraction integer
  coding and arbitrary-width (1-64 bit) bit-packing (ref go/group.go,
  go/bit/bit.go),
* the minh halo-catalog format incl. the spatial "boundary" layout
  (ref go/minh/) and the minp particle-snapshot format (ref go/minp/),
* text-catalog ingestion (Rockstar / consistent-trees) and LGadget-2
  binary snapshot interop (ref go/text/, go/minp/snapshot/),
* config/flag parsing, name standardization, CLI conversion pipelines
  (ref go/config/, scripts/).

Unlike the Go/Cython reference, all data transforms (quantize/dequantize,
delta coding, bit pack/unpack, sub-cell gather/scatter) run as JAX/XLA
programs on the accelerator (an NVIDIA GPU), with independent blocks
sharded data-parallel across a device mesh.  The byte format produced is identical to the reference writer
(see docs/FORMAT.md and core/spec.py for the normative semantics).

NOTE: importing ``minnow_tpu.ops`` or ``minnow_tpu.parallel`` enables
``jax_enable_x64``: the codec operates on int64 column data (halo IDs
exceed 2**32) and the container format is defined in terms of 64-bit
integers.  float32 quantization math is pinned with explicit dtypes
everywhere, so x64 does not change any on-disk bytes.  The top-level
package and all host-side paths (core readers/writers, formats, ingest,
CLI host mode) deliberately never import jax -- opening a file must not
initialize an accelerator runtime (or pay the multi-second import).
"""

__version__ = "0.1.0"

from . import core
from .core import spec
from .core.writer import Writer, create
from .core.reader import Reader, open  # noqa: A004 - mirrors reference API
from .core.types import (
    MAGIC,
    VERSION,
    INT64_GROUP,
    INT32_GROUP,
    INT16_GROUP,
    INT8_GROUP,
    UINT64_GROUP,
    UINT32_GROUP,
    UINT16_GROUP,
    UINT8_GROUP,
    FLOAT64_GROUP,
    FLOAT32_GROUP,
    INT_GROUP,
    FLOAT_GROUP,
    GROUP_NAMES,
    type_match,
)
