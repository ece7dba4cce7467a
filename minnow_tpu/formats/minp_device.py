"""Device-batched minp reads: decode a whole snapshot file's sub-cell
blocks through the device pipeline.

The host reader (formats/minp.py) decodes 3*subCells**3 blocks one at a
time; here each axis's blocks decode in width-bucketed batched device
calls (the read mirror of minp.Writer(encoder=...)), then one
reshape/transpose restores file order.  Bit-identical to the host
reader in every dither mode (one defined stream, docs/FORMAT.md
section 6); the default matches the host reader's ("uniform").
"""

from __future__ import annotations

import numpy as np

from ..ops import bitpack, codec
from . import minp as minp_fmt

__all__ = ["read_vectors"]


def read_vectors(reader: minp_fmt.Reader, dither: str = None,
                 seed: int = None) -> np.ndarray:
    """Equivalent of reader.vectors() via batched device decode.
    ``dither``/``seed`` default to the READER's configured mode, so
    device bulk reads agree bitwise with ``reader.vectors()`` however
    the file was opened."""
    if dither is None:
        dither = reader.f.dither
    if seed is None:
        seed = reader.f.seed
    s = reader.cell.sub_cells
    s3 = s * s * s
    if reader.f.blocks() != 3 * s3:
        raise ValueError("Expected %d sub-cell blocks, but got %d"
                         % (3 * s3, reader.f.blocks()))
    n_sub3 = reader.f.data_len(0)
    l = np.float32(reader.header.l)

    blocks = np.empty((s3, n_sub3, 3), dtype=np.float32)
    for k in range(3):
        raw = [reader.f.raw_block(k * s3 + sc) for sc in range(s3)]
        out_rows = np.empty((s3, n_sub3), np.float32)

        buckets: dict = {}
        for sc, (payload, mn, bits, n, params) in enumerate(raw):
            buckets.setdefault(bits, []).append(sc)

        for bits, ids in buckets.items():
            w = max(bitpack.words_per_block(bits, n_sub3), 1)
            words = np.zeros((len(ids), w), dtype=np.uint32)
            mins = np.empty(len(ids), np.int64)
            lows = np.empty(len(ids), np.float32)
            highs = np.empty(len(ids), np.float32)
            pixels = np.empty(len(ids), np.int64)
            periodic = np.empty(len(ids), bool)
            for row, sc in enumerate(ids):
                payload, mn, _, _, params = raw[sc]
                if bits:
                    words[row] = bitpack.bytes_to_words(payload, bits,
                                                        n_sub3)
                mins[row] = mn
                lows[row], highs[row], pixels[row], periodic[row] = params
            block_ids = np.asarray([k * s3 + sc for sc in ids], np.int64)
            dec = codec.decode_float_bucket(
                words, mins, lows, highs, pixels, periodic, block_ids,
                bits, n_sub3, dither=dither, seed=seed)
            for row, sc in enumerate(ids):
                out_rows[sc] = dec[row]

        if reader.periodic:
            out_rows = np.where(out_rows < 0, out_rows + l, out_rows)
            out_rows = np.where(out_rows >= l, out_rows - l, out_rows)
        blocks[:, :, k] = out_rows

    return minp_fmt.join_sub_cells(blocks, s)
