"""Device-batched minh reads: decode whole columns through the device
pipeline.

The host reader (formats/minh.py) decodes block-by-block in numpy; for
bulk reads this module gathers the packed payloads (host IO), then
unpacks + dequantizes all blocks of a column in batched width-specialized
device calls (ops/codec.py), bucketed by (block length, width).

Dither: the device counter-hash stream keyed on (seed, global block
id) -- deterministic (see ops/codec.dither_hash_u) and the same
stream the host reader computes, so every mode is bit-identical to the
host reader.
"""

from __future__ import annotations

import numpy as np

from ..core import types as ctypes_
from ..ops import bitpack, codec
from . import minh as minh_mod

__all__ = ["read_floats", "read_ints"]


def _gather_raw(reader, c: int):
    """Collect (payload, min, bits, n, params) of every block of column
    c, in block order."""
    blocks = []
    for b in range(reader.blocks):
        blocks.append(reader.f.raw_block(reader._block_idx(c, b)))
    return blocks


def read_floats(reader: minh_mod.Reader, names, dither: str = None,
                seed: int = None):
    """Read float columns via batched device decode; returns
    {name: float32 array} over all blocks concatenated (equivalent to
    reader.floats).  ``dither``/``seed`` default to the READER's
    configured mode, so device bulk reads agree bitwise with
    ``reader.floats`` however the file was opened (one defined stream,
    docs/FORMAT.md section 6)."""
    if dither is None:
        dither = reader.f.dither
    if seed is None:
        seed = reader.f.seed
    out = {}
    for name in names:
        c = reader._col(name)
        col = reader.columns[c]
        ctypes_.type_match(np.empty(0, np.float32), col.type)
        raw = _gather_raw(reader, c)
        parts = [None] * len(raw)

        buckets: dict = {}
        for b, (payload, mn, bits, n, params) in enumerate(raw):
            buckets.setdefault((n, bits), []).append(b)

        for (n, bits), ids in buckets.items():
            w = max(bitpack.words_per_block(bits, n), 1)
            words = np.zeros((len(ids), w), dtype=np.uint32)
            mins = np.empty(len(ids), np.int64)
            lows = np.empty(len(ids), np.float32)
            highs = np.empty(len(ids), np.float32)
            pixels = np.empty(len(ids), np.int64)
            periodic = np.empty(len(ids), bool)
            for row, b in enumerate(ids):
                payload, mn, _, _, params = raw[b]
                if bits:
                    words[row] = bitpack.bytes_to_words(payload, bits, n)
                mins[row] = mn
                lows[row], highs[row], pixels[row], periodic[row] = params
            # dither keys use the CONTAINER block index -- the same id
            # the host reader passes (core/reader.py data(b)), so host
            # and device uniform-dither reads agree bitwise
            block_ids = np.asarray(
                [reader._block_idx(c, b) for b in ids], np.int64)
            dec = codec.decode_float_bucket(
                words, mins, lows, highs, pixels, periodic, block_ids,
                bits, n, dither=dither, seed=seed)
            for row, b in enumerate(ids):
                parts[b] = dec[row]

        arr = np.concatenate(parts) if parts else \
            np.empty(0, np.float32)
        if col.log != 0:
            arr = np.float32(np.power(10.0, arr.astype(np.float64)))
        out[name] = arr
    return out


def read_ints(reader: minh_mod.Reader, names):
    """Read int columns via batched device decode."""
    out = {}
    for name in names:
        c = reader._col(name)
        ctypes_.type_match(np.empty(0, np.int64),
                           reader.columns[c].type)
        raw = _gather_raw(reader, c)
        parts = [None] * len(raw)
        buckets: dict = {}
        for b, (payload, mn, bits, n, params) in enumerate(raw):
            buckets.setdefault((n, bits), []).append(b)
        for (n, bits), ids in buckets.items():
            w = max(bitpack.words_per_block(bits, n), 1)
            words = np.zeros((len(ids), w), dtype=np.uint32)
            mins = np.empty(len(ids), np.int64)
            for row, b in enumerate(ids):
                payload, mn, _, _, _ = raw[b]
                if bits:
                    words[row] = bitpack.bytes_to_words(payload, bits, n)
                mins[row] = mn
            dec = np.asarray(codec.decode_int_blocks(
                words, mins, int(bits), int(n)))
            for row, b in enumerate(ids):
                parts[b] = dec[row]
        out[name] = np.concatenate(parts) if parts else \
            np.empty(0, np.int64)
    return out
