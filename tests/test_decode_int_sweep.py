"""Width sweep of the bulk int decode (ID columns: 33-64-bit deltas),
bitwise against the host reader: codec.decode_int_blocks, the route the
minh device reader runs, on blocks written by the host writer."""

import numpy as np
import pytest

import minnow_tpu as minnow
from minnow_tpu.ops import bitpack, codec


@pytest.mark.parametrize("bits", range(33, 65))
def test_decode_int_blocks(tmp_path, bits):
    rng = np.random.default_rng(bits)
    n = 77  # not a multiple of 32
    span = (1 << bits) - 1
    base = rng.integers(-(1 << 62), 1 << 62) if bits < 63 else 0
    d = rng.integers(0, 1 << 62, n, dtype=np.int64).view(np.uint64) \
        & np.uint64(span)
    # pin the width to ``bits`` (at 64: int64 min and max)
    d[:2] = [1 << 63, (1 << 63) - 1] if bits == 64 else [0, span]
    # deltas wrap modulo 2^64, as Go's int64 arithmetic does
    full = d.view(np.int64) + np.int64(base)
    narrow = base + rng.integers(0, 1 << 40, n)
    fname = str(tmp_path / "ids.minnow")
    w = minnow.create(fname)
    w.int_group(n)
    for x in (full, narrow):
        w.data(np.asarray(x, np.int64))
    w.close()

    r = minnow.open(fname)
    raw = [r.raw_block(b) for b in range(r.blocks())]
    assert raw[0][2] == bits
    for b, (payload, mn, width, _, _) in enumerate(raw):
        words = bitpack.bytes_to_words(payload, width, n)[None]
        got = np.asarray(codec.decode_int_blocks(
            words, np.array([mn], np.int64), width, n))[0]
        np.testing.assert_array_equal(got, r.data(b))
    r.close()
