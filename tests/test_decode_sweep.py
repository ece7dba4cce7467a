"""Width sweep of the bulk float decode the minh/minp device readers run
(codec.decode_float_bucket), bitwise against the host reader.

Every width 1-32 in dither modes ``none`` and ``uniform``: the widths up
to 24 take the all-32-bit route (int32 unpack + dequantize24), the wider
ones the generic f64 route.  Each case writes a container with the host
writer -- a full-range block, a periodic wrap cluster and a narrow
block, at a length that is not a multiple of 32 -- and decodes its raw
blocks in width buckets, as the readers do.
"""

import numpy as np
import pytest

import minnow_tpu as minnow
from minnow_tpu.ops import bitpack, codec


@pytest.mark.parametrize("dither", ["none", "uniform"])
@pytest.mark.parametrize("bits", range(1, 33))
def test_decode_float_blocks_matches_host_reader(tmp_path, bits, dither):
    rng = np.random.default_rng(bits)
    n = 77  # not a multiple of 32: the stream ends mid-word
    dx = 1 / 64
    pixels = 1 << bits
    high = pixels * dx
    q_full = rng.integers(0, pixels, n)
    q_full[:2] = [0, pixels - 1]  # pin the width to ``bits``
    half = max(pixels // 16, 1)
    q_wrap = np.concatenate([rng.integers(0, half, n // 2),
                             pixels - 1 - rng.integers(0, half,
                                                       n - n // 2)])
    q_narrow = pixels // 3 + rng.integers(0, max(pixels // 64, 1), n)
    fname = str(tmp_path / "sweep.minnow")
    w = minnow.create(fname)
    w.float_group(n, (0.0, high), dx)
    for q in (q_full, q_wrap, q_narrow):
        w.data(((q + 0.5) * dx).astype(np.float32))
    w.close()

    r = minnow.open(fname, dither=dither, seed=5)
    raw = [r.raw_block(b) for b in range(r.blocks())]
    assert raw[0][2] == bits
    buckets = {}
    for b, blk in enumerate(raw):
        buckets.setdefault(blk[2], []).append(b)
    for width, ids in buckets.items():
        words = np.zeros((len(ids), max(bitpack.words_per_block(width, n),
                                        1)), np.uint32)
        for row, b in enumerate(ids):
            if width:
                words[row] = bitpack.bytes_to_words(raw[b][0], width, n)
        params = [raw[b][4] for b in ids]
        got = codec.decode_float_bucket(
            words, np.array([raw[b][1] for b in ids], np.int64),
            np.array([p[0] for p in params], np.float32),
            np.array([p[1] for p in params], np.float32),
            np.array([p[2] for p in params], np.int64),
            np.array([p[3] for p in params], bool),
            np.array(ids, np.int64), width, n, dither=dither, seed=5)
        for row, b in enumerate(ids):
            want = r.data(b)
            np.testing.assert_array_equal(got[row].view(np.uint32),
                                          want.view(np.uint32))
    r.close()
