"""Width x length sweep of BlockEncoder's encode on a 4-device CPU mesh,
byte for byte against the host spec encoding (ref go/group.go:242-327,
go/bit/bit.go): the one device encode path the writers run.

Each batch holds 6 blocks (padded to 8 on the mesh): full-range, a
periodic wrap cluster, a narrow block, a short block, an empty block
and a non-periodic block -- so every width bucket and the masked tails
are exercised.  Blocks the device reduction cannot certify fall back to
the normative host scan.
"""

import numpy as np
import pytest

import jax

from minnow_tpu.core import spec
from minnow_tpu.parallel import BlockEncoder, mesh as mesh_lib


@pytest.fixture(scope="module")
def enc4():
    return BlockEncoder(mesh_lib.block_mesh(jax.devices()[:4]))


def _check_float(enc, x, low, high, pixels, lens, periodic, clamp_q=False):
    got = enc.encode_float_blocks(x, low, high, pixels, lens=lens,
                                  periodic=periodic, clamp_q=clamp_q)
    for i in range(x.shape[0]):
        payload, mn, bits, _ = spec.encode_float_block(
            x[i, :lens[i]], low, high, pixels, periodic=bool(periodic[i]),
            clamp_q=clamp_q)
        if lens[i] == 0:
            mn = 0
        assert got.payloads[i] == payload, i
        assert (int(got.mins[i]), int(got.bits[i])) == (mn, bits), i
    return got


@pytest.mark.parametrize("n", [77, 512, 16384])
@pytest.mark.parametrize("bits", [1, 7, 11, 18, 23, 31])
def test_encode_float_blocks_byte_exact(enc4, bits, n):
    rng = np.random.default_rng(bits * 100 + n)
    pixels = 1 << bits
    dx = 1 / 64
    low, high = 0.0, pixels * dx

    def vals(q):
        return ((q + 0.3) * dx).astype(np.float32)

    q = rng.integers(0, pixels, (6, n))
    q[0, :2] = [0, pixels - 1]
    half = max(pixels // 16, 1)
    q[1] = np.concatenate([rng.integers(0, half, n // 2),
                           pixels - 1 - rng.integers(0, half, n - n // 2)])
    q[2] = pixels // 3 + rng.integers(0, max(pixels // 64, 1), n)
    lens = np.array([n, n, n, max(n // 4, 1), 0, n], np.int64)
    periodic = np.array([True, True, True, True, True, False])
    got = _check_float(enc4, vals(q), low, high, pixels, lens, periodic)
    assert got.bits[0] == bits
    if bits >= 7:
        assert got.bits[1] < bits and got.bits[2] < bits


@pytest.mark.parametrize("n", [77, 4096])
@pytest.mark.parametrize("bits", [1, 11, 32, 33, 41, 45, 63, 64])
def test_encode_int_blocks_byte_exact(enc4, bits, n):
    rng = np.random.default_rng(bits * 7 + n)
    span = (1 << bits) - 1
    d = rng.integers(0, 1 << 62, (6, n), dtype=np.int64).view(np.uint64) \
        & np.uint64(span)
    d[0, :2] = [0, span]
    x = d.view(np.int64) + np.int64(-(10 ** 12))  # negative mins, wraps
    if bits == 64:
        x[0, :2] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max]
    x[3] = 7  # constant block: width 0
    lens = np.array([n, n, max(n // 3, 1), n, 0, 1], np.int64)
    got = enc4.encode_int_blocks(x, lens=lens)
    for i in range(6):
        payload, mn, width = spec.encode_int_block(x[i, :lens[i]])
        if lens[i] == 0:
            mn = 0
        assert got.payloads[i] == payload, i
        assert (int(got.mins[i]), int(got.bits[i])) == (mn, width), i
    assert got.bits[0] == bits and got.bits[3] == 0


@pytest.mark.parametrize("case", ["above_range", "below_range",
                                  "clamped_top"])
def test_encode_float_blocks_host_fallback(enc4, case):
    """Pixels outside [0, P) (reachable only through the raw float API)
    defeat the one-pass periodic reduction; those blocks are re-encoded
    by the normative host scan, the rest stay on the device path."""
    rng = np.random.default_rng(88)
    n = 512
    low, high, dx = 0.0, 250.0, 0.001
    pixels = spec.float_group_pixels(low, high, dx)
    x = rng.uniform(0, 249.9, (5, n)).astype(np.float32)
    clamp_q = False
    periodic = np.ones(5, bool)
    if case == "above_range":
        x[1, 5] = 260.0
    elif case == "below_range":
        x[2, 7] = -3.0
    else:
        # non-periodic data at the top edge: q == pixels is clamped
        x[3, 9] = np.float32(high)
        periodic[3] = False
        clamp_q = True
    _check_float(enc4, x, low, high, pixels, np.full(5, n, np.int64),
                 periodic, clamp_q=clamp_q)


@pytest.mark.parametrize("offset", [-2, -1, 0, 1, 2])
def test_encode_float_window_boundary(enc4, offset):
    """Periodic windows straddling exactly pixels//2 -- the boundary of
    the recentering's wide-window select -- byte-match the spec on both
    sides."""
    n = 512
    low, high, dx = 0.0, 250.0, 0.001
    pixels = spec.float_group_pixels(low, high, dx)
    span = pixels // 2 + offset
    # window anchored across the periodic seam: pixels
    # {p-1, 0, .., span-1} -> width span+1 around the boundary
    q = np.linspace(0, span - 1, n - 1).astype(np.int64)
    xr = (q.astype(np.float64) * dx + dx * 0.25).astype(np.float32)
    x = np.concatenate([[np.float32(249.9995)], xr])[None]
    _check_float(enc4, x, low, high, pixels, np.array([n]),
                 np.array([True]))
