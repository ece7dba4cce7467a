"""Device ops (minnow_tpu.ops) vs the normative host spec, byte-for-byte.

Runs on the CPU backend (tests/conftest.py); the same programs compile for
the GPU unchanged.  Mirrors the reference's bit-kernel property tests
(ref go/bit/bit_test.go:9-69) plus batched/masked paths the reference
doesn't have.
"""

import numpy as np
import pytest

from minnow_tpu.core import spec
from minnow_tpu.ops import bitpack, codec


def _rand_u64(rng, n, bits=64):
    x = rng.integers(0, 2**63, size=n, dtype=np.int64).view(np.uint64)
    x = (x << np.uint64(1)) | rng.integers(0, 2, n).astype(np.uint64)
    if bits < 64:
        x &= np.uint64((1 << bits) - 1)
    return x


@pytest.mark.parametrize("bits", list(range(0, 65)))
def test_pack_matches_spec_bytes(bits):
    # n = 77 covers partial tiles and non-word-aligned stream ends; sizes
    # 1/32/1000 are swept for a width sample below to bound compile time.
    rng = np.random.default_rng(bits + 1)
    n = 77
    x = _rand_u64(rng, n)
    want = spec.pack_bits(x, bits)
    words = bitpack.pack(x, bits)
    assert bitpack.words_to_bytes(words, bits, n) == want


@pytest.mark.parametrize("bits", [1, 8, 11, 32, 33, 45, 64])
@pytest.mark.parametrize("n", [1, 7, 32, 255])
def test_pack_matches_spec_sizes(bits, n):
    rng = np.random.default_rng(bits * 1000 + n)
    x = _rand_u64(rng, n)
    want = spec.pack_bits(x, bits)
    words = bitpack.pack(x, bits)
    assert bitpack.words_to_bytes(words, bits, n) == want


@pytest.mark.parametrize("bits", [1, 3, 8, 11, 16, 23, 31, 32, 33, 45, 63, 64])
def test_unpack_matches_spec(bits):
    rng = np.random.default_rng(bits + 100)
    n = 513
    x = _rand_u64(rng, n, bits)
    data = spec.pack_bits(x, bits)
    words = bitpack.bytes_to_words(data, bits, n)
    got = np.asarray(bitpack.unpack(words, bits, n))
    np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("bits", [1, 7, 19, 32, 41, 64])
def test_pack_batch(bits):
    rng = np.random.default_rng(bits)
    b, n = 5, 97
    x = _rand_u64(rng, b * n).reshape(b, n)
    words = np.asarray(bitpack.pack_batch(x, bits))
    for i in range(b):
        want = spec.pack_bits(x[i], bits)
        assert bitpack.words_to_bytes(words[i], bits, n) == want
    back = np.asarray(bitpack.unpack_batch(words, bits, n))
    mask = np.uint64(0xFFFFFFFFFFFFFFFF) if bits >= 64 \
        else np.uint64((1 << bits) - 1)
    np.testing.assert_array_equal(back, x & mask)


def test_bits_needed_matches_precision():
    vals = np.array([0, 1, 2, 3, 255, 256, 2**31, 2**50, 2**63,
                     2**64 - 1], dtype=np.uint64)
    import jax.numpy as jnp

    got = np.asarray(codec.bits_needed(jnp.asarray(vals)))
    want = [spec.precision_needed(int(v)) for v in vals]
    np.testing.assert_array_equal(got, want)


def test_quantize_matches_spec():
    rng = np.random.default_rng(5)
    low, high, pixels = np.float32(-50), np.float32(100), 3000
    x = rng.uniform(-50, 100, 4000).astype(np.float32)
    want = spec.quantize(x, low, high, pixels)
    got = np.asarray(codec.quantize(x, low, high, np.int64(pixels)))
    np.testing.assert_array_equal(got, want)


def test_quantize_adversarial_boundaries():
    """Values engineered to sit at pixel boundaries must floor identically
    on host and device (float32 division rounding)."""
    low, high, pixels = np.float32(0), np.float32(1), 7
    dx = spec.quantize_dx(low, high, pixels)
    grid = np.arange(1, 8, dtype=np.float32) * dx
    x = np.concatenate([np.nextafter(grid, -np.inf), grid,
                        np.nextafter(grid, np.inf)]).astype(np.float32)
    want = spec.quantize(x, low, high, pixels)
    got = np.asarray(codec.quantize(x, low, high, np.int64(pixels)))
    np.testing.assert_array_equal(got, want)


def test_prepare_int_blocks_masked():
    rng = np.random.default_rng(11)
    b, width = 4, 64
    x = rng.integers(-(2**40), 2**40, size=(b, width), dtype=np.int64)
    n = np.array([64, 17, 1, 33], dtype=np.int64)
    deltas, mins, maxd = (np.asarray(a) for a in
                          codec.prepare_int_blocks(x, n))
    for i in range(b):
        payload, mn, bits = spec.encode_int_block(x[i, :n[i]])
        assert mins[i] == mn
        assert spec.precision_needed(int(maxd[i])) == bits
        got = bitpack.words_to_bytes(
            bitpack.pack(deltas[i], bits), bits, int(n[i]))
        assert got == payload


def test_prepare_float_blocks_matches_spec():
    rng = np.random.default_rng(13)
    b, width = 6, 128
    low = np.zeros(b, np.float32)
    high = np.full(b, 250.0, np.float32)
    pixels = np.full(b, spec.float_group_pixels(0, 250, 0.01), np.int64)
    n = np.array([128, 128, 100, 128, 3, 77], dtype=np.int64)
    x = np.empty((b, width), np.float32)
    x[:4] = ((rng.uniform(-5, 5, (4, width)) + 250) % 250)  # wrap clusters
    x[4:] = rng.uniform(0, 249.9, (2, width))
    periodic = np.ones(b, bool)

    deltas, mins, maxd, valid = (np.asarray(a) for a in
                                 codec.prepare_float_blocks(
                                     x, low, high, pixels, n, periodic))
    assert valid.all()
    for i in range(b):
        payload, mn, bits, _ = spec.encode_float_block(
            x[i, :n[i]], low[i], high[i], int(pixels[i]), True)
        assert mins[i] == mn, i
        assert spec.precision_needed(int(maxd[i])) == bits, i
        got = bitpack.words_to_bytes(
            bitpack.pack(deltas[i], bits), bits, int(n[i]))
        assert got == payload, i


def test_prepare_float_blocks_flags_out_of_range():
    x = np.array([[-5.0, 5.0, 11.0]], np.float32)  # q outside [0, pixels)
    out = codec.prepare_float_blocks(
        x, np.zeros(1, np.float32), np.full(1, 10.0, np.float32),
        np.full(1, 20, np.int64), np.array([3], np.int64),
        np.ones(1, bool))
    assert not np.asarray(out[3])[0]


def test_decode_float_blocks_uniform_dither_in_pixel():
    rng = np.random.default_rng(23)
    b, n = 2, 100
    low = np.zeros(b, np.float32)
    high = np.full(b, 10.0, np.float32)
    pixels = np.full(b, 100, np.int64)
    x = rng.uniform(0, 9.9, (b, n)).astype(np.float32)
    lens = np.full(b, n, np.int64)
    periodic = np.zeros(b, bool)

    deltas, mins, _, _ = codec.prepare_float_blocks(
        x, low, high, pixels, lens, periodic)
    words = bitpack.pack_batch(np.asarray(deltas), 10)
    a = np.asarray(codec.decode_float_blocks(
        words, np.asarray(mins), low, high, pixels, periodic,
        np.arange(b, dtype=np.int64), 10, n, dither="uniform"))
    b2 = np.asarray(codec.decode_float_blocks(
        words, np.asarray(mins), low, high, pixels, periodic,
        np.arange(b, dtype=np.int64), 10, n, dither="uniform"))
    np.testing.assert_array_equal(a, b2)  # deterministic
    assert np.all(np.abs(a - x) <= 0.1 * (1 + 1e-4))


def test_numpy_dither_twins_match_jax_bitwise():
    """core/dither's pure-numpy threefry fold_in + lowbias32 hash must
    equal the jax device stream bit-for-bit (ONE defined uniform
    stream, docs/FORMAT.md section 6).  The host reader never imports
    jax, so this equivalence is what makes host and device uniform
    reads of the same file agree bitwise."""
    import jax

    from minnow_tpu.core import dither

    ids = np.array([0, 1, 2, 5, 1000, 2**31, 2**32 - 1, 3_141_592_653],
                   dtype=np.int64)
    for seed in (0, 1, 123456789, 2**40 + 3):
        base = jax.random.PRNGKey(seed)
        kj = jax.vmap(lambda i: jax.random.fold_in(base, i))(ids)
        k1n, k2n = dither._np_fold_in(seed, ids)
        np.testing.assert_array_equal(np.asarray(kj[:, 0]), k1n)
        np.testing.assert_array_equal(np.asarray(kj[:, 1]), k2n)

    c = np.arange(4096, dtype=np.uint32)
    k1, k2 = dither._np_fold_in(3, np.arange(8))
    for i in range(8):
        uj = np.asarray(jax.jit(codec.dither_hash_u)(
            c, np.uint32(k1[i]), np.uint32(k2[i])))
        un = dither._np_hash_u(c, k1[i], k2[i])
        np.testing.assert_array_equal(uj.view(np.uint32),
                                      un.view(np.uint32))

    u = dither.dither_u("uniform", 0, 5, 1 << 14)
    assert u.dtype == np.float32
    assert (u >= 0).all() and (u < 1).all()
    # statistically uniform enough for the coarse bench/test bound
    assert abs(float(u.mean()) - 0.5) < 0.02


def test_dither_hash_stream_quality():
    """The counter-hash dither stream: uniform marginals, no visible
    serial correlation, distinct streams across blocks, determinism."""
    ids = np.arange(4, dtype=np.int64)
    k1, k2 = (np.asarray(k) for k in codec.dither_keys(ids, 0))
    n = 1 << 16
    c = np.arange(n, dtype=np.uint32)
    us = np.stack([np.asarray(codec.dither_hash_u(
        c, np.uint32(k1[b]), np.uint32(k2[b]))) for b in range(4)])
    assert (us >= 0).all() and (us < 1).all()
    # uniform marginals: mean 0.5 +- 4 sigma, var 1/12
    se = 1 / np.sqrt(12 * n)
    assert np.abs(us.mean(axis=1) - 0.5).max() < 4 * se
    assert np.abs(us.var(axis=1) - 1 / 12).max() < 0.002
    # serial correlation ~ 0
    for b in range(4):
        x = us[b] - us[b].mean()
        r1 = (x[:-1] * x[1:]).mean() / x.var()
        assert abs(r1) < 0.02, r1
    # blocks decorrelated (not translated copies)
    for a in range(4):
        for b in range(a + 1, 4):
            xa = us[a] - us[a].mean()
            xb = us[b] - us[b].mean()
            rab = (xa * xb).mean() / np.sqrt(xa.var() * xb.var())
            assert abs(rab) < 0.02, (a, b, rab)
    # deterministic
    again = np.asarray(codec.dither_hash_u(
        c, np.uint32(k1[0]), np.uint32(k2[0])))
    np.testing.assert_array_equal(us[0], again)
