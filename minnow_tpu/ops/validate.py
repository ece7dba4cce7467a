"""Backend numeric-exactness validation.

The on-disk format is defined by IEEE float32 arithmetic (core/spec.py);
this module proves, at runtime on the *actual* backend, that the device
codec reproduces it bitwise.  Run by chip_smoke.py and bench.py on the
GPU and by the test suite on the CPU mesh; any mismatch is a hard failure
of the byte-exactness contract, not a tolerance issue.

Found and guarded so far:

* XLA f32 division is reciprocal-approximated (2 ulp): codec divides in
  f64 and rounds back with ``_rp32`` (exact by Figueroa's double-rounding
  theorem), and the encode prep divides in integer limbs (fastdiv).
* FMA contraction of ``dx*v + low`` would merge two roundings into one:
  codec pins the product with ``_rp32`` (f64 route) or a runtime-opaque
  select (dequantize24).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core import spec
from . import codec


def _rand_f32(rng, n, lo, hi):
    return rng.uniform(lo, hi, n).astype(np.float32)


def validate_quantize(n: int = 200_000, seed: int = 0) -> None:
    """Device quantize == host spec quantize, bit for bit, on random and
    boundary-adversarial inputs.  Always through jit: fusion rewrites
    (FMA contraction, division demotion) only happen in compiled code."""
    import jax

    rng = np.random.default_rng(seed)
    jq = jax.jit(codec.quantize)

    # random configs
    for low, high, dx in [(0.0, 250.0, 0.001), (-50.0, 100.0, 1.0),
                          (0.0, 1.0, 1 / 7), (1.0, 5.0, 1e-4),
                          (5.0, 16.0, 0.001)]:
        pixels = spec.float_group_pixels(low, high, dx)
        x = _rand_f32(rng, n, low, high)
        want = spec.quantize(x, low, high, pixels)
        got = np.asarray(jq(
            x, np.float32(low), np.float32(high), np.int64(pixels)))
        bad = np.nonzero(got != want)[0]
        if bad.size:
            raise AssertionError(
                "device quantize diverges from spec: %d/%d mismatches, "
                "first at x=%.9g (want %d got %d) [low=%g high=%g px=%d]"
                % (bad.size, n, x[bad[0]], want[bad[0]], got[bad[0]],
                   low, high, pixels))

    # adversarial: values engineered one ulp around every pixel boundary
    low, high, pixels = np.float32(0), np.float32(1), 4093
    dxq = spec.quantize_dx(low, high, pixels)
    ks = rng.integers(1, pixels, 50_000)
    grid = (ks.astype(np.float32) * dxq).astype(np.float32)
    x = np.concatenate([np.nextafter(grid, -np.inf), grid,
                        np.nextafter(grid, np.inf)])
    want = spec.quantize(x, low, high, pixels)
    got = np.asarray(jq(x, low, high, np.int64(pixels)))
    if not np.array_equal(got, want):
        bad = np.nonzero(got != want)[0]
        raise AssertionError(
            "device quantize diverges at pixel boundaries: %d mismatches "
            "(e.g. x=%.9g want %d got %d)" % (bad.size, x[bad[0]],
                                              want[bad[0]], got[bad[0]]))


def validate_dequantize(n: int = 200_000, seed: int = 1) -> None:
    """Device dequantize (dither=none) == host spec, bit for bit.
    Through jit (see validate_quantize); the (5, 16, 0.001) config with
    q=6276 is the FMA-contraction regression case."""
    import jax

    rng = np.random.default_rng(seed)
    jd = jax.jit(lambda q, lo, hi, p: codec.dequantize(q, lo, hi, p))
    for low, high, dx in [(0.0, 250.0, 0.001), (-50.0, 100.0, 0.25),
                          (5.0, 16.0, 0.001)]:
        pixels = spec.float_group_pixels(low, high, dx)
        q = rng.integers(0, pixels, n)
        q[0] = min(6276, pixels - 1)
        want = spec.dequantize(q, low, high, pixels)
        got = np.asarray(jd(
            jnp.asarray(q), np.float32(low), np.float32(high),
            np.int64(pixels)))
        if pixels <= (1 << 24):
            j24 = jax.jit(lambda q, lo, hi, p: codec.dequantize24(
                q.astype(jnp.int32), lo, hi, p))
            got24 = np.asarray(j24(
                jnp.asarray(q), np.float32(low), np.float32(high),
                np.int64(pixels)))
            bad = np.nonzero(got24.view(np.int32)
                             != want.view(np.int32))[0]
            if bad.size:
                raise AssertionError(
                    "dequantize24 diverges from spec: %d mismatches "
                    "(e.g. q=%d want %.9g got %.9g)"
                    % (bad.size, q[bad[0]], want[bad[0]], got24[bad[0]]))
        if not np.array_equal(got.view(np.int32), want.view(np.int32)):
            bad = np.nonzero(got.view(np.int32) != want.view(np.int32))[0]
            raise AssertionError(
                "device dequantize diverges from spec: %d mismatches "
                "(likely FMA contraction; e.g. q=%d want %.9g got %.9g)"
                % (bad.size, q[bad[0]], want[bad[0]], got[bad[0]]))


def validate_quantize_fast(seed: int = 3) -> None:
    """Integer-exact fast quantize (ops/fastdiv.py) == spec, bitwise,
    through jit, incl. pixel-boundary adversarial values."""
    import jax

    from . import fastdiv

    rng = np.random.default_rng(seed)
    jq = jax.jit(fastdiv.quantize_fast)
    for low, high, dx in [(0.0, 250.0, 0.001), (-50.0, 100.0, 1.0),
                          (5.0, 16.0, 0.001), (0.0, 1.0, 1 / 7)]:
        pixels = spec.float_group_pixels(low, high, dx)
        dxq = spec.quantize_dx(low, high, pixels)
        b, eb, m0, m1, ok = fastdiv.divisor_magic(np.array([dxq]))
        assert ok[0]
        x = _rand_f32(rng, 100_000, low, high)
        ks = rng.integers(0, pixels, 20_000)
        grid = np.float32(low) + (ks.astype(np.float32) * dxq).astype(
            np.float32)
        x = np.concatenate([x, np.nextafter(grid, -np.inf), grid,
                            np.nextafter(grid, np.inf)])
        diff = (x - np.float32(low)).astype(np.float32)
        q, exact = jq(diff, b[0], eb[0], m0[0], m1[0])
        q, exact = np.asarray(q), np.asarray(exact)
        # flagged elements (e.g. subnormal diffs -> quotient < 2^-120)
        # legitimately route to the host fallback; the adversarial grid
        # deliberately includes such values, so only sanity-bound the rate
        frac_flagged = (~exact).mean()
        if frac_flagged > 0.25:
            raise AssertionError("fast quantize certified too few "
                                 "elements (%.3f%% flagged)"
                                 % (100 * frac_flagged))
        want = spec.quantize(x, low, high, pixels)
        bad = np.nonzero((q != want) & exact)[0]
        if bad.size:
            raise AssertionError(
                "fast quantize diverges from spec: %d mismatches (e.g. "
                "x=%a want %d got %d) [low=%g high=%g dx=%g]"
                % (bad.size, float(x[bad[0]]), want[bad[0]], q[bad[0]],
                   low, high, dx))


def validate_pack(seed: int = 2) -> None:
    """Device pack bytes == spec pack bytes for a sample of widths."""
    from . import bitpack

    rng = np.random.default_rng(seed)
    for bits in (1, 7, 11, 18, 23, 32, 45, 64):
        x = rng.integers(0, 2**63, 4097, dtype=np.int64).view(np.uint64)
        want = spec.pack_bits(x, bits)
        got = bitpack.words_to_bytes(bitpack.pack(x, bits), bits, len(x))
        if got != want:
            raise AssertionError("device pack diverges at bits=%d" % bits)
        back = np.asarray(bitpack.unpack(
            bitpack.bytes_to_words(want, bits, len(x)), bits, len(x)))
        mask = np.uint64(0xFFFFFFFFFFFFFFFF) if bits >= 64 \
            else np.uint64((1 << bits) - 1)
        if not np.array_equal(back, x & mask):
            raise AssertionError("device unpack diverges at bits=%d" % bits)


def validate_blocks(seed: int = 4) -> None:
    """The batched routes the writers and bulk readers run == host spec,
    byte for byte: BlockEncoder's float encode prep (fastdiv limbs,
    int32 deltas) + width-specialized pack, and the bulk decode
    (``decode_float_blocks32``: int32 unpack + ``dequantize24``) in
    dither modes ``none`` and ``uniform`` against the host reader's
    stream.  Covers a periodic wrap cluster and a ragged block."""
    from ..core import dither
    from . import bitpack, fastdiv

    rng = np.random.default_rng(seed)
    low, high, dx = 0.0, 250.0, 0.001
    pixels = spec.float_group_pixels(low, high, dx)
    bsz, n = 4, 4096
    x = rng.uniform(0, 249.9, (bsz, n)).astype(np.float32)
    x[2] = np.concatenate([rng.uniform(0, 3, n // 2),
                           250.0 - rng.uniform(0, 3, n - n // 2)])
    lens = np.array([n, n, n, n - 77], np.int64)
    lowv = np.full(bsz, low, np.float32)
    highv = np.full(bsz, high, np.float32)
    pixv = np.full(bsz, pixels, np.int64)
    per = np.ones(bsz, bool)
    dxq = np.full(bsz, spec.quantize_dx(low, high, pixels), np.float32)
    db, deb, dm0, dm1, dok = fastdiv.divisor_magic(dxq)
    assert dok.all()
    deltas, mins, maxd, valid = codec.prepare_float_blocks_fast32(
        x, lowv, pixv, lens, per, db, deb, dm0, dm1)
    if not np.asarray(valid).all():
        raise AssertionError("fast encode prep failed to certify "
                             "in-range blocks")
    mins, maxd = np.asarray(mins), np.asarray(maxd)
    block_ids = np.arange(bsz, dtype=np.int64) + 7
    for i in range(bsz):
        m = int(lens[i])
        payload, mn, bts, q = spec.encode_float_block(x[i, :m], low, high,
                                                      pixels)
        if int(mins[i]) != mn or spec.precision_needed(int(maxd[i])) != bts:
            raise AssertionError("encode prep stats diverge from spec at "
                                 "block %d" % i)
        words = bitpack.pack_batch(deltas[i:i + 1], bts)
        if bitpack.words_to_bytes(words[0], bts, m) != payload:
            raise AssertionError("encode payload diverges from spec at "
                                 "block %d" % i)
        w = bitpack.bytes_to_words(payload, bts, m)[None]
        q = spec.bound(q, 0, pixels)
        for mode in ("none", "uniform"):
            got = np.asarray(codec.decode_float_blocks32(
                w, np.array([mn]), lowv[:1], highv[:1], pixv[:1], per[:1],
                block_ids[i:i + 1], bts, m, dither=mode, seed=3))[0]
            want = spec.dequantize(
                q, low, high, pixels,
                u=dither.dither_u(mode, 3, int(block_ids[i]), m))
            if not np.array_equal(got.view(np.int32), want.view(np.int32)):
                raise AssertionError(
                    "bulk decode (dither=%s) diverges from the host "
                    "reader at block %d" % (mode, i))


# Which arithmetic route each check gates: the production encode prep
# quantizes through fastdiv limbs and the bulk readers dequantize through
# dequantize24; the f64 + _rp32 routes serve the generic (wide-pixel)
# paths and the single-block API.
ROUTES = {
    "quantize": ("f64+_rp32", "fastdiv limbs"),
    "dequantize": ("f64+_rp32", "dequantize24"),
}


def validate_backend() -> dict:
    """Run all exactness checks on the current default backend.  Returns a
    small report dict; raises AssertionError on any divergence."""
    import jax

    validate_quantize()
    validate_quantize_fast()
    validate_dequantize()
    validate_pack()
    validate_blocks()
    dev = jax.devices()[0]
    return {
        "backend": dev.platform,
        "device_kind": dev.device_kind,
        "exact": True,
        "routes": ROUTES,
    }
