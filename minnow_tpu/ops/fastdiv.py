"""Exact float32 quantization via integer arithmetic.

``q = floor(RN32((x - low) / dx))`` must be bit-exact (core/spec.py), but
XLA's f32 division is approximate.  This module computes the correctly
rounded f32 quotient with pure integer ops, no f64 anywhere:

* decompose ``diff = a * 2^ea`` and the per-block divisor
  ``dx = b * 2^eb`` into 24-bit mantissas (subnormal ``diff`` handled by
  renormalizing with an exact float-conversion CLZ trick);
* the normalized integer quotient ``Q = floor(a * 2^s / b)``
  (``s in {23, 24}``, 48-bit dividend) uses a per-block
  Granlund-Montgomery magic reciprocal ``m = ceil(2^72 / b)`` --
  always exact for 24-bit divisors since ``m*b - 2^72 < b < 2^24``;
* round to nearest-even with the exact remainder, renormalize, and take
  the floor with sign handling (negative quotients floor away from
  zero when any fraction bits remain).

Elements the fast path cannot certify (NaN/Inf inputs, quotient
magnitude >= 2^62 or < 2^-120 where f32 subnormal rounding matters, or a
non-normal divisor) are flagged; callers fall back to the normative host
scan for those blocks, exactly like the periodic out-of-range fallback.

Validated bitwise against core/spec.py over random + boundary
adversarial vectors in ops/validate.py and tests/test_fastdiv.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["divisor_magic", "quantize_fast"]

_M32 = np.uint64(0xFFFFFFFF)


def divisor_magic(dx):
    """Host-side per-block divisor decomposition + magic reciprocal.

    Returns ``(b, eb, m0, m1, ok)`` arrays: 24-bit mantissa, unbiased
    exponent minus 23, magic low/high u32 limbs, and a validity flag
    (False for non-positive / subnormal / non-finite dx)."""
    dx = np.asarray(dx, np.float32)
    bits = dx.view(np.uint32)
    e_raw = ((bits >> np.uint32(23)) & np.uint32(0xFF)).astype(np.int64)
    m_raw = (bits & np.uint32(0x7FFFFF)).astype(np.uint64)
    sign = bits >> np.uint32(31)
    ok = (sign == 0) & (e_raw > 0) & (e_raw < 255)
    b = np.where(ok, m_raw | np.uint64(1 << 23), np.uint64(1 << 23))
    eb = np.where(ok, e_raw - 150, 0)

    m0 = np.zeros(dx.shape, np.uint64)
    m1 = np.zeros(dx.shape, np.uint64)
    flat_b = b.reshape(-1)
    fm0, fm1 = m0.reshape(-1), m1.reshape(-1)
    for i, bi in enumerate(flat_b.tolist()):
        m = -((-(1 << 72)) // bi)  # ceil(2^72 / b)
        fm0[i] = m & 0xFFFFFFFF
        fm1[i] = m >> 32
    return (b, eb.astype(np.int64), m0, m1, ok)


def quantize_fast(diff, b, eb, m0, m1, out32: bool = False):
    """``floor(RN32(diff / dx))`` for f32 ``diff`` (any shape) and
    per-block divisor decomposition broadcast against it.

    Returns ``(q, exact)``; where ``exact`` is False the value is
    unspecified and the caller must use the normative fallback.  With
    ``out32`` the result is int32 and quotients with |q| >= 2^30 are
    flagged -- the all-native-width path for pixel counts < 2^31."""
    bits = jax.lax.bitcast_convert_type(diff, jnp.uint32)
    sign = bits >> np.uint32(31)
    e_raw = ((bits >> np.uint32(23)) & np.uint32(0xFF)).astype(jnp.int64)
    m_raw = bits & np.uint32(0x7FFFFF)
    is_zero = (bits & np.uint32(0x7FFFFFFF)) == 0
    invalid = e_raw == 255  # NaN / Inf

    # normalize subnormal mantissas: exact msb via float conversion
    # (m_raw < 2^23 so the f32 conversion of the integer is exact)
    safe_m = jnp.maximum(m_raw, np.uint32(1))
    msb = (jax.lax.bitcast_convert_type(
        safe_m.astype(jnp.float32), jnp.uint32)
        >> np.uint32(23)).astype(jnp.int64) - 127
    shn = (23 - msb).astype(jnp.uint32)
    subn = e_raw == 0
    a = jnp.where(subn, m_raw << shn, m_raw | np.uint32(1 << 23))
    ea = jnp.where(subn, -149 - shn.astype(jnp.int64), e_raw - 150)

    b32 = b.astype(jnp.uint32)
    t = (a < b32).astype(jnp.int64)
    s = (23 + t).astype(jnp.uint64)

    # Q = floor(a * 2^s / b) via the magic product, exploiting that the
    # mantissa a has only 24 bits: a*m = a*m0 + a*m1*2^32 with both
    # partial products < 2^57, so
    #   floor(a*2^s*m / 2^72) = ((a*m0 >> 32) + a*m1) >> (40 - s)
    # (the dropped low 32+(40-s) bits cannot carry).  Three 64-bit
    # multiplies total (incl. the remainder) vs five for the generic
    # 48-bit-dividend form.
    a64 = a.astype(jnp.uint64)
    lo = a64 * m0
    hi = a64 * m1
    q24 = ((lo >> np.uint64(32)) + hi) >> (np.uint64(40) - s)

    n_full = a64 << s
    rem = n_full - q24 * b
    r2 = rem << np.uint64(1)
    up = (r2 > b) | ((r2 == b) & ((q24 & np.uint64(1)) == 1))
    m_mant = q24 + up.astype(jnp.uint64)
    e_z = ea - eb - t  # = ea - eb - s + 23
    ovf = m_mant == np.uint64(1 << 24)
    m_mant = jnp.where(ovf, np.uint64(1 << 23), m_mant)
    e_z = e_z + ovf.astype(jnp.int64)

    invalid = invalid | (e_z >= (30 if out32 else 62)) | (e_z < -120)

    # floor(+-M * 2^(E-23))
    up_sh = jnp.clip(e_z - 23, 0, 63).astype(jnp.uint64)
    dn_sh = jnp.clip(23 - e_z, 0, 63).astype(jnp.uint64)
    big = e_z >= 23
    q_mag = jnp.where(big, m_mant << up_sh, m_mant >> dn_sh)
    frac_mask = (np.uint64(1) << dn_sh) - np.uint64(1)
    frac = (~big) & ((m_mant & frac_mask) != 0)
    idt = jnp.int32 if out32 else jnp.int64
    q_val = jnp.where(sign == 0, q_mag.astype(idt),
                      -(q_mag.astype(idt)) - frac.astype(idt))
    q_val = jnp.where(is_zero, 0, q_val)
    # +0 diffs are exact by definition (quotient 0); their mantissa
    # path computes garbage exponents that must not flag them.  -0.0 is
    # FLAGGED: on a backend that flushes subnormals in the upstream f32
    # subtract, a -0.0 diff may stand for a true
    # negative-subnormal difference whose spec quotient floors to -1,
    # so it must route to the host fallback, where numpy recomputes the
    # unflushed diff.  (A genuine -0.0 diff also floors to 0 there, so
    # the fallback is correct either way.)
    negzero = is_zero & (sign != np.uint32(0))
    return q_val, (is_zero & (sign == np.uint32(0))) \
        | (~(invalid | negzero))
