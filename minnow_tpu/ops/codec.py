"""Device-side (JAX/XLA) codec transforms.

Batched, mask-based equivalents of the per-block reference loops:

* float32 quantization ``q = floor(f32(x - low) / dx)``
  (ref go/group.go:312-320) -- all arithmetic pinned to float32,
* the periodic recentering of ref go/group.go:321-324, using the exact
  one-pass reduction derived in core/spec.py:periodic_min_fast (the
  sequential greedy scan is provably equal for in-range inputs; blocks the
  reduction flags invalid fall back to the host scan),
* per-block min-subtraction and delta statistics (ref go/group.go:242-255),
* dequantization with the deterministic counter-hash dither
  (dither_hash_u; ref go/group.go:299-310).

All functions take a batch of blocks ``(B, N)`` with a per-block valid
length ``n`` (padding is masked out of every statistic and packs as zero
bits, which is byte-compatible with the unpadded stream).  Shapes are
static under jit; the data-dependent pack width is resolved by bucketing
in parallel/pipeline.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import bitpack

__all__ = [
    "quantize",
    "dequantize",
    "dequantize24",
    "bits_needed",
    "periodic_distance",
    "bound",
    "prepare_int_blocks",
    "prepare_float_blocks",
    "prepare_float_blocks_fast",
    "prepare_float_blocks_fast32",
    "decode_int_blocks",
    "decode_float_blocks",
    "decode_float_blocks32",
    "decode_float_bucket",
    "padded_rows",
]


def _rp32(x64):
    """Round an f64-typed value to exact float32 precision/range in place.

    This pins intermediate f32 roundings under XLA: measured on the CPU
    backend, ``a*b + c`` contracts into an FMA through BOTH
    ``optimization_barrier`` and ``--xla_cpu_enable_fast_math=false``,
    and f64 ops whose operands are upcasts and whose result is downcast
    get silently narrowed back to f32 (recreating the fusable pattern).
    ReducePrecision(8, 23) is an explicit numerical op the simplifier
    never elides or fuses through; the jitted runtime validation
    (ops/validate.py) gates that the roundings survive compilation on
    whatever backend runs the codec.

    The whole float codec runs in f64 arithmetic (every f32 input value
    is exact in f64, and every f64 op on f32-valued operands is exact)
    with an ``_rp32`` after each operation the reference performs in
    float32 -- reproducing Go's op-by-op rounding exactly.
    """
    return jax.lax.reduce_precision(x64, exponent_bits=8, mantissa_bits=23)


def _f64(x):
    return jnp.asarray(x).astype(jnp.float64)


def _dx64(low, high, pixels):
    """f32-valued dx as f64: ``f32(high - low) / f32(pixels)``
    (ref go/group.go:316) -- subtraction, int conversion and division
    each rounded to f32."""
    span = _rp32(_f64(high) - _f64(low))
    pix = _rp32(_f64(pixels))
    return _rp32(span / pix)


def quantize(x, low, high, pixels):
    """float32 -> int64 pixel indices (ref go/group.go:312-320).  ``low``,
    ``high`` are float32 scalars (or (B,1) columns), ``pixels`` int64."""
    dx = _dx64(low, high, pixels)
    diff = _rp32(_f64(x) - _f64(low))
    q32 = _rp32(diff / dx)
    return jnp.floor(q32).astype(jnp.int64)


def dequantize(q, low, high, pixels, u=None):
    """int64 pixels -> float32 with dither ``u`` in [0,1)
    (ref go/group.go:299-310): ``out = dx*f32(q+u) + low``.

    With ``u=None`` (mode "none") this is bit-identical to the host
    reader.  Dithered modes compute ``q+u`` in float32: for q < 2^24
    (every realistic config, the dequantize24 fast path) that equals the
    host's single f64 rounding bit-for-bit; above it only the
    decoded-value contract ``|x-x_hat|<=dx`` is promised.  The uniform dither STREAM itself is
    one defined sequence shared bitwise by host and device
    (core/dither.py)."""
    dx = _dx64(low, high, pixels)
    if u is None:
        v = _rp32(_f64(q))  # f32(q) conversion rounding
    else:
        v = _rp32(_rp32(_f64(q)) + _rp32(_f64(u)))
    prod = _rp32(dx * v)
    # final add needs no explicit rounding pin: the f64 sum of two
    # f32-valued numbers is exact, the downcast is exactly the IEEE f32
    # add, and FMA fusion is blocked by the _rp32 on prod
    return (prod + _f64(low)).astype(jnp.float32)


def dequantize24(q, low, high, pixels, u=None):
    """All-native-f32 dequantize for ``pixels <= 2^24`` (every realistic
    config): with q < 2^24, ``f32(q)`` is exact, so the only rounding
    hazard left is FMA contraction of ``dx*v + low`` -- blocked by the
    runtime-opaque select below.  No f64 on the per-element path.
    Caller guarantees the pixel bound (host check); bitwise equality
    with spec.dequantize is enforced by ops/validate.py on every
    backend."""
    low32 = jnp.asarray(low, jnp.float32)
    dx = _dx64(low32, jnp.asarray(high, jnp.float32),
               pixels).astype(jnp.float32)  # per block, tiny
    v = q.astype(jnp.float32)
    if u is not None:
        v = v + u.astype(jnp.float32)
    # Block FMA contraction of dx*v + low with a select on a per-element
    # always-true-but-unprovable predicate (q >= min(q): the reduction
    # value is runtime data).  Scalar predicates get hoisted out of the
    # vectorized loop and the contraction returns; identity
    # ReducePrecision and optimization_barrier are likewise eliminated /
    # ignored (all measured on the CPU backend).
    prod = dx * v
    prod = jnp.where(q >= jnp.min(q), prod, jnp.float32(0))
    return prod + low32


def bits_needed(max_delta):
    """Exact bit length of a uint64 (= spec.precision_needed).  Equals the
    reference's float64 ``ceil(log2(max+1))`` for all max < ~2**47
    (ref go/bit/bit.go:19-21; divergence documented in core/spec.py)."""
    max_delta = max_delta.astype(jnp.uint64)
    ks = jnp.arange(64, dtype=jnp.uint64)
    return jnp.sum((max_delta[..., None] >> ks) != 0, axis=-1).astype(
        jnp.int64)


def periodic_distance(x, x0, pixels):
    """Vectorized signed circular distance (ref go/group.go:412-420)."""
    d = x - x0
    return jnp.where(
        d >= 0,
        jnp.where(d > pixels - d, d - pixels, d),
        jnp.where(d < -(d + pixels), pixels + d, d),
    )


def bound(x, minimum, pixels):
    """Wrap into [minimum, minimum+pixels) by a single +-pixels step
    (ref go/group.go:374-382)."""
    x = x + jnp.where(x < minimum, pixels, 0)
    return x - jnp.where(x >= minimum + pixels, pixels, 0)


def _mask(n, width):
    return jax.lax.broadcasted_iota(jnp.int64, (1, width), 1) < n[:, None]


def _masked_min(x, mask):
    return jnp.where(mask, x, jnp.iinfo(x.dtype).max).min(axis=1)


def _masked_max(x, mask):
    return jnp.where(mask, x, jnp.iinfo(x.dtype).min).max(axis=1)


def _delta_stats(q, mask):
    """Min-subtraction with wraparound in the input's width, padding
    packed as zero (ref go/group.go:242-255).  int32 q yields uint32
    deltas (the all-native-width path), int64 yields uint64."""
    udt = jnp.uint32 if q.dtype == jnp.int32 else jnp.uint64
    mn = _masked_min(q, mask)
    deltas = jnp.where(mask, q - mn[:, None], 0).astype(udt)
    maxd = jnp.where(mask, deltas, 0).max(axis=1)
    return deltas, mn, maxd


@jax.jit
def prepare_int_blocks(x, n):
    """Batched int-block encode prep: ``x`` (B, N) int64, ``n`` (B,) valid
    lengths.  Returns ``(deltas u64 (B,N), mins (B,), maxdeltas (B,))``."""
    mask = _mask(n, x.shape[1])
    return _delta_stats(x, mask)


@jax.jit
def int_block_stats(x, n):
    """Stats-only int encode prep: one fused HBM read of ``x``, no
    delta materialization.  Returns ``(mins, maxdeltas)`` bit-identical
    to :func:`prepare_int_blocks`'s -- the max u64 delta is the wrapped
    difference ``max - min`` (mod-2^64 differences are monotone in the
    int64 order, so the max element realizes it).  First dispatch of
    the two-pass int encode; BlockEncoder pairs it with the
    width-bucketed fused delta+pack (bitpack.delta_pack_batch), saving
    the 8 B/elem u64 delta round-trip through HBM."""
    mask = _mask(n, x.shape[1])
    mn = _masked_min(x, mask)
    mx = _masked_max(x, mask)
    maxd = jnp.where(n > 0, (mx - mn).astype(jnp.uint64), jnp.uint64(0))
    return mn, maxd


def _finish_float_blocks(q, pixels, n, periodic, mask, clamp_q: bool):
    """Shared tail of the float encode prep: range check, periodic
    recentering (one-pass reduction), delta stats."""
    p = pixels[:, None]
    if clamp_q:
        q = jnp.minimum(q, p - 1)
    in_range = jnp.where(mask, (q >= 0) & (q < p), True).all(axis=1)

    x0 = q[:, :1]
    y = periodic_distance(q, x0, p)
    ymin = _masked_min(y, mask)
    ymax = _masked_max(y, mask)
    w = ymax - ymin + 1
    m = x0[:, 0] + ymin
    m = jnp.where(m < 0, m + pixels, m)
    m = jnp.where(w > pixels // 2, 0, m)

    qb = jnp.where(periodic[:, None], bound(q, m[:, None], p), q)
    deltas, mn, maxd = _delta_stats(qb, mask)
    valid = in_range | ~periodic
    return deltas, mn, maxd, valid


@partial(jax.jit, static_argnames=("clamp_q",))
def prepare_float_blocks_fast32(x, low, pixels, n, periodic,
                                b, eb, m0, m1, clamp_q: bool = False):
    """All-native-width encode prep for pixel counts < 2^29: int32
    pixels, uint32 deltas -- half the memory traffic of the 64-bit
    path.  Same certification semantics as
    :func:`prepare_float_blocks_fast`."""
    from . import fastdiv

    width = x.shape[1]
    mask = _mask(n, width)
    diff = x.astype(jnp.float32) - low[:, None]
    q, exact = fastdiv.quantize_fast(diff, b[:, None], eb[:, None],
                                     m0[:, None], m1[:, None], out32=True)
    all_exact = jnp.where(mask, exact, True).all(axis=1)
    deltas, mn, maxd, valid = _finish_float_blocks(
        q, pixels.astype(jnp.int32), n, periodic, mask, clamp_q)
    return deltas, mn, maxd, valid & all_exact


@partial(jax.jit, static_argnames=("clamp_q",))
def prepare_float_blocks_fast(x, low, pixels, n, periodic,
                              b, eb, m0, m1, clamp_q: bool = False):
    """Integer-exact encode prep (ops/fastdiv.py): same results as
    :func:`prepare_float_blocks` in integer arithmetic.  ``b/eb/m0/m1``
    are the per-block divisor decomposition from
    ``fastdiv.divisor_magic`` (host).
    ``valid`` additionally goes False for blocks the fast quotient path
    cannot certify (the caller re-encodes those on host)."""
    from . import fastdiv

    width = x.shape[1]
    mask = _mask(n, width)
    diff = x.astype(jnp.float32) - low[:, None]
    q, exact = fastdiv.quantize_fast(diff, b[:, None], eb[:, None],
                                     m0[:, None], m1[:, None])
    all_exact = jnp.where(mask, exact, True).all(axis=1)
    deltas, mn, maxd, valid = _finish_float_blocks(
        q, pixels, n, periodic, mask, clamp_q)
    return deltas, mn, maxd, valid & all_exact


@partial(jax.jit, static_argnames=("clamp_q",))
def prepare_float_blocks(x, low, high, pixels, n, periodic,
                         clamp_q: bool = False):
    """Batched float-block encode prep (ref go/group.go:312-327).

    ``x`` (B, N) float32; ``low``/``high`` float32 (B,); ``pixels`` int64
    (B,); ``n`` (B,) valid lengths; ``periodic`` bool (B,).

    Returns ``(deltas u64, mins, maxdeltas, valid)`` -- ``valid[b]`` False
    when block b contains out-of-range pixels so the one-pass periodic
    reduction does not apply and the caller must use the host scan.
    """
    _, width = x.shape
    mask = _mask(n, width)
    q = quantize(x, low[:, None], high[:, None], pixels[:, None])
    return _finish_float_blocks(q, pixels, n, periodic, mask, clamp_q)


@partial(jax.jit, static_argnames=("bits", "n"))
def decode_int_blocks(words, mins, bits: int, n: int):
    """Batched int-block decode: (B, W) words -> (B, n) int64
    (ref go/group.go:257-263)."""
    deltas = bitpack.unpack_batch(words, bits, n)
    return deltas.astype(jnp.int64) + mins[:, None]


def dither_keys(block_ids, seed):
    """Per-block device-dither keys: full jax-threefry ``fold_in`` of
    ``(seed, block_id)`` -- the key schedule itself is cryptographic-
    grade; only the per-ELEMENT mixing uses the cheap counter hash
    below.  Because that hash mixes ``(c + k2) ^ k1``, two blocks that
    collide on k1 (expected ~B^2/2^33 pairs by birthday -- hundreds at
    ~2^20 blocks) have streams that are exact counter-TRANSLATES of
    each other, so block streams are not fully independent functions
    of the id.  Harmless for the |x - x_hat| <= dx contract (each
    element's draw is still uniform); callers needing cross-block
    stream independence can use the legacy dither="philox" host mode.
    The host reader computes this same key schedule in pure numpy
    (core/dither._np_fold_in), so host and device uniform reads agree
    bitwise.  Returns (k1, k2) uint32 (B,) arrays."""
    base = jax.random.PRNGKey(seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(block_ids)
    return keys[:, 0], keys[:, 1]


def dither_hash_u(c, k1, k2):
    """The framework's device uniform-dither stream (v2): element
    counter ``c`` (u32) + per-block keys -> u float32 in [0, 1).

    Defined as the lowbias32 avalanche hash (Wellons' statistically
    tested 2-multiply mixer) of ``(c + k2) ^ k1``, with the standard
    mantissa-fill float transform.  ~15 integer ops/element, where a
    full 20-round threefry (~118 ops/elem) would make the DEFAULT read
    mode compute-bound.  Pure u32/f32 ops; u32*u32 keeps only the exact
    wrapping low product.  The dither contract is unchanged: deterministic in
    (seed, block_id, element), uniform on the 2^23 grid,
    ``|x - x_hat| <= dx``.  The host reader computes this exact stream
    in pure numpy (core/dither._np_hash_u), so host and device uniform
    reads of the same file agree bitwise."""
    x = (c + k2) ^ k1
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x21F0AAAD)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0xD35A2D97)
    x = x ^ (x >> np.uint32(15))
    fb = (x >> np.uint32(9)) | np.uint32(0x3F800000)
    return jax.lax.bitcast_convert_type(fb, jnp.float32) \
        - jnp.float32(1.0)


def _dither_u(block_ids, n, dither, seed):
    if dither == "none":
        return None
    if dither == "midpoint":
        return jnp.full((block_ids.shape[0], n), 0.5, jnp.float32)
    if dither == "uniform":
        k1, k2 = dither_keys(block_ids, seed)
        c = jnp.arange(n, dtype=jnp.uint32)[None, :]
        return dither_hash_u(c, k1[:, None], k2[:, None])
    raise ValueError("unknown dither mode %r" % dither)


@partial(jax.jit, static_argnames=("bits", "n", "dither"))
def decode_float_blocks32(words, mins, low, high, pixels, periodic,
                          block_ids, bits: int, n: int,
                          dither: str = "none", seed: int = 0):
    """All-native-width batched float decode for bits <= 32 and
    pixels <= 2^24 (caller-checked): uint32 unpack, int32 recentering,
    native-f32 dequantize.  Bit-identical to decode_float_blocks."""
    q = bitpack.unpack_batch32(words, bits, n).astype(jnp.int32) \
        + mins[:, None].astype(jnp.int32)
    p32 = pixels[:, None].astype(jnp.int32)
    q = jnp.where(periodic[:, None], bound(q, 0, p32), q)
    u = _dither_u(block_ids, n, dither, seed)
    return dequantize24(q, low[:, None], high[:, None], pixels[:, None],
                        u)


@partial(jax.jit, static_argnames=("bits", "n", "dither"))
def decode_float_blocks(words, mins, low, high, pixels, periodic,
                        block_ids, bits: int, n: int,
                        dither: str = "none", seed: int = 0):
    """Batched float-block decode (ref go/group.go:299-310).

    Device dither: the counter-hash stream keyed on ``(seed,
    block_id)`` (dither_hash_u) -- deterministic, uniform float32 in
    [0,1).  Modes ``none``/``midpoint`` are bit-identical to the host
    reader.
    """
    q = decode_int_blocks(words, mins, bits, n)
    p = pixels[:, None]
    q = jnp.where(periodic[:, None], bound(q, 0, p), q)
    u = _dither_u(block_ids, n, dither, seed)
    return dequantize(q, low[:, None], high[:, None], p, u)


def padded_rows(m: int) -> int:
    """Batch rows a width bucket of ``m`` blocks is padded to: the next
    power of two.  Bucket sizes are data-dependent, and every new batch
    shape is a new compile; padding bounds the compiles per width to
    log2 of the largest bucket."""
    return 1 << max(int(m) - 1, 0).bit_length()


def decode_float_bucket(words, mins, low, high, pixels, periodic,
                        block_ids, bits: int, n: int, dither: str = "none",
                        seed: int = 0):
    """Decode one (width, length) bucket of float blocks (host arrays,
    one row per block) by the narrowest exact route:
    :func:`decode_float_blocks32` when every bound fits 32 bits
    (``bits <= 32``, ``pixels <= 2^24``, ``|min| < 2^30`` -- every
    realistic config), else :func:`decode_float_blocks`.  Rows are
    padded to :func:`padded_rows` by repeating the last block.  Both
    routes are bit-identical to the host reader; returns (B, n)
    float32 on the host."""
    m = len(mins)
    fast = (bits <= 32 and int(np.max(pixels)) <= (1 << 24)
            and int(np.max(np.abs(mins))) < (1 << 30))
    decode = decode_float_blocks32 if fast else decode_float_blocks
    pad = np.minimum(np.arange(padded_rows(m)), m - 1)
    out = decode(*(np.asarray(a)[pad] for a in (
        words, mins, low, high, pixels, periodic, block_ids)),
        int(bits), int(n), dither=dither, seed=seed)
    return np.asarray(out)[:m]
