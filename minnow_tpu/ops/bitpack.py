"""Word-parallel fixed-width bit packing (JAX/XLA).

The reference packs one element at a time through a 9-byte shuffle buffer
(ref go/bit/bit.go:100-131; python/cy_bit.pyx:15-96).  Here the stream is
reformulated word-parallel, so every element of a batch packs at once:

* the byte stream is viewed as little-endian uint32 words;
* elements are processed in tiles of 32: a width-``b`` tile occupies
  exactly ``32*b`` bits = ``b`` words, so for fixed ``b`` the
  (element, word, shift) contribution pattern is static;
* packing a tile is an unrolled sequence of shift/OR ops, vectorized
  across all tiles (the tile axis is the vector axis) -- elementwise
  work with no gathers, scatters or data-dependent control flow;
* 64-bit values travel as (lo, hi) uint32 pairs so the hot loop runs
  in 32-bit integer arithmetic.

Bit layout matches the reference exactly: element ``i`` occupies bits
``[i*b, (i+1)*b)`` of the stream, LSB-first (ref go/bit/bit.go spec;
verified byte-for-byte against core/spec.py in tests/test_ops.py).

Functions are jit-specialized on the static width ``b`` (<= 64 variants,
cached compiles); blocks with different widths are bucketed by the
pipeline layer (parallel/pipeline.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import spec

__all__ = [
    "words_per_block",
    "split_u64",
    "join_u64",
    "pack",
    "unpack",
    "pack_batch",
    "unpack_batch",
    "words_to_bytes",
    "bytes_to_words",
]

_TILE = 32


def words_per_block(bits: int, n: int) -> int:
    """uint32 words holding ``n`` elements at width ``bits``."""
    return (bits * n + 31) // 32


def split_u64(x):
    """uint64 (or int64) array -> (lo, hi) uint32 pair.  32-bit inputs
    (the all-native-width path) skip the 64-bit split entirely; for
    widths <= 32 the hi half is dead code XLA eliminates."""
    if x.dtype in (jnp.uint32, jnp.int32):
        lo = x.astype(jnp.uint32)
        return lo, jnp.zeros_like(lo)
    x = x.astype(jnp.uint64)
    lo = (x & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    hi = (x >> jnp.uint64(32)).astype(jnp.uint32)
    return lo, hi


def join_u64(lo, hi):
    """(lo, hi) uint32 pair -> uint64 array."""
    return (hi.astype(jnp.uint64) << jnp.uint64(32)) | lo.astype(jnp.uint64)


def _masks(bits: int):
    lo_bits = min(bits, 32)
    lo_mask = np.uint32(0xFFFFFFFF if lo_bits >= 32 else (1 << lo_bits) - 1)
    hi_bits = max(bits - 32, 0)
    hi_mask = np.uint32(0xFFFFFFFF if hi_bits >= 32 else (1 << hi_bits) - 1)
    return lo_mask, hi_mask


def _shift_parts(x, offs):
    """For (32, T) values ``x`` whose element row j sits at bit offset
    ``offs[j]`` (mod 32), return the in-word and spill-word contributions
    as two (32, T) arrays, plus the per-row target word index.

    Element rows, tile columns: the tile axis is the minor (contiguous)
    axis, shifts broadcast per row."""
    s = (offs % 32).astype(np.uint32)  # (32,)
    w = offs // 32
    part_lo = x << s[:, None]
    # spill = x >> (32 - s) for s > 0; for s == 0 the shift amount wraps,
    # so mask the result instead of branching
    s2 = ((32 - s) % 32).astype(np.uint32)
    part_hi = jnp.where((s > 0)[:, None], x >> s2[:, None],
                        jnp.uint32(0))
    return part_lo, part_hi, w


def _segment_sum_words(parts, words_idx, bits: int, t: int):
    """Sum (32, T) contribution rows into (bits, T) words.  For fixed
    width the element->word map is monotone, so each word's contributors
    are a contiguous row range: static slice + row sum-reduce
    (OR == ADD, contributions occupy disjoint bits)."""
    rows = []
    for w in range(bits):
        acc = None
        for part, idx in zip(parts, words_idx):
            j0 = int(np.searchsorted(idx, w, side="left"))
            j1 = int(np.searchsorted(idx, w, side="right"))
            if j1 > j0:
                seg = part[j0:j1].sum(axis=0, dtype=jnp.uint32)
                acc = seg if acc is None else acc + seg
        rows.append(acc if acc is not None
                    else jnp.zeros((t,), jnp.uint32))
    return jnp.stack(rows, axis=0)  # (bits, T)


def _pack_tiles(lo_t, hi_t, bits: int):
    """Pack (32, T) uint32 element halves into (T, bits) words."""
    t = lo_t.shape[1]
    lo_mask, hi_mask = _masks(bits)
    offs = np.arange(_TILE, dtype=np.int64) * bits

    parts = []
    idxs = []
    lo_m = lo_t & lo_mask
    p_lo, p_spill, w = _shift_parts(lo_m, offs)
    parts += [p_lo, p_spill]
    idxs += [w, w + 1]
    if bits > 32:
        hi_m = hi_t & hi_mask
        # hi half sits 32 bits further along: word w+1, same shift
        q_lo, q_spill, _ = _shift_parts(hi_m, offs)
        parts += [q_lo, q_spill]
        idxs += [w + 1, w + 2]
    return _segment_sum_words(parts, idxs, bits, t).T  # (T, bits)


def _unpack_tiles(words_t, bits: int):
    """Inverse of :func:`_pack_tiles`: (T, bits) words -> (lo, hi) of
    shape (T, 32).  Word rows gathered by static index, per-row vector
    shifts, tiles on the minor axis."""
    lo_mask, hi_mask = _masks(bits)
    offs = np.arange(_TILE, dtype=np.int64) * bits
    wt = words_t.T  # (bits, T)

    def extract(base_off, mask):
        s = (base_off % 32).astype(np.uint32)
        w = np.minimum(base_off // 32, bits - 1)
        w2 = np.minimum(base_off // 32 + 1, bits - 1)
        a = wt[w]  # (32, T) static row gather
        b = wt[w2]
        s2 = ((32 - s) % 32).astype(np.uint32)
        out = a >> s[:, None]
        out = out | jnp.where((s > 0)[:, None], b << s2[:, None],
                              jnp.uint32(0))
        return (out & mask).T  # (T, 32)

    lo = extract(offs, lo_mask)
    if bits > 32:
        hi = extract(offs + 32, hi_mask)
    else:
        hi = jnp.zeros_like(lo)
    return lo, hi


def _pack_1d(lo, hi, bits: int):
    """(N,) uint32 pair -> (words_per_block(bits, N),) uint32."""
    n = lo.shape[0]
    if bits == 0 or n == 0:
        return jnp.zeros((0,), jnp.uint32)
    pad = (-n) % _TILE
    if pad:
        lo = jnp.pad(lo, (0, pad))
        hi = jnp.pad(hi, (0, pad))
    t = (n + pad) // _TILE
    words = _pack_tiles(lo.reshape(t, _TILE).T, hi.reshape(t, _TILE).T,
                        bits).reshape(t * bits)
    return words[: words_per_block(bits, n)]


def _unpack_1d(words, bits: int, n: int):
    """(W,) uint32 words -> (N,) (lo, hi) uint32 pair."""
    if bits == 0:
        z = jnp.zeros((n,), jnp.uint32)
        return z, z
    t = (n + _TILE - 1) // _TILE
    pad = t * bits - words.shape[0]
    if pad > 0:
        words = jnp.pad(words, (0, pad))
    lo_t, hi_t = _unpack_tiles(words.reshape(t, bits), bits)
    return lo_t.reshape(-1)[:n], hi_t.reshape(-1)[:n]


@partial(jax.jit, static_argnames=("bits",))
def pack(x, bits: int):
    """Pack a uint64/int64 vector at static width ``bits`` into uint32
    stream words."""
    lo, hi = split_u64(x)
    return _pack_1d(lo, hi, bits)


@partial(jax.jit, static_argnames=("bits", "n"))
def unpack(words, bits: int, n: int):
    """Unpack ``n`` elements at width ``bits`` back into uint64."""
    lo, hi = _unpack_1d(words, bits, n)
    return join_u64(lo, hi)


@partial(jax.jit, static_argnames=("bits",))
def pack_batch(x, bits: int):
    """Pack each row of ``x`` (B, N) independently -> (B, W) words.
    Rows are independent streams (one per minnow block)."""
    lo, hi = split_u64(x)
    return jax.vmap(lambda a, b: _pack_1d(a, b, bits))(lo, hi)


@partial(jax.jit, static_argnames=("bits",))
def delta_pack_batch(x, mins, n, bits: int):
    """Fused ``(x - min) & mask -> pack`` at static width ``bits``: the
    second dispatch of the two-pass int encode (stats come from
    codec.int_block_stats).  Reads x (8 B/elem) and writes words
    (bits/8) directly -- no u64 delta round-trip through memory.  Tail
    elements past each block's length ``n`` pack as zero, matching
    codec.prepare_int_blocks (ref go/group.go:242-255); for widths
    <= 32 the deltas stay native u32."""
    mask = jax.lax.broadcasted_iota(
        jnp.int64, (1, x.shape[1]), 1) < n[:, None]
    d = jnp.where(mask, x - mins[:, None], 0)
    if bits <= 32:
        lo = d.astype(jnp.uint32)  # low 32 bits: exact for bits <= 32
        return jax.vmap(
            lambda a: _pack_1d(a, jnp.zeros_like(a), bits))(lo)
    lo, hi = split_u64(d.astype(jnp.uint64))
    return jax.vmap(lambda a, b: _pack_1d(a, b, bits))(lo, hi)


@partial(jax.jit, static_argnames=("bits", "n"))
def unpack_batch(words, bits: int, n: int):
    """(B, W) words -> (B, n) uint64."""
    lo, hi = jax.vmap(lambda w: _unpack_1d(w, bits, n))(words)
    return join_u64(lo, hi)


@partial(jax.jit, static_argnames=("bits", "n"))
def unpack_batch32(words, bits: int, n: int):
    """(B, W) words -> (B, n) uint32, for widths <= 32 (the
    all-native-width decode path)."""
    if bits > 32:
        raise ValueError("unpack_batch32 requires bits <= 32")
    lo, _ = jax.vmap(lambda w: _unpack_1d(w, bits, n))(words)
    return lo


# -- host-side glue ---------------------------------------------------------


def words_to_bytes(words, bits: int, n: int) -> bytes:
    """Device words -> exact reference byte stream (host)."""
    raw = np.asarray(words).astype("<u4").tobytes()
    return raw[: spec.array_bytes(bits, n)]


def bytes_to_words(data: bytes, bits: int, n: int) -> np.ndarray:
    """Reference byte stream -> device words (host)."""
    need = words_per_block(bits, n)
    buf = data[: spec.array_bytes(bits, n)]
    buf = buf + b"\0" * (need * 4 - len(buf))
    return np.frombuffer(buf, dtype="<u4").copy()
