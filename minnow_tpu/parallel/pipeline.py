"""Sharded block encode/decode pipeline.

The distributed generalization of the reference's sequential writer loop
(ref go/minh/minh.go:99-139 + go/bit/bit.go): minnow blocks are
data-parallel (each carries its own min/bits metadata,
ref go/group.go:242-263), so the pipeline

  1. shards the block axis of a (B, N) batch across the mesh and runs the
     fused quantize/recenter/delta/stats program (ops/codec.py) -- one jit,
     XLA inserts any needed collectives;
  2. resolves the data-dependent pack width per block on host (exact
     ``precision_needed``), bucketing blocks by width;
  3. packs each bucket with the width-specialized word-parallel kernel
     (ops/bitpack.py), still sharded;
  4. computes writer-order byte offsets as an exclusive prefix-sum of the
     block sizes (the distributed analog of blockIndex.addBlock,
     ref go/block_index.go:16-23) and assembles exact reference bytes.

Blocks whose pixels fall outside [0, P) (possible only through the raw
float API) are re-encoded on host with the normative greedy scan --
the device one-pass reduction flags them via ``valid``.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import numpy as np

from ..core import spec
from ..ops import bitpack, codec
from . import mesh as mesh_lib

__all__ = ["EncodedBlocks", "BlockEncoder"]


@dataclass
class EncodedBlocks:
    """Result of encoding a batch of blocks: per-block packed payloads and
    tail metadata, plus writer-order offsets."""

    payloads: list  # list[bytes], one per block
    mins: np.ndarray  # (B,) int64
    bits: np.ndarray  # (B,) int64
    lens: np.ndarray  # (B,) int64 valid lengths

    @property
    def sizes(self) -> np.ndarray:
        return np.array([len(p) for p in self.payloads], dtype=np.int64)

    @property
    def offsets(self) -> np.ndarray:
        """Exclusive prefix-sum: byte offset of each block within the
        group's data region (ref go/block_index.go)."""
        sizes = self.sizes
        out = np.zeros_like(sizes)
        np.cumsum(sizes[:-1], out=out[1:])
        return out

    def total_bytes(self) -> int:
        return int(self.sizes.sum())

    def write_to(self, writer) -> None:
        """Append all blocks to the current group of a core Writer via the
        pre-encoded fast path."""
        for payload, mn, bits in zip(self.payloads, self.mins, self.bits):
            writer.data_encoded(payload, int(mn), int(bits))


class BlockEncoder:
    """Device-sharded encoder/decoder for batches of minnow blocks.

    Runs on JAX's default backend; with ``mesh`` the block axis is
    sharded over the mesh's devices.  Bytes are identical to the host
    spec encoding whatever the backend or mesh."""

    def __init__(self, mesh=None):
        from ..utils import device

        device.ensure_compile_cache()
        self.mesh = mesh

    # -- helpers -----------------------------------------------------------

    def _shard(self, *arrays):
        """Place batch arrays with the block axis sharded over the mesh."""
        if self.mesh is None:
            return arrays
        out = []
        for a in arrays:
            sh = mesh_lib.block_sharding(self.mesh, np.ndim(a))
            out.append(jax.device_put(a, sh))
        return tuple(out)

    def _pad(self, b: int) -> int:
        if self.mesh is None:
            return b
        d = self.mesh.devices.size
        return b + ((-b) % d)

    @staticmethod
    def _as_batch(x, lens):
        x = np.asarray(x)
        b, n = x.shape
        if lens is None:
            lens = np.full(b, n, dtype=np.int64)
        else:
            lens = np.asarray(lens, dtype=np.int64)
        return x, b, n, lens

    @staticmethod
    def _bucket_loop(rows_all, bits, lens, pack_rows) -> list:
        """Shared width-bucketing: group rows by width, call
        ``pack_rows(rows, idx, width) -> (B_idx, W) words`` per bucket,
        and slice each row's payload bytes (``idx`` may repeat the
        bucket's last block as padding).  Device rows stay on device
        between the stats pass and the width-specialized pack (only the
        packed words -- the compressed bytes -- ever cross to host)."""
        b = rows_all.shape[0]
        payloads: list = [b""] * b
        for width in np.unique(bits):
            width = int(width)
            if width == 0:
                continue
            idx = np.nonzero(bits == width)[0]
            if len(idx) < b:
                # pad the bucket by repeating its last block (bounded
                # compiles, see codec.padded_rows)
                pidx = idx[np.minimum(np.arange(
                    codec.padded_rows(len(idx))), len(idx) - 1)]
                rows = rows_all[pidx]
            else:
                pidx, rows = idx, rows_all
            words = np.asarray(pack_rows(rows, pidx, width))
            for row, block_id in enumerate(idx):
                payloads[block_id] = bitpack.words_to_bytes(
                    words[row], width, int(lens[block_id]))
        return payloads

    def _bucket_pack(self, deltas, bits, lens) -> list:
        """Pack rows of materialized ``deltas`` grouped by width
        (the float encode prep's tail)."""
        return self._bucket_loop(
            deltas, bits, lens,
            lambda rows, idx, width: bitpack.pack_batch(rows, width))

    def _bucket_pack_ints(self, x, mins, bits, lens) -> list:
        """Width-bucketed fused delta+pack for int blocks: the second
        dispatch of the two-pass int encode reads ``x`` + per-block
        mins and emits words directly (no materialized deltas,
        ref go/group.go:242-255)."""
        mins64 = np.asarray(mins, np.int64)
        lens64 = np.asarray(lens, np.int64)
        return self._bucket_loop(
            x, bits, lens,
            lambda rows, idx, width: bitpack.delta_pack_batch(
                rows, mins64[idx], lens64[idx], width))

    # -- encode ------------------------------------------------------------

    def encode_int_blocks(self, x, lens=None) -> EncodedBlocks:
        """Encode (B, N) int64 blocks (ref go/group.go:242-255).

        Two-pass: a fused stats-only read (codec.int_block_stats), then
        a width-bucketed fused delta+pack straight from ``x``
        (bitpack.delta_pack_batch) -- the u64 deltas never round-trip
        through HBM, and widths <= 32 pack in native u32."""
        x, b, n, lens = self._as_batch(x, lens)
        bp = self._pad(b)
        if bp != b:
            x = np.pad(x, [(0, bp - b), (0, 0)])
            lens_p = np.pad(lens, (0, bp - b), constant_values=1)
        else:
            lens_p = lens
        (x_d, lens_d) = self._shard(x, lens_p)
        mins_d, maxd = codec.int_block_stats(x_d, lens_d)
        x_d = x_d[:b]  # stays on device for the pack dispatches
        mins = np.asarray(mins_d)[:b].copy()
        maxd = np.asarray(maxd)[:b]
        mins[lens == 0] = 0  # empty block: min is 0 (ref go/group.go:244)
        bits = np.array([spec.precision_needed(int(m)) for m in maxd],
                        dtype=np.int64)
        payloads = self._bucket_pack_ints(x_d, mins, bits, lens)
        return EncodedBlocks(payloads, mins, bits, lens)

    def encode_float_blocks(self, x, low, high, pixels, lens=None,
                            periodic=True,
                            clamp_q: bool = False) -> EncodedBlocks:
        """Encode (B, N) float32 blocks (ref go/group.go:312-327).

        ``low``/``high``/``pixels``/``periodic`` may be scalars or (B,)
        arrays (per-block quantization configs are broadcast with the
        data, matching the multi-column minh layout)."""
        x, b, n, lens = self._as_batch(x, lens)
        low = np.broadcast_to(np.asarray(low, np.float32), (b,)).copy()
        high = np.broadcast_to(np.asarray(high, np.float32), (b,)).copy()
        pixels = np.broadcast_to(np.asarray(pixels, np.int64), (b,)).copy()
        periodic = np.broadcast_to(np.asarray(periodic, bool), (b,)).copy()
        bp = self._pad(b)
        if bp != b:
            pad = bp - b
            x = np.pad(x, [(0, pad), (0, 0)])
            low = np.pad(low, (0, pad))
            high = np.pad(high, (0, pad), constant_values=1)
            pixels = np.pad(pixels, (0, pad), constant_values=1)
            periodic = np.pad(periodic, (0, pad))
            lens_p = np.pad(lens, (0, pad), constant_values=1)
        else:
            lens_p = lens

        # host: per-block pixel width + divisor magic for the
        # integer-exact fast quantize (ops/fastdiv.py)
        from ..ops import fastdiv

        with np.errstate(all="ignore"):
            dxq = (np.float32(high - low)
                   / pixels.astype(np.float32)).astype(np.float32)
        db, deb, dm0, dm1, dok = fastdiv.divisor_magic(dxq)

        sharded = self._shard(x, low, periodic, db, deb, dm0, dm1)
        (x_d, low_d, per_d, db_d, deb_d, dm0_d, dm1_d) = sharded
        (pix_d, lens_d) = self._shard(pixels, lens_p)
        # all-native-width graph when every pixel count fits 29 bits
        # (int32 arithmetic + uint32 deltas; no 64-bit emulation)
        prep = codec.prepare_float_blocks_fast32 \
            if int(pixels.max()) < (1 << 29) \
            else codec.prepare_float_blocks_fast
        deltas, mins, maxd, valid = prep(
            x_d, low_d, pix_d, lens_d, per_d, db_d, deb_d, dm0_d, dm1_d,
            clamp_q=clamp_q)
        deltas = deltas[:b]  # stays on device
        mins = np.asarray(mins)[:b].astype(np.int64)
        maxd = np.asarray(maxd)[:b].astype(np.uint64)
        mins[lens == 0] = 0  # empty block: min is 0 (ref go/group.go:244)
        valid = np.asarray(valid)[:b] & dok[:b]

        if not valid.all():
            # Rare fallback: out-of-range pixels -> normative host greedy
            # scan (raw float API only; minh/minp data is always in range).
            deltas = np.asarray(deltas).copy()
            for i in np.nonzero(~valid)[0]:
                payload, mn, bits_i, q = spec.encode_float_block(
                    x[i, :lens[i]], low[i], high[i], int(pixels[i]),
                    periodic=bool(periodic[i]), clamp_q=clamp_q)
                mn64 = np.int64(mn)
                d = np.zeros(n, np.uint64)
                d[:lens[i]] = (q - mn64).view(np.uint64)
                deltas[i] = d
                mins[i] = mn64
                maxd[i] = d.max() if lens[i] else 0

        bits = np.array([spec.precision_needed(int(m)) for m in maxd],
                        dtype=np.int64)
        payloads = self._bucket_pack(deltas, bits, lens)
        return EncodedBlocks(payloads, mins, bits, lens)

    # -- decode ------------------------------------------------------------

    def _shard_rows(self, *arrays):
        """Pad the leading (block) axis of a decode bucket to the mesh
        size and shard it; returns (padded+sharded arrays, valid rows).
        Off-mesh this is the identity (decode buckets are elementwise
        per block, so XLA auto-SPMD handles the sharded batch with no
        program changes -- the read mirror of the encode sharding,
        ref go/reader.go:114-127)."""
        b = arrays[0].shape[0]
        if self.mesh is None:
            return arrays, b
        bp = self._pad(b)
        if bp != b:
            arrays = tuple(
                np.pad(a, [(0, bp - b)] + [(0, 0)] * (a.ndim - 1))
                for a in arrays)
        return self._shard(*arrays), b

    def decode_int_blocks(self, payloads, mins, bits, n: int) -> np.ndarray:
        """Decode per-block payloads back to (B, n) int64."""
        b = len(payloads)
        mins = np.asarray(mins, np.int64)
        bits = np.asarray(bits, np.int64)
        out = np.empty((b, n), dtype=np.int64)
        for width in np.unique(bits):
            width = int(width)
            idx = np.nonzero(bits == width)[0]
            if width == 0:
                out[idx] = mins[idx, None]
                continue
            w = bitpack.words_per_block(width, n)
            words = np.zeros((len(idx), w), dtype=np.uint32)
            for row, block_id in enumerate(idx):
                words[row] = bitpack.bytes_to_words(
                    payloads[block_id], width, n)
            (words_d, mins_d), nb = self._shard_rows(words, mins[idx])
            dec = np.asarray(codec.decode_int_blocks(
                words_d, mins_d, width, n))[:nb]
            out[idx] = dec
        return out

    def decode_float_blocks(self, payloads, mins, bits, low, high, pixels,
                            n: int, periodic=True, dither: str = "none",
                            seed: int = 0, block_ids=None) -> np.ndarray:
        """Decode per-block payloads back to (B, n) float32
        (ref go/group.go:299-310)."""
        b = len(payloads)
        mins = np.asarray(mins, np.int64)
        bits = np.asarray(bits, np.int64)
        low = np.broadcast_to(np.asarray(low, np.float32), (b,))
        high = np.broadcast_to(np.asarray(high, np.float32), (b,))
        pixels = np.broadcast_to(np.asarray(pixels, np.int64), (b,))
        periodic = np.broadcast_to(np.asarray(periodic, bool), (b,))
        if block_ids is None:
            block_ids = np.arange(b, dtype=np.int64)
        block_ids = np.asarray(block_ids, np.int64)

        out = np.empty((b, n), dtype=np.float32)
        for width in np.unique(bits):
            width = int(width)
            idx = np.nonzero(bits == width)[0]
            w = max(bitpack.words_per_block(width, n), 1)
            words = np.zeros((len(idx), w), dtype=np.uint32)
            if width:
                for row, block_id in enumerate(idx):
                    words[row] = bitpack.bytes_to_words(
                        payloads[block_id], width, n)
            sharded, nb = self._shard_rows(
                words, mins[idx], low[idx], high[idx], pixels[idx],
                periodic[idx], block_ids[idx])
            (words_d, mins_d, low_d, high_d, pix_d, per_d, bid_d) = \
                sharded
            dec = np.asarray(codec.decode_float_blocks(
                words_d, mins_d, low_d, high_d, pix_d, per_d, bid_d,
                width, n, dither=dither, seed=seed))[:nb]
            out[idx] = dec
        return out
