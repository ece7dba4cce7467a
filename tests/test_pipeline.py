"""Sharded pipeline tests on the virtual 8-device CPU mesh.

The multi-chip analog of the reference's in-memory multi-file mocks
(ref go/minp/snapshot/mock.go): shard blocks over 8 virtual devices,
assert the assembled bytes equal the host spec encoder byte-for-byte.
"""

import numpy as np
import pytest

import jax

from minnow_tpu.core import spec
from minnow_tpu.parallel import BlockEncoder, mesh as mesh_lib


@pytest.fixture(scope="module")
def mesh8():
    devs = jax.devices()
    assert len(devs) >= 8, "conftest must force 8 virtual cpu devices"
    return mesh_lib.block_mesh(devs[:8])


def _check_float_equal_to_spec(enc, x, low, high, pixels, lens,
                               periodic=True, clamp_q=False):
    for i in range(x.shape[0]):
        payload, mn, bits, _ = spec.encode_float_block(
            x[i, :lens[i]], low if np.isscalar(low) else low[i],
            high if np.isscalar(high) else high[i],
            int(pixels if np.isscalar(pixels) else pixels[i]),
            periodic=periodic, clamp_q=clamp_q)
        assert enc.payloads[i] == payload, i
        assert enc.mins[i] == mn, i
        assert enc.bits[i] == bits, i


def test_sharded_float_encode_matches_spec(mesh8):
    rng = np.random.default_rng(0)
    b, n = 19, 256  # deliberately not a multiple of 8
    low, high, dx = 0.0, 250.0, 0.01
    pixels = spec.float_group_pixels(low, high, dx)
    x = ((rng.uniform(-3, 3, (b, n)) + 250) % 250).astype(np.float32)
    lens = rng.integers(1, n + 1, b)

    enc = BlockEncoder(mesh8).encode_float_blocks(
        x, low, high, pixels, lens=lens)
    _check_float_equal_to_spec(enc, x, low, high, pixels, lens)

    # writer-order offsets are the exclusive prefix sum of sizes
    np.testing.assert_array_equal(
        enc.offsets, np.concatenate([[0], np.cumsum(enc.sizes)[:-1]]))


def test_sharded_int_encode_matches_spec(mesh8):
    rng = np.random.default_rng(1)
    b, n = 16, 128
    x = rng.integers(-(2**45), 2**45, (b, n), dtype=np.int64)
    x[3] = 7  # constant block -> bits 0
    enc = BlockEncoder(mesh8).encode_int_blocks(x)
    for i in range(b):
        payload, mn, bits = spec.encode_int_block(x[i])
        assert enc.payloads[i] == payload
        assert (enc.mins[i], enc.bits[i]) == (mn, bits)
    assert enc.bits[3] == 0 and enc.payloads[3] == b""


def test_sharded_roundtrip_decode(mesh8):
    rng = np.random.default_rng(2)
    b, n = 8, 512
    low, high, dx = -50.0, 100.0, 0.125
    pixels = spec.float_group_pixels(low, high, dx)
    x = rng.uniform(-50, 99.9, (b, n)).astype(np.float32)
    be = BlockEncoder(mesh8)
    enc = be.encode_float_blocks(x, low, high, pixels)
    dec = be.decode_float_blocks(enc.payloads, enc.mins, enc.bits, low,
                                 high, pixels, n, dither="uniform")
    assert np.all(np.abs(dec - x) <= dx * (1 + 1e-5))
    dec2 = be.decode_float_blocks(enc.payloads, enc.mins, enc.bits, low,
                                  high, pixels, n, dither="uniform")
    np.testing.assert_array_equal(dec, dec2)


def test_out_of_range_block_falls_back_to_host(mesh8):
    x = np.array([[-5.0, 5.0, 11.0, 2.0]], np.float32)  # q outside [0, P)
    pixels = spec.float_group_pixels(0, 10, 0.5)
    enc = BlockEncoder(mesh8).encode_float_blocks(x, 0.0, 10.0, pixels)
    payload, mn, bits, _ = spec.encode_float_block(x[0], 0.0, 10.0, pixels)
    assert enc.payloads[0] == payload
    assert enc.mins[0] == mn and enc.bits[0] == bits


def test_pipeline_feeds_container_writer(tmp_path, mesh8):
    """Device-encoded payloads stream into the container via the
    pre-encoded fast path and read back identically."""
    import minnow_tpu as minnow

    rng = np.random.default_rng(3)
    b, n = 12, 100
    low, high, dx = 0.0, 100.0, 0.01
    pixels = spec.float_group_pixels(low, high, dx)
    x = rng.uniform(0, 99.9, (b, n)).astype(np.float32)

    enc = BlockEncoder(mesh8).encode_float_blocks(x, low, high, pixels)

    fname = str(tmp_path / "dev.minnow")
    w = minnow.create(fname)
    w.float_group(n, (low, high), dx)
    enc.write_to(w)
    w.close()

    # Byte-identity with the pure-host writer
    fname2 = str(tmp_path / "host.minnow")
    w2 = minnow.create(fname2)
    w2.float_group(n, (low, high), dx)
    for i in range(b):
        w2.data(x[i])
    w2.close()
    assert open(fname, "rb").read() == open(fname2, "rb").read()

    r = minnow.open(fname, dither="none")
    for i in range(b):
        got = r.data(i)
        assert np.all(np.abs(got - x[i]) <= dx * (1 + 1e-5))
    r.close()


def test_int_encode_fused_delta_pack_edges(mesh8):
    """The two-pass int encode (stats-only read + fused delta+pack)
    matches spec.encode_int_block bytes on the edge shapes: masked
    tails (lens < N), full-span wraps (max - min overflows int64),
    widths on both sides of 32, and negative mins."""
    rng = np.random.default_rng(9)
    b, n = 8, 96
    x = rng.integers(-(2**40), 2**40, (b, n), dtype=np.int64)
    x[0, 0], x[0, 1] = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    x[1] = rng.integers(0, 7, n)                   # 3-bit deltas
    x[2] = rng.integers(-(2**62), 2**62, n)        # ~63-bit deltas
    x[4] = -(10**12) + rng.integers(0, 100, n)     # negative mins
    lens = np.array([n, n, n, 0, n, 17, n, 1], dtype=np.int64)
    enc = BlockEncoder(mesh8).encode_int_blocks(x, lens=lens)
    for i in range(b):
        payload, mn, bits = spec.encode_int_block(x[i, :lens[i]])
        if lens[i] == 0:
            mn = 0
        assert enc.payloads[i] == payload, i
        assert (enc.mins[i], enc.bits[i]) == (mn, bits), i


def test_sharded_decode_bit_identical_to_host_reader(tmp_path, mesh8):
    """Mesh-sharded bulk decode of a host-written minh file equals the
    host reader bit-for-bit (the read mirror of the encode sharding,
    ref go/reader.go:114-127)."""
    from minnow_tpu.formats import minh as minh_mod

    rng = np.random.default_rng(31)
    m, nblk = 64, 5  # 5 blocks: pads to 8 on the mesh
    cols = [minh_mod.Column(type=minh_mod.Int),
            minh_mod.Column(type=minh_mod.Float, low=0.0, high=250.0,
                            dx=0.001)]
    blocks = [(rng.integers(0, 1 << 45, m).astype(np.int64),
               rng.uniform(0, 249.9, m).astype(np.float32))
              for _ in range(nblk)]
    fname = str(tmp_path / "dec.minh")
    w = minh_mod.create(fname)
    w.header(["id", "x"], "", cols)
    w.geometry(250.0, 0, 0)
    for ids, xs in blocks:
        w.block([ids, xs])
    w.close()

    be = BlockEncoder(mesh8)
    r = minh_mod.open(fname, dither="none")
    host = {**r.ints(["id"]), **r.floats(["x"])}
    for c, name in ((0, "id"), (1, "x")):
        raw = [r.f.raw_block(r._block_idx(c, b))
               for b in range(r.blocks)]
        payloads = [blk[0] for blk in raw]
        mins = np.asarray([blk[1] for blk in raw], np.int64)
        bits = np.asarray([blk[2] for blk in raw], np.int64)
        if name == "id":
            dec = be.decode_int_blocks(payloads, mins, bits, m)
            np.testing.assert_array_equal(dec.reshape(-1), host[name])
        else:
            low, high, pixels, per = raw[0][4]
            dec = be.decode_float_blocks(
                payloads, mins, bits, low, high, pixels, m,
                periodic=per, dither="none")
            np.testing.assert_array_equal(
                dec.reshape(-1).view(np.uint32),
                host[name].view(np.uint32))
    r.close()


def test_minp_mesh_writer_byte_identical(tmp_path, mesh8):
    """minp vectors written through the mesh-sharded encoder == host
    writer bytes (ref go/minp/minp.go:86-119)."""
    from minnow_tpu.formats import minp

    rng = np.random.default_rng(33)
    hd = minp.Header(l=100.0, n_side=8, n_total=512)
    vec = rng.uniform(0, 99.9, (512, 3)).astype(np.float32)
    host_f = str(tmp_path / "h.minp")
    mesh_f = str(tmp_path / "m.minp")
    for fname, enc in ((host_f, None), (mesh_f, BlockEncoder(mesh8))):
        w = minp.Writer(fname, encoder=enc)
        w.header(hd, b"hdr", minp.Cell(0, 1, 2), 0.01, True)
        w.vectors(vec)
        w.close()
    assert open(host_f, "rb").read() == open(mesh_f, "rb").read()


def test_boundary_mesh_writer_byte_identical(tmp_path, mesh8):
    """Boundary write through the mesh-sharded encoder == host per-cell
    loop bytes (ref go/minh/boundary.go:184-225)."""
    from minnow_tpu.formats import boundary, minh
    from minnow_tpu.formats.boundary_device import DeviceBoundaryWriter

    rng = np.random.default_rng(35)
    l, cells, bnd = 100.0, 2, 5.0
    n = 200
    x = (rng.uniform(0, 1, n) * l).astype(np.float32)
    y = (rng.uniform(0, 1, n) * l).astype(np.float32)
    z = (rng.uniform(0, 1, n) * l).astype(np.float32)
    ids = rng.integers(0, 10 ** 12, n).astype(np.int64)

    def write(fname, enc):
        w = boundary.create_boundary(fname)
        if enc is not None:
            w = DeviceBoundaryWriter(w, encoder=enc)
        w.header("t")
        w.geometry(l, bnd, cells)
        w.coordinates(x, y, z)
        w.column("id", minh.Column(type=minh.Int), ids)
        w.column("x", minh.Column(type=minh.Float, low=0, high=l,
                                  dx=0.001), x)
        w.close()

    host_f = str(tmp_path / "h.minh")
    mesh_f = str(tmp_path / "m.minh")
    write(host_f, None)
    write(mesh_f, BlockEncoder(mesh8))
    assert open(host_f, "rb").read() == open(mesh_f, "rb").read()

