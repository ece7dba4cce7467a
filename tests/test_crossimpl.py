"""Cross-implementation validation against the *untouched* reference
Python stack (ref python/minnow.py, python/minh.py, python/bit.py).

The reference runs in a subprocess with ``tests/crossimpl/cy_bit_shim``
standing in for its compiled Cython kernel (no Cython in this image; the
shim is a literal transcription of cy_bit.pyx and imports nothing from
this repo).  This replicates the reference's own cross-implementation
contract -- its Go and Python stacks validate against each other through
shared files (ref go/minnow_test.go:191-310, python/minnow_test.py:358-368).

Directions covered:

* byte identity: this repo's writer and the reference writer produce
  bit-for-bit identical containers and minh files for the same inputs
  (fixed-size and bit-packed int groups; the reference Python float-group
  *writer* quantizes in float64 instead of the normative float32 -- SURVEY
  App. B #5 -- so float byte identity is asserted through the reference
  *reader* instead, see below);
* repo reader decodes reference-written files exactly;
* reference reader decodes repo-written files exactly, including float
  groups: the reference's per-block dither stream (``random.seed(b)``,
  ref python/minnow.py:175) is replicated here to recover the exact pixel
  indices the reference unpacked, which are compared against the
  normative quantizer -- proving the packed float payload bytes decode
  identically through the reference's own bit kernel.

Fixture values stay below 2**47 so the reference's float64
``ceil(log2(max+1))`` width formula is exact (see spec.precision_needed).
"""

import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from minnow_tpu.core import spec
from minnow_tpu.core import types as mtypes
from minnow_tpu.core import reader as mreader
from minnow_tpu.core import writer as mwriter
from minnow_tpu.formats import minh as mminh

HERE = os.path.dirname(os.path.abspath(__file__))
CROSS = os.path.join(HERE, "crossimpl")
SHIM = os.path.join(CROSS, "cy_bit_shim")
REF_PY = "/root/reference/python"

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(REF_PY, "minnow.py")),
    reason="reference Python stack not available")


def run_ref(script, *args):
    """Run a tests/crossimpl driver with the reference stack on sys.path."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REF_PY + os.pathsep + SHIM
    res = subprocess.run(
        [sys.executable, os.path.join(CROSS, script)] + [str(a) for a in args],
        capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, (
        "%s failed:\nstdout:\n%s\nstderr:\n%s"
        % (script, res.stdout, res.stderr))


def ref_dither(block, n):
    """The reference reader's per-block dither stream
    (ref python/minnow.py:174-176): legacy numpy global RNG."""
    np.random.seed(block)
    return np.random.rand(n)


# ---------------------------------------------------------------------------
# Container fixtures
# ---------------------------------------------------------------------------


def container_fixture():
    """Headers + all ten fixed-size groups + a 4-block int group."""
    rng = np.random.RandomState(1234)
    plan, arrays = [], {}

    def data(key, arr):
        arrays[key] = arr
        plan.append({"op": "data", "key": key})

    plan.append({"op": "header", "key": "hdr0"})
    arrays["hdr0"] = np.frombuffer(b"minnow-tpu crossimpl fixture",
                                   dtype=np.uint8).copy()

    n = 257
    for gt in range(10):
        plan.append({"op": "fixed_group", "gt": gt, "n": n})
        dt = mtypes.FIXED_SIZE_DTYPES[gt]
        for b in range(2):
            if dt.kind == "f":
                arr = (rng.standard_normal(n) * 1e3).astype(dt)
            elif dt.kind == "u":
                arr = rng.randint(0, np.iinfo(dt).max // 2 + 1,
                                  size=n).astype(dt)
            else:
                info = np.iinfo(dt)
                arr = rng.randint(info.min // 2, info.max // 2 + 1,
                                  size=n).astype(dt)
            data("fg%d_%d" % (gt, b), arr)

    plan.append({"op": "header", "key": "hdr1"})
    arrays["hdr1"] = np.arange(7, dtype="<i8")

    m = 801
    plan.append({"op": "int_group", "n": m})
    data("ig_0", rng.randint(-5_000_000, 5_000_000, size=m).astype(np.int64))
    data("ig_1", np.full(m, -123456789, dtype=np.int64))  # 0-bit constant
    wide = rng.randint(0, 2, size=m).astype(np.int64) * ((1 << 33) - 1)
    data("ig_2", wide)                                     # 33-bit width
    data("ig_3", rng.randint(-3, 4, size=m).astype(np.int64))  # 3-bit width
    return plan, arrays


def write_repo_container(path, plan, arrays):
    w = mwriter.create(path)
    for op in plan:
        kind = op["op"]
        if kind == "header":
            w.header(arrays[op["key"]])
        elif kind == "fixed_group":
            w.fixed_size_group(op["gt"], op["n"])
        elif kind == "int_group":
            w.int_group(op["n"])
        elif kind == "data":
            w.data(arrays[op["key"]])
    w.close()


def save_container_fixture(path, plan, arrays):
    np.savez(path, plan=np.array(json.dumps(plan)), **arrays)


def plan_blocks(plan, arrays):
    """The (key, array) sequence of data blocks in container block order."""
    return [(op["key"], arrays[op["key"]])
            for op in plan if op["op"] == "data"]


def test_container_byte_identity_with_reference_writer(tmp_path):
    plan, arrays = container_fixture()
    npz = tmp_path / "fixture.npz"
    save_container_fixture(npz, plan, arrays)
    ref_file = tmp_path / "ref.minnow"
    repo_file = tmp_path / "repo.minnow"
    run_ref("ref_container_write.py", npz, ref_file)
    write_repo_container(str(repo_file), plan, arrays)
    ref_bytes = ref_file.read_bytes()
    repo_bytes = repo_file.read_bytes()
    assert len(ref_bytes) == len(repo_bytes)
    assert ref_bytes == repo_bytes


def test_repo_reader_reads_reference_container(tmp_path):
    plan, arrays = container_fixture()
    npz = tmp_path / "fixture.npz"
    save_container_fixture(npz, plan, arrays)
    ref_file = tmp_path / "ref.minnow"
    run_ref("ref_container_write.py", npz, ref_file)

    r = mreader.open(str(ref_file))
    assert r.header(0) == arrays["hdr0"].tobytes()
    np.testing.assert_array_equal(r.header(1, np.int64), arrays["hdr1"])
    blocks = plan_blocks(plan, arrays)
    assert r.blocks() == len(blocks)
    for b, (key, expect) in enumerate(blocks):
        got = r.data(b)
        assert got.dtype.kind == expect.dtype.kind, key
        np.testing.assert_array_equal(got, expect, err_msg=key)
    r.close()


def test_reference_reader_reads_repo_container(tmp_path):
    plan, arrays = container_fixture()
    repo_file = tmp_path / "repo.minnow"
    write_repo_container(str(repo_file), plan, arrays)
    out_npz = tmp_path / "refread.npz"
    run_ref("ref_container_read.py", repo_file, out_npz)

    out = np.load(out_npz)
    blocks = plan_blocks(plan, arrays)
    assert int(out["n_blocks"]) == len(blocks)
    for b, (key, expect) in enumerate(blocks):
        np.testing.assert_array_equal(out["block%d" % b], expect,
                                      err_msg=key)


# ---------------------------------------------------------------------------
# Float groups: repo writer -> reference reader, exact pixel recovery
# ---------------------------------------------------------------------------


def float_fixture():
    """Three float groups x two blocks, incl. a periodic wrap cluster."""
    rng = np.random.RandomState(99)
    n = 1500
    groups = []
    # uniform data over the box
    groups.append(dict(low=0.0, high=100.0, dx=0.05, blocks=[
        (rng.rand(n) * 100.0).astype(np.float32),
        (rng.rand(n) * 100.0).astype(np.float32),
    ]))
    # cluster wrapped across the periodic boundary -> nonzero periodic min
    wrap = np.concatenate([rng.rand(n // 2) * 3.0,
                           100.0 - rng.rand(n - n // 2) * 3.0])
    groups.append(dict(low=0.0, high=100.0, dx=0.01, blocks=[
        wrap.astype(np.float32),
        np.roll(wrap, 7).astype(np.float32),
    ]))
    # negative range
    groups.append(dict(low=-50.0, high=75.0, dx=0.1, blocks=[
        (rng.rand(n) * 125.0 - 50.0).astype(np.float32),
        (rng.rand(n) * 125.0 - 50.0).astype(np.float32),
    ]))
    return groups


def test_reference_reader_reads_repo_float_groups(tmp_path):
    groups = float_fixture()
    repo_file = tmp_path / "repo_float.minnow"
    w = mwriter.create(str(repo_file))
    for g in groups:
        w.float_group(len(g["blocks"][0]), (g["low"], g["high"]), g["dx"])
        for x in g["blocks"]:
            w.data(x)
    w.close()

    out_npz = tmp_path / "refread.npz"
    run_ref("ref_container_read.py", repo_file, out_npz)
    out = np.load(out_npz)

    b = 0
    for g in groups:
        low32 = np.float32(g["low"])
        high32 = np.float32(g["high"])
        pixels = spec.float_group_pixels(g["low"], g["high"], g["dx"])
        # the reference reader dequantizes in float64
        # (ref python/minnow.py:355-360)
        dx64 = (float(high32) - float(low32)) / pixels
        for x in g["blocks"]:
            got = out["block%d" % b]
            u = ref_dither(b, len(x))
            # exact pixel recovery through the reference's bit kernel
            q_rec = np.rint((got - float(low32)) / dx64 - u).astype(np.int64)
            q_expect = spec.quantize(x, g["low"], g["high"], pixels)
            np.testing.assert_array_equal(q_rec, q_expect)
            # decoded-value contract: |x_hat - x| <= dx
            assert np.max(np.abs(got - x.astype(np.float64))) <= \
                dx64 * 1.0001
            b += 1


# ---------------------------------------------------------------------------
# minh files
# ---------------------------------------------------------------------------


def minh_int_fixture():
    """Int-only minh catalog (the reference Python float-group *writer*
    diverges from the normative float32 quantizer, so byte-identity
    fixtures exclude float columns)."""
    rng = np.random.RandomState(7)
    names = ["id", "descendant", "flags"]
    cols = [
        {"type": mminh.Int64, "log": 0, "low": 0.0, "high": 0.0, "dx": 0.0},
        {"type": mminh.Int, "log": 0, "low": 0.0, "high": 0.0, "dx": 0.0},
        {"type": mminh.Int32, "log": 0, "low": 0.0, "high": 0.0, "dx": 0.0},
    ]
    sizes = [400, 233, 512]
    blocks = []
    base = 0
    for n in sizes:
        blocks.append([
            (np.arange(n, dtype=np.int64) * 17 + base),
            rng.randint(-1, 10_000_000, size=n).astype(np.int64),
            rng.randint(0, 64, size=n).astype(np.int32),
        ])
        base += n * 17
    meta = {
        "names": names,
        "text": "crossimpl minh fixture",
        "cols": cols,
        "blocks": len(sizes),
        "geometry": [125.0, 0.0, 0],
    }
    return meta, blocks


def save_minh_fixture(path, meta, blocks):
    arrays = {}
    for b, cols in enumerate(blocks):
        for c, arr in enumerate(cols):
            arrays["b%d_c%d" % (b, c)] = arr
    np.savez(path, meta=np.array(json.dumps(meta)), **arrays)


def write_repo_minh(path, meta, blocks):
    cols = [mminh.Column(type=c["type"], log=c["log"], low=c["low"],
                         high=c["high"], dx=c["dx"]) for c in meta["cols"]]
    w = mminh.create(path)
    w.header(meta["names"], meta["text"], cols)
    if meta.get("geometry"):
        l, boundary, cells = meta["geometry"]
        w.geometry(l, boundary, cells)
    for cols_b in blocks:
        w.block(cols_b)
    w.close()


def test_minh_byte_identity_with_reference_writer(tmp_path):
    meta, blocks = minh_int_fixture()
    npz = tmp_path / "fixture.npz"
    save_minh_fixture(npz, meta, blocks)
    ref_file = tmp_path / "ref.minh"
    repo_file = tmp_path / "repo.minh"
    run_ref("ref_minh_write.py", npz, ref_file)
    write_repo_minh(str(repo_file), meta, blocks)
    assert ref_file.read_bytes() == repo_file.read_bytes()


def test_repo_minh_reads_reference_minh(tmp_path):
    meta, blocks = minh_int_fixture()
    npz = tmp_path / "fixture.npz"
    save_minh_fixture(npz, meta, blocks)
    ref_file = tmp_path / "ref.minh"
    run_ref("ref_minh_write.py", npz, ref_file)

    r = mminh.open(str(ref_file))
    assert r.names == meta["names"]
    # ints() follows the Go contract (ref go/minh/minh.go:232-237):
    # int64/int-group columns only.
    got = r.ints(["id", "descendant"])
    for c, name in enumerate(["id", "descendant"]):
        expect = np.concatenate([blocks[b][c] for b in range(len(blocks))])
        np.testing.assert_array_equal(got[name], expect)
    # the Int32 column reads exactly through the container layer
    ncols = len(meta["names"])
    for b in range(len(blocks)):
        np.testing.assert_array_equal(r.f.data(b * ncols + 2), blocks[b][2])
    r.close()


def minh_float_fixture():
    rng = np.random.RandomState(21)
    names = ["x", "mvir"]
    cols = [
        mminh.Column(type=mminh.Float, log=0, low=0.0, high=125.0, dx=0.001),
        mminh.Column(type=mminh.Float, log=1, low=10.0, high=15.0, dx=0.01),
    ]
    sizes = [700, 300]
    blocks = []
    for n in sizes:
        x = (rng.rand(n) * 125.0).astype(np.float32)
        mvir = (10.0 ** (10.0 + rng.rand(n) * 4.9)).astype(np.float32)
        blocks.append([x, mvir])
    return names, cols, blocks


def test_reference_minh_reads_repo_float_columns(tmp_path):
    names, cols, blocks = minh_float_fixture()
    repo_file = tmp_path / "repo_float.minh"
    w = mminh.create(str(repo_file))
    w.header(names, "float crossimpl", cols)
    for cols_b in blocks:
        w.block(cols_b)
    w.close()

    out_npz = tmp_path / "refread.npz"
    run_ref("ref_minh_read.py", repo_file, out_npz)
    out = np.load(out_npz)
    assert out["names"].item() == "$".join(names)

    ncols = len(cols)
    for c, col in enumerate(cols):
        got_full = out["col%d" % c]
        i0 = 0
        for b, cols_b in enumerate(blocks):
            x = cols_b[c]
            n = len(x)
            got = got_full[i0:i0 + n].astype(np.float64)
            i0 += n
            if col.log:
                got = np.log10(got)  # reference applied 10**
            pixels = spec.float_group_pixels(col.low, col.high, col.dx)
            low32 = np.float32(col.low)
            dx64 = (float(np.float32(col.high)) - float(low32)) / pixels
            # container block index for basic minh layout
            # (ref python/minh.py:150-153)
            idx = b * ncols + c
            u = ref_dither(idx, n)
            q_rec = np.rint((got - float(low32)) / dx64 - u).astype(np.int64)
            buf = mminh.process_float_column(x, col)
            q_expect = spec.quantize(buf, col.low, col.high, pixels)
            np.testing.assert_array_equal(q_rec, q_expect)
            # value contract on the (possibly log-scaled) column
            ref_vals = buf.astype(np.float64)
            assert np.max(np.abs(got - ref_vals)) <= dx64 * 1.0001


def test_reference_minh_reads_repo_boundary_file(tmp_path):
    """The untouched reference minh reader decodes a repo-written
    boundary-layout file: column-major block indexing (b + c*blocks,
    ref python/minh.py:150-153), int columns exact, float columns with
    exact pixel recovery."""
    from minnow_tpu.formats import boundary

    rng = np.random.default_rng(31)
    l, cells, bnd = 100.0, 2, 10.0
    n = 300
    x = rng.uniform(0, l - 0.2, n).astype(np.float32)
    y = rng.uniform(0, l - 0.2, n).astype(np.float32)
    z = rng.uniform(0, l - 0.2, n).astype(np.float32)
    ids = rng.integers(0, 10**10, n).astype(np.int64)

    repo_file = tmp_path / "repo.bnd.minh"
    w = boundary.create_boundary(str(repo_file))
    w.header("crossimpl boundary")
    w.geometry(l, bnd, cells)
    w.coordinates(x, y, z)
    cell_index = [np.array(i) for i in w.cell_index]
    w.column("id", mminh.Column(type=mminh.Int), ids)
    xcol = mminh.Column(type=mminh.Float, low=0.0, high=l, dx=0.01)
    w.column("x", xcol, x)
    w.close()

    out_npz = tmp_path / "refread.npz"
    run_ref("ref_minh_read.py", repo_file, out_npz)
    out = np.load(out_npz)
    assert out["names"].item() == "boundary$id$x"
    assert int(out["cells"]) == cells
    n_blocks = int(out["blocks"])
    assert n_blocks == cells ** 3
    lengths = out["block_lengths"]

    # repo reader provides the expected per-cell ordering
    r = mminh.open(str(repo_file), dither="none")
    expect_ids = r.ints(["id"])["id"]
    expect_flags = r.ints(["boundary"])["boundary"]
    np.testing.assert_array_equal(out["col1"], expect_ids)
    np.testing.assert_array_equal(out["col0"], expect_flags)

    # float column: exact pixel recovery through the reference's own
    # dither stream; container block index for boundary layout is
    # b + c*blocks with c the x-column's container column (2)
    pixels = spec.float_group_pixels(xcol.low, xcol.high, xcol.dx)
    dx64 = (float(np.float32(xcol.high)) - float(np.float32(xcol.low))) \
        / pixels
    got_x = out["col2"].astype(np.float64)
    i0 = 0
    for b in range(n_blocks):
        m = int(lengths[b])
        idx = b + 2 * n_blocks
        u = ref_dither(idx, m)
        q_rec = np.rint(
            (got_x[i0:i0 + m] - float(np.float32(xcol.low))) / dx64
            - u).astype(np.int64)
        # quantize the ORIGINAL per-cell values (re-quantizing decoded
        # values is off by one at pixel boundaries)
        cell_x = mminh.process_float_column(x[cell_index[b]], xcol)
        q_expect = spec.quantize(cell_x, xcol.low, xcol.high, pixels)
        np.testing.assert_array_equal(q_rec, q_expect)
        i0 += m
    r.close()
