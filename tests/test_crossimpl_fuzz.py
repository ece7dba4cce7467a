"""GENERATIVE cross-implementation fuzz against the untouched reference
Python stack (ref python/minnow.py, python/minh.py).

The fixed-fixture cross-impl tests (test_crossimpl.py) spot-check the
byte contract; this file fuzzes it: ~100 random seeds across container,
minh, float-group, and boundary shapes, pushed through the reference
subprocess in BATCHES (tests/crossimpl/ref_batch.py -- one interpreter
per direction, not per seed).  This replicates, at fuzz scale, the
reference's own cross-impl ritual (ref python/minnow_test.py:358-368).

Generation constraints mirror the reference's numeric envelope:
int spans stay below 2**47 so its float64 ``ceil(log2(max+1))`` width
formula is exact, and float values stay inside [low, high).

``MINNOW_TPU_CROSSIMPL_FUZZ_SEEDS`` scales the per-category seed count
(default 25; total = 4x that).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from minnow_tpu.core import reader as mreader
from minnow_tpu.core import spec
from minnow_tpu.core import types as mtypes
from minnow_tpu.core import writer as mwriter
from minnow_tpu.formats import minh as mminh

HERE = os.path.dirname(os.path.abspath(__file__))
CROSS = os.path.join(HERE, "crossimpl")
SHIM = os.path.join(CROSS, "cy_bit_shim")
REF_PY = "/root/reference/python"

SEEDS = int(os.environ.get("MINNOW_TPU_CROSSIMPL_FUZZ_SEEDS", "25"))

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(REF_PY, "minnow.py")),
    reason="reference Python stack not available")


def run_ref_batch(manifest_lines, tmp_path):
    """Run a list of ``mode in out`` jobs in one reference subprocess."""
    manifest = tmp_path / "manifest.txt"
    manifest.write_text("\n".join(manifest_lines) + "\n")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REF_PY + os.pathsep + SHIM
    res = subprocess.run(
        [sys.executable, os.path.join(CROSS, "ref_batch.py"),
         str(manifest)],
        capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, (
        "ref_batch failed:\nstdout:\n%s\nstderr:\n%s"
        % (res.stdout, res.stderr))


def ref_dither(block, n):
    """(ref python/minnow.py:174-176): legacy numpy global RNG."""
    np.random.seed(block)
    return np.random.rand(n)


def rand_int_column(rng, n):
    """Random int64 data spanning the width envelope: constants, tiny,
    wide (up to 46-bit spans), negative mins."""
    kind = rng.integers(0, 4)
    base = int(rng.integers(-(1 << 45), 1 << 45))
    if kind == 0:
        return np.full(n, base, np.int64)
    w = int(rng.integers(1, 47))
    span = 1 << w
    hi_cap = min(span, (1 << 46))
    vals = base + rng.integers(0, hi_cap, n)
    # clamp the span below 2**47 around base
    return vals.astype(np.int64)


# ---------------------------------------------------------------------------
# A. containers: byte identity + both read directions
# ---------------------------------------------------------------------------


def gen_container(rng):
    plan, arrays = [], {}
    key_i = [0]

    def data(arr):
        key = "k%d" % key_i[0]
        key_i[0] += 1
        arrays[key] = arr
        plan.append({"op": "data", "key": key})

    plan.append({"op": "header", "key": "hdr"})
    arrays["hdr"] = rng.integers(0, 256, rng.integers(1, 64),
                                 dtype=np.int64).astype(np.uint8)
    for _ in range(int(rng.integers(1, 4))):
        gt = int(rng.integers(0, 10))
        n = int(rng.integers(1, 700))
        plan.append({"op": "fixed_group", "gt": gt, "n": n})
        dt = mtypes.FIXED_SIZE_DTYPES[gt]
        for _ in range(int(rng.integers(1, 3))):
            if dt.kind == "f":
                arr = (rng.standard_normal(n) * 1e3).astype(dt)
            elif dt.kind == "u":
                arr = rng.integers(0, np.iinfo(dt).max // 2 + 1,
                                   n).astype(dt)
            else:
                info = np.iinfo(dt)
                arr = rng.integers(info.min // 2, info.max // 2 + 1,
                                   n).astype(dt)
            data(arr)
    m = int(rng.integers(1, 900))
    plan.append({"op": "int_group", "n": m})
    for _ in range(int(rng.integers(1, 4))):
        data(rand_int_column(rng, m))
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


def test_fuzz_container_byte_identity_and_reads(tmp_path):
    cases = []
    manifest = []
    for s in range(SEEDS):
        rng = np.random.default_rng(1000 + s)
        plan, arrays = gen_container(rng)
        npz = tmp_path / ("fix%d.npz" % s)
        np.savez(npz, plan=np.array(json.dumps(plan)), **arrays)
        repo_file = tmp_path / ("repo%d.minnow" % s)
        ref_file = tmp_path / ("ref%d.minnow" % s)
        refread = tmp_path / ("refread%d.npz" % s)
        write_repo_container(str(repo_file), plan, arrays)
        manifest.append("container_write %s %s" % (npz, ref_file))
        manifest.append("container_read %s %s" % (repo_file, refread))
        cases.append((plan, arrays, repo_file, ref_file, refread))
    run_ref_batch(manifest, tmp_path)

    for s, (plan, arrays, repo_file, ref_file, refread) in \
            enumerate(cases):
        # byte identity with the reference writer
        assert repo_file.read_bytes() == ref_file.read_bytes(), \
            "container bytes diverge at seed %d" % s
        blocks = [(op["key"], arrays[op["key"]])
                  for op in plan if op["op"] == "data"]
        # reference reader decodes the repo-written file exactly
        out = np.load(refread)
        assert int(out["n_blocks"]) == len(blocks)
        for b, (key, expect) in enumerate(blocks):
            np.testing.assert_array_equal(
                out["block%d" % b], expect,
                err_msg="seed %d block %s (ref read)" % (s, key))
        # repo reader decodes the reference-written file exactly
        r = mreader.open(str(ref_file))
        for b, (key, expect) in enumerate(blocks):
            np.testing.assert_array_equal(
                r.data(b), expect,
                err_msg="seed %d block %s (repo read)" % (s, key))
        r.close()


# ---------------------------------------------------------------------------
# B. float groups: repo writer -> reference reader, exact pixel recovery
# ---------------------------------------------------------------------------


def gen_float_group(rng):
    low = float(rng.uniform(-500, 500))
    high = low + float(rng.uniform(0.5, 1000))
    # dx spanning ~2**4 pixels up to the point where dx approaches the
    # f32 ulp of the data (once dx ~ ulp, |x_hat - x| <= dx stops being
    # meaningful in exact arithmetic -- representation error dominates)
    ulp = float(np.spacing(np.float32(max(abs(low), abs(high)))))
    max_pixels = min(2.0 ** 24, (high - low) / (64.0 * ulp))
    pixels_target = 2 ** float(rng.uniform(4, np.log2(max_pixels)))
    dx = (high - low) / pixels_target
    n = int(rng.integers(1, 2500))
    nblocks = int(rng.integers(1, 3))
    span = np.float32(high) - np.float32(low)
    blocks = [
        (low + rng.uniform(0, 1, n).astype(np.float32)
         * (span * np.float32(0.999))).astype(np.float32)
        for _ in range(nblocks)]
    return dict(low=low, high=high, dx=dx, blocks=blocks)


def test_fuzz_float_groups_reference_reader(tmp_path):
    cases = []
    manifest = []
    for s in range(SEEDS):
        rng = np.random.default_rng(2000 + s)
        groups = [gen_float_group(rng)
                  for _ in range(int(rng.integers(1, 3)))]
        repo_file = tmp_path / ("float%d.minnow" % s)
        refread = tmp_path / ("floatread%d.npz" % s)
        w = mwriter.create(str(repo_file))
        for g in groups:
            w.float_group(len(g["blocks"][0]), (g["low"], g["high"]),
                          g["dx"])
            for x in g["blocks"]:
                w.data(x)
        w.close()
        manifest.append("container_read %s %s" % (repo_file, refread))
        cases.append((groups, refread))
    run_ref_batch(manifest, tmp_path)

    for s, (groups, refread) in enumerate(cases):
        out = np.load(refread)
        b = 0
        for g in groups:
            low32 = np.float32(g["low"])
            pixels = spec.float_group_pixels(g["low"], g["high"],
                                             g["dx"])
            dx64 = (float(np.float32(g["high"])) - float(low32)) / pixels
            for x in g["blocks"]:
                got = out["block%d" % b]
                u = ref_dither(b, len(x))
                q_rec = np.rint((got - float(low32)) / dx64
                                - u).astype(np.int64)
                q_expect = spec.quantize(x, g["low"], g["high"], pixels)
                np.testing.assert_array_equal(
                    q_rec, q_expect,
                    err_msg="seed %d block %d pixel recovery" % (s, b))
                # value sanity bound is 2*dx, not dx: quantization is
                # floor(RN32(diff/dx)) -- the same f32 arithmetic as
                # the reference (ref go/group.go:312-320) -- so a value
                # within f32 rounding of a pixel boundary can land one
                # pixel over, and |x - x_hat| < 2*dx is the provable
                # contract.  Exactness is pinned by the pixel-recovery
                # assert above (found at seed 597 of the round-5
                # 3000-seed soak: error 1.001*dx with q still exact).
                assert np.max(np.abs(got - x.astype(np.float64))) <= \
                    2 * dx64 * 1.0001, "seed %d value contract" % s
                b += 1


# ---------------------------------------------------------------------------
# C. minh: byte identity (int + fixed-size columns) + repo reads ref
# ---------------------------------------------------------------------------

_MINH_FIXED_TYPES = [mminh.Int64, mminh.Int32, mminh.Int16, mminh.Int8,
                     mminh.Float64, mminh.Float32]


def gen_minh(rng):
    ncols = int(rng.integers(1, 5))
    cols, names = [], []
    for c in range(ncols):
        if rng.integers(0, 2):
            t = mminh.Int
        else:
            t = _MINH_FIXED_TYPES[rng.integers(
                0, len(_MINH_FIXED_TYPES))]
        cols.append({"type": int(t), "log": 0, "low": 0.0, "high": 0.0,
                     "dx": 0.0})
        names.append("c%d" % c)
    sizes = [int(rng.integers(1, 800))
             for _ in range(int(rng.integers(1, 4)))]
    blocks = []
    for n in sizes:
        row = []
        for c in cols:
            t = c["type"]
            if t == mminh.Int:
                row.append(rand_int_column(rng, n))
            else:
                dt = mtypes.FIXED_SIZE_DTYPES[t]
                if dt.kind == "f":
                    row.append((rng.standard_normal(n) * 100).astype(dt))
                else:
                    info = np.iinfo(dt)
                    row.append(rng.integers(info.min // 2,
                                            info.max // 2 + 1,
                                            n).astype(dt))
        blocks.append(row)
    meta = {"names": names, "text": "fuzz minh %s" % rng.integers(1e9),
            "cols": cols, "blocks": len(sizes),
            "geometry": [float(rng.uniform(10, 500)), 0.0, 0]}
    return meta, blocks


def write_repo_minh(path, meta, blocks):
    cols = [mminh.Column(type=c["type"], log=c["log"], low=c["low"],
                         high=c["high"], dx=c["dx"])
            for c in meta["cols"]]
    w = mminh.create(path)
    w.header(meta["names"], meta["text"], cols)
    if meta.get("geometry"):
        l, boundary, cells = meta["geometry"]
        w.geometry(l, boundary, cells)
    for cols_b in blocks:
        w.block(cols_b)
    w.close()


def test_fuzz_minh_byte_identity(tmp_path):
    cases = []
    manifest = []
    for s in range(SEEDS):
        rng = np.random.default_rng(3000 + s)
        meta, blocks = gen_minh(rng)
        npz = tmp_path / ("minh%d.npz" % s)
        arrays = {}
        for b, cols_b in enumerate(blocks):
            for c, arr in enumerate(cols_b):
                arrays["b%d_c%d" % (b, c)] = arr
        np.savez(npz, meta=np.array(json.dumps(meta)), **arrays)
        ref_file = tmp_path / ("minhref%d.minh" % s)
        repo_file = tmp_path / ("minhrepo%d.minh" % s)
        write_repo_minh(str(repo_file), meta, blocks)
        manifest.append("minh_write %s %s" % (npz, ref_file))
        cases.append((meta, blocks, repo_file, ref_file))
    run_ref_batch(manifest, tmp_path)

    for s, (meta, blocks, repo_file, ref_file) in enumerate(cases):
        assert repo_file.read_bytes() == ref_file.read_bytes(), \
            "minh bytes diverge at seed %d" % s
        # repo reader reads the reference-written file: bit-packed Int
        # columns via ints(), fixed-size columns via the container layer
        r = mminh.open(str(ref_file))
        int_names = [n for n, c in zip(meta["names"], meta["cols"])
                     if c["type"] in (mminh.Int, mminh.Int64)]
        if int_names:
            got = r.ints(int_names)
            for name in int_names:
                c = meta["names"].index(name)
                expect = np.concatenate(
                    [blocks[b][c] for b in range(len(blocks))])
                np.testing.assert_array_equal(
                    got[name].astype(np.int64), expect.astype(np.int64),
                    err_msg="seed %d col %s" % (s, name))
        ncols = len(meta["names"])
        for c, cdef in enumerate(meta["cols"]):
            if cdef["type"] in (mminh.Int, mminh.Int64):
                continue
            for b in range(len(blocks)):
                np.testing.assert_array_equal(
                    r.f.data(b * ncols + c), blocks[b][c],
                    err_msg="seed %d fixed col %d" % (s, c))
        r.close()


# ---------------------------------------------------------------------------
# D. boundary files: repo writer -> reference reader
# ---------------------------------------------------------------------------


def test_fuzz_boundary_reference_reader(tmp_path):
    from minnow_tpu.formats import boundary

    nseeds = max(SEEDS // 2, 1)
    cases = []
    manifest = []
    for s in range(nseeds):
        rng = np.random.default_rng(4000 + s)
        l = float(rng.uniform(50, 300))
        cells = int(rng.integers(2, 4))
        bnd = float(rng.uniform(0.5, l / cells / 2.5))
        n = int(rng.integers(100, 700))
        x = rng.uniform(0, l * 0.998, n).astype(np.float32)
        y = rng.uniform(0, l * 0.998, n).astype(np.float32)
        z = rng.uniform(0, l * 0.998, n).astype(np.float32)
        ids = rand_int_column(rng, n)
        dx = float(rng.uniform(0.001, 0.1))
        xcol = mminh.Column(type=mminh.Float, low=0.0, high=l, dx=dx)

        repo_file = tmp_path / ("bnd%d.minh" % s)
        w = boundary.create_boundary(str(repo_file))
        w.header("fuzz boundary %d" % s)
        w.geometry(l, bnd, cells)
        w.coordinates(x, y, z)
        cell_index = [np.array(i) for i in w.cell_index]
        w.column("id", mminh.Column(type=mminh.Int), ids)
        w.column("x", xcol, x)
        w.close()
        refread = tmp_path / ("bndread%d.npz" % s)
        manifest.append("minh_read %s %s" % (repo_file, refread))
        cases.append((l, cells, x, ids, dx, xcol, cell_index, repo_file,
                      refread))
    run_ref_batch(manifest, tmp_path)

    for s, (l, cells, x, ids, dx, xcol, cell_index, repo_file,
            refread) in enumerate(cases):
        out = np.load(refread)
        assert out["names"].item() == "boundary$id$x"
        n_blocks = int(out["blocks"])
        assert n_blocks == cells ** 3
        lengths = out["block_lengths"]

        r = mminh.open(str(repo_file), dither="none")
        np.testing.assert_array_equal(
            out["col1"], r.ints(["id"])["id"],
            err_msg="seed %d ids" % s)
        np.testing.assert_array_equal(
            out["col0"], r.ints(["boundary"])["boundary"],
            err_msg="seed %d flags" % s)

        pixels = spec.float_group_pixels(xcol.low, xcol.high, xcol.dx)
        dx64 = (float(np.float32(xcol.high))
                - float(np.float32(xcol.low))) / pixels
        got_x = out["col2"].astype(np.float64)
        i0 = 0
        for b in range(n_blocks):
            m = int(lengths[b])
            idx = b + 2 * n_blocks
            u = ref_dither(idx, m)
            q_rec = np.rint(
                (got_x[i0:i0 + m] - float(np.float32(xcol.low))) / dx64
                - u).astype(np.int64)
            cell_x = mminh.process_float_column(x[cell_index[b]], xcol)
            q_expect = spec.quantize(cell_x, xcol.low, xcol.high,
                                     pixels)
            np.testing.assert_array_equal(
                q_rec, q_expect,
                err_msg="seed %d cell %d pixel recovery" % (s, b))
            i0 += m
        r.close()
