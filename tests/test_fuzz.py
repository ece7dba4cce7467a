"""Generative round-trip fuzz of the container and minh layers.

Random mixtures of headers/groups/blocks (including degenerate shapes:
empty headers, zero-length blocks, groups with no blocks, constant
blocks, negative extremes) must round-trip exactly.  Mirrors nothing in
the reference -- its suites are fixed fixtures -- but the byte layout is
pinned by the goldens, so this is free coverage of framing corners.
"""

import numpy as np
import pytest

import minnow_tpu as minnow
from minnow_tpu.formats import minh


def _random_int_block(rng, n):
    kind = rng.integers(0, 4)
    if kind == 0:
        return rng.integers(-(2**62), 2**62, n, dtype=np.int64)
    if kind == 1:
        return np.full(n, rng.integers(-(2**40), 2**40), dtype=np.int64)
    if kind == 2:
        return rng.integers(0, 2, n, dtype=np.int64)
    return rng.integers(-5, 5, n, dtype=np.int64)


@pytest.mark.parametrize("seed", range(20))
def test_container_fuzz_roundtrip(tmp_path, seed):
    rng = np.random.default_rng(seed)
    fname = str(tmp_path / "fuzz.minnow")
    w = minnow.create(fname)

    log = []  # (kind, expected)
    for _ in range(int(rng.integers(1, 12))):
        choice = rng.integers(0, 4)
        if choice == 0:
            data = rng.bytes(int(rng.integers(0, 64)))
            w.header(data)
            log.append(("header", data))
        elif choice == 1:
            n = int(rng.integers(0, 33))
            w.int_group(n)
            for _ in range(int(rng.integers(1, 4))):
                x = _random_int_block(rng, n)
                w.data(x)
                log.append(("int", x))
        elif choice == 2:
            n = int(rng.integers(1, 33))
            low = float(rng.uniform(-100, 0))
            high = float(rng.uniform(1, 100))
            dx = float(rng.uniform(0.01, 1.0))
            w.float_group(n, (low, high), dx)
            for _ in range(int(rng.integers(1, 4))):
                x = rng.uniform(low, high * 0.999, n).astype(np.float32)
                w.data(x)
                log.append(("float", (x, dx)))
        else:
            gt = int(rng.integers(0, 10))
            n = int(rng.integers(0, 17))
            from minnow_tpu.core import types as ctypes_

            dt = ctypes_.group_dtype(gt)
            w.fixed_size_group(gt, n)
            if np.issubdtype(dt, np.floating):
                x = rng.uniform(-10, 10, n).astype(dt)
            else:
                info = np.iinfo(dt)
                x = rng.integers(info.min, info.max, n, dtype=dt,
                                 endpoint=True)
            w.data(x)
            log.append(("fixed", x))
    w.close()

    r = minnow.open(fname, dither="none")
    h = b_ = 0
    for kind, expected in log:
        if kind == "header":
            assert r.header(h) == expected
            h += 1
        elif kind == "int":
            np.testing.assert_array_equal(r.data(b_), expected)
            b_ += 1
        elif kind == "float":
            x, dx = expected
            got = r.data(b_)
            # 2*dx at f32 pixel boundaries (docs/FORMAT.md section 6)
            assert np.all(np.abs(got - x) <= 2 * dx * (1 + 1e-4))
            b_ += 1
        else:
            got = r.data(b_)
            np.testing.assert_array_equal(got, expected)
            b_ += 1
    r.close()


@pytest.mark.parametrize("seed", range(8))
def test_minh_fuzz_roundtrip(tmp_path, seed):
    rng = np.random.default_rng(100 + seed)
    fname = str(tmp_path / "fuzz.minh")
    n_cols = int(rng.integers(1, 6))
    cols, names = [], []
    for c in range(n_cols):
        t = int(rng.integers(0, 4))
        if t == 0:
            cols.append(minh.Column(type=minh.Int64))
        elif t == 1:
            cols.append(minh.Column(type=minh.Int))
        elif t == 2:
            cols.append(minh.Column(type=minh.Float32))
        else:
            lo = float(rng.uniform(-10, 0))
            hi = float(rng.uniform(1, 100))
            cols.append(minh.Column(type=minh.Float, low=lo, high=hi,
                                    dx=float(rng.uniform(0.001, 0.5))))
        names.append("c%d" % c)

    blocks = []
    w = minh.create(fname)
    w.header(names, "fuzz", cols)
    w.geometry(100, 0, 0)
    for _ in range(int(rng.integers(1, 4))):
        n = int(rng.integers(1, 200))
        blk = []
        for col in cols:
            if col.type in (minh.Int64, minh.Int):
                blk.append(rng.integers(-(2**50), 2**50, n,
                                        dtype=np.int64))
            elif col.type == minh.Float32:
                blk.append(rng.uniform(-1, 1, n).astype(np.float32))
            else:
                blk.append(rng.uniform(col.low, col.high * 0.999,
                                       n).astype(np.float32))
        blocks.append(blk)
        w.block(blk)
    w.close()

    r = minh.open(fname, dither="none")
    assert r.block_lengths == [len(b[0]) for b in blocks]
    for c, col in enumerate(cols):
        name = names[c]
        if col.type in (minh.Int64, minh.Int):
            got = r.ints([name])[name]
            want = np.concatenate([b[c] for b in blocks])
            np.testing.assert_array_equal(got, want)
        elif col.type == minh.Float32:
            got = r.floats([name])[name]
            want = np.concatenate([b[c] for b in blocks])
            np.testing.assert_array_equal(got, want)
        else:
            got = r.floats([name])[name]
            want = np.concatenate([b[c] for b in blocks])
            assert np.all(np.abs(got - want) <= 2 * col.dx * (1 + 1e-4))
    r.close()


@pytest.mark.parametrize("seed", range(30))
def test_verify_never_crashes_on_corruption(tmp_path, seed):
    """Random byte corruption of a valid file: verify() must report
    problems (or cleanly pass when the flips miss critical bytes), never
    raise -- the failure-detection contract."""
    from minnow_tpu.cli import verify_minnow

    rng = np.random.default_rng(seed)
    fname = str(tmp_path / "victim.minnow")
    w = minnow.create(fname)
    w.header(b"corruption target")
    w.int_group(50)
    w.data(rng.integers(0, 2**30, 50, dtype=np.int64))
    w.float_group(50, (0.0, 100.0), 0.5)
    w.data(rng.uniform(0, 99, 50).astype(np.float32))
    w.close()

    raw = bytearray(open(fname, "rb").read())
    n_flips = int(rng.integers(1, 12))
    for _ in range(n_flips):
        pos = int(rng.integers(0, len(raw)))
        raw[pos] ^= int(rng.integers(1, 256))
    bad = str(tmp_path / "corrupt.minnow")
    open(bad, "wb").write(bytes(raw))

    problems = verify_minnow.verify(bad, deep=True)  # must not raise
    assert isinstance(problems, list)
