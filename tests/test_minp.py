"""minp format round-trips (mirrors ref go/minp/minp_test.go)."""

import numpy as np
import pytest

from minnow_tpu.formats import minp


def _snap(rng, n_side, l):
    n = n_side ** 3
    return (rng.uniform(0, l, (n, 3))).astype(np.float32)


@pytest.mark.parametrize("n_side,sub_cells", [(4, 1), (4, 2), (8, 2),
                                              (8, 4), (6, 3)])
@pytest.mark.parametrize("periodic", [True, False])
def test_minp_roundtrip(tmp_path, n_side, sub_cells, periodic):
    # ref go/minp/minp_test.go:7-73
    rng = np.random.default_rng(n_side * 10 + sub_cells)
    l, dx = 100.0, 0.01
    vec = _snap(rng, n_side, l * 0.999)
    hd = minp.Header(z=0.5, scale=2 / 3, omega_m=0.3, omega_l=0.7,
                     h100=0.7, l=l, epsilon=0.1, n_side=n_side,
                     n_total=n_side ** 3, uniform_mp=1e9)
    cell = minp.Cell(0, 1, sub_cells)

    fname = str(tmp_path / "p.minp")
    w = minp.create(fname)
    w.header(hd, b"\x63", cell, dx, periodic)
    w.vectors(vec)
    w.close()

    r = minp.open(fname, dither="uniform")
    assert r.header.n_side == n_side and r.header.l == l
    assert r.raw_header == b"\x63"
    assert r.cell.sub_cells == sub_cells
    assert r.periodic == periodic
    assert r.n() == n_side ** 3
    got = r.vectors()
    d = np.abs(got - vec)
    if periodic:
        d = np.minimum(d, l - d)
    assert np.all(d <= dx * (1 + 1e-4))
    r.close()


def test_sub_cell_split_join_inverse():
    # ref go/minp/minp_test.go:153-189
    rng = np.random.default_rng(0)
    n_file, s = 6, 3
    vec = rng.uniform(0, 1, (n_file ** 3, 3)).astype(np.float32)
    blocks = minp.split_sub_cells(vec, s)
    assert blocks.shape == (27, 8, 3)
    back = minp.join_sub_cells(blocks, s)
    np.testing.assert_array_equal(back, vec)


def test_sub_cell_element_order_matches_reference():
    """Hand-check the scalar loop semantics of getSubCell
    (ref go/minp/minp.go:246-264) against the reshape/transpose."""
    n_file, s = 4, 2
    n_sub = n_file // s
    idx = np.arange(n_file ** 3)
    vec = np.stack([idx, idx, idx], axis=1).astype(np.float32)
    blocks = minp.split_sub_cells(vec, s)
    for sc in range(s ** 3):
        sx, sy, sz = sc % s, (sc // s) % s, sc // (s * s)
        j = 0
        for jz in range(n_sub):
            for jy in range(n_sub):
                for jx in range(n_sub):
                    ix = jx + n_sub * sx
                    iy = jy + n_sub * sy
                    iz = jz + n_sub * sz
                    i = ix + iy * n_file + iz * n_file * n_file
                    assert blocks[sc, j, 0] == i, (sc, j)
                    j += 1


def test_lagrangian_ids():
    # ref go/minp/minp_test.go:75-100 style hand expectations
    cell = minp.Cell(file_index=0, file_cells=2, sub_cells=1)
    ids = minp.lagrangian_ids(cell, n_side=4)
    assert list(ids[:8]) == [0, 1, 4, 5, 16, 17, 20, 21]
    cell = minp.Cell(file_index=1, file_cells=2, sub_cells=1)
    ids = minp.lagrangian_ids(cell, 4)
    assert list(ids[:2]) == [2, 3]
    cell = minp.Cell(file_index=7, file_cells=2, sub_cells=1)
    ids = minp.lagrangian_ids(cell, 4)
    assert ids[-1] == 63


def test_minp_ids_roundtrip(tmp_path):
    rng = np.random.default_rng(9)
    hd = minp.Header(l=10.0, n_side=4, n_total=64)
    cell = minp.Cell(3, 2, 1)
    fname = str(tmp_path / "ids.minp")
    w = minp.create(fname)
    w.header(hd, b"", cell, 0.01, True)
    w.vectors(rng.uniform(0, 10, (8, 3)).astype(np.float32))
    w.close()
    r = minp.open(fname)
    ids = r.ids()
    want = minp.lagrangian_ids(cell, 4)
    np.testing.assert_array_equal(ids, want)
    r.close()


def test_minp_rejects_wrong_len(tmp_path):
    w = minp.create(str(tmp_path / "bad.minp"))
    w.header(minp.Header(l=1.0, n_side=4), b"", minp.Cell(0, 1, 2),
             0.1, True)
    with pytest.raises(ValueError, match="len"):
        w.vectors(np.zeros((9, 3), np.float32))


def test_minp_device_writer_byte_identical(tmp_path):
    """minp written through the device pipeline == host writer bytes."""
    from minnow_tpu.parallel import BlockEncoder

    rng = np.random.default_rng(42)
    hd = minp.Header(l=100.0, n_side=8, n_total=512)
    vec = rng.uniform(0, 99.9, (512, 3)).astype(np.float32)

    for periodic in (True, False):
        host_f = str(tmp_path / ("h%d.minp" % periodic))
        dev_f = str(tmp_path / ("d%d.minp" % periodic))
        for fname, enc in ((host_f, None), (dev_f, BlockEncoder())):
            w = minp.Writer(fname, encoder=enc)
            w.header(hd, b"x", minp.Cell(0, 1, 2), 0.01, periodic)
            w.vectors(vec)
            w.close()
        assert open(host_f, "rb").read() == open(dev_f, "rb").read(), \
            periodic


def test_minp_device_reader_matches_host(tmp_path):
    from minnow_tpu.formats import minp_device

    rng = np.random.default_rng(77)
    hd = minp.Header(l=100.0, n_side=8, n_total=512)
    vec = rng.uniform(0, 99.9, (512, 3)).astype(np.float32)
    for periodic in (True, False):
        fname = str(tmp_path / ("p%d.minp" % periodic))
        w = minp.create(fname)
        w.header(hd, b"", minp.Cell(0, 1, 2), 0.01, periodic)
        w.vectors(vec)
        w.close()
        r = minp.open(fname, dither="none")
        host = r.vectors()
        dev = minp_device.read_vectors(r, dither="none")
        np.testing.assert_array_equal(dev, host)
        r.close()


def test_minp_uniform_dither_host_equals_device_bitwise(tmp_path):
    """One defined uniform stream (VERDICT r4 #5), minp side: host and
    device bulk reads of the same snapshot agree bitwise in uniform
    mode (dither keys = container block indices on both paths)."""
    from minnow_tpu.formats import minp_device

    rng = np.random.default_rng(78)
    hd = minp.Header(l=100.0, n_side=8, n_total=512)
    vec = rng.uniform(0, 99.9, (512, 3)).astype(np.float32)
    fname = str(tmp_path / "u.minp")
    w = minp.create(fname)
    w.header(hd, b"", minp.Cell(0, 1, 2), 0.01, True)
    w.vectors(vec)
    w.close()
    for seed in (0, 3):
        r = minp.open(fname, dither="uniform", seed=seed)
        host = r.vectors()
        dev = minp_device.read_vectors(r, dither="uniform", seed=seed)
        np.testing.assert_array_equal(dev.view(np.uint32),
                                      host.view(np.uint32))
        r.close()
