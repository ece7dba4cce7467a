"""Device-batched minh reads must equal the host reader exactly
(dither="none") and within dx (uniform)."""

import numpy as np
import pytest

from minnow_tpu.formats import minh, minh_device


def _write_catalog(fname, rng, lens=(100, 37, 100)):
    names = ["id", "x", "mvir"]
    cols = [minh.Column(type=minh.Int),
            minh.Column(type=minh.Float, low=0, high=250, dx=0.01),
            minh.Column(type=minh.Float, log=1, low=5, high=16,
                        dx=0.001)]
    w = minh.create(fname)
    w.header(names, "t", cols)
    w.geometry(250, 0, 0)
    data = []
    for n in lens:
        blk = [rng.integers(0, 10**12, n),
               rng.uniform(0, 249.9, n).astype(np.float32),
               (10.0 ** rng.uniform(5.5, 15.5, n)).astype(np.float32)]
        data.append(blk)
        w.block(blk)
    w.close()
    return names, data


def test_device_reads_match_host(tmp_path):
    fname = str(tmp_path / "c.minh")
    rng = np.random.default_rng(0)
    _write_catalog(fname, rng)

    r = minh.open(fname, dither="none")
    host_f = r.floats(["x", "mvir"])
    host_i = r.ints(["id"])
    dev_f = minh_device.read_floats(r, ["x", "mvir"], dither="none")
    dev_i = minh_device.read_ints(r, ["id"])
    np.testing.assert_array_equal(dev_f["x"], host_f["x"])
    np.testing.assert_array_equal(dev_f["mvir"], host_f["mvir"])
    np.testing.assert_array_equal(dev_i["id"], host_i["id"])
    r.close()


def test_device_uniform_dither_within_dx(tmp_path):
    fname = str(tmp_path / "c.minh")
    rng = np.random.default_rng(1)
    names, data = _write_catalog(fname, rng)
    r = minh.open(fname)
    got = minh_device.read_floats(r, ["x"], dither="uniform")["x"]
    want = np.concatenate([blk[1] for blk in data])
    assert np.all(np.abs(got - want) <= 0.01 * (1 + 1e-5))
    again = minh_device.read_floats(r, ["x"], dither="uniform")["x"]
    np.testing.assert_array_equal(got, again)
    r.close()


def test_uniform_dither_host_equals_device_bitwise(tmp_path):
    """One defined uniform stream (VERDICT r4 #5): the host reader's
    pure-numpy counter-hash must equal the device decode bitwise --
    same file, same mode, same floats regardless of read path.  Also
    pins the container-block-index keying (a column-local index on
    either side would break this for every column but the first)."""
    fname = str(tmp_path / "c.minh")
    rng = np.random.default_rng(2)
    _write_catalog(fname, rng)

    for seed in (0, 9):
        r = minh.open(fname, dither="uniform", seed=seed)
        host = r.floats(["x", "mvir"])
        dev = minh_device.read_floats(r, ["x", "mvir"],
                                      dither="uniform", seed=seed)
        np.testing.assert_array_equal(dev["x"], host["x"])
        np.testing.assert_array_equal(dev["mvir"], host["mvir"])
        r.close()


def test_philox_legacy_mode_reproduces_old_stream(tmp_path):
    """dither="philox" keeps the rounds-1-4 host stream available (and
    distinct from the defined uniform stream)."""
    fname = str(tmp_path / "c.minh")
    rng = np.random.default_rng(3)
    _write_catalog(fname, rng)

    r_p = minh.open(fname, dither="philox")
    r_u = minh.open(fname, dither="uniform")
    xp = r_p.floats(["x"])["x"]
    xu = r_u.floats(["x"])["x"]
    assert np.any(xp != xu)          # different streams
    assert np.all(np.abs(xp - xu) <= 2 * 0.01 * (1 + 1e-5))
    r_p2 = minh.open(fname, dither="philox")
    np.testing.assert_array_equal(xp, r_p2.floats(["x"])["x"])
    r_p.close(), r_u.close(), r_p2.close()


def test_verify_minnow_cli(tmp_path, capsys):
    import pytest

    from minnow_tpu.cli import verify_minnow

    fname = str(tmp_path / "ok.minh")
    rng = np.random.default_rng(2)
    _write_catalog(fname, rng, lens=(10,))
    assert verify_minnow.verify(fname, deep=True) == []

    # crashed-writer file: header never rewritten (zero magic)
    crashed = str(tmp_path / "crashed.minnow")
    data = open(fname, "rb").read()
    open(crashed, "wb").write(b"\0" * 48 + data[48:])
    problems = verify_minnow.verify(crashed)
    assert any("never closed" in p for p in problems)

    # truncated tail
    trunc = str(tmp_path / "trunc.minnow")
    open(trunc, "wb").write(data[:len(data) - 10])
    assert verify_minnow.verify(trunc)

    with pytest.raises(SystemExit) as e:
        verify_minnow.main([fname, crashed])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "ok" in out and "INVALID" in out

