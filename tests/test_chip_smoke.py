"""chip_smoke.py's phases at tiny sizes on the CPU, and its refusal to
run without a GPU.  The full-size run is ``python chip_smoke.py`` on the
card (README)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def minh_file(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("smoke"))
    path, res = chip_smoke.minh_convert(work, 3000, seed=1)
    return work, path, res


def test_minh_phase_device_equals_host(minh_file):
    _, path, res = minh_file
    assert res["identical"] and res["files"] == 1
    assert os.path.getsize(path) == res["bytes"]


def test_minh_read_phase_bitwise(minh_file):
    res = chip_smoke.minh_read(minh_file[1])
    # 7 float + 1 int column, two dither modes
    assert res == {"columns_x_modes": 16, "bitwise_equal": True}


def test_boundary_phase_identical(minh_file):
    work, path, _ = minh_file
    res = chip_smoke.boundary(work, path, cells=2, bnd=5.0)
    assert res["identical"] and res["files"] == 1


def test_minp_phase_identical_and_bitwise(tmp_path):
    res = chip_smoke.minp_convert(str(tmp_path), 32, 3, seed=2,
                                  file_cells=2, sub_cells=2)
    assert res["identical"] and res["files"] == 16
    assert res["reads"] == 32 and res["bitwise_equal"]


def test_catalog_columns(tmp_path):
    """The catalog has the documented columns: 41-bit IDs, positions in
    the box, velocities within +-5000, masses for the log column."""
    cfg, hlist = chip_smoke.write_catalog(str(tmp_path), 500, seed=3)
    data = np.loadtxt(hlist)
    assert data.shape == (500, 8)
    assert data[:, 0].max() < 2 ** 41 and data[:, 0].max() > 2 ** 38
    assert (data[:, 1:4] >= 0).all() and (data[:, 1:4] <= 250).all()
    assert (np.abs(data[:, 4:7]) < 5000).all()
    types = open(os.path.join(str(tmp_path), "types.txt")).read()
    assert "id int\n" in types and "mvir q_float log" in types


def test_flagship_phase_small():
    res = chip_smoke.flagship(n_blocks=4, n=1024, id_blocks=2, id_n=512,
                              reps=2)
    ops = [r["op"] for r in res["results"]]
    assert ops == ["encode_prep", "encode_pack", "encode_total",
                   "decode_none", "decode_uniform", "id_encode_stats",
                   "id_encode_pack", "id_decode"]
    assert all(r["ms"] > 0 for r in res["results"])


def test_sharded_encode_phase_on_four_devices(tmp_path):
    # 3 catalog blocks: the batch pads to the mesh before sharding
    res = chip_smoke.sharded_encode(jax.devices()[:4], 32, 768, seed=4,
                                    work=str(tmp_path), n=256)
    assert res["shard_devices"] == 4 and res["devices"] == 4
    assert res["minp_files"] == 128 and res["catalog_blocks"] == 6


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "no GPU" in err


@pytest.mark.parametrize("alone", [False, True])
def test_script_fails_off_gpu_without_a_result(tmp_path, alone):
    """``JAX_PLATFORMS=cpu python chip_smoke.py`` exits non-zero before
    any phase, and so does the script copied into a directory that
    holds nothing else of the repo; neither prints a result line."""
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = REPO
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                       env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert "phase" not in p.stdout
    for line in p.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
