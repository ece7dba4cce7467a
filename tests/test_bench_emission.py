"""bench.py's one-JSON-line contract, tested as a subprocess contract.

Every run prints exactly one parseable JSON line, including runs that
fail: a section that raises and a budget that runs out each emit a
partial record carrying the error, and exit 1.  bench.py measures only
on a GPU, so these drive ``bench.main()`` through a ``-c`` wrapper that
substitutes the device check (the test's fake) on the CPU backend.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FAKE_GPU = (
    "import sys; sys.path.insert(0, %r)\n"
    "import bench\n"
    "bench._require_gpu = lambda: {'platform': 'gpu', 'kind': 'fake',\n"
    "                              'count': 1}\n" % REPO)


def _run_wrapped(code, budget, timeout=180):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["MINNOW_TPU_BENCH_BUDGET_S"] = str(budget)
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in p.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, "expected exactly one JSON line:\n%s\n%s" \
        % (p.stdout, p.stderr)
    return p.returncode, json.loads(lines[0])


def test_budget_expiry_emits_partial_results():
    """Budget expires mid-run (a section that never returns) -> partial
    record with a stage marker and whatever detail accumulated, rc 1."""
    code = _FAKE_GPU + (
        "import time\n"
        "from minnow_tpu.ops import validate\n"
        "validate.validate_backend = lambda: {'exact': True}\n"
        "def hang(*a, **k):\n"
        "    time.sleep(3600)\n"
        "bench.bench_device = hang\n"
        "bench.main()\n")
    rc, rec = _run_wrapped(code, budget=30, timeout=120)
    assert rc == 1
    assert rec.get("partial") is True
    assert rec["error"].startswith("bench_timeout_after_")
    assert rec["stage"] == "bench_device"
    assert rec["device"] == {"platform": "gpu", "kind": "fake",
                             "count": 1}
    # the native baseline runs in seconds and must have landed
    assert rec["detail"]["native_single_core_GBps"] > 0
    assert "nvidia_smi" in rec["detail"]


def test_midrun_raise_emits_partial_results():
    """A raise mid-run -> partial record carrying the error, rc 1."""
    code = _FAKE_GPU + (
        "from minnow_tpu.ops import validate\n"
        "def boom():\n"
        "    raise RuntimeError('simulated device failure')\n"
        "validate.validate_backend = boom\n"
        "bench.main()\n")
    rc, rec = _run_wrapped(code, budget=120)
    assert rc == 1
    assert rec.get("partial") is True
    assert "simulated device failure" in rec["error"]
    assert rec["stage"] == "validate"


def test_no_gpu_fails_without_timing():
    """On the CPU backend bench.py times nothing: one error record,
    rc 1, no device numbers."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 1
    lines = [ln for ln in p.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert "needs a GPU" in rec["error"]
    assert rec["value"] is None and rec["device"] is None
    assert "encode_GBps" not in rec.get("detail", {})


def test_hbm_slope_cap_and_min_timed():
    """The slope honesty guards: _cap_to_hbm must replace any slope
    past the HBM traffic-model ceiling with the cap (raw preserved),
    from the H100's data-sheet row; a device kind not in the table is
    an error, never an assumed peak.  Pure helpers -- no device
    needed."""
    import pytest

    sys.path.insert(0, REPO)
    import bench

    assert bench._hbm_bw("NVIDIA H100 80GB HBM3") == 3350.0
    for kind in ("cpu", "NVIDIA A100-SXM4-80GB", ""):
        with pytest.raises(ValueError, match="no peak HBM bandwidth"):
            bench._hbm_bw(kind)

    a = bench._Timed(0.010, [0.010, 0.014, 0.030])
    assert float(a) == 0.010 and a.med == 0.014 and a.spread == 3.0

    d = {"decode_xla_GBps": 2500.781,
         "decode_xla_GBps_med": 2200.9,
         "encode_xla_GBps": 64.6,
         "bench_shape": "(256->4096, 131072)"}

    class _FakeDev:
        device_kind = "NVIDIA H100 80GB HBM3"

    import jax
    real_devices = jax.devices
    try:
        jax.devices = lambda *a, **k: [_FakeDev()]
        cap = bench._cap_to_hbm(d, 18)
    finally:
        jax.devices = real_devices
    assert abs(cap - 3350.0 * 4 / 6.25) < 1e-6
    assert d["decode_xla_GBps"] == round(cap, 1)
    assert d["decode_xla_GBps_raw"] == 2500.781
    assert d["decode_xla_GBps_med"] == round(cap, 1)
    assert d["encode_xla_GBps"] == 64.6   # under the cap: kept
    assert "encode_xla_GBps_raw" not in d
    assert set(d["hbm_capped"]) == {"decode_xla_GBps",
                                    "decode_xla_GBps_med"}

    class _Cpu:
        device_kind = "cpu"

    try:
        jax.devices = lambda *a, **k: [_Cpu()]
        with pytest.raises(ValueError):
            bench._cap_to_hbm({}, 18)
    finally:
        jax.devices = real_devices
