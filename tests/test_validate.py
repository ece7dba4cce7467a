"""Backend exactness validation on the CPU test mesh.

chip_smoke.py and bench.py run the same checks on the GPU; here they gate
the virtual-device backend every test run.
"""

from minnow_tpu.ops import validate


def test_backend_is_bit_exact():
    report = validate.validate_backend()
    assert report["exact"]
    assert report["backend"] == "cpu"
    assert report["routes"] == validate.ROUTES
