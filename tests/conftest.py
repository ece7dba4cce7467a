"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh (multi-device sharding is
validated without accelerator hardware, as the reference validates
multi-file datasets with in-memory mocks -- ref go/minp/snapshot/mock.go).
The env vars must be set before jax initializes, hence at conftest import
time.  What only the GPU can run lives in chip_smoke.py.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


@pytest.fixture
def tmp_minnow(tmp_path):
    def _make(name="file.minnow"):
        return str(tmp_path / name)

    return _make
