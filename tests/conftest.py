import os
import sys

# Tests run the multi-device sharding paths on a virtual 8-device CPU mesh
# (standard JAX trick). The backend is pinned to the CPU here; tests that
# need the GPU are marked `gpu`, start their own process, and skip when no
# card is present (`python -m pytest tests/ -m gpu` on the GPU machine).
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import pytest

REF_BIN = os.path.join(ROOT, ".refbuild", "strawberry")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where none is present")


@pytest.fixture(scope="session")
def reference_binary():
    if not os.path.exists(REF_BIN):
        pytest.skip("reference binary not built (tools/build_reference.sh)")
    return REF_BIN
