import os
import sys

# Tests run on the CPU backend (sharding tests on 8 virtual CPU
# devices) unless the process already chose a platform: chip_smoke.py
# sets JAX_PLATFORMS=cuda and runs the `gpu`-marked tests on the card.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "--xla_force_host_platform_device_count" not in \
        os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") +
        " --xla_force_host_platform_device_count=8").strip()
import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

REFERENCE_DIR = "/root/reference"
TEST_DATA = os.path.join(REFERENCE_DIR, "test_data")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs a CUDA kernel on the card; skips (in a "
        "fixture) where JAX has no GPU backend")


@pytest.fixture(autouse=True)
def _integer_scores():
    """The score type is process-global (core.scoring.SCORE_TYPE): a
    test that runs with double scores and fails before its pipeline
    restores them must not change the tests that share its worker."""
    from lastz_tpu.core.scoring import set_score_type
    set_score_type("I")


@pytest.fixture(scope="session")
def test_data_dir():
    if not os.path.isdir(TEST_DATA):
        pytest.skip("reference test_data not available")
    return TEST_DATA
