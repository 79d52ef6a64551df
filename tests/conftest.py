"""Test configuration: run everything on CPU with 8 virtual devices so the
multi-device sharding logic is testable without a GPU (SURVEY.md §4e)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

from torrey.utils.config import setup_jax  # noqa: E402

setup_jax()

SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")

# Fast/slow split: tests matching these name prefixes measured >=4 s each
# on a 2-core CPU (pytest --durations) — recorded goldens at full spp,
# deep parity and the sharded gradient.  Marked centrally here so the
# split tracks measurements, not file layout.
_SLOW_PREFIXES = (
    "test_recorded_golden",
    "test_golden_image[bunny",
    "test_sharded_grad_matches_single",
    "test_grad_matches_finite_difference",
    "test_native_sah_is_faster_at_scale",
)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: >=4 s on the 2-core CPU mesh (goldens, deep "
        "parity, big scenes); deselect with -m fast")
    config.addinivalue_line(
        "markers", "fast: auto-applied complement of slow — "
        "`pytest -m fast` runs the quick suite (<2 min)")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.name.startswith(_SLOW_PREFIXES):
            item.add_marker(pytest.mark.slow)
        else:
            item.add_marker(pytest.mark.fast)


@pytest.fixture(scope="session")
def scenes_dir():
    return SCENES
