"""Test configuration.

Tests run on the CPU backend with 8 virtual devices (for sharding tests)
and 64-bit mode enabled so the f64 value tables ported from the reference
(`/root/reference/tests/`) can be checked at full precision.

Tests that need a GPU carry the ``gpu`` marker and request the ``gpu``
fixture, which skips them when no card is present (decided when the
test runs, never at import or collection).  On the card, run them with
``pytest -m gpu`` without the CPU forcing below: set
``NDI_TESTS_ON_GPU=1``.
"""

import os
import sys
from pathlib import Path

import pytest

# make the package importable regardless of the pytest invocation cwd
_ROOT = str(Path(__file__).resolve().parent.parent)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

if os.environ.get("NDI_TESTS_ON_GPU", "") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU (request the `gpu` fixture; run with "
        "NDI_TESTS_ON_GPU=1 pytest -m gpu)",
    )
    config.addinivalue_line(
        "markers",
        "slow: long-running tests (multi-process cluster, 16M-knot "
        "capacity sweeps, big property tables).  CI runs everything; "
        "iterate locally with `pytest -m quick`.",
    )
    config.addinivalue_line(
        "markers",
        "quick: auto-applied to every test not marked slow/gpu "
        "(`pytest -m quick` is the fast local loop)",
    )
    # x64 MUST be enabled here (before collection): test modules build
    # jnp constants at import time, and collection imports them —
    # enabling x64 any later silently downgrades those module-level
    # value tables to f32 (caught as a 3e-7 oracle mismatch in
    # test_cubic_spline).
    if os.environ.get("NDI_TESTS_ON_GPU", "") != "1":
        import jax

        jax.config.update("jax_enable_x64", True)


def _slow_list():
    path = Path(__file__).resolve().parent / "_slow_tests.txt"
    try:
        return {
            line.strip()
            for line in path.read_text().splitlines()
            if line.strip() and not line.startswith("#")
        }
    except OSError:
        return set()


def pytest_collection_modifyitems(config, items):
    slow = _slow_list()
    for item in items:
        rel = item.nodeid.split("tests/")[-1]
        if rel in slow and item.get_closest_marker("slow") is None:
            item.add_marker("slow")
        if item.get_closest_marker("slow") is None and (
            item.get_closest_marker("gpu") is None
        ):
            item.add_marker("quick")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX sees none."""
    import jax

    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU (NDI_TESTS_ON_GPU=1 pytest -m gpu)")
    return devices[0]
