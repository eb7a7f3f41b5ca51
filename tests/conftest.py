"""Test configuration: simulate an 8-device mesh on CPU.

Multi-device logic is tested without accelerators the same way the
reference's multi-rank logic would be tested without a cluster: by forcing
the host platform to expose 8 virtual devices (SURVEY.md §4). Tests that
need a GPU carry the `gpu` marker and skip here (see the `gpu` fixture).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import pytest


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX sees none. Decided at
    run time, never at import, so every worker collects the same tests."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX sees {devices[0].platform}")
    return devices[0]
