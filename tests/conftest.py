"""Test configuration: run everything on a virtual 8-device CPU mesh.

Tests are deterministic and hardware-independent, per SURVEY.md §4: the
GPU walk kernel runs in Pallas interpret mode here. Tests marked ``gpu``
need the card; they skip on the CPU and run on a GPU machine with
``PFAC_TEST_ON_CARD=1 python -m pytest tests/ -m gpu``.
"""
import os

ON_CARD = os.environ.get("PFAC_TEST_ON_CARD") == "1"
# must happen before the first backend initialization anywhere in the session
if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")

from pfac_tpu.runtime import compile_cache

compile_cache.enable()

import numpy as np
import pytest


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU; skips the test when JAX has none (decided here, at
    run time, never while test modules are imported)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


@pytest.fixture(scope="session")
def fixtures_dir():
    return os.path.join(os.path.dirname(__file__))


@pytest.fixture(scope="session")
def example_pattern_path(fixtures_dir):
    return os.path.join(fixtures_dir, "pattern", "example_pattern")


@pytest.fixture(scope="session")
def example_input(fixtures_dir):
    with open(os.path.join(fixtures_dir, "data", "example_input"), "rb") as f:
        return f.read()


@pytest.fixture(scope="session")
def example_pattern2_path(fixtures_dir):
    return os.path.join(fixtures_dir, "pattern", "example_pattern2")


@pytest.fixture(scope="session")
def example_input2(fixtures_dir):
    with open(os.path.join(fixtures_dir, "data", "example_input2"), "rb") as f:
        return f.read()


def brute_force_match(patterns, data: bytes) -> np.ndarray:
    """Independent oracle: result[i] = ID of longest pattern starting at i.

    Ties (only possible for duplicate patterns) resolve to the later ID,
    matching the reference's dense-table overwrite order.
    """
    n = len(data)
    out = np.zeros(n, dtype=np.int32)
    for i in range(n):
        best_id, best_len = 0, -1
        for pid, p in enumerate(patterns, start=1):
            lp = len(p)
            if lp >= best_len and data[i : i + lp] == p:
                best_id, best_len = pid, lp
        out[i] = best_id
    return out


@pytest.fixture(scope="session")
def oracle():
    return brute_force_match
