"""Test session config.

The distributed sorting library cannot be exercised on a single device, so
the test session runs with 8 emulated CPU devices (NOT the 512-device
dry-run setting, which stays confined to repro.launch.dryrun per the
project brief).  This must happen before jax initializes its backend —
conftest import precedes all test imports.

Higher emulated PE counts (p = 64–1024) do not need more XLA devices: the
``backend="sim"`` path of ``psort`` vmaps the per-PE bodies over a leading
axis in one process, with grouped collectives chunked into ring steps once
their gather buffers would blow past memory (see ``repro.core.comm``).

Markers: ``slow`` tags the long-tail matrix tests; the default lane
excludes them (``addopts`` in pyproject.toml), so the tier-1 command
``pytest -x -q`` stays fast.  Run ``pytest -m slow`` for the full matrix.
``faults`` tags the fault-injection lane (tests/test_faults.py): CI runs
the small-p slice in the fast job (``-m "faults and not slow"``) and the
full algorithm × distribution fault matrix nightly (``-m slow``).
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np   # noqa: E402
import pytest        # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running matrix/scaling tests (excluded from "
        "the default fast lane; run with -m slow)")
    config.addinivalue_line(
        "markers", "faults: fault-injection lane (kill/delay/rescale); the "
        "fast CI slice runs -m 'faults and not slow'")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (the PyTorch port's "
        "CUDA kernels); skips where no GPU is present")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
