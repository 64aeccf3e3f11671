import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

# NOTE: no XLA_FLAGS here on purpose — locally, smoke tests and benches see
# the single real CPU device (the dry-run sets its own flags; multi-device
# tests spawn subprocesses via the ``dist_run`` fixture below). CI launches
# the whole suite with 8 forced devices instead, which additionally enables
# the in-process shard tests in test_dist_unit.py; the suite is green both
# ways.

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _fresh_deprecation_state():
    """Reset the legacy-shim warn-once registry before every test.

    The shims warn once *per process* (exec/deprecation.py), so whether a
    given test observes the DeprecationWarning used to depend on which
    tests called a shim before it — order-dependent under
    ``pytest -p no:randomly``, random seeds, and split matrix workers.
    Resetting per test makes every test see a fresh process-like state;
    within a test the exactly-once contract is untouched."""
    from repro.exec.deprecation import reset_warnings

    reset_warnings()
    yield
    reset_warnings()


def run_multi_device(code: str, n_dev: int = 8, timeout: int = 360) -> dict:
    """Run ``code`` in a subprocess with ``n_dev`` fake CPU devices.

    Protocol: the snippet prints one JSON object as its last stdout line;
    a non-zero exit fails the test with the tail of stderr. Shared by all
    distributed tests so the main process keeps its single real device.
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_dev}"
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="session")
def dist_run():
    """The subprocess multi-device runner (XLA_FLAGS host-device-count +
    JSON-over-stdout protocol). New distributed tests take this fixture
    instead of re-implementing the spawn."""
    return run_multi_device


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels); such a test "
        "skips, with its reason, where torch finds no CUDA device")
