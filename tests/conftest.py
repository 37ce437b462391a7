import os
import sys

# src/ layout import path (tests run as `PYTHONPATH=src pytest tests/`; this
# makes plain `pytest` work too).  NOTE: no XLA_FLAGS here on purpose — smoke
# tests must see the real single-device CPU backend; mesh-dependent tests
# spawn subprocesses that set --xla_force_host_platform_device_count.
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def run_subprocess(code: str, devices: int = 8, timeout: int = 600) -> str:
    """Run `code` in a fresh python with N fake XLA host devices."""
    import subprocess

    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=timeout,
    )
    assert out.returncode == 0, f"subprocess failed:\n{out.stdout}\n{out.stderr}"
    return out.stdout


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; the test skips without one")
