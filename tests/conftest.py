# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# real single CPU device.  Sharded behaviour is tested via subprocesses that
# set --xla_force_host_platform_device_count themselves.
import os
import subprocess
import sys

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def run_sharded(script: str, devices: int = 8, timeout: int = 420) -> str:
    """Run a python snippet in a subprocess with N fake devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run(
        [sys.executable, "-c", script],
        capture_output=True,
        text=True,
        env=env,
        timeout=timeout,
    )
    assert proc.returncode == 0, f"sharded subprocess failed:\n{proc.stderr[-4000:]}"
    return proc.stdout


@pytest.fixture
def sim_harness():
    """Factory for seeded virtual-time scenario harnesses (core.simclock).

    Usage: ``h = sim_harness(seed=7, policy="slo", num_workers=4)`` —
    everything the harness runs happens in virtual time (no real sleeps),
    and a same-seed, same-schedule harness must replay a byte-identical
    event trace (``h.trace_bytes()``)."""
    from repro.core.simclock import SimHarness

    def make(seed: int = 0, **service_kwargs):
        return SimHarness(seed=seed, **service_kwargs)

    return make


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA card a ``card`` test runs on; skips on a machine without one
    (decided here, never while a module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
