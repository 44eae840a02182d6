"""Test env: force CPU with 8 virtual devices so sharding/collective paths
are exercised without an accelerator (chip_smoke.py runs the card).
Must run before jax is imported anywhere."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


def make_tone(fs, f, n, amp=1.0, phase=0.0, noise=0.0, rng=None):
    t = np.arange(n) / fs
    x = amp * np.exp(1j * (2 * np.pi * f * t + phase))
    if noise > 0:
        rng = rng or np.random.default_rng(0)
        x = x + noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)
