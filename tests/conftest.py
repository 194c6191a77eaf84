"""Test configuration: force CPU backend with a virtual 8-device mesh.

Tests validate correctness of the (pure-JAX) kernels on the CPU backend;
TPU-specific performance is exercised by bench.py on real hardware.
The persistent compilation cache is enabled by spartan2_tpu.__init__
(shared with verify scripts and benches via ~/.cache/spartan2_tpu).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import spartan2_tpu  # noqa: F401  (enables the persistent compile cache)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: runs for tens of minutes; deselect with -m 'not slow'")
