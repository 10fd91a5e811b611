"""Test configuration: force an 8-device virtual CPU platform so
multi-chip sharding (jax.sharding.Mesh over key groups) is exercised
without TPU hardware.  Must run before jax initializes a backend.

Note: env-var JAX_PLATFORMS is not enough here — a site customization
may pre-register an accelerator platform at interpreter startup; the
in-process config update below still wins as long as no backend has
been initialized yet.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running chaos sweeps excluded from the tier-1 run "
        "(-m 'not slow')")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")
