"""Test configuration: CPU backend with 8 virtual devices and float64.

Tests run on a virtual 8-device CPU mesh (SURVEY.md section 4) so
multi-device sharding is exercised without accelerators; x64 is enabled
so golden comparisons against scipy oracles are meaningful.  The
platform is also forced through jax.config before backend init, so a
machine with a GPU still runs this suite on the CPU: the compiled GPU
path is checked by `python chip_smoke.py`, in one process on the card.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

assert jax.devices()[0].platform == "cpu"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-process / long-running tests")
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skipped elsewhere (chip_smoke.py "
        "runs these checks on the card)")
