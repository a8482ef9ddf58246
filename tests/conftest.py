"""Test configuration: a virtual 8-device CPU mesh with fp64 enabled.

Mirrors the reference's test strategy (tests/Makefile:78-98 in the
reference: `mpirun -np N --oversubscribe` on one machine) — here, N virtual
XLA host-platform devices stand in for N cards so the full sharded code
paths (GSPMD partitioning, collectives) execute without hardware.

Tests marked ``card`` need the GPU and skip on the CPU.  They run on a
machine with a card with ``SBT_TEST_ON_CARD=1 python -m pytest -m card
tests/``, which leaves the platform to JAX.
"""

import os

import pytest

ON_CARD = os.environ.get("SBT_TEST_ON_CARD") == "1"

if not ON_CARD:
    # must be set before the first jax backend use
    flags = os.environ.get("XLA_FLAGS", "")
    if "--xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

from superbblas_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
# the sweeps generate many distinct shapes: cache every compile
enable_compile_cache(min_compile_secs=0.0)


@pytest.fixture
def card():
    """The GPU a ``card`` test runs on; skips when there is none."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs a GPU (run with SBT_TEST_ON_CARD=1 on a card)")
    return devs[0]
