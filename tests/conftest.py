"""Test config: run on CPU with 8 virtual devices and x64 enabled.

Mirrors the reference's test strategy (SURVEY.md §4): multi-rank behavior is
tested by running several MPI ranks on one host; we emulate a multi-device
mesh with `--xla_force_host_platform_device_count=8`, and use float64 on CPU
to check kernels against analytic solutions at tight tolerance.

Tests marked `gpu` need the card: they run where JAX_PLATFORMS names it
(`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`) and skip
elsewhere; the `gpu_device` fixture decides at run time.
"""

import os

# Must be set before the CPU backend initializes. jax.config.update (not
# env vars) also covers an environment that imported jax already.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

if "cuda" not in os.environ.get("JAX_PLATFORMS", ""):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


@pytest.fixture
def devices8():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs[:8]


@pytest.fixture
def gpu_device():
    """The first GPU, or skip: decided when the test runs, never at
    import or collection."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu)")
