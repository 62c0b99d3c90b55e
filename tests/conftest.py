import os

import pytest

# The suite runs on a virtual 8-device CPU mesh: sharding logic is
# validated without accelerators.  On a GPU machine, JAX_PLATFORMS=cuda
# leaves the platform alone so `pytest -m gpu` runs the card-only tests.
ON_CPU = os.environ.get("JAX_PLATFORMS", "cpu") in ("", "cpu")
if ON_CPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if ON_CPU:
    jax.config.update("jax_platforms", "cpu")
    # fp64 on CPU for numerics parity with the fp64 reference
    jax.config.update("jax_enable_x64", True)
    assert jax.default_backend() == "cpu" and len(jax.devices()) == 8

REF = "/root/reference"
SIMPLE = os.path.join(REF, "examples", "simple")


@pytest.fixture
def gpu():
    """Card-only tests take this fixture (and the `gpu` marker): they
    skip unless JAX's default backend is an NVIDIA GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `JAX_PLATFORMS=cuda python "
                    "-m pytest -m gpu tests/` on the card")
