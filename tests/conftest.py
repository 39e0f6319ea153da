"""Test environment: CPU backend with 8 virtual devices.

Matches SURVEY §4's multi-node testing note: sharded paths are validated
on a CPU mesh via ``--xla_force_host_platform_device_count=8``.

Tests run on the CPU unless ``JAX_PLATFORMS`` says otherwise; the tests
marked ``gpu`` need a card and are run on one with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.  Both the env
var and ``jax.config`` are set because a pytest plugin may import jax
before this conftest runs.  CPU test compiles stay out of the package's
persistent compilation cache.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["PETAL_NO_COMPILE_CACHE"] = "1"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when there is none.  Decided
    here, at run time — never while test modules are imported."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu)")
    return gpus[0]
