"""Test harness: CPU with 8 virtual devices is the suite default.

``JAX_PLATFORMS``, where set, picks the platforms instead (the GPU tests
run with ``JAX_PLATFORMS=cuda,cpu``).

Sharding tests run against a virtual 8-device CPU mesh (XLA host-platform
device count), which exercises the same partitioning and collective code
paths XLA compiles for several GPUs.  Tests that need a GPU take the
``gpu_device`` fixture and carry the ``gpu`` marker; they skip here.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from conan_slam.utils.compile_cache import setup_compile_cache  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
setup_compile_cache()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where the process has none.

    Decided when the test runs, never at import or collection, so every
    test worker collects the same tests.
    """
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip(
            "needs a GPU (on a GPU host: "
            "JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/)"
        )
    return gpus[0]
