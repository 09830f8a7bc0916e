"""Test configuration: run the tests on a virtual 8-device CPU mesh.

Multi-device sharding is validated on virtual CPU devices
(JAX_PLATFORMS=cpu + xla_force_host_platform_device_count=8). Tests marked
``gpu`` need a card: they skip here, and ``python chip_smoke.py`` runs them
on the GPU in its own process with SDFLIB_TESTS_ON_GPU=1, which leaves the
platform to JAX.

KNOWN BLIND SPOT: a program can be bit-exact on the CPU and wrong on a GPU
(TF32 contractions, denormal flushing, another reduction order). The GPU
is checked by chip_smoke.py, which compares every phase on the card with a
plain reference; CPU-green alone does not clear numeric changes.
"""
import os

import pytest

ON_GPU = os.environ.get("SDFLIB_TESTS_ON_GPU") == "1"

if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

import sdflib_tpu  # noqa: E402  (applies the package's compile-cache rule)

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    # Cache even sub-second compiles: XLA:CPU compiles dominate suite wall
    # time, and most test programs recur run to run. The directory follows
    # the package's rule (sdflib_tpu.compile_cache_dir).
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev
