"""Test config: an 8-device virtual CPU platform for the sharding tests.

The tests run on the CPU, whatever the machine holds (`JAX_PLATFORMS=cpu`
plus `jax.config.update`, in case JAX was imported before this file).  The
8-device mesh is load-bearing: sharded tests FAIL (not skip) if it is
absent.  Tests that need the GPU carry the `gpu` marker and decide in the
`gpu` fixture, at run time, whether a card is present.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
if not os.environ.get("NICETPU_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

from nicetpu.config import apply_compilation_cache

if not os.environ.get("NICETPU_TEST_GPU"):
    jax.config.update("jax_platforms", "cpu")
# Persistent XLA compile cache (JAX_COMPILATION_CACHE_DIR, else
# <checkout>/.jax_cache): the unrolled decode selects compile slowly on the
# CPU, and cached executables make repeat runs minutes faster.
apply_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
if not os.environ.get("NICETPU_TEST_GPU"):
    assert len(jax.devices()) >= 8, (
        "test environment must expose 8 virtual CPU devices; got "
        f"{jax.devices()} — sharded tests cannot be skipped silently"
    )


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `NICETPU_TEST_GPU=1 pytest -m gpu tests/`")
    return jax.devices()[0]
