"""The platform decision (nicetpu.device), the compile-cache location
(nicetpu.config) and the exact integer scans that replaced matmul stand-ins."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nicetpu import api, config, device


@pytest.mark.parametrize(
    "backend,gpu", [("gpu", True), ("cpu", False)]
)
def test_platform_choice(monkeypatch, backend, gpu):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert device.platform() == backend
    assert device.is_gpu() is gpu


def test_unknown_platform_raises(monkeypatch):
    """No silent fallback: a backend the device path does not support is
    an error, for "auto" routing too."""
    monkeypatch.setattr(jax, "default_backend", lambda: "unknown")
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        device.platform()
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        api.encode(np.zeros((4, 4, 3), np.uint8), backend="auto")


def test_auto_routes_to_native_on_cpu(monkeypatch):
    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    from nicetpu.hostref import oracle

    monkeypatch.setattr(oracle, "encode_native", lambda img: calls.append(1) or b"x")
    assert api.encode(np.zeros((4, 4, 3), np.uint8), backend="auto") == b"x"
    assert calls == [1]


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.compilation_cache_dir() == str(tmp_path)


def test_cache_dir_default_is_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert config.compilation_cache_dir() == os.path.join(root, ".jax_cache")
    assert os.path.isfile(os.path.join(config.REPO_ROOT, "nicetpu", "device.py"))


@pytest.mark.parametrize("center", [2048, 4096])
def test_cumsum_offsets_exact_near_tf32_limit(center):
    """The bit-offset scans are int32 `jnp.cumsum`: exact where a TF32 (10-bit
    mantissa) matmul would round, i.e. for element and prefix values just
    above 2048."""
    from nicetpu.kernels.encode2 import _fold_place_grouped

    rng = np.random.default_rng(center)
    k = rng.integers(center - 3, center + 4, 4096).astype(np.int32)
    got = np.asarray(jnp.cumsum(jnp.asarray(k)))
    np.testing.assert_array_equal(got, np.cumsum(k.astype(np.int64)))
    # end to end: group records of up to 320 bits, offsets well past 2^11
    N, S = 4096, 8
    aob = rng.integers(0, 6, (N, S)).astype(np.int32)
    code = (rng.integers(0, 1 << 30, (N, S)) & ((1 << aob) - 1)).astype(np.uint32)
    _, total, ovf = _fold_place_grouped(
        jnp.asarray(aob), jnp.asarray(code), w_cap=int(aob.sum()) // 32 + 16
    )
    assert not bool(ovf)
    assert int(total) == int(aob.sum())
