"""Device-fallback observability: a kernel bug or a device error must
surface as a failure, never as a silent native fallback; the format's own
data-dependent escapes are counted."""

import jax
import numpy as np
import pytest

from nicetpu import api, pipeline


def _img(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 50, (16, 16, 3)).astype(np.uint8)


def test_injected_bug_propagates(monkeypatch):
    """An exception in the fused encode is a hard error."""

    def boom(*a, **k):
        raise AssertionError("injected kernel bug")

    monkeypatch.setattr(pipeline, "encode_batch_resident", boom)
    with pytest.raises(AssertionError, match="injected kernel bug"):
        pipeline.encode_batch_fused([_img()])
    # and through the hybrid scheduler, too (its device leg is the fused
    # round-trip dispatch)
    monkeypatch.setattr(pipeline, "roundtrip_batch_resident", boom)
    with pytest.raises(AssertionError, match="injected kernel bug"):
        pipeline.roundtrip_hybrid(
            [([_img()], object())], device_threads=1, cpu_threads=0
        )


def _device_error(*a, **k):
    raise jax.errors.JaxRuntimeError("INTERNAL: device failure")


@pytest.mark.parametrize("path", ["encode_batch_fused", "roundtrip_hybrid"])
def test_device_error_propagates(monkeypatch, path):
    """A JaxRuntimeError (what a failed device compile or launch raises) is
    neither retried nor routed to the native codec: it reaches the caller,
    and no fallback is counted."""
    pipeline.pop_stats()
    if path == "encode_batch_fused":
        monkeypatch.setattr(pipeline, "encode_batch_resident", _device_error)
        call = lambda: pipeline.encode_batch_fused([_img(1)])
    else:
        from nicetpu.kernels import decode3

        monkeypatch.setattr(decode3, "roundtrip_verify_fused", _device_error)
        dev = pipeline.upload_batch([_img(1)])
        call = lambda: pipeline.roundtrip_hybrid(
            [([_img(1)], dev)], device_threads=1, cpu_threads=0
        )
    with pytest.raises(jax.errors.JaxRuntimeError, match="device failure"):
        call()
    assert pipeline.pop_stats() == {"device_fallbacks": 0, "overflow_fallbacks": 0}


def test_api_encode_batch_stats_plumbing():
    imgs = [_img(2), _img(3)]
    stats: dict = {}
    datas = api.encode_batch(imgs, backend="native", stats=stats)
    assert stats["backend"] == "native"
    dstats: dict = {}
    decs = api.decode_batch(datas, backend="native", stats=dstats)
    assert dstats["backend"] == "native"
    for im, dec in zip(imgs, decs):
        assert np.array_equal(im, dec)


def test_api_decode_batch_jax_stats():
    """Explicit jax backend fills the v3 decoder's fallback counters."""
    imgs = [_img(4), _img(5)]
    datas = api.encode_batch(imgs, backend="native")
    stats: dict = {}
    decs = api.decode_batch(datas, backend="jax", stats=stats)
    assert stats["backend"] == "jax"
    assert stats["fallbacks"] == 0
    for im, dec in zip(imgs, decs):
        assert np.array_equal(im, dec)
