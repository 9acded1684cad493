"""Batch APIs: OpenMP native batch + JAX batched pipeline + api dispatch."""

import numpy as np
import pytest

from nicetpu.spec import codec

oracle = pytest.importorskip("nicetpu.hostref.oracle")

try:
    oracle.get_lib()
    HAVE_LIB = True
except Exception:  # pragma: no cover
    HAVE_LIB = False

pytestmark = pytest.mark.skipif(not HAVE_LIB, reason="g++ toolchain unavailable")


def _mixed_images(seed=0, count=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        h, w = int(rng.integers(4, 40)), int(rng.integers(4, 40))
        out.append(
            (rng.integers(0, 6, (h, w, 1)) * 40 + rng.integers(0, 5, (h, w, 3))).astype(
                np.uint8
            )
        )
    return out


class TestNativeBatch:
    def test_roundtrip_and_parity(self):
        imgs = _mixed_images()
        datas = oracle.encode_batch_native(imgs)
        for im, d in zip(imgs, datas):
            assert d == codec.encode(im)
        outs = oracle.decode_batch_native(datas)
        for im, o in zip(imgs, outs):
            np.testing.assert_array_equal(o, im)


class TestJaxBatch:
    def test_batch_matches_spec(self):
        from nicetpu.kernels.encode2 import encode_batch

        rng = np.random.default_rng(1)
        imgs = np.stack(
            [
                rng.integers(0, 256, (12, 16, 3), dtype=np.uint8),
                (rng.integers(0, 4, (12, 16, 1)) * 60 + rng.integers(0, 4, (12, 16, 3))).astype(np.uint8),
                np.full((12, 16, 3), 9, dtype=np.uint8),
            ]
        )
        outs = encode_batch(imgs)
        for b in range(imgs.shape[0]):
            assert outs[b] == codec.encode(imgs[b])


class TestApiBatch:
    def test_api_batch_roundtrip(self):
        from nicetpu import api

        imgs = _mixed_images(seed=2, count=4)
        datas = api.encode_batch(imgs)
        outs = api.decode_batch(datas)
        for im, o in zip(imgs, outs):
            np.testing.assert_array_equal(o, im)


class TestHybridScheduler:
    """Heterogeneous round-trip scheduler (pipeline.roundtrip_hybrid): device
    and CPU workers drain one queue from opposite ends; every stream must be
    byte-identical to the spec encoder regardless of who won each batch."""

    def test_hybrid_byte_exact_and_complete(self):
        from nicetpu.pipeline import roundtrip_hybrid, upload_batch

        rng = np.random.default_rng(3)
        imgs = [
            (rng.integers(0, 5, (16, 32, 1)) * 50 + rng.integers(0, 4, (16, 32, 3))).astype(
                np.uint8
            )
            for _ in range(12)
        ]
        hb = [imgs[i : i + 4] for i in range(0, 12, 4)]
        batches = [(b, upload_batch(b)) for b in hb]
        res, stats = roundtrip_hybrid(batches, device_threads=2, cpu_threads=1)
        assert stats["device_batches"] + stats["cpu_batches"] == len(batches)
        for out, b in zip(res, hb):
            for (d, dec), im in zip(out, b):
                assert d == codec.encode(im)
                np.testing.assert_array_equal(dec, im)

    def test_hybrid_host_only_entries(self):
        """dev_batch=None entries must route to the host path even when a
        device worker pops them."""
        from nicetpu.pipeline import roundtrip_hybrid

        rng = np.random.default_rng(4)
        imgs = [rng.integers(0, 256, (8, 16, 3)).astype(np.uint8) for _ in range(4)]
        batches = [(imgs[:2], None), (imgs[2:], None)]
        res, stats = roundtrip_hybrid(batches, device_threads=1, cpu_threads=0)
        assert stats["cpu_batches"] == 2
        for out, b in zip(res, [imgs[:2], imgs[2:]]):
            for (d, dec), im in zip(out, b):
                assert d == codec.encode(im)
                np.testing.assert_array_equal(dec, im)


class TestAlphaPolicy:
    """channels=4 wire story (SURVEY A.8.3): the reference encoder writes
    channels=4 files its own decoder cannot reconstruct; this codec always
    writes channels=3 with an explicit, tested RGBA policy."""

    def test_rgba_drop_matches_rgb(self):
        from nicetpu import api

        rng = np.random.default_rng(0)
        rgb = rng.integers(0, 256, (12, 16, 3)).astype(np.uint8)
        rgba = np.dstack([rgb, rng.integers(0, 256, (12, 16)).astype(np.uint8)])
        assert api.encode(rgba, backend="spec") == api.encode(rgb, backend="spec")

    def test_rgba_error_policy(self):
        import pytest

        from nicetpu import api

        rgba = np.zeros((8, 8, 4), np.uint8)
        with pytest.raises(ValueError, match="alpha"):
            api.encode(rgba, backend="spec", alpha="error")

    def test_wire_channels_always_3(self):
        from nicetpu import api
        from nicetpu.format import headers

        rgba = np.zeros((8, 8, 4), np.uint8)
        data = api.encode(rgba, backend="spec")
        assert headers.parse_file_header(data)[2] == 3
