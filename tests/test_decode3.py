"""Tests for the v3 device decoder (chunked walk + slot-space assembly).

On the CPU test platform the walk runs as the plain reference (`walk_ref`);
the GPU kernel is pinned against it in tests/test_walk_kernel.py.  These
tests pin the full pipeline byte-exact against the executable spec codec.

Image shapes are deliberately limited to two sizes — every distinct
(n_pixels, width, steps, maxl) tuple is a separate XLA compile and the
unrolled group-decode body compiles slowly on CPU.
"""

import numpy as np
import pytest

from nicetpu.format import constants as C
from nicetpu.kernels import decode3
from nicetpu.spec import codec

SHAPE_A = (48, 64)
SHAPE_B = (64, 128)


def mkimg(shape, seed=0, runs=True):
    h, w = shape
    rng = np.random.default_rng(seed)
    if runs:
        img = (
            rng.integers(0, 5, (h, w, 1)) * 50 + rng.integers(0, 4, (h, w, 3))
        ).astype(np.uint8)
        img[h // 3 : h // 2] = img[h // 3, 0]  # long run crossing rows
        return img
    return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("seed,runs", [(0, True), (1, False), (2, True)])
def test_roundtrip_matches_spec(seed, runs):
    img = mkimg(SHAPE_A, seed, runs)
    data = codec.encode(img)
    stats = {}
    out = decode3.decode_jax_v3(data, stats=stats)
    assert stats["fallbacks"] == 0, "device path must not silently fall back"
    assert np.array_equal(out, img)


def test_batch_decode():
    imgs = [mkimg(SHAPE_A, s) for s in range(3)]
    datas = [codec.encode(im) for im in imgs]
    stats = {}
    outs = decode3.decode_batch_jax_v3(datas, stats=stats)
    assert stats["fallbacks"] == 0
    for out, im in zip(outs, imgs):
        assert np.array_equal(out, im)


def test_multichunk_noise_stream():
    # noise payload >> chunk_bits: several chunks walk speculatively and
    # must self-sync (near-fixed-length groups are the hard case)
    img = mkimg(SHAPE_B, 3, runs=False)
    data = codec.encode(img)
    stats = {}
    out = decode3.decode_jax_v3(data, stats=stats)
    assert stats["fallbacks"] == 0
    assert np.array_equal(out, img)


def test_small_chunks_correct_even_if_fallback():
    # 512-bit chunks self-sync poorly on noise (measured ~26% per-chunk
    # failure); the gate must catch misses and the result stay exact.
    img = mkimg(SHAPE_B, 4, runs=False)
    data = codec.encode(img)
    out = decode3.decode_jax_v3(data, chunk_bits=512, ladder=((8, 2),))
    assert np.array_equal(out, img)


def test_all_modes_exercised():
    # gradient + noise + flat patches hits every mode incl. LUMA refs
    h, w = SHAPE_B
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 3 % 256, (xx + yy) % 256, yy * 5 % 256], axis=-1).astype(
        np.uint8
    )
    img[10:20, 10:20] = 77
    rng = np.random.default_rng(7)
    img[25:] = rng.integers(0, 256, (h - 25, w, 3))
    data = codec.encode(img)
    out = decode3.decode_jax_v3(data)
    assert np.array_equal(out, img)


def test_long_run_digits():
    img = np.full(SHAPE_B + (3,), 9, np.uint8)  # one giant run, multi-digit
    img[0, 0] = [1, 2, 3]
    data = codec.encode(img)
    stats = {}
    out = decode3.decode_jax_v3(data, stats=stats)
    assert stats["fallbacks"] == 0
    assert np.array_equal(out, img)


def test_corrupt_stream_falls_back_or_raises():
    img = mkimg(SHAPE_A, 5)
    data = bytearray(codec.encode(img))
    # flip payload bits mid-stream
    data[C.FILE_HEADER_BYTES + C.STREAM_HEADERS_BYTES + 40] ^= 0xFF
    try:
        out = decode3.decode_jax_v3(bytes(data), ladder=((8, 2),))
        assert out.shape == img.shape  # defined-shape output, no crash
    except (ValueError, OverflowError):
        pass  # clean rejection also fine


def test_serial_recon_path():
    img = mkimg(SHAPE_A, 6)
    data = codec.encode(img)
    out = decode3.decode_jax_v3(data, serial_recon=True)
    assert np.array_equal(out, img)


@pytest.mark.parametrize(
    "n,want", [(1, 1), (7, 7), (9, 10), (16, 16), (17, 20), (33, 40), (2305, 2560), (4097, 5120)]
)
def test_bucket_chunks(n, want):
    assert decode3.bucket_chunks(n) == want


def test_bucket_chunks_bounds():
    """Never fewer chunks, at most 25% more, and monotone."""
    got = [decode3.bucket_chunks(n) for n in range(1, 20000)]
    for n, b in enumerate(got, start=1):
        assert n <= b < n * 1.25 + 1
    assert got == sorted(got)


def test_nearby_payloads_share_one_program():
    """Two images whose payloads differ by a chunk or more, inside one
    bucket, decode exactly through one compiled program."""
    noise = mkimg(SHAPE_A, 9, runs=False)
    hdr = C.FILE_HEADER_BYTES + C.STREAM_HEADERS_BYTES + 4
    by_program: dict = {}  # (word-array shape, static args) -> {exact words: image}
    for k in range(1, SHAPE_A[0]):  # k noisy rows over a run-heavy image
        img = mkimg(SHAPE_A, 8)
        img[:k] = noise[:k]
        data = codec.encode(img)
        bits = (len(data) - hdr) * 8
        # the word count each rung would need with no bucket
        exact = max(-(-bits // c.chunk_bits) * (c.chunk_bits // 32) for c in decode3.LADDER)
        args, kw = decode3.prepare_batch_args([data])
        key = (args[0].shape, tuple(sorted(kw.items())))
        by_program.setdefault(key, {})[exact] = (img, data)
    pair = next((list(v.values())[:2] for v in by_program.values() if len(v) > 1), None)
    assert pair is not None, "no two payload sizes share one decode program"
    sizes = []
    for img, data in pair:
        stats = {}
        out = decode3.decode_jax_v3(data, stats=stats)
        assert stats["fallbacks"] == 0
        assert np.array_equal(out, img)
        sizes.append(decode3._device_decode_v3._cache_size())
    assert sizes[0] == sizes[1]
