"""The v2 device decoder (kernels/decode_dev.py) vs the executable spec.

The device decoder is the parallel counterpart of the reference's serial
decode loop (ref code.rs:573-684, hfe.rs:206-222, bitreader.rs:78-100); every
test round-trips spec-encoded bytes through `decode_jax` and demands byte
equality with the input raster, exercising both reconstruction paths
(serial chain spec and the segment-LUT row kernel).
"""

import glob
import os

import numpy as np
import pytest

from nicetpu.kernels.decode_dev import decode_jax
from nicetpu.spec import codec


def _cases() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(7)
    cases: dict[str, np.ndarray] = {}
    cases["noise"] = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    cases["const"] = np.full((40, 32, 3), 77, np.uint8)  # one full-image run
    x = np.zeros((16, 16, 3), np.uint8)
    x[:8] = 5
    x[8:] = 200
    cases["two-band-runs"] = x
    cases["tiny-w4"] = rng.integers(0, 256, (5, 4, 3)).astype(np.uint8)
    cases["one-row"] = rng.integers(0, 256, (1, 64, 3)).astype(np.uint8)
    cases["grad"] = (
        (
            np.arange(96)[None, :, None] * 2
            + np.arange(128)[:, None, None]
            + rng.integers(-2, 3, (128, 96, 3))
        )
        % 256
    ).astype(np.uint8)
    x = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    x[10:] = x[9, -1]
    cases["tail-run"] = x  # run ending exactly at the raster end (A.8.8)
    x = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    x[:20] = 0
    cases["head-run"] = x
    # last-3-columns same-row back-refs (w-1 / w-3 wrap, SURVEY A.8.2):
    # make column 0..2 values recur at the row ends
    x = rng.integers(0, 256, (8, 12, 3)).astype(np.uint8)
    x[:, -1] = np.roll(x[:, 0], -1, axis=0)
    x[2:, -1] = x[2:, 0]
    cases["row-wrap-refs"] = x
    return cases


@pytest.mark.parametrize("name", list(_cases()))
def test_roundtrip_rows_kernel(name):
    img = _cases()[name]
    out = decode_jax(codec.encode(img))
    np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("name", ["noise", "grad", "tail-run", "row-wrap-refs"])
def test_roundtrip_serial_recon(name):
    img = _cases()[name]
    out = decode_jax(codec.encode(img), serial_recon=True)
    np.testing.assert_array_equal(out, img)


def test_golden_fixtures_match_spec():
    files = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "data", "*.nice")))
    assert files
    for f in files:
        data = open(f, "rb").read()
        np.testing.assert_array_equal(decode_jax(data), codec.decode(data))


def test_max_token_density():
    """All-encoded noise maximizes chain length (every pixel a prefix +
    payload, zero runs) — stresses the pointer-doubling level budget."""
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (48, 52, 3)).astype(np.uint8)
    out = decode_jax(codec.encode(img))
    np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("name", ["noise", "grad", "tail-run", "row-wrap-refs"])
def test_roundtrip_doubling_chain(name):
    """The exact pointer-doubling chain (fallback path) must agree."""
    img = _cases()[name]
    out = decode_jax(codec.encode(img), chain="doubling")
    np.testing.assert_array_equal(out, img)


def test_spec_chain_digit_dense():
    """Adversarial for the speculative walk: alternating pixel/1-run
    patterns make the prefix stream digit-dominated (1-2 bit groups, the
    minimum-progress regime).  decode_jax must stay byte-exact — via the
    verified walk or the clean fallback."""
    rng = np.random.default_rng(13)
    img = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    img[:, 1::2] = img[:, 0::2]  # every pixel followed by a 1-pixel run
    out = decode_jax(codec.encode(img))
    np.testing.assert_array_equal(out, img)

    # and a long single-digit-run texture (prefix stream nearly all digit-0)
    img2 = np.repeat(rng.integers(0, 256, (32, 32, 3)), 2, axis=1).astype(np.uint8)
    out2 = decode_jax(codec.encode(img2))
    np.testing.assert_array_equal(out2, img2)


def test_spec_chain_matches_doubling_mask():
    """On valid streams the speculative walk must find EXACTLY the
    pointer-doubling orbit (restricted to real payload bits)."""
    import jax.numpy as jnp

    from nicetpu.format import constants as C
    from nicetpu.format import headers, huffman
    from nicetpu.kernels.decode_dev import (
        build_next_tables,
        chain_mask,
        pixel_jump,
        prepare_tables,
        spec_chain_mask,
    )

    rng = np.random.default_rng(29)
    for img in (
        rng.integers(0, 256, (24, 20, 3)).astype(np.uint8),
        (rng.integers(0, 4, (40, 16, 1)) * 60 + rng.integers(0, 3, (40, 16, 3))).astype(np.uint8),
    ):
        data = codec.encode(img)
        flat = headers.parse_stream_headers(data[C.FILE_HEADER_BYTES :])
        tabs = prepare_tables(flat)
        payload = data[C.FILE_HEADER_BYTES + C.STREAM_HEADERS_BYTES : len(data) - 4]
        wbits = len(payload) * 8
        src = np.frombuffer(payload + b"\0" * ((-len(payload)) % 4), dtype=">u4")
        words = np.zeros(1024, dtype=np.uint32)
        words[: src.shape[0]] = src.astype(np.uint32)
        af, present, ib, sorted_flat, pfx = (jnp.asarray(t) for t in tabs)
        nexta, nextb = build_next_tables(jnp.asarray(words), af, present, ib, pfx)
        next0 = pixel_jump(nexta, nextb)
        vis_spec, ok = spec_chain_mask(next0, jnp.int32(wbits))
        assert bool(ok)
        vis_dbl = np.asarray(chain_mask(next0, 18))
        p = np.arange(vis_dbl.shape[0])
        want = vis_dbl & (p < wbits)
        np.testing.assert_array_equal(np.asarray(vis_spec), want)


def test_fallback_on_garbage_is_clean():
    """A corrupted payload must either decode via the host fallback or raise
    a clean ValueError — never crash or hang (SURVEY A.8.4 anti-goal)."""
    img = _cases()["grad"]
    data = bytearray(codec.encode(img))
    rng = np.random.default_rng(3)
    for lo in (13, 800):  # stream-header region and payload region
        for _ in range(5):
            mutated = bytearray(data)
            for _ in range(8):
                mutated[rng.integers(lo, len(data))] ^= int(rng.integers(1, 256))
            try:
                decode_jax(bytes(mutated))
            except (ValueError, OverflowError):
                pass


def test_decode_batch_jax():
    """One vmapped dispatch decodes a same-shape batch with per-image tables;
    a corrupt member falls back per image without poisoning the batch."""
    from nicetpu.kernels.decode_dev import decode_batch_jax

    rng = np.random.default_rng(17)
    imgs = [rng.integers(0, 256, (24, 16, 3)).astype(np.uint8) for _ in range(3)]
    imgs.append(np.full((24, 16, 3), 9, np.uint8))
    datas = [codec.encode(im) for im in imgs]
    for o, im in zip(decode_batch_jax(datas), imgs):
        np.testing.assert_array_equal(o, im)

    bad = bytearray(datas[1])
    bad[900] ^= 0xFF
    try:
        outs = decode_batch_jax([datas[0], bytes(bad), datas[2]])
        np.testing.assert_array_equal(outs[0], imgs[0])
        np.testing.assert_array_equal(outs[2], imgs[2])
    except ValueError:
        pass  # clean reject of the corrupt member is also acceptable
