"""Tests for the first-divergence diff utility."""

import numpy as np

from nicetpu.spec import codec
from util_firstdiff import first_pixel_diff, first_token_diff, token_trace


def _img(h=24, w=24, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 40, (h, w, 3)).astype(np.uint8)
    base[h // 2 :] = base[0, 0]  # some runs
    return base


def test_token_trace_matches_decode():
    img = _img()
    data = codec.encode(img)
    trace = token_trace(data)
    # trace must start at bit 0 with a prefix token and be bit-monotonic
    assert trace[0][0] == 0 and trace[0][1] == codec.C.SC_PREFIXES
    bits = [t[0] for t in trace]
    assert bits == sorted(bits)
    # owning pixels are monotonic and within the raster
    pixels = [t[3] for t in trace]
    assert pixels == sorted(pixels)
    assert 0 <= pixels[-1] < img.shape[0] * img.shape[1]


def test_identical_streams_and_rasters():
    img = _img(seed=1)
    data = codec.encode(img)
    assert first_token_diff(data, data) is None
    assert first_pixel_diff(img, img) is None


def test_pixel_diff_reports_first_divergence_with_context():
    img = _img(seed=2)
    data = codec.encode(img)
    bad = img.copy()
    bad[5, 7, 1] ^= 3
    bad[9, 2, 0] ^= 1
    d = first_pixel_diff(img, bad, data)
    assert d["kind"] == "pixel"
    assert (d["y"], d["x"]) == (5, 7)
    assert d["n_diff_pixels"] == 2
    assert d["a"][1] != d["b"][1]
    assert "context" in d and d["context"][0]["stream"] == codec.C.SC_PREFIXES


def test_token_diff_localizes_payload_corruption():
    img = _img(seed=3)
    a = codec.encode(img)
    # re-encode a slightly different image => same headers only if tables
    # coincide; instead corrupt one payload byte to force a token divergence
    b = bytearray(a)
    b[codec.C.FILE_HEADER_BYTES + codec.C.STREAM_HEADERS_BYTES + 10] ^= 0x40
    d = first_token_diff(a, bytes(b))
    assert d is not None
    if d["kind"] == "token":
        assert d["a"]["bit"] <= (10 + 1) * 8
    else:
        assert d["kind"] == "token_count"


def test_header_diffs():
    img = _img(seed=4)
    a = codec.encode(img)
    other = _img(16, 24, seed=4)
    b = codec.encode(other)
    d = first_token_diff(a, b)
    assert d["kind"] == "file_header"
    # stream-header divergence: flip a length field bit
    c = bytearray(a)
    c[codec.C.FILE_HEADER_BYTES + 2] ^= 1
    d2 = first_token_diff(a, bytes(c))
    assert d2["kind"] == "stream_header"
    assert "stream" in d2 and "symbol" in d2
