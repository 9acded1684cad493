"""Differential decoder fuzz: spec vs native on corrupted/truncated streams.

The reference decoder reads uninitialized memory and over-copies on corrupt
input (SURVEY A.8.4-5, A.8.8) — the anti-goal.  Both of this repo's decoders
must fail CLEANLY (ValueError/RuntimeError, no crash, no hang) or succeed;
where both succeed on the same mutated stream they must agree byte-for-byte.
"""

import numpy as np
import pytest

from nicetpu.spec import codec

pytestmark = pytest.mark.filterwarnings("ignore")


def _native():
    from nicetpu.hostref import oracle

    return oracle


def _decode_spec(data: bytes):
    try:
        return codec.decode(data), None
    except (ValueError, OverflowError, IndexError, ZeroDivisionError) as e:
        # IndexError/ZeroDivisionError would be hardening gaps: flag loudly
        if isinstance(e, (IndexError, ZeroDivisionError)):
            raise AssertionError(f"spec decoder raised raw {type(e).__name__}: {e}")
        return None, e


def _decode_native(data: bytes):
    oracle = _native()
    try:
        return oracle.decode_native(data), None
    except (ValueError, RuntimeError) as e:
        return None, e


@pytest.fixture(scope="module")
def base_stream() -> bytes:
    rng = np.random.default_rng(0)
    img = (
        (np.arange(40)[None, :, None] * 3 + np.arange(32)[:, None, None] * 2
         + rng.integers(-4, 5, (32, 40, 3))) % 256
    ).astype(np.uint8)
    return codec.encode(img)


def test_payload_corruption_differential(base_stream):
    rng = np.random.default_rng(1)
    data = bytearray(base_stream)
    agreements = 0
    for trial in range(200):
        mutated = bytearray(data)
        for _ in range(int(rng.integers(1, 6))):
            mutated[int(rng.integers(13, len(data)))] ^= int(rng.integers(1, 256))
        blob = bytes(mutated)
        s, se = _decode_spec(blob)
        n, ne = _decode_native(blob)
        if s is not None and n is not None:
            np.testing.assert_array_equal(s, n, err_msg=f"trial {trial}")
            agreements += 1
    # most single-byte payload corruptions still parse (wrong pixels, same
    # token structure) — the differential check must actually exercise
    assert agreements > 10


def test_header_corruption_differential(base_stream):
    rng = np.random.default_rng(2)
    data = bytearray(base_stream)
    for trial in range(150):
        mutated = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            mutated[int(rng.integers(0, 13 + 757))] ^= int(rng.integers(1, 256))
        blob = bytes(mutated)
        s, _ = _decode_spec(blob)
        n, _ = _decode_native(blob)
        if s is not None and n is not None:
            np.testing.assert_array_equal(s, n, err_msg=f"trial {trial}")


def test_truncation_differential(base_stream):
    for cut in list(range(0, 20)) + [100, 500, len(base_stream) // 2,
                                     len(base_stream) - 6, len(base_stream) - 1]:
        blob = base_stream[:cut]
        _decode_spec(blob)
        _decode_native(blob)  # must not crash or hang


def test_size_extremes():
    oracle = _native()
    from nicetpu.format import headers

    # absurd dimensions must be rejected before any allocation explosion
    for w, h in [(0, 0), (1, 1), (2**31 - 1, 2**31 - 1), (4, 0), (0, 4)]:
        blob = headers.pack_file_header(w, h, 3) + b"\x00" * 800
        _decode_spec(blob)
        try:
            oracle.decode_native(blob)
        except (ValueError, RuntimeError, MemoryError):
            pass


def test_random_garbage():
    rng = np.random.default_rng(3)
    for n in (0, 5, 13, 100, 1000, 5000):
        blob = bytes(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
        _decode_spec(blob)
        _decode_native(blob)
