"""Corruption-class decode tests: for each v3 gate,
construct a stream that trips exactly it and assert the gate via stats —
"defends as designed", not merely "doesn't crash".

Gate order in `stats["gates"]` / `_decode_core_v3`:
  [0] consistency — anchored re-walk reproduces speculative chunk exits
  [1] crossing    — every walked chunk crossed its boundary in budget
  [2] coverage    — decoded pixel coverage tiles [0, N) exactly
  [3] backref     — BACK_REF indices < NUM_BACK_REF (ref code.rs:634 panics)
"""

import numpy as np
import pytest

from nicetpu.format import constants as C
from nicetpu.format import headers
from nicetpu.kernels import decode3 as d3
from nicetpu.spec import codec

CONSISTENCY, CROSSING, COVERAGE, BACKREF = range(4)


def _gates(datas, *, chunk_bits=d3.CHUNK_BITS, steps_div=8, rounds=2):
    args, kw = d3.prepare_batch_args(
        datas, chunk_bits=chunk_bits, steps_div=steps_div, rounds=rounds
    )
    out, ok, gates = d3._device_decode_v3(*args, **kw)
    return np.asarray(out), np.asarray(ok), np.asarray(gates)


def _abab(h=64, w=64):
    """Every pixel BACK_REF(offset 2) => ~2-bit groups, ~2048 groups/chunk:
    denser than any step budget (max steps = chunk_bits/3) can walk."""
    img = np.zeros((h, w, 3), np.uint8)
    img[:, 0::2] = (200, 10, 40)
    img[:, 1::2] = (15, 220, 90)
    return img


def test_valid_stream_passes_all_gates():
    rng = np.random.default_rng(0)
    img = (rng.integers(0, 25, (48, 48, 3)) * 10).astype(np.uint8)
    data = codec.encode(img)
    # robust config: near-uniform random content self-syncs slowly, so the
    # FAST rung may legitimately miss (consistency gate) and retry — the
    # ladder contract below pins that no fallback ever reaches the host
    cfg = d3._as_cfg(d3.LADDER[-1])
    out, ok, gates = _gates(
        [data], chunk_bits=cfg.chunk_bits, steps_div=cfg.steps_div,
        rounds=cfg.rounds,
    )
    assert bool(ok[0]) and gates[0].all()
    # core output is channel-planar (3, N)
    h, w, _ = img.shape
    assert np.array_equal(out[0].reshape(3, h, w).transpose(1, 2, 0), img)
    # and the production ladder decodes it on device (no host fallback)
    stats: dict = {}
    dec = d3.decode_batch_jax_v3([data], stats=stats)[0]
    assert stats["fallbacks"] == 0
    assert np.array_equal(dec, img)


def test_truncated_payload_trips_coverage():
    rng = np.random.default_rng(1)
    img = (rng.integers(0, 25, (48, 48, 3)) * 9).astype(np.uint8)
    data = codec.encode(img)
    cut = (len(data) - C.FILE_HEADER_BYTES - C.STREAM_HEADERS_BYTES) // 2
    truncated = data[: len(data) - cut]
    out, ok, gates = _gates([truncated])
    assert not bool(ok[0])
    assert not bool(gates[0, COVERAGE])


def test_dense_short_groups_trip_crossing_and_ladder_falls_back():
    data = codec.encode(_abab())
    # direct core call at the fast config: budget 512 < ~2048 groups/chunk
    out, ok, gates = _gates([data], steps_div=8, rounds=2)
    assert not bool(ok[0])
    assert not bool(gates[0, CROSSING])
    # the full ladder also cannot cover 2-bit groups (max budget cb/3);
    # decode_batch falls back to the host decoder and still gets it right
    stats: dict = {}
    dec = d3.decode_batch_jax_v3([data], stats=stats)[0]
    assert stats["fallbacks"] == 1
    assert not stats["gates"][0][CROSSING]
    assert np.array_equal(dec, _abab())


def test_invalid_backref_index_trips_backref_gate():
    """Stream 9 symbols 5..10 have no offset (SURVEY A.3 row 9): the spec
    decoder raises; the device pipeline must reject via the backref gate
    rather than silently misdecoding (it used to treat idx>=5 as idx 0)."""
    img = _abab(32, 32)
    plan = codec.tokenize(img)
    br = (plan.streams == C.SC_BACK_REF) & plan.valid
    assert br.any()
    idx = np.argwhere(br)
    r, c = idx[len(idx) // 2]
    plan.symbols[r, c] = 9  # undecodable back-ref index
    counts = codec.histogram(plan)
    from nicetpu.format import huffman

    flat_lengths, flat_codes, _ = huffman.build_all_tables(counts)
    data = (
        headers.pack_file_header(32, 32, 3)
        + headers.pack_stream_headers(flat_lengths)
        + codec.pack_payload(plan, flat_lengths, flat_codes)
    )
    with pytest.raises(ValueError):
        codec.decode(data)
    out, ok, gates = _gates([data], steps_div=3, rounds=3)
    assert not bool(ok[0])
    assert not bool(gates[0, BACKREF])


def test_small_chunks_self_sync_miss_trips_consistency():
    """Near-fixed-length content (uniform noise -> ~25-bit RGB groups)
    defeats Huffman self-sync at small chunk sizes; the consistency gate
    must catch the miss (the production 4096-bit chunks make this rare —
    this test shrinks the chunk to make it reproducible)."""
    hit = None
    for seed in range(8):
        rng = np.random.default_rng(seed)
        img = rng.integers(0, 256, (48, 48, 3)).astype(np.uint8)
        data = codec.encode(img)
        out, ok, gates = _gates([data], chunk_bits=512, steps_div=3, rounds=2)
        if not bool(ok[0]):
            hit = (seed, gates)
            # the failure must be a consistency (or budget) miss, never a
            # silent wrong decode
            assert not bool(gates[0, CONSISTENCY]) or not bool(
                gates[0, CROSSING]
            )
        else:
            h, w, _ = img.shape
            assert np.array_equal(
                out[0].reshape(3, h, w).transpose(1, 2, 0), img
            )
        if hit and not bool(hit[1][0, CONSISTENCY]):
            break
    assert hit is not None, "no self-sync miss in 8 noise seeds at 512-bit chunks"
    assert not bool(hit[1][0, CONSISTENCY]), (
        "expected a consistency-gate miss; got only budget misses"
    )
