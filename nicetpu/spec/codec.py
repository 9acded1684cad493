"""Numpy executable spec of the `.nice` codec.

Encoder: fully vectorized over pixels (the same formulation the device kernels
use — SURVEY §3.1's insight that every mode decision depends only on the raw
input bytes).  Decoder: serial reconstruction loop mirroring ref
code.rs:573-684, with robust handling of the end-of-image run (we never
execute the reference's out-of-bounds over-copy, SURVEY A.8.8).

Behavioral sources: ref code.rs:159-414 (encoder cascade), code.rs:371-407
(runs), code.rs:573-684 (decoder), hfe.rs (entropy), bitwriter.rs/bitreader.rs
(bit I/O).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from nicetpu.format import constants as C
from nicetpu.format import headers, huffman


# ---------------------------------------------------------------------------
# Tokenizer (vectorized)
# ---------------------------------------------------------------------------


@dataclass
class TokenPlan:
    """Per-pixel token slots in serial order (SURVEY A.6).

    streams/symbols/valid: (N, TOKEN_SLOTS).  Flattening row-major and taking
    valid slots yields the exact serial token sequence of the reference.
    """

    streams: np.ndarray  # uint8
    symbols: np.ndarray  # uint16
    valid: np.ndarray  # bool


def _shifted(flat: np.ndarray, off: int) -> np.ndarray:
    """ref[p] = flat[p - off] (zeros where p < off; callers mask validity)."""
    n = flat.shape[0]
    out = np.zeros_like(flat)
    if off < n:
        out[off:] = flat[: n - off]
    return out


def tokenize(img: np.ndarray) -> TokenPlan:
    """Vectorized mode cascade + run analysis for an (H, W, 3) uint8 image."""
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError("expected (H, W, 3) uint8 image")
    H, W, _ = img.shape
    if W < C.MIN_WIDTH:
        raise ValueError(f"width must be >= {C.MIN_WIDTH} (SURVEY A.8.7)")
    N = H * W
    flat = img.reshape(N, 3).astype(np.int32)
    pos = np.arange(N)

    prev = _shifted(flat, 1)  # raster predecessor (wraps rows, ref code.rs:412)
    above = _shifted(flat, W)
    row0 = pos < W

    # --- BACK_REF: first exact 3-byte match over 5 offsets (code.rs:192-206)
    br_offsets = C.back_ref_offsets(W)
    br_hits = np.stack(
        [(pos >= off) & np.all(flat == _shifted(flat, off), axis=1) for off in br_offsets]
    )  # (5, N)
    br_any = br_hits.any(axis=0)
    br_idx = br_hits.argmax(axis=0)

    # --- SMALL_DIFF: i16 non-wrapping diffs vs avg/left predictor (code.rs:210-247)
    pred_sd = np.where(row0[:, None], prev, (above + prev) // 2)
    d_sd = flat - pred_sd
    sd_hit = (pos > 0) & np.all((d_sd >= -3) & (d_sd <= 3), axis=1)
    sd_code = (3 + d_sd[:, 0]) + 7 * (3 + d_sd[:, 1]) + 49 * (3 + d_sd[:, 2])

    def luma_diffs(ref: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Wrapping-u8 luma-style diffs vs a reference pixel (code.rs:252-339)."""
        g = (flat[:, 1] - ref[:, 1]) & 255
        r = (flat[:, 0] - ref[:, 0] - g) & 255
        b = (flat[:, 2] - ref[:, 2] - g) & 255
        ok = (
            ((g >= 224) | (g < 32))
            & ((r >= 240) | (r < 16))
            & ((b >= 240) | (b < 16))
        )
        return g, r, b, ok

    # --- COLOR_LUMA2: averaged predictor, requires p >= W (code.rs:252-292)
    avg = (above + prev) // 2  # u16 floor; operands nonnegative
    l2_g, l2_r, l2_b, l2_ok = luma_diffs(avg)
    l2_hit = (~row0) & l2_ok

    # --- COLOR_LUMA: 11 single-pixel refs, first in-range wins (code.rs:295-339)
    lu_offsets = C.luma_ref_offsets(W)
    lu_pass = np.zeros((C.NUM_LUMA_REF, N), dtype=bool)
    lu_g = np.zeros((C.NUM_LUMA_REF, N), dtype=np.int32)
    lu_r = np.zeros((C.NUM_LUMA_REF, N), dtype=np.int32)
    lu_b = np.zeros((C.NUM_LUMA_REF, N), dtype=np.int32)
    for i, off in enumerate(lu_offsets):
        g, r, b, ok = luma_diffs(_shifted(flat, off))
        lu_pass[i] = (pos >= off) & (pos > 0) & ok
        lu_g[i], lu_r[i], lu_b[i] = g, r, b
    lu_any = lu_pass.any(axis=0)
    lu_idx = lu_pass.argmax(axis=0)
    ar = np.arange(N)
    lu_gs, lu_rs, lu_bs = lu_g[lu_idx, ar], lu_r[lu_idx, ar], lu_b[lu_idx, ar]

    # --- RGB fallback residuals (code.rs:341-366); pixel-0 predictor is 0
    pred_rgb_row0 = np.where(pos[:, None] > 0, prev, 0)
    res = np.where(row0[:, None], (flat - pred_rgb_row0) & 255, (flat - avg) & 255)

    # --- Mode priority select (first hit wins)
    mode = np.select(
        [br_any, sd_hit, l2_hit, lu_any],
        [
            np.full(N, C.PREFIX_BACK_REF),
            np.full(N, C.PREFIX_SMALL_DIFF),
            np.full(N, C.PREFIX_COLOR_LUMA2),
            np.full(N, C.PREFIX_COLOR_LUMA),
        ],
        default=C.PREFIX_RGB,
    )

    # --- Encoded-pixel set + run lengths (SURVEY §3.1)
    enc = np.empty(N, dtype=bool)
    enc[0] = True
    enc[1:] = np.any(flat[1:] != flat[:-1], axis=1)
    change_idx = np.where(enc, pos, N)
    suffix_min = np.minimum.accumulate(change_idx[::-1])[::-1]
    next_change = np.concatenate([suffix_min[1:], [N]])
    run_len = next_change - pos - 1  # meaningful for encoded pixels

    v = np.maximum(run_len - 1, 0)
    has_run = enc & (run_len > 0)
    # digit count per the encoder loop (code.rs:392-406): 1 + #{j>=1 : v >= 8^j}
    ndigits = np.ones(N, dtype=np.int64)
    for j in range(1, C.MAX_RUN_DIGITS):
        ndigits += v >= (1 << (3 * j))

    # --- Assemble token slots
    S = C.TOKEN_SLOTS
    streams = np.zeros((N, S), dtype=np.uint8)
    symbols = np.zeros((N, S), dtype=np.uint16)
    valid = np.zeros((N, S), dtype=bool)

    streams[:, 0] = C.SC_PREFIXES
    symbols[:, 0] = mode
    valid[:, 0] = enc

    is_br = mode == C.PREFIX_BACK_REF
    is_sd = mode == C.PREFIX_SMALL_DIFF
    is_l2 = mode == C.PREFIX_COLOR_LUMA2
    is_lu = mode == C.PREFIX_COLOR_LUMA
    is_rgb = mode == C.PREFIX_RGB

    # slot 1
    streams[:, 1] = np.select(
        [is_br, is_sd, is_l2, is_lu],
        [C.SC_BACK_REF, C.SC_SMALL_DIFF, C.SC_LUMA_BASE_DIFF2, C.SC_LUMA_BACK_REF],
        default=C.SC_RGB,
    )
    symbols[:, 1] = np.select(
        [is_br, is_sd, is_l2, is_lu],
        [br_idx, sd_code, (l2_g + 32) & 255, lu_idx],
        default=res[:, 0],
    )
    valid[:, 1] = enc

    # slot 2
    streams[:, 2] = np.select(
        [is_l2, is_lu], [C.SC_LUMA_OTHER_DIFF2, C.SC_LUMA_BASE_DIFF], default=C.SC_RGB
    )
    symbols[:, 2] = np.select(
        [is_l2, is_lu], [(l2_r + 16) & 255, (lu_gs + 32) & 255], default=res[:, 1]
    )
    valid[:, 2] = enc & (is_l2 | is_lu | is_rgb)

    # slot 3
    streams[:, 3] = np.select(
        [is_l2, is_lu], [C.SC_LUMA_OTHER_DIFFB2, C.SC_LUMA_OTHER_DIFF], default=C.SC_RGB
    )
    symbols[:, 3] = np.select(
        [is_l2, is_lu], [(l2_b + 16) & 255, (lu_rs + 16) & 255], default=res[:, 2]
    )
    valid[:, 3] = enc & (is_l2 | is_lu | is_rgb)

    # slot 4 (COLOR_LUMA only: blue diff into SC_LUMA_OTHER_DIFF)
    streams[:, 4] = C.SC_LUMA_OTHER_DIFF
    symbols[:, 4] = (lu_bs + 16) & 255
    valid[:, 4] = enc & is_lu

    # run digit slots
    for j in range(C.MAX_RUN_DIGITS):
        streams[:, 5 + j] = C.SC_PREFIXES
        symbols[:, 5 + j] = ((v >> (3 * j)) & 7) + C.PREFIX_RUN_BASE
        valid[:, 5 + j] = has_run & (j < ndigits)

    # Invalid slots may hold out-of-alphabet symbols (ungated diffs); zero them
    # so flat-table gathers stay in range everywhere downstream.
    streams[~valid] = 0
    symbols[~valid] = 0

    return TokenPlan(streams=streams, symbols=symbols, valid=valid)


# ---------------------------------------------------------------------------
# Encoder: tokens -> bitstream
# ---------------------------------------------------------------------------


def histogram(plan: TokenPlan) -> np.ndarray:
    bins = np.asarray(C.STREAM_BASE, dtype=np.int64)[plan.streams[plan.valid]] + (
        plan.symbols[plan.valid].astype(np.int64)
    )
    return np.bincount(bins, minlength=C.TOTAL_SYMBOLS)


def pack_payload(
    plan: TokenPlan, flat_lengths: np.ndarray, flat_codes: np.ndarray
) -> bytes:
    """Parallel bit-pack: exclusive-scan bit offsets + word scatter-add.

    Identical math to the device kernel (SURVEY §7.1 bit-pack).  Returns the
    payload plus the 5-byte flush tail [B, B, 0, 0, 0] (SURVEY A.1/A.6).
    """
    streams = plan.streams.reshape(-1).astype(np.int64)
    symbols = plan.symbols.reshape(-1).astype(np.int64)
    valid = plan.valid.reshape(-1)
    bins = np.asarray(C.STREAM_BASE, dtype=np.int64)[streams] + symbols
    aob = np.where(valid, flat_lengths[bins].astype(np.int64), 0)
    code = np.where(valid, flat_codes[bins].astype(np.int64), 0)

    offs = np.concatenate([[0], np.cumsum(aob)[:-1]])
    total_bits = int(aob.sum())

    n_words = total_bits // 32 + 2
    words = np.zeros(n_words, dtype=np.uint64)
    sel = valid & (aob > 0)
    o, L, cd = offs[sel], aob[sel], code[sel]
    w = o >> 5
    r = o & 31
    fits = r + L <= 32
    k = np.where(fits, 0, r + L - 32)
    hi = np.where(fits, cd << np.maximum(32 - r - L, 0), cd >> k)
    lo = np.where(fits, 0, (cd & ((1 << k) - 1)) << (32 - k))
    np.add.at(words, w, hi.astype(np.uint64))
    np.add.at(words, w + 1, lo.astype(np.uint64))
    assert (words <= 0xFFFFFFFF).all()

    raw = words.astype(">u4").tobytes()
    full = total_bits // 8
    B = raw[full] if total_bits % 8 else 0
    return raw[:full] + bytes([B, B, 0, 0, 0])


def encode(img: np.ndarray) -> bytes:
    """Full spec encoder: (H, W, 3) uint8 -> `.nice` bytes."""
    H, W, _ = img.shape
    plan = tokenize(img)
    counts = histogram(plan)
    flat_lengths, flat_codes, _ = huffman.build_all_tables(counts)
    return (
        headers.pack_file_header(W, H, 3)
        + headers.pack_stream_headers(flat_lengths)
        + pack_payload(plan, flat_lengths, flat_codes)
    )


# ---------------------------------------------------------------------------
# Decoder (serial spec)
# ---------------------------------------------------------------------------


class BitReader:
    """MSB-first bit reader; zero-extends past the end (the 5-byte tail plus
    zero-extension make the decoder's lookahead safe, SURVEY §2.3.6)."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def peek(self, n: int) -> int:
        byte0 = self.pos >> 3
        chunk = self.data[byte0 : byte0 + 5]
        val = int.from_bytes(chunk + b"\0" * (5 - len(chunk)), "big")
        return (val >> (40 - (self.pos & 7) - n)) & ((1 << n) - 1)

    def take(self, n: int) -> int:
        v = self.peek(n)
        self.pos += n
        return v


class StreamDecoder:
    """One-shot LUT decode (ref hfe.rs:206-222) with a LUT-free canonical
    range fallback for streams whose max code length exceeds the LUT cap."""

    def __init__(self, lengths: np.ndarray) -> None:
        self.lengths = np.asarray(lengths, dtype=np.int64)
        # Corrupt-header hardening (matches the C++ decoder): every length in
        # 1..=31 and the code exactly complete (Kraft sum == 1) — what every
        # conforming encoder emits (full-alphabet Huffman, SURVEY §2.3.1).
        if (self.lengths < 1).any() or (self.lengths > C.MAX_CODE_LEN).any():
            raise ValueError("corrupt stream header: code length out of range")
        if int((1 << (C.MAX_CODE_LEN - self.lengths)).sum()) != 1 << C.MAX_CODE_LEN:
            raise ValueError("corrupt stream header: non-canonical Kraft sum")
        self.max_aob = int(lengths.max())
        if self.max_aob <= 16:
            codes = huffman.canonical_codes(lengths)
            self.lut_sym, self.lut_aob = huffman.decode_lut(lengths, codes)
            self.deep = False
        else:
            self.sorted_syms, self.index_base, self.aligned_first = (
                huffman.canonical_decode_tables(lengths)
            )
            self.deep = True

    def read(self, br: BitReader) -> int:
        if not self.deep:
            x = br.peek(self.max_aob)
            br.pos += int(self.lut_aob[x])
            return int(self.lut_sym[x])
        aligned = br.peek(self.max_aob) << (32 - self.max_aob)
        best_l = 0
        for ln in range(1, self.max_aob + 1):
            af = int(self.aligned_first[ln])
            if af <= aligned:
                best_l = ln
        af = int(self.aligned_first[best_l])
        idx = int(self.index_base[best_l]) + ((aligned - af) >> (32 - best_l))
        sym = int(self.sorted_syms[idx])
        br.pos += best_l
        return sym


def decode(data: bytes) -> np.ndarray:
    """Serial spec decoder: `.nice` bytes -> (H, W, 3) uint8.

    Mirrors ref code.rs:573-684 with the A.8.8 fix: run copies are clamped to
    the image and we never read tokens past a run that fills the raster.
    """
    W, H, channels = headers.parse_file_header(data)
    if channels != 3:
        raise ValueError("only channels=3 decode is defined (SURVEY A.8.3)")
    N = W * H
    flat_lengths = headers.parse_stream_headers(data[C.FILE_HEADER_BYTES :])
    decoders = [
        StreamDecoder(
            flat_lengths[C.STREAM_BASE[s] : C.STREAM_BASE[s] + C.ALPHABET_SIZES[s]]
        )
        for s in range(C.NUM_STREAMS)
    ]
    br = BitReader(data[C.FILE_HEADER_BYTES + C.STREAM_HEADERS_BYTES :])
    rd = lambda s: decoders[s].read(br)

    lu_offsets = C.luma_ref_offsets(W)
    br_offsets = C.back_ref_offsets(W)

    out = np.zeros((N, 3), dtype=np.int64)
    pos = 0
    prev = 0
    prefix = rd(C.SC_PREFIXES)
    while True:
        if prefix == C.PREFIX_COLOR_LUMA2:
            g = rd(C.SC_LUMA_BASE_DIFF2) - 32
            up = pos - W
            avg = (out[prev] + out[up]) // 2
            gg = (g + avg[1]) & 255
            rr = (rd(C.SC_LUMA_OTHER_DIFF2) - 16 + g + avg[0]) & 255
            bb = (rd(C.SC_LUMA_OTHER_DIFFB2) - 16 + g + avg[2]) & 255
            out[pos] = (rr, gg, bb)
        elif prefix == C.PREFIX_SMALL_DIFF:
            code = rd(C.SC_SMALL_DIFF)
            dr = code % 7
            code = (code - dr) // 7
            dg = code % 7
            db = (code - dg) // 7
            ref = out[prev] if pos < W else (out[pos - W] + out[prev]) // 2
            out[pos] = (ref + np.array([dr, dg, db]) - 3) & 255
        elif prefix == C.PREFIX_COLOR_LUMA:
            off = lu_offsets[rd(C.SC_LUMA_BACK_REF)]
            g = rd(C.SC_LUMA_BASE_DIFF) - 32
            ref = out[pos - off]
            gg = (g + ref[1]) & 255
            rr = (rd(C.SC_LUMA_OTHER_DIFF) - 16 + g + ref[0]) & 255
            bb = (rd(C.SC_LUMA_OTHER_DIFF) - 16 + g + ref[2]) & 255
            out[pos] = (rr, gg, bb)
        elif prefix == C.PREFIX_BACK_REF:
            # Stream 9's alphabet is 11 symbols but the offset table has only
            # 5 entries (SURVEY A.3 row 9); indices 5..10 can only appear in
            # corrupt streams (the reference would panic, ref code.rs:634).
            idx = rd(C.SC_BACK_REF)
            if idx >= C.NUM_BACK_REF:
                raise ValueError(f"corrupt stream: back-ref index {idx} at pixel {pos}")
            out[pos] = out[pos - br_offsets[idx]]
        elif prefix == C.PREFIX_RGB:
            ref = out[prev] if pos < W else out[pos - W]
            pred = (ref + out[prev]) // 2 if pos > 0 else np.zeros(3, dtype=np.int64)
            out[pos] = (np.array([rd(C.SC_RGB), rd(C.SC_RGB), rd(C.SC_RGB)]) + pred) & 255
        else:
            raise ValueError(f"unknown prefix {prefix} at pixel {pos}")

        prev = pos
        pos += 1
        if pos >= N:
            break
        prefix = rd(C.SC_PREFIXES)
        if prefix >= C.PREFIX_RUN_BASE:
            v = 0
            shift = 0
            stream_done = False
            while True:
                v += (prefix - C.PREFIX_RUN_BASE) << shift
                shift += 3
                remaining = N - pos
                if v + 1 >= remaining:
                    # Run fills the raster: no further tokens exist; do not
                    # read the reference's one-past-the-end prefix (A.8.8).
                    stream_done = True
                    break
                if v + (1 << shift) + 1 > remaining:
                    # No additional digit could produce a valid run; the next
                    # symbol must be the next pixel's mode prefix.
                    prefix = rd(C.SC_PREFIXES)
                    break
                prefix = rd(C.SC_PREFIXES)
                if prefix < C.PREFIX_RUN_BASE:
                    break
            copies = min(v + 1, N - pos)
            out[pos : pos + copies] = out[prev]
            prev = pos + copies - 1
            pos += copies
            if stream_done or pos >= N:
                break

    return out.astype(np.uint8).reshape(H, W, 3)
