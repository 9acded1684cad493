"""Device `.nice` decode v2: fully parallel entropy decode + gather-free
pixel reconstruction, all on device (superseded by decode3 except for the
row reconstruction, which decode3 uses).

This is the parallel reformulation of the reference's strictly serial decoder
(ref code.rs:573-684 reconstruction, hfe.rs:206-222 symbol decode,
bitreader.rs:78-100 bit peek).  It has NO serial token walks and no
data-dependent gathers inside sequential loops — three ideas:

1. **Per-bit packed walk tables (gather-free).**  For every payload bit
   position p and every stream s, the canonical code length L_s(p) is a
   handful of unsigned threshold compares of the 32-bit window at p against
   the per-length first codes (format.huffman.decode_dev_tables).  All ten
   lengths plus the prefix-stream symbol pack into two int32 words per bit.

2. **Pixel-group jump table + chunked speculative walk.**  The decoder's
   parser state machine (prefix -> payload tokens -> back to prefix, ref
   code.rs:576-651) collapses into a single per-bit function next0[p]: "if
   a pixel group starts at bit p, the next group starts at next0[p]" —
   built with 8 flat gathers (prefix symbol selects the payload slot
   streams; each slot hop is one gather into the packed tables).  The true
   token boundaries are the orbit of bit 0 under next0, found by
   `spec_chain_mask`: independent walks from every 512-bit chunk boundary,
   self-synchronizing Huffman-style, each VERIFIED against the anchored
   true entry (exit of the previous chunk) — O(B) gathered volume.  A miss
   (corrupt stream, adversarial self-sync failure) clears `ok` and the
   caller falls back; `chain_mask` (exact pointer doubling, O(B log B))
   remains as the deterministic device-side alternative.

3. **Gather-free segmented row reconstruction.**  The value chain
   out[p] = f_p(out[p-1], ...) is serial through the WHOLE raster (the
   format's row-wrapping `prev`, SURVEY A.8.2, forbids any row wavefront),
   but every per-pixel transfer is per-channel and one of const /
   add-lag-k / floor-average — each exactly a 256-entry LUT of one chain
   value, and LUTs compose.  Rows are an H-step scan carrying the previous
   FOUR rows (all CONST refs reach <= 3W+3 back, ref code.rs:141-145), so
   `above` and all reference pixels come from static slices of the carry —
   zero in-loop gathers.  Each row: segment LUTs built by pushing all 256
   candidate boundary values through the segment in parallel (elementwise),
   segment boundaries resolved by a short one-hot scan, then a replay pass;
   a 3-column serial fixup handles the w-1/w-3 same-row wrap refs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from nicetpu.format import constants as C

# ---------------------------------------------------------------------------
# Mode tables (ref code.rs:576-651: which streams each mode's payload uses)
# ---------------------------------------------------------------------------
# payload symbols per mode prefix
NPAYLOAD = (1, 3, 4, 1, 3)  # BACK_REF, RGB, COLOR_LUMA, SMALL_DIFF, COLOR_LUMA2
# per-mode payload slot streams (-1 = no symbol in that slot)
SLOT_STREAM = (
    (C.SC_BACK_REF, -1, -1, -1),
    (C.SC_RGB, C.SC_RGB, C.SC_RGB, -1),
    (C.SC_LUMA_BACK_REF, C.SC_LUMA_BASE_DIFF, C.SC_LUMA_OTHER_DIFF, C.SC_LUMA_OTHER_DIFF),
    (C.SC_SMALL_DIFF, -1, -1, -1),
    (C.SC_LUMA_BASE_DIFF2, C.SC_LUMA_OTHER_DIFF2, C.SC_LUMA_OTHER_DIFFB2, -1),
)

# reconstruction transfer forms (expand_positions -> reconstruct_*)
F_CONST, F_ADD1, F_ADD2, F_ADD3, F_HALF = 0, 1, 2, 3, 4


def _sel(key, table):
    """Select static per-key constants with predicated selects (no gather)."""
    out = jnp.full(key.shape, int(table[0]), jnp.int32)
    for i in range(1, len(table)):
        out = jnp.where(key == i, int(table[i]), out)
    return out


def _field(a, b, s: int):
    """Code length of stream s from the packed (nexta, nextb) pair."""
    return (a >> (5 * s)) & 31 if s < 5 else (b >> (5 * (s - 5))) & 31


# ---------------------------------------------------------------------------
# Phase 0: per-bit windows + packed walk tables (all VPU, gather-free)
# ---------------------------------------------------------------------------


def windows_all(words: jnp.ndarray) -> jnp.ndarray:
    """32-bit MSB-first bit windows at every bit position.

    words: (Bw,) uint32 (payload packed MSB-first, with >= 2 zero tail
    words).  Returns (Bw*32,) uint32: win[p] = payload bits p..p+31."""
    w = words
    w1 = jnp.concatenate([w[1:], jnp.zeros(1, jnp.uint32)])
    o = jnp.arange(32, dtype=jnp.uint32)
    hi = w[:, None] << o[None, :]
    lo = jnp.where(o[None, :] == 0, jnp.uint32(0), w1[:, None] >> (32 - o[None, :]))
    return (hi | lo).reshape(-1)


def _window_at(words, pos):
    """32-bit window at arbitrary bit positions (two flat gathers)."""
    w = pos >> 5
    sh = (pos & 31).astype(jnp.uint32)
    return (words[w] << sh) | jnp.where(
        sh == 0, jnp.uint32(0), words[jnp.minimum(w + 1, words.shape[0] - 1)] >> (jnp.uint32(32) - sh)
    )


def _length_one_stream(win, af_s, present_s):
    """Code length at every position for one stream (canonical decode:
    L = max{l: present[l] and af[l] <= win}; af increasing over present l)."""
    L = jnp.zeros(win.shape, jnp.int32)
    for l in range(1, 32):
        L = jnp.where(present_s[l] & (win >= af_s[l]), l, L)
    return L


def _sym_index(win, L, af_s, present_s, ib_s):
    """Canonical index of the codeword at a window, given its length L."""
    idx = jnp.zeros(win.shape, jnp.int32)
    for l in range(1, 32):
        v = ib_s[l] + ((win - af_s[l]) >> jnp.uint32(32 - l)).astype(jnp.int32)
        idx = jnp.where((L == l) & present_s[l], v, idx)
    return idx


def build_next_tables(words, af, present, ib, pfx_sorted):
    """Packed per-bit walk tables (NEXTA, NEXTB), each (B,) int32.

    NEXTA packs code lengths of streams 0..4 (5 bits each, bits 0..24) plus
    the prefix-stream SYMBOL decoded at p (bits 25..28, values 0..12);
    NEXTB packs lengths of streams 5..9.  pfx_sorted maps the prefix
    stream's canonical index -> symbol value (host-prepared)."""
    win = windows_all(words)
    Ls = [_length_one_stream(win, af[s], present[s]) for s in range(C.NUM_STREAMS)]
    nexta = Ls[0]
    for s in range(1, 5):
        nexta = nexta | (Ls[s] << (5 * s))
    nextb = Ls[5]
    for s in range(6, 10):
        nextb = nextb | (Ls[s] << (5 * (s - 5)))

    sp = C.SC_PREFIXES
    idx = _sym_index(win, Ls[sp], af[sp], present[sp], ib[sp])
    sym = jnp.zeros(win.shape, jnp.int32)
    for j in range(C.ALPHABET_SIZES[sp]):
        sym = jnp.where(idx == j, pfx_sorted[j], sym)
    return nexta | (sym << 25), nextb


# ---------------------------------------------------------------------------
# Phase 1: pixel-group jump table + pointer-doubling chain mask
# ---------------------------------------------------------------------------


def pixel_jump(nexta, nextb):
    """next0[p] = bit position of the next pixel-group start, assuming a
    group (mode prefix or run digit + its payload) starts at p in the
    prefix state.  8 flat gathers; everything else elementwise."""
    B = nexta.shape[0]
    ab = jnp.stack([nexta, nextb], axis=1)  # (B, 2): one row gather per hop
    m = (nexta >> 25) & 15
    q = jnp.arange(B, dtype=jnp.int32) + ((nexta >> 5) & 31)  # consume prefix
    for k in range(C.MODE_PAYLOAD_SLOTS):
        qc = jnp.minimum(q, B - 1)
        row = ab[qc]
        a, b = row[:, 0], row[:, 1]
        L = jnp.zeros(B, jnp.int32)
        for mode in range(5):
            s = SLOT_STREAM[mode][k]
            if s >= 0:
                L = jnp.where(m == mode, _field(a, b, s), L)
        q = q + L
    return jnp.minimum(q, B - 1)


def chain_mask(next0, levels: int):
    """Boolean mask of the orbit of bit 0 under next0 (pointer doubling).

    After `levels` rounds the mask covers chain prefixes up to 2^levels
    nodes — exact, no speculation.  Chains longer than that (corrupt
    streams) leave the mask incomplete, which the coverage check catches.

    Cost: 2*levels flat gathers/scatters over ALL B bit positions
    (~38x the payload in gathered volume at levels ~ 19) — kept as the
    deterministic fallback; `spec_chain_mask` is ~5x cheaper."""
    B = next0.shape[0]
    V = jnp.zeros(B, jnp.int32).at[0].set(1)
    J = next0
    for _ in range(levels):
        V = V.at[J].max(V)
        J = J[J]
    return V > 0


def spec_chain_mask(
    next0, wbits, *, chunk_bits: int = 4096, rounds: int = 3, unroll: int = 8
):
    """Speculative self-synchronizing chunked walk (gap-array technique from
    the GPU Huffman literature, PAPERS.md): the orbit of bit 0 under next0
    in O(rounds * B) gathered volume instead of pointer doubling's
    O(B log B) (~38x the payload at 512^2).

    A walk starts at every chunk_bits boundary and follows next0 for
    chunk_bits steps (every group consumes >= 1 bit, so that always crosses
    the chunk; walks freeze at their first position past the boundary —
    that exit is the next chunk's candidate entry).  Huffman mode chains
    self-synchronize, so a walk started mid-token usually merges with the
    true chain well before its chunk ends — measured merge rates for this
    grammar (10 interleaved streams, mode-driven parse) need ~2-4 kbit
    chunks, weaker than single-stream Huffman.  Each subsequent round
    re-walks every chunk from the candidate entries e_c (= previous round's
    exit of chunk c-1, anchored at e_0 = 0); entry truth propagates at
    least one chunk per round and in practice converges in <= 2 rounds at
    chunk_bits = 4096.  The gate is exit CONSISTENCY of the final round:
    if it reproduces the entries it was given, induction from the anchor
    proves every e_c true (walks are deterministic functions of their
    start).  Any residual inconsistency (corrupt stream, adversarial
    self-sync failure) clears `ok` and the caller falls back — correctness
    never rests on the heuristic.

    Returns (visited (B,) bool, ok bool)."""
    B = next0.shape[0]
    if B % chunk_bits:
        raise ValueError(f"B {B} must be a multiple of chunk_bits {chunk_bits}")
    nch = B // chunk_bits
    starts = jnp.arange(nch, dtype=jnp.int32) * chunk_bits
    bounds = starts + chunk_bits

    def step(p, _):
        nxt = next0[jnp.minimum(p, B - 1)]
        # max(p+1, .) forces progress on corrupt tables so chunk_bits steps
        # always cross the boundary (wrong walks are caught by `ok`)
        pn = jnp.where(p >= bounds, p, jnp.maximum(nxt, p + 1))
        return pn, p

    def walk(entries):
        return jax.lax.scan(step, entries, None, length=chunk_bits, unroll=unroll)

    e = starts
    for _ in range(rounds - 1):
        exits, _ = walk(e)
        e = jnp.concatenate([jnp.zeros(1, jnp.int32), exits[:-1]])
    exits, W = walk(e)
    e2 = jnp.concatenate([jnp.zeros(1, jnp.int32), exits[:-1]])
    live = starts < wbits
    ok = jnp.all((e2 == e) | ~live)
    mask = (W < bounds[None, :]) & (W < wbits)
    visited = (
        jnp.zeros(B, jnp.bool_)
        .at[jnp.where(mask, W, B).reshape(-1)]
        .set(True, mode="drop")
    )
    return visited, ok


# ---------------------------------------------------------------------------
# Phase 2: chain -> per-pixel (mode, params, run, position)
# ---------------------------------------------------------------------------


def assemble_chain(
    visited, words, af, present, ib, sorted_flat, pfx_sorted,
    n_pixels: int, np_cap: int, wbits: int,
):
    """Compact the chain mask into ordered pixel records (ref
    code.rs:573-684's loop, flattened).

    The state-0 chain nodes are exactly the mode prefixes and run digits in
    serial order; payload symbols are re-derived per pixel with 4 chained
    flat gathers.  Returns the pix dict for expand_positions.  Garbage
    nodes decoded from the flush tail (SURVEY A.6) land past position N and
    are dropped; the final run is clamped to the raster end (the
    reference's A.8.8 over-copy, defined cleanly)."""
    N, NP = n_pixels, np_cap
    B = visited.shape[0]
    p = jnp.arange(B, dtype=jnp.int32)
    vt = visited & (p < wbits)
    rank = jnp.cumsum(vt.astype(jnp.int32)) - 1
    n0 = rank[-1] + 1
    seqp = jnp.full(NP, -1, jnp.int32).at[jnp.where(vt, rank, NP)].set(p, mode="drop")

    live = seqp >= 0
    pos0 = jnp.where(live, seqp, 0)
    # prefix symbol decoded from the bit window (avoids a big-table gather)
    sp = C.SC_PREFIXES
    win0 = _window_at(words, pos0)
    L0 = _length_one_stream(win0, af[sp], present[sp])
    idx0 = _sym_index(win0, L0, af[sp], present[sp], ib[sp])
    sym0 = pfx_sorted[jnp.clip(idx0, 0, pfx_sorted.shape[0] - 1)]
    is_pfx = live & (sym0 < C.PREFIX_RUN_BASE)
    is_digit = live & (sym0 >= C.PREFIX_RUN_BASE)
    m = jnp.where(is_pfx, sym0, 0)

    # payload symbols: hop through the slots, decoding each codeword from its
    # bit window (ref hfe.rs:206-222, vectorized).  Everything stays in
    # predicated select loops over the tiny (10, 32) canonical tables —
    # big-table gathers are ~100x slower than VPU selects on this backend.
    params = jnp.zeros((NP, 4), jnp.int32)
    q = pos0 + L0
    for k in range(C.MODE_PAYLOAD_SLOTS):
        qc = jnp.minimum(q, B - 1)
        s_arr = jnp.full(NP, -1, jnp.int32)
        for mode in range(5):
            if SLOT_STREAM[mode][k] >= 0:
                s_arr = jnp.where(m == mode, SLOT_STREAM[mode][k], s_arr)
        has = is_pfx & (s_arr >= 0)
        s_idx = jnp.maximum(s_arr, 0)
        win = _window_at(words, qc)
        # L, canonical idx via per-length selects (af/present/ib columns are
        # (10,) vectors; indexing them by s_idx is a small-table gather)
        L = jnp.zeros(NP, jnp.int32)
        for l in range(1, 32):
            L = jnp.where(present[:, l][s_idx] & (win >= af[:, l][s_idx]), l, L)
        idx = jnp.zeros(NP, jnp.int32)
        for l in range(1, 32):
            v = ib[:, l][s_idx] + ((win - af[:, l][s_idx]) >> jnp.uint32(32 - l)).astype(jnp.int32)
            idx = jnp.where((L == l) & present[:, l][s_idx], v, idx)
        symk = sorted_flat[s_idx, jnp.clip(idx, 0, sorted_flat.shape[1] - 1)]
        params = params.at[:, k].set(jnp.where(has, symk, 0))
        q = q + jnp.where(has, L, 0)

    # run digits: ordinal = distance from the owning prefix in the chain
    ar = jnp.arange(NP, dtype=jnp.int32)
    pid = jnp.cumsum(is_pfx.astype(jnp.int32)) - 1
    last_pfx = jax.lax.cummax(jnp.where(is_pfx, ar, -1))
    kk = ar - last_pfx - 1
    # Digit clamps: real streams never exceed MAX_RUN_DIGITS digits and the
    # 11th digit (shift 30) is 0/1 for any int32 run value; garbage tail
    # digits would overflow the shift, so clamp/drop them — the coverage
    # clamp below (and the ok check) makes garbage inflation harmless.
    dig_ok = is_digit & (pid >= 0) & (kk >= 0) & (kk < C.MAX_RUN_DIGITS)
    kcl = jnp.clip(kk, 0, C.MAX_RUN_DIGITS - 1)
    dv = sym0 - C.PREFIX_RUN_BASE
    dv = jnp.where(kcl == C.MAX_RUN_DIGITS - 1, jnp.minimum(dv, 1), dv)
    v = (
        jnp.zeros(NP, jnp.int32)
        .at[jnp.where(dig_ok, pid, NP)]
        .add(jnp.where(dig_ok, dv << (3 * kcl), 0), mode="drop")
    )
    ndig = (
        jnp.zeros(NP, jnp.int32)
        .at[jnp.where(is_digit & (pid >= 0), pid, NP)]
        .add(1, mode="drop")
    )

    # compact pixel records (pid-indexed)
    dst = jnp.where(is_pfx, pid, NP)
    mode_arr = jnp.zeros(NP, jnp.int32).at[dst].set(m, mode="drop")
    params_arr = jnp.zeros((NP, 4), jnp.int32).at[dst].set(params, mode="drop")

    n_pix = jnp.sum(is_pfx.astype(jnp.int32))
    pix_valid = ar < n_pix
    coverage = jnp.where(pix_valid, 1 + jnp.where(ndig > 0, v + 1, 0), 0)
    start = jnp.cumsum(coverage) - coverage
    real = pix_valid & (start < N)
    coverage = jnp.where(real, jnp.minimum(coverage, N - start), 0)
    ok = (coverage.sum() == N) & (n0 <= NP)
    return {
        "mode": mode_arr,
        "params": params_arr,
        "start": start,
        "coverage": coverage,
        "real": real,
        "ok": ok,
    }


# ---------------------------------------------------------------------------
# Phase 3: per-position transfer forms (ref code.rs:576-651, vectorized)
# ---------------------------------------------------------------------------


def expand_positions(pix: dict, n_pixels: int, width: int):
    """Per-position (form (N,), delta (3, N) planar, refoff (N,)) arrays for
    the value chain.

    Run-covered positions copy the predecessor (ADD1 delta 0 — the default);
    encoded pixels scatter their mode's transfer at their start position:
      CONST: out_c = (gather(pos - refoff)_c + delta_c) & 255   [refoff >= 4
             always lands in earlier rows or the same-row wrap; refoff 0 => 0]
      ADDk : out_c = (chain_c[-k] + delta_c) & 255   [flat lags 1..3 ride the
             chain; row wrap is natural — the chain runs in raster order]
      HALF : out_c = (((above_c + chain_c[-1]) >> 1) + delta_c) & 255
    """
    N, W = n_pixels, width
    mode, params, start, real = pix["mode"], pix["params"], pix["start"], pix["real"]
    p1, p2, p3, p4 = params[:, 0], params[:, 1], params[:, 2], params[:, 3]

    is_br = mode == C.PREFIX_BACK_REF
    is_rgb = mode == C.PREFIX_RGB
    is_lu = mode == C.PREFIX_COLOR_LUMA
    is_sd = mode == C.PREFIX_SMALL_DIFF
    is_l2 = mode == C.PREFIX_COLOR_LUMA2
    row0 = start < W
    pos0 = start == 0

    br_off = _sel(p1, C.back_ref_offsets(W))
    lu_off = _sel(p1, C.luma_ref_offsets(W))
    ref = jnp.where(is_br, br_off, jnp.where(is_lu, lu_off, 0))
    lagk = jnp.where((ref >= 1) & (ref <= 3), ref, 0)

    form = jnp.full(mode.shape, F_ADD1, jnp.int32)
    form = jnp.where(is_br | is_lu, jnp.where(lagk > 0, F_CONST + lagk, F_CONST), form)
    form = jnp.where(is_sd | is_rgb, jnp.where(row0, F_ADD1, F_HALF), form)
    form = jnp.where(is_l2, F_HALF, form)
    form = jnp.where(is_rgb & pos0, F_CONST, form)
    ref = jnp.where(lagk > 0, 0, ref)

    lg = p2 - 32
    g2 = p1 - 32
    sd_r = p1 % 7
    sd_rem = (p1 - sd_r) // 7
    sd_g = sd_rem % 7
    sd_b = (sd_rem - sd_g) // 7
    dr = jnp.select(
        [is_br, is_lu, is_l2, is_sd], [0, p3 - 16 + lg, p2 - 16 + g2, sd_r - 3],
        default=p1,
    )
    dg = jnp.select(
        [is_br, is_lu, is_l2, is_sd], [0, lg, g2, sd_g - 3], default=p2
    )
    db = jnp.select(
        [is_br, is_lu, is_l2, is_sd], [0, p4 - 16 + lg, p3 - 16 + g2, sd_b - 3],
        default=p3,
    )

    dst = jnp.where(real, start, N)
    form_pos = jnp.full(N, F_ADD1, jnp.int32).at[dst].set(form, mode="drop")
    ref_pos = jnp.zeros(N, jnp.int32).at[dst].set(ref, mode="drop")
    # channel-planar (3, N): three flat scatters, stacked on a LEADING axis
    delta_pos = jnp.stack(
        [
            jnp.zeros(N + 1, jnp.int32).at[dst].set(d, mode="drop")[:N]
            for d in (dr, dg, db)
        ],
        axis=0,
    )
    return form_pos, delta_pos, ref_pos


# ---------------------------------------------------------------------------
# Phase 4: reconstruction
# ---------------------------------------------------------------------------


def _apply_form(f, d, cv, ab, r1, r2, r3):
    """Element-wise transfer application; r1/r2/r3 are chain values at lags
    1..3 (shapes broadcast against f/d/cv/ab)."""
    return jnp.where(
        f == F_CONST,
        cv + d,
        jnp.where(
            f == F_ADD1,
            r1 + d,
            jnp.where(
                f == F_ADD2,
                r2 + d,
                jnp.where(f == F_ADD3, r3 + d, ((ab + r1) >> 1) + d),
            ),
        ),
    ) & 255


def reconstruct_serial(form, delta, refoff, n_pixels: int, width: int):
    """Exact N-step serial chain — the executable spec of the transfer forms
    (cross-tested against reconstruct_rows; use only for small rasters).

    delta is CHANNEL-PLANAR (3, N); returns (3, N).  (All reconstruction
    arrays are planar: each channel is a contiguous (N,) row.)"""
    N, W = n_pixels, width

    def body(out, i):
        prev = [out[:, jnp.maximum(i - k, 0)] for k in (1, 2, 3)]
        above = out[:, jnp.maximum(i - W, 0)]
        cval = jnp.where(refoff[i] > 0, out[:, jnp.maximum(i - refoff[i], 0)], 0)
        val = _apply_form(form[i], delta[:, i], cval, above, prev[0], prev[1], prev[2])
        return out.at[:, i].set(val), None

    out, _ = jax.lax.scan(body, jnp.zeros((3, N), jnp.int32), jnp.arange(N))
    return out


def _const_offsets(width: int) -> list[int]:
    """Distinct CONST ref offsets (lags 1..3 ride the chain instead)."""
    offs = set(C.back_ref_offsets(width)) | set(C.luma_ref_offsets(width))
    return sorted(o for o in offs if o >= 4)


def reconstruct_rows(
    form, delta, refoff, n_pixels: int, width: int, segs: int, prev4=None
):
    """Fast exact reconstruction (module docstring idea 3), gather-free.

    An H-step scan carries the previous 4 rows; per row: segment transfer
    LUTs over 256 candidate boundary values (elementwise build), a one-hot
    S-step boundary resolve, an L-step replay, and a 3-column serial fixup
    for the w-1/w-3 same-row wrap refs (SURVEY A.8.2).  Requires
    width % segs == 0 and segment length >= 4.

    CHANNEL-PLANAR: delta is (3, N) and the result is (3, N); all inner
    arrays keep channels on a leading axis so the (candidates, segment)
    dims ride full (8, 128) vector tiles — the r3 channel-minor layout
    measured 57% of decode time from 3/128-lane tiles alone.

    prev4: optional (3, 4*W) int32 initial carry (the 4 rows preceding this
    block) — lets sharded decode pipeline row blocks across devices."""
    N, W, S = n_pixels, width, segs
    if W % S or W // S < 4:
        raise ValueError(f"segs {S} must divide width {W} with segment length >= 4")
    L = W // S
    H = N // W
    offs = _const_offsets(W)
    cand = jnp.broadcast_to(jnp.arange(256, dtype=jnp.int32)[None, None, :], (3, S, 256))
    u256 = jnp.arange(256, dtype=jnp.int32)

    f_rows = form.reshape(H, W)
    d_rows = jnp.swapaxes(delta.reshape(3, H, W), 0, 1)  # (H, 3, W)
    ro_rows = refoff.reshape(H, W)

    def row_body(prev4, xs):
        f_row, d_row, ro_row = xs  # (W,), (3, W), (W,)
        prev4p = jnp.concatenate([prev4, jnp.zeros((3, 3), jnp.int32)], axis=1)
        ab_row = prev4[:, 3 * W :]
        cv_row = jnp.zeros((3, W), jnp.int32)
        for o in offs:
            cv_row = jnp.where(
                (ro_row == o)[None, :], prev4p[:, 4 * W - o : 5 * W - o], cv_row
            )

        # per-position (L, ...) slices for the inner scans; channel stays a
        # leading broadcast axis, (S,)/(3, S) trailing
        fT = jnp.swapaxes(f_row.reshape(S, L), 0, 1)  # (L, S)
        dT = jnp.transpose(d_row.reshape(3, S, L), (2, 0, 1))  # (L, 3, S)
        cvT = jnp.transpose(cv_row.reshape(3, S, L), (2, 0, 1))
        abT = jnp.transpose(ab_row.reshape(3, S, L), (2, 0, 1))

        # build: push all 256 candidate boundary values through each segment
        def build_step(carry, x):
            r1, r2, r3, t1, t2, t3 = carry  # r* (3, S, 256); t* (S,)
            f, d, cv, ab = x
            new = _apply_form(
                f[None, :, None], d[:, :, None], cv[:, :, None], ab[:, :, None],
                r1, r2, r3,
            )
            nt = jnp.where(f == F_ADD2, t2, jnp.where(f == F_ADD3, t3, t1))
            return (new, r1, r2, nt, t1, t2), None

        # Inner scans are fully unrolled: at W=512/segs=32 the three nested
        # loops would be 64 sequential XLA while-iterations per row, each
        # with its own loop overhead.  Unrolling turns each row body into
        # straight-line code (lengths are static and small).
        (r1, r2, r3, t1, t2, t3), _ = jax.lax.scan(
            build_step,
            (cand, cand, cand,
             jnp.zeros(S, jnp.int32), jnp.ones(S, jnp.int32), jnp.full(S, 2, jnp.int32)),
            (fT, dT, cvT, abT),
            unroll=True,
        )

        # resolve: boundary triples across segments (one-hot LUT application
        # keeps every step gather-free).  trip rows = lag 1..3, cols = ch.
        b0 = jnp.stack([prev4[:, 4 * W - 1], prev4[:, 4 * W - 2], prev4[:, 4 * W - 3]])

        def resolve_step(trip, x):
            r1s, r2s, r3s, t1s, t2s, t3s = x  # r*s (3, 256); t*s scalar

            def ev(lut, tag):
                tv = jnp.where(tag == 0, trip[0], jnp.where(tag == 1, trip[1], trip[2]))
                oh = u256[None, :] == tv[:, None]  # (3, 256)
                return jnp.sum(jnp.where(oh, lut, 0), axis=1)

            new = jnp.stack([ev(r1s, t1s), ev(r2s, t2s), ev(r3s, t3s)])
            return new, trip

        _, trips = jax.lax.scan(
            resolve_step,
            b0,
            (
                jnp.swapaxes(r1, 0, 1), jnp.swapaxes(r2, 0, 1),
                jnp.swapaxes(r3, 0, 1), t1, t2, t3,
            ),
            unroll=True,
        )
        # trips[s] = (3 lags, 3 ch) true boundary values at entry of segment s

        # replay with true inputs; carried values are (3 ch, S)
        def replay_step(carry, x):
            v1, v2, v3 = carry
            f, d, cv, ab = x
            new = _apply_form(f[None, :], d, cv, ab, v1, v2, v3)
            return (new, v1, v2), new

        _, rowv = jax.lax.scan(
            replay_step,
            (
                jnp.swapaxes(trips[:, 0], 0, 1),
                jnp.swapaxes(trips[:, 1], 0, 1),
                jnp.swapaxes(trips[:, 2], 0, 1),
            ),
            (fT, dT, cvT, abT),
            unroll=True,
        )
        row = jnp.transpose(rowv, (1, 2, 0)).reshape(3, W)

        # fixup: w-1/w-3 refs from the last <= 3 columns land in the CURRENT
        # row (cols 0..2); the build above read them stale.  Recompute the
        # last 3 columns serially — their chain deps are unaffected and only
        # the final segment's (unused) exit saw stale values.
        for x in (W - 3, W - 2, W - 1):
            cv = jnp.zeros(3, jnp.int32)
            for o in offs:
                src = row[:, x - o] if x - o >= 0 else prev4[:, 4 * W + x - o]
                cv = jnp.where(ro_row[x] == o, src, cv)
            lag = [
                row[:, x - k] if x - k >= 0 else prev4[:, 4 * W + x - k]
                for k in (1, 2, 3)
            ]
            val = _apply_form(
                f_row[x], d_row[:, x], cv, ab_row[:, x], lag[0], lag[1], lag[2]
            )
            row = row.at[:, x].set(val)

        return jnp.concatenate([prev4[:, W:], row], axis=1), row

    init = jnp.zeros((3, 4 * W), jnp.int32) if prev4 is None else prev4
    tail, rows = jax.lax.scan(
        row_body, init, (f_rows, d_rows, ro_rows), unroll=2
    )
    out = jnp.swapaxes(rows, 0, 1).reshape(3, N)
    if prev4 is None:
        return out
    return out, tail


# ---------------------------------------------------------------------------
# Orchestration: full device decode + host wrapper
# ---------------------------------------------------------------------------


def _decode_core(
    words,
    wbits,
    af,
    present,
    ib,
    sorted_flat,
    pfx_sorted,
    *,
    n_pixels: int,
    width: int,
    np_cap: int,
    levels: int,
    segs: int,
    serial_recon: bool = False,
    chain: str = "spec",
):
    """End-to-end on-device decode of one payload.  Returns (out u8 (N,3), ok).

    chain: "spec" (speculative chunked walk, default) or "doubling" (exact
    pointer doubling, ~5x more gathered volume).  ok gates correctness: the
    assembled pixel coverage must tile the raster exactly, the chain must
    fit np_cap, and (spec mode) every chunk walk must verify against its
    anchored entry.  The host wrapper falls back to the serial decoder when
    ok is False (corrupt/non-canonical streams, or a self-sync miss)."""
    nexta, nextb = build_next_tables(words, af, present, ib, pfx_sorted)
    next0 = pixel_jump(nexta, nextb)
    if chain == "spec":
        visited, ok_walk = spec_chain_mask(next0, wbits)
    else:
        visited = chain_mask(next0, levels)
        ok_walk = jnp.bool_(True)
    pix = assemble_chain(
        visited, words, af, present, ib, sorted_flat, pfx_sorted,
        n_pixels, np_cap, wbits,
    )
    form, delta, refoff = expand_positions(pix, n_pixels, width)
    if serial_recon:
        out = reconstruct_serial(form, delta, refoff, n_pixels, width)
    else:
        out = reconstruct_rows(form, delta, refoff, n_pixels, width, segs)
    return out.astype(jnp.uint8), pix["ok"] & ok_walk


_STATIC = ("n_pixels", "width", "np_cap", "levels", "segs", "serial_recon", "chain")
_device_decode = partial(jax.jit, static_argnames=_STATIC)(_decode_core)


@partial(jax.jit, static_argnames=_STATIC)
def _device_decode_batch(words, wbits, af, present, ib, sorted_flat, pfx_sorted, **kw):
    """vmapped decode of a same-shape batch: words (B, Bw), wbits (B,),
    tables stacked with a leading batch axis."""
    return jax.vmap(
        lambda w, b, a, p, i, s, f: _decode_core(w, b, a, p, i, s, f, **kw)
    )(words, wbits, af, present, ib, sorted_flat, pfx_sorted)


def _pick_segs(width: int) -> int:
    """Divisor of width balancing build (2L) vs resolve (S) scan steps."""
    best, best_cost = 1, float("inf")
    for s in range(1, width + 1):
        if width % s == 0 and width // s >= 4:
            cost = 2 * (width // s) + s
            if cost < best_cost:
                best, best_cost = s, cost
    return best


def prepare_tables(flat_lengths: np.ndarray):
    """Device decode tables from the parsed (858,) code lengths."""
    from nicetpu.format import huffman

    af, present, ib, sorted_flat = huffman.decode_dev_tables(flat_lengths)
    sp = C.SC_PREFIXES
    base, size = C.STREAM_BASE[sp], C.ALPHABET_SIZES[sp]
    lengths = np.asarray(flat_lengths[base : base + size], dtype=np.int64)
    order = np.lexsort((np.arange(size), lengths))  # canonical idx -> symbol
    return af, present, ib, sorted_flat.astype(np.int32), order.astype(np.int32)


def decode_jax(data: bytes, *, serial_recon: bool = False, chain: str = "spec") -> np.ndarray:
    """Device `.nice` decode (v2): bytes -> (H, W, 3) uint8.

    Parallel counterpart of ref code.rs:573-684 / hfe.rs:206-222 /
    bitreader.rs:78-100 (see module docstring).  Falls back to the host
    decoder when the device pipeline flags a non-canonical stream."""
    from nicetpu.format import headers

    W, H, channels = headers.parse_file_header(data)
    if channels != 3:
        raise ValueError("only channels=3 decode is defined (SURVEY A.8.3)")
    if W < C.MIN_WIDTH:
        raise ValueError(f"width must be >= {C.MIN_WIDTH}")
    N = W * H
    flat_lengths = headers.parse_stream_headers(data[C.FILE_HEADER_BYTES :])
    from nicetpu.format import huffman

    huffman.validate_flat_lengths(flat_lengths)  # clean reject, no raw errors
    tabs = prepare_tables(flat_lengths)

    payload = data[C.FILE_HEADER_BYTES + C.STREAM_HEADERS_BYTES : len(data) - 4]
    wbits = len(payload) * 8
    # Bucket the word-array length so payload-size jitter between images of
    # one shape reuses the same executable (wbits itself is a traced scalar).
    n_words = len(payload) // 4 + 3
    bucket = max(1024, -(-n_words // 16384) * 16384)  # 64 KiB granularity
    src = np.frombuffer(payload + b"\0" * ((-len(payload)) % 4), dtype=">u4")
    words = np.zeros(bucket, dtype=">u4")
    words[: src.shape[0]] = src

    np_cap = N + 80
    levels = max(1, int(np.ceil(np.log2(np_cap))) + 1)
    segs = _pick_segs(W)

    out, ok = _device_decode(
        jnp.asarray(words.astype(np.uint32)),
        jnp.int32(wbits),
        *(jnp.asarray(t) for t in tabs),
        n_pixels=N,
        width=W,
        np_cap=np_cap,
        levels=levels,
        segs=segs,
        serial_recon=serial_recon,
        chain=chain,
    )
    if not bool(ok):
        from nicetpu.spec import codec

        return codec.decode(data)
    # device output is channel-planar (3, N); untangle on host
    return np.asarray(out).reshape(3, H, W).transpose(1, 2, 0)


def decode_batch_jax(
    datas: list[bytes], *, serial_recon: bool = False, chain: str = "spec"
) -> list[np.ndarray]:
    """Batched device v2 decode of same-shape `.nice` streams (one vmapped
    dispatch; per-image Huffman tables).  Decode throughput on device comes
    from batching — the per-bit table build, chain doubling, and row scans
    all vectorize across images.  Falls back per image on corrupt streams."""
    from nicetpu.format import headers, huffman

    if not datas:
        return []
    shapes = {headers.parse_file_header(d)[:2] for d in datas}
    if len(shapes) != 1:
        raise ValueError("decode_batch_jax requires same-shape streams")
    W, H = next(iter(shapes))
    if W < C.MIN_WIDTH:
        raise ValueError(f"width must be >= {C.MIN_WIDTH}")
    N = W * H

    tabs = []
    payloads = []
    for d in datas:
        if headers.parse_file_header(d)[2] != 3:
            raise ValueError("only channels=3 decode is defined (SURVEY A.8.3)")
        flat_lengths = headers.parse_stream_headers(d[C.FILE_HEADER_BYTES :])
        huffman.validate_flat_lengths(flat_lengths)
        tabs.append(prepare_tables(flat_lengths))
        payloads.append(d[C.FILE_HEADER_BYTES + C.STREAM_HEADERS_BYTES : len(d) - 4])

    n_words = max(len(p) for p in payloads) // 4 + 3
    bucket = max(1024, -(-n_words // 16384) * 16384)
    words = np.zeros((len(datas), bucket), dtype=np.uint32)
    wbits = np.zeros(len(datas), dtype=np.int32)
    for i, p in enumerate(payloads):
        src = np.frombuffer(p + b"\0" * ((-len(p)) % 4), dtype=">u4")
        words[i, : src.shape[0]] = src
        wbits[i] = len(p) * 8

    np_cap = N + 80
    out, ok = _device_decode_batch(
        jnp.asarray(words),
        jnp.asarray(wbits),
        *(jnp.asarray(np.stack([t[j] for t in tabs])) for j in range(5)),
        n_pixels=N,
        width=W,
        np_cap=np_cap,
        levels=max(1, int(np.ceil(np.log2(np_cap))) + 1),
        segs=_pick_segs(W),
        serial_recon=serial_recon,
        chain=chain,
    )
    ok_np = np.asarray(ok)
    out_np = np.asarray(out)
    result = []
    for i, d in enumerate(datas):
        if bool(ok_np[i]):
            result.append(out_np[i].reshape(3, H, W).transpose(1, 2, 0))
        else:
            from nicetpu.spec import codec

            result.append(codec.decode(d))
    return result
