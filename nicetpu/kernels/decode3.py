"""Device `.nice` decode v3: speculative chunk walk + slot-space assembly.

Parallel reformulation of the reference's strictly serial decoder (ref
code.rs:573-684 reconstruction, hfe.rs:206-222 symbol decode,
bitreader.rs:78-100 bit peek):

1. **Chunked speculative walk.**  The payload is cut into chunk_bits-bit
   chunks; each chunk is walked serially group by group (prefix -> payload
   slots -> next group, ref code.rs:576-651) from a speculative entry.
   Canonical lengths/indices come from threshold compares against the
   per-image first-code tables (ref hfe.rs:206-222 vectorized).  On a GPU
   the walk is one kernel (`walk_gpu`: one thread per chunk, the whole step
   loop inside the kernel, direct word loads); elsewhere it is the plain
   `lax.scan` reference `walk_ref`, which is also the kernel's test oracle.
   Chunk entries are speculative (self-synchronizing Huffman, the gap-array
   technique of the GPU Huffman decoders in PAPERS.md): round 1 walks from
   chunk starts, round 2 re-walks from round-1 exits anchored at bit 0; if
   round-2 exits reproduce their entries, induction from the anchor proves
   every entry true.  Any inconsistency (corrupt stream, self-sync miss,
   step budget exhausted) clears `ok` and the caller falls back to the host
   decoder — correctness never rests on the heuristic.

2. **Slot-space assembly** (pure element-wise + cumsums): the walk's
   records (chunk-major, step-major = serial token order) yield run values
   via digit-ordinal arithmetic and pixel start positions via ONE cumsum of
   per-slot coverage — no compaction pass, no visited bitmask.

3. **Symbol join**: canonical index -> symbol through the per-image
   (length asc, symbol asc) order tables (one gather per slot).

4. **One packed-int32 placement scatter** per slot (form + ref-index +
   3 delta bytes in 31 bits), then the segment-LUT row reconstruction
   (`decode_dev.reconstruct_rows`).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from nicetpu import device
from nicetpu.format import constants as C
from nicetpu.kernels.decode_dev import (
    F_ADD1,
    F_CONST,
    F_HALF,
    SLOT_STREAM,
    _const_offsets,
    _sel,
    reconstruct_rows,
    reconstruct_serial,
)

# ---------------------------------------------------------------------------
# Walk geometry
# ---------------------------------------------------------------------------


class WalkCfg(NamedTuple):
    """One walk configuration (a retry-ladder rung); static under jit.

    chunk_bits: payload bits per speculative chunk — a self-synchronization
      safety margin (near-fixed-length streams realign slowly; failures are
      caught by the consistency gate, so small chunks buy parallel width,
      not wrongness).
    steps_div: step budget divisor (budget = chunk_bits / steps_div; a
      chunk with mean group size < steps_div bits exhausts it and fails
      the crossing gate -> next rung).
    rounds: speculative walk rounds (entry truth propagates >= 1 chunk per
      round past a self-sync miss).
    """

    chunk_bits: int
    steps_div: int
    rounds: int


# Retry ladder: fast config first (2048-bit chunks), then the robust config
# (big self-sync margin, deep step budget).  Images still failing fall back
# to the host decoder.
LADDER = (WalkCfg(2048, 8, 2), WalkCfg(4096, 3, 3))
CHUNK_BITS = LADDER[0].chunk_bits  # default chunk size
STEPS_DIV = LADDER[1].steps_div  # robust step divisor
MAX_GROUP_BITS = 5 * C.MAX_CODE_LEN  # prefix + <= 4 payload codes
# Zero words kept past the last chunk: a group starting just before a
# chunk's end reads up to MAX_GROUP_BITS + a 32-bit window past it.
LOOKAHEAD_WORDS = 8
# Per-stream BASE length bound T (static): codes of length <= T decode in
# the always-on unrolled loop; deeper codes (rare by construction — Kraft
# mass of lengths > 14 is < 2^-14 per symbol) take the `_canon_ext`
# escape, entered only when a lane of the current mode actually peeks past
# the T+1 threshold.  Exact for ALL depths, one executable for all content.
MAXL_BASE = 14
# Streams with tiny alphabets have provably short codes: lengths < alphabet.
MAXL_SMALL = 12  # covers SC_PREFIXES (13), SC_LUMA_BACK_REF / SC_BACK_REF (11)
_SMALL_STREAMS = frozenset(
    s for s in range(C.NUM_STREAMS) if C.ALPHABET_SIZES[s] <= MAXL_SMALL + 1
)

_MSB = -0x80000000  # int32 sign bit (Python int: safe to close over in kernels)
_I32_MAX = 0x7FFFFFFF


def _steps(chunk_bits: int, steps_div: int = STEPS_DIV) -> int:
    return -(-chunk_bits // steps_div)


def _any(x):
    """jnp.any as an int32 max: the GPU kernel's lowering has no boolean
    reduction."""
    return jnp.max(x.astype(jnp.int32)) > 0


# Static per-stream BASE maxl of every decode program.  The walk's
# `_canon_decode` unrolls one threshold compare per candidate length up to
# the bound; deeper codes are exact via the `_canon_ext` escape, so the
# bound need not cover a table's max length, and one uniform tuple gives
# one executable for all content (small alphabets are clipped by
# `_stream_maxl`).
WALK_MAXL = (MAXL_BASE,) * C.NUM_STREAMS


# ---------------------------------------------------------------------------
# Shared group-decode math (used by the plain reference AND the GPU kernel;
# only the word and table reads differ).  All windows are uint32 carried as
# int32.
# ---------------------------------------------------------------------------


def _stream_maxl(s: int, maxl) -> int:
    """Per-stream BASE length bound; maxl is an int (uniform) or a 10-tuple."""
    m = maxl[s] if isinstance(maxl, tuple) else maxl
    return min(m, MAXL_SMALL) if s in _SMALL_STREAMS else m


def _deep_cap(s: int) -> int:
    """Deepest possible code length for stream s (Huffman depth <= n-1;
    the encoder's clamp bounds everything at MAX_CODE_LEN)."""
    return min(C.MAX_CODE_LEN, C.ALPHABET_SIZES[s] - 1)


def derive_walk_tables(af, present, ib):
    """(B, 10, 32) af/present/ib decode tables -> the walk's 3-op-per-length
    threshold tables (aff, dD, inc), each (B, 10, 32) int32.

    The canonical decode "L = max{l : present[l] and af[l] <= win}" needs 3
    predicated selects per length to track af[L]/ib[L] alongside.  Because
    left-aligned first codes INCREASE over present lengths, the predicate
    [l <= L] can be made monotone over ALL lengths by suffix-filling:

      aff[l] = biased af of the first present length >= l
               (INT32_MAX where none — see `inc` for why that is safe)
      hit_l  = (win ^ MSB) >= aff[l]   <=>   l <= L        (1 op)
      L      = sum_l hit_l * inc[l]                        (2 ops)
      idx    = sum_l hit_l * dD[l] + (win >>> (32 - L))    (2 ops + tail)

    where dD[l] telescopes D[l] = ib[l'] - first_code_value[l'] for the
    last present l' <= l (so sum_{l<=L} dD[l] = D[L] = ib[L] - fc[L], and
    idx = D[L] + (win >> (32-L)) = ib[L] + (win - af[L]) >> (32-L); int32
    wraparound in the partial sums is exact mod-2^32 arithmetic).  dD is 0
    at absent lengths.  inc[l] = 1 for l <= max present length else 0 — it
    kills the one unrepresentable case: an all-ones window equals the
    INT32_MAX sentinel of absent-beyond-max columns, which would otherwise
    inflate L (dD there is already 0)."""
    af_b = af ^ _MSB
    big = jnp.int32(_I32_MAX)
    pres = present != 0
    af_bp = jnp.where(pres, af_b, big)
    aff = jnp.flip(jax.lax.cummin(jnp.flip(af_bp, -1), axis=af_bp.ndim - 1), -1)
    l_idx = jnp.arange(32, dtype=jnp.int32)
    fc = jax.lax.shift_right_logical(
        af, jnp.broadcast_to((32 - l_idx) & 31, af.shape)
    )
    D_at = jnp.where(pres, ib - fc, 0)
    cols = []
    cur = jnp.zeros_like(D_at[..., 0])
    maxlen = jnp.zeros_like(cur)
    for l in range(32):
        cur = jnp.where(pres[..., l], D_at[..., l], cur)
        maxlen = jnp.where(pres[..., l], l, maxlen)
        cols.append(cur)
    D_ff = jnp.stack(cols, axis=-1)
    dD = D_ff - jnp.concatenate(
        [jnp.zeros_like(D_ff[..., :1]), D_ff[..., :-1]], axis=-1
    )
    inc = (l_idx <= maxlen[..., None]).astype(jnp.int32)
    return aff, dD, inc


def _canon_sum(win_b, s, tget, lo: int, hi: int, L, acc):
    """Accumulate hits over lengths lo..hi (3 predicated ops per length)."""
    for l in range(lo, hi + 1):
        hit = win_b >= tget("aff", s, l)
        L = L + jnp.where(hit, tget("inc", s, l), 0)
        acc = acc + jnp.where(hit, tget("dD", s, l), 0)
    return L, acc


def _canon_decode(win, s, tget, maxl, mode_mask=None):
    """(L, idx) of the canonical codeword at a window for stream s.

    Monotone threshold-count decode over the derive_walk_tables layout,
    exact for ANY code depth: lengths 1..T (T = the static per-stream base
    bound) decode in the always-on unrolled loop; the rare deeper codes
    (Kraft mass < 2^-T per window) extend the sums under a lax.cond entered
    only when some lane's window actually peeks past the T+1 threshold.

    mode_mask (optional bool array): lanes whose decoded group actually
    uses stream s.  Gates BOTH the whole stream decode (skipped when no
    lane of this block is in a matching mode — on photo content most steps
    visit 2-3 of the 10 streams) and the deep-escape trigger (an ungated
    trigger would fire on other modes' random window bits ~ every block).
    Lanes outside the mask get garbage (L, idx); callers must blend them
    away (they do — by the same mask)."""
    win_b = win ^ _MSB
    T = _stream_maxl(s, maxl)
    cap = _deep_cap(s)
    zero = jnp.zeros_like(win)

    def full(_):
        L, acc = _canon_sum(win_b, s, tget, 1, T, zero, zero)
        if T < cap:
            probe = win_b >= tget("aff", s, T + 1)
            if mode_mask is not None:
                probe = probe & mode_mask
            L, acc = jax.lax.cond(
                _any(probe),
                lambda la: _canon_sum(win_b, s, tget, T + 1, cap, *la),
                lambda la: la,
                (L, acc),
            )
        return L, acc

    if mode_mask is None:
        L, acc = full(None)
    else:
        L, acc = jax.lax.cond(_any(mode_mask), full, lambda _: (zero, zero), None)
    idx = acc + jax.lax.shift_right_logical(win, 32 - jnp.maximum(L, 1))
    return L, idx


def _decode_group(p, win_at, tget, pfx_get, maxl):
    """One pixel-group decode at bit position p (ref code.rs:576-651 +
    hfe.rs:206-222, vectorized over lanes).

    win_at(q) -> int32 window (bits q..q+31, MSB-first, uint32 as int32);
    tget(table, s, l) -> scalar table value for stream s, length l
      (table in {"aff", "dD", "inc"} — derive_walk_tables layout);
    pfx_get(j) -> prefix-stream canonical-order symbol j.

    Returns (sym, idx1..idx4, q_next).  For run digits (sym >= 5) the
    payload indices are 0 and q_next = p + prefix length.  Payload slots
    decode per STREAM, gated by whether any lane's decoded mode uses that
    stream (`_canon_decode` mode_mask), then select by mode."""
    sp = C.SC_PREFIXES
    win0 = win_at(p)
    L0, idx0 = _canon_decode(win0, sp, tget, maxl)
    sym = jnp.zeros_like(idx0)
    for j in range(C.ALPHABET_SIZES[sp]):
        sym = jnp.where(idx0 == j, pfx_get(j), sym)

    q = p + L0
    idxs = []
    for k in range(C.MODE_PAYLOAD_SLOTS):
        modes = [m for m in range(5) if SLOT_STREAM[m][k] >= 0]
        streams = sorted({SLOT_STREAM[m][k] for m in modes})
        win = win_at(q)
        per_stream = {}
        for s in streams:
            masks = [sym == m for m in modes if SLOT_STREAM[m][k] == s]
            mmask = masks[0]
            for mk in masks[1:]:
                mmask = mmask | mk
            per_stream[s] = _canon_decode(win, s, tget, maxl, mode_mask=mmask)
        Lk = jnp.zeros_like(sym)
        idxk = jnp.zeros_like(sym)
        has = jnp.zeros_like(sym, dtype=jnp.bool_)
        for m in modes:
            Ls, idxs_s = per_stream[SLOT_STREAM[m][k]]
            is_m = sym == m
            Lk = jnp.where(is_m, Ls, Lk)
            idxk = jnp.where(is_m, idxs_s, idxk)
            has = has | is_m
        idxs.append(jnp.where(has, idxk, 0))
        q = q + jnp.where(has, Lk, 0)
    return sym, idxs, q


# ---------------------------------------------------------------------------
# The walk: plain reference and GPU kernel
# ---------------------------------------------------------------------------


def _window(w0, w1, sh):
    """32-bit window starting `sh` bits into word w0 (w1 follows it)."""
    lo = jnp.where(sh == 0, 0, jax.lax.shift_right_logical(w1, (32 - sh) & 31))
    return (w0 << sh) | lo


def walk_ref(
    words, entries, aff, dD, inc, pfx_sorted, wbits,
    *, chunk_bits, steps, maxl, chunk0=0,
):
    """Chunked walk of one image as a `lax.scan`.  words (Wn,) uint32 or
    int32; entries (nch,) int32 absolute bit positions; aff/dD/inc the
    (10, 32) derive_walk_tables threshold tables; pfx_sorted (16,).
    Returns (pos, sym, idx12, idx34) each (nch, steps) int32 (pos = -1
    where frozen/dead) and exits (nch,).

    chunk0: for shard-local word slices — the walk handles chunks
    [chunk0, chunk0 + nch) and `words` starts at absolute bit
    chunk0 * chunk_bits (positions stay global)."""
    nch = entries.shape[0]
    wi = words.astype(jnp.int32)
    wn = wi.shape[0]
    bit_base = chunk0 * chunk_bits
    bound = (chunk0 + jnp.arange(nch, dtype=jnp.int32) + 1) * chunk_bits

    def win_at(q):
        rel = q - bit_base
        w = rel >> 5
        w0 = wi[jnp.clip(w, 0, wn - 1)]
        w1 = wi[jnp.clip(w + 1, 0, wn - 1)]
        return _window(w0, w1, rel & 31)

    def tget(table, s, l):
        return {"aff": aff, "dD": dD, "inc": inc}[table][s, l]

    def pfx_get(j):
        return pfx_sorted[j]

    def step(p, _):
        alive = (p < bound) & (p < wbits)
        sym, idxs, q = _decode_group(p, win_at, tget, pfx_get, maxl)
        p_new = jnp.where(alive, jnp.maximum(p + 1, q), p)
        rec_pos = jnp.where(alive, p, -1)
        rec_sym = jnp.where(alive, sym, 0)
        i12 = jnp.where(alive, idxs[0] | (idxs[1] << 16), 0)
        i34 = jnp.where(alive, idxs[2] | (idxs[3] << 16), 0)
        return p_new, (rec_pos, rec_sym, i12, i34)

    exits, (pos, sym, i12, i34) = jax.lax.scan(step, entries, None, length=steps)
    return (
        jnp.swapaxes(pos, 0, 1),
        jnp.swapaxes(sym, 0, 1),
        jnp.swapaxes(i12, 0, 1),
        jnp.swapaxes(i34, 0, 1),
        exits,
    )


# GPU walk geometry: one thread walks one chunk; a program owns
# WALK_CHUNKS chunks (one per thread at WALK_WARPS warps of 32).
WALK_CHUNKS = 128
WALK_WARPS = 4


def _walk_kernel(
    wbits_ref,  # (B,) int32 payload bits per image
    chunk0_ref,  # (B,) int32 global index of each image's first local chunk
    entries_ref,  # (B * nch,) int32
    words_ref,  # (B * wn,) int32 (uint32 words)
    aff_ref,  # (B * 10 * 32,) int32 (derive_walk_tables)
    dD_ref,
    inc_ref,
    pfx_ref,  # (B * 16,) int32
    pos_ref,  # (B * nch * steps,) int32, walk_ref's serial order
    sym_ref,
    i12_ref,
    i34_ref,
    exit_ref,  # (B * nch,) int32
    *,
    nch: int,
    wn: int,
    chunk_bits: int,
    steps: int,
    maxl,
):
    b = pl.program_id(0)
    c = pl.program_id(1) * WALK_CHUNKS + jnp.arange(WALK_CHUNKS, dtype=jnp.int32)
    # The last program's tail lanes hold no chunk: they load a clamped row
    # and store nothing (masked; their distinct out-of-range rows keep the
    # interpret-mode scatter free of duplicate indices).
    live = c < nch
    row = b * nch + c
    wbits = wbits_ref[b]
    chunk0 = chunk0_ref[b]
    bit_base = chunk0 * chunk_bits
    bound = (chunk0 + c + 1) * chunk_bits
    wrow = b * wn
    tables = {"aff": aff_ref, "dD": dD_ref, "inc": inc_ref}

    def win_at(q):
        rel = q - bit_base
        w = rel >> 5
        w0 = plgpu.load(words_ref.at[wrow + jnp.clip(w, 0, wn - 1)])
        w1 = plgpu.load(words_ref.at[wrow + jnp.clip(w + 1, 0, wn - 1)])
        return _window(w0, w1, rel & 31)

    def tget(table, s, l):
        return tables[table][(b * C.NUM_STREAMS + s) * 32 + l]

    def pfx_get(j):
        return pfx_ref[b * 16 + j]

    def decode(p):
        sym, idxs, q = _decode_group(p, win_at, tget, pfx_get, maxl)
        return sym, idxs[0] | (idxs[1] << 16), idxs[2] | (idxs[3] << 16), q

    def frozen(p):
        zero = jnp.zeros_like(p)
        return zero, zero, zero, p

    def step(i, p):
        alive = (p < bound) & (p < wbits)
        # once every chunk of this program is frozen, skip the decode
        sym, i12, i34, q = jax.lax.cond(_any(alive), decode, frozen, p)
        out = row * steps + i
        plgpu.store(pos_ref.at[out], jnp.where(alive, p, -1), mask=live)
        plgpu.store(sym_ref.at[out], jnp.where(alive, sym, 0), mask=live)
        plgpu.store(i12_ref.at[out], jnp.where(alive, i12, 0), mask=live)
        plgpu.store(i34_ref.at[out], jnp.where(alive, i34, 0), mask=live)
        return jnp.where(alive, jnp.maximum(p + 1, q), p)

    entry = plgpu.load(entries_ref.at[b * nch + jnp.minimum(c, nch - 1)])
    p0 = jnp.where(live, entry, bound)
    p = jax.lax.fori_loop(0, steps, step, p0)
    plgpu.store(exit_ref.at[row], p, mask=live)


def walk_gpu(
    words, entries, aff, dD, inc, pfx, wbits, chunk0,
    *, chunk_bits, steps, maxl, interpret: bool = False,
):
    """Batched chunk walk as one GPU kernel (Pallas, Triton route).

    words (B, Wn) int32; entries (B, nch) int32; aff/dD/inc (B, 10, 32)
    int32; pfx (B, 16) int32; wbits, chunk0 (B,) int32.  Returns pos, sym,
    i12, i34 (B, nch, steps) and exits (B, nch) — exactly `walk_ref`'s
    results per image.  interpret=True runs the kernel on the CPU (tests)."""
    B, nch = entries.shape
    wn = words.shape[1]
    kern = partial(
        _walk_kernel, nch=nch, wn=wn, chunk_bits=chunk_bits, steps=steps, maxl=maxl
    )
    rec = jax.ShapeDtypeStruct((B * nch * steps,), jnp.int32)
    flat = lambda x: x.astype(jnp.int32).reshape(-1)
    pos, sym, i12, i34, exits = pl.pallas_call(
        kern,
        grid=(B, pl.cdiv(nch, WALK_CHUNKS)),
        out_shape=(rec, rec, rec, rec, jax.ShapeDtypeStruct((B * nch,), jnp.int32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=WALK_WARPS, num_stages=1),
        interpret=interpret,
        name="walk_gpu",
    )(
        flat(wbits), flat(chunk0), flat(entries), flat(words),
        flat(aff), flat(dD), flat(inc), flat(pfx),
    )
    recs = (r.reshape(B, nch, steps) for r in (pos, sym, i12, i34))
    return (*recs, exits.reshape(B, nch))


def walk_batch(
    words, entries, aff, dD, inc, pfx, wbits, chunk0,
    *, chunk_bits, steps, maxl,
):
    """The walk on this platform (`device.is_gpu`): the GPU kernel, or
    `walk_ref` vmapped over images.  Arguments and results as `walk_gpu`."""
    kw = dict(chunk_bits=chunk_bits, steps=steps, maxl=maxl)
    if device.is_gpu():
        return walk_gpu(words, entries, aff, dD, inc, pfx, wbits, chunk0, **kw)

    def one(wd, e, a, d, ic, pf, wb, c0):
        return walk_ref(wd, e, a, d, ic, pf, wb, chunk0=c0, **kw)

    return jax.vmap(one)(words, entries, aff, dD, inc, pfx, wbits, chunk0)


# ---------------------------------------------------------------------------
# Assembly: walk records -> packed placement records (all element-wise)
# ---------------------------------------------------------------------------

REC_DEFAULT = F_ADD1  # form=ADD1, ref 0, deltas 0: the run-covered transfer


def _ref_index_table(width: int):
    """Static maps: payload symbol -> (lag 1..3 | 0) and (ref-index | 0)."""
    offs = _const_offsets(width)
    br = C.back_ref_offsets(width)
    lu = C.luma_ref_offsets(width)

    def split(tbl):
        lag, refi = [], []
        for o in tbl:
            if 1 <= o <= 3:
                lag.append(o)
                refi.append(0)
            else:
                lag.append(0)
                refi.append(offs.index(o) + 1)
        return tuple(lag), tuple(refi)

    return split(br), split(lu), offs


def assemble_v3(pos, sym, p1, p2, p3, p4, n_pixels: int, width: int, wbits):
    """Slot records -> (rec int32, dst, (ok_cov, ok_ref) (B,) gate flags).

    pos/sym/p1..p4 (payload SYMBOLS, post-join): (B, S) arrays in serial
    slot order.  Implements the decoder state machine of ref code.rs:573-684 in slot
    space: run values via digit ordinals (ref code.rs:661-680), pixel
    starts via one coverage cumsum, transfer forms per mode (ref
    code.rs:576-651).

    Gates: ok_cov — the decoded pixel coverage tiles [0, N) exactly
    (truncated/corrupt streams under-cover); ok_ref — every BACK_REF index
    is < NUM_BACK_REF (stream 9's alphabet has 11 symbols but only 5 are
    placeable; the reference would panic, ref code.rs:634, and the spec
    decoder raises — the device path must reject, not misdecode)."""
    N, W = n_pixels, width
    cumsum = lambda x: jnp.cumsum(x, axis=1)
    cummax = lambda x: jax.lax.cummax(x, axis=1)
    valid = (pos >= 0) & (pos < wbits[:, None])
    is_pfx = valid & (sym < C.PREFIX_RUN_BASE)
    is_dig = valid & (sym >= C.PREFIX_RUN_BASE)

    cd = cumsum(is_dig.astype(jnp.int32))
    cd_base = cummax(jnp.where(is_pfx, cd, -1))
    kk = cd - cd_base - 1
    dig_ok = is_dig & (cd_base >= 0) & (kk >= 0) & (kk < C.MAX_RUN_DIGITS)
    kcl = jnp.clip(kk, 0, C.MAX_RUN_DIGITS - 1)
    dv = sym - C.PREFIX_RUN_BASE
    dv = jnp.where(kcl == C.MAX_RUN_DIGITS - 1, jnp.minimum(dv, 1), dv)
    cov = (
        is_pfx.astype(jnp.int32)
        + jnp.where(dig_ok, (dv << (3 * kcl)) + (kk == 0), 0)
    )
    # Clamp per-slot coverage to N: keeps the int32 cumsum overflow-free on
    # adversarial digit chains (legit coverage <= N per pixel by definition).
    cov = jnp.minimum(cov, N)
    incl = cumsum(cov)
    start = incl - cov
    real = is_pfx & (start < N)
    # coverage must tile [0, N) exactly: cumsum construction is gapless, so
    # the only failure is total < N (truncated walk / corrupt stream).
    # (total = sum of cov = last serial element of incl)
    ok_cov = jnp.sum(cov, axis=1) >= N
    ok_ref = ~jnp.any(
        real & (sym == C.PREFIX_BACK_REF) & (p1 >= C.NUM_BACK_REF), axis=1
    )

    rec, dst = slot_records(is_pfx, sym, p1, p2, p3, p4, start, real, N, W)
    return rec, dst, (ok_cov, ok_ref)


def slot_records(is_pfx, sym, p1, p2, p3, p4, start, real, n_pixels: int, width: int):
    """Packed placement records from decoded pixel slots (elementwise).

    Transfer-form selection per mode (ref code.rs:576-651): BACK_REF/LUMA
    refs split into chain lags 1..3 vs const offsets; SMALL_DIFF/RGB/LUMA2
    take the floor-average form off row 0.  Returns (rec, dst): rec packs
    form(3b) | ref-index(4b) | dr,dg,db (8b each, mod 256) in 31 bits."""
    N, W = n_pixels, width
    mode = jnp.where(is_pfx, sym, 0)
    is_br = mode == C.PREFIX_BACK_REF
    is_rgb = mode == C.PREFIX_RGB
    is_lu = mode == C.PREFIX_COLOR_LUMA
    is_sd = mode == C.PREFIX_SMALL_DIFF
    is_l2 = mode == C.PREFIX_COLOR_LUMA2
    row0 = start < W
    pos0 = start == 0

    (br_lag, br_refi), (lu_lag, lu_refi), _ = _ref_index_table(W)
    lag = jnp.where(is_br, _sel(p1, br_lag), jnp.where(is_lu, _sel(p1, lu_lag), 0))
    refi = jnp.where(is_br, _sel(p1, br_refi), jnp.where(is_lu, _sel(p1, lu_refi), 0))

    form = jnp.full(mode.shape, F_ADD1, jnp.int32)
    form = jnp.where(is_br | is_lu, jnp.where(lag > 0, F_CONST + lag, F_CONST), form)
    form = jnp.where(is_sd | is_rgb, jnp.where(row0, F_ADD1, F_HALF), form)
    form = jnp.where(is_l2, F_HALF, form)
    form = jnp.where(is_rgb & pos0, F_CONST, form)
    refi = jnp.where(lag > 0, 0, refi)

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
    dg = jnp.select([is_br, is_lu, is_l2, is_sd], [0, lg, g2, sd_g - 3], default=p2)
    db = jnp.select(
        [is_br, is_lu, is_l2, is_sd], [0, p4 - 16 + lg, p3 - 16 + g2, sd_b - 3],
        default=p3,
    )

    rec = (
        form
        | (refi << 3)
        | ((dr & 255) << 7)
        | ((dg & 255) << 15)
        | ((db & 255) << 23)
    )
    dst = jnp.where(real, start, N)
    return rec, dst


def place_and_unpack(rec, dst, n_pixels: int, width: int):
    """Scatter packed records to raster positions; unpack to (form (B, N),
    delta (B, 3, N) CHANNEL-PLANAR, refoff (B, N)) for the row
    reconstruction.  rec/dst: (B, ...) any layout (flattened internally —
    real slots have unique dst, so scatter order is irrelevant)."""
    N, W = n_pixels, width
    offs = _const_offsets(W)
    B = rec.shape[0]
    recf = rec.reshape(B, -1)
    dstf = dst.reshape(B, -1)

    def one(rec1, dst1):
        base = jnp.full(N + 1, REC_DEFAULT, jnp.int32)
        return base.at[dst1].set(rec1, mode="drop")[:N]

    recN = jax.vmap(one)(recf, dstf)
    form = recN & 7
    refi = (recN >> 3) & 15
    delta = jnp.stack(
        [(recN >> 7) & 255, (recN >> 15) & 255, (recN >> 23) & 255], axis=1
    )
    refoff = _sel(refi, (0,) + tuple(offs))
    return form, delta, refoff


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------


def _sym_join(bins, sym_tbl):
    """Canonical-index bins -> symbols via per-image tables."""

    def one(b, t):
        live = b < C.TOTAL_SYMBOLS
        return jnp.where(live, t[jnp.clip(b, 0, C.TOTAL_SYMBOLS - 1)], 0)

    return jax.vmap(one)(bins, sym_tbl)


def _payload_bins(sym, i12, i34):
    """Walk records -> 4 slot-wise flat canonical bins (invalid = padded)."""
    idx = (i12 & 0xFFFF, i12 >> 16, i34 & 0xFFFF, i34 >> 16)
    PAD = 1023  # any bin >= C.TOTAL_SYMBOLS is "no symbol"
    bins = []
    for k in range(C.MODE_PAYLOAD_SLOTS):
        b = jnp.full(sym.shape, PAD, jnp.int32)
        for m in range(5):
            s = SLOT_STREAM[m][k]
            if s >= 0:
                b = jnp.where(sym == m, C.STREAM_BASE[s] + idx[k], b)
        bins.append(b)
    return bins


def _as_cfg(rung, chunk_bits: int = CHUNK_BITS) -> WalkCfg:
    """Normalize a ladder rung: WalkCfg passes through; a legacy
    (steps_div, rounds) pair picks up the caller's chunk_bits."""
    if isinstance(rung, WalkCfg):
        return rung
    sd, rd = rung
    return WalkCfg(chunk_bits, sd, rd)


def _decode_core_v3(
    words, wbits, af, present, ib, pfx, sym_tbl,
    *, n_pixels: int, width: int, chunk_bits: int, steps: int, maxl,
    segs: int, rounds: int = 3, serial_recon: bool = False,
):
    """Full device decode of a batch.

    words (B, Wn) uint32-as-int32 payload words (Wn >= nch*chunk_bits/32 +
    LOOKAHEAD_WORDS); wbits (B,) int32; af/present/ib (B, 10, 32) int32; pfx
    (B, 1, 16) int32; sym_tbl (B, 858) int32.  Returns (out (B, 3, N) uint8
    channel-planar, ok (B,), gates (B, 4) bool) with gates = [consistency,
    crossing, coverage, backref-index] (ok = AND of all; per-gate flags let
    tests pin WHICH defense caught a corruption class)."""
    B, Wn = words.shape
    nch = (Wn - LOOKAHEAD_WORDS) // (chunk_bits // 32)
    entries0 = jnp.broadcast_to(
        jnp.arange(nch, dtype=jnp.int32)[None, :] * chunk_bits, (B, nch)
    )
    aff, dD, inc = derive_walk_tables(af, present, ib)
    chunk0 = jnp.zeros((B,), jnp.int32)

    def walk(e):
        with jax.named_scope("walk"):
            return walk_batch(
                words, e, aff, dD, inc, pfx[:, 0], wbits, chunk0,
                chunk_bits=chunk_bits, steps=steps, maxl=maxl,
            )

    # round 1: speculative entries = chunk starts (anchored at bit 0).
    # Each later round re-walks from the previous exits: entry truth
    # propagates >= 1 chunk/round past a self-sync miss, so `rounds` walks
    # tolerate runs of (rounds - 2) consecutive non-syncing chunks.
    e = entries0
    for _ in range(rounds - 1):
        _, _, _, _, ex = walk(e)
        e = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), ex[:, :-1]], axis=1)
    pos, sym, i12, i34, ex2 = (r.reshape(B, -1) for r in walk(e))

    # Gate (induction from the bit-0 anchor): every final-round exit that is
    # still inside the payload must equal the entry the NEXT chunk was given,
    # and every chunk that actually walked must have crossed its boundary
    # (not run out of step budget).  Any miss -> ok False -> host fallback.
    ex2 = ex2.reshape(B, nch)
    wb = wbits[:, None]
    starts = jnp.arange(nch, dtype=jnp.int32)[None, :] * chunk_bits
    bounds = starts + chunk_bits
    ok_consist = jnp.all(
        (ex2[:, :-1] == e[:, 1:]) | (ex2[:, :-1] >= wb), axis=1
    )
    walked = e < wb
    crossed = ex2 >= jnp.minimum(bounds, wb)
    ok_cross = jnp.all(crossed | ~walked, axis=1)

    with jax.named_scope("assemble"):
        syms = [_sym_join(b, sym_tbl) for b in _payload_bins(sym, i12, i34)]
        rec, dst, (ok_cov, ok_ref) = assemble_v3(
            pos, sym, syms[0], syms[1], syms[2], syms[3], n_pixels, width, wbits
        )
        form, delta, refoff = place_and_unpack(rec, dst, n_pixels, width)
    with jax.named_scope("reconstruct"):
        if serial_recon:
            out = jax.vmap(
                lambda f, d, r: reconstruct_serial(f, d, r, n_pixels, width)
            )(form, delta, refoff)
        else:
            out = jax.vmap(
                lambda f, d, r: reconstruct_rows(f, d, r, n_pixels, width, segs)
            )(form, delta, refoff)
    gates = jnp.stack([ok_consist, ok_cross, ok_cov, ok_ref], axis=1)
    return out.astype(jnp.uint8), jnp.all(gates, axis=1), gates


_STATIC_V3 = ("n_pixels", "width", "chunk_bits", "steps", "maxl", "segs", "rounds", "serial_recon")
_device_decode_v3 = partial(jax.jit, static_argnames=_STATIC_V3)(_decode_core_v3)


# ---------------------------------------------------------------------------
# Host wrappers
# ---------------------------------------------------------------------------


def prepare_tables_v3(flat_lengths: np.ndarray):
    """Device tables for one image: (af, present, ib, pfx16, sym_tbl).

    af/present/ib: (10, 32) int32 (af = first codes left-aligned, as int32
    bit patterns); pfx16: (1, 16) canonical-order prefix symbols; sym_tbl:
    (858,) flat canonical-index -> symbol join table."""
    from nicetpu.format import huffman

    af, present, ib, sorted_flat = huffman.decode_dev_tables(flat_lengths)
    sp = C.SC_PREFIXES
    base, size = C.STREAM_BASE[sp], C.ALPHABET_SIZES[sp]
    lengths = np.asarray(flat_lengths[base : base + size], dtype=np.int64)
    order = np.lexsort((np.arange(size), lengths))
    pfx16 = np.zeros((1, 16), np.int32)
    pfx16[0, :size] = order
    sym_tbl = np.zeros(C.TOTAL_SYMBOLS, np.int32)
    for s in range(C.NUM_STREAMS):
        b, n = C.STREAM_BASE[s], C.ALPHABET_SIZES[s]
        sym_tbl[b : b + n] = sorted_flat[s, :n]
    return (
        af.view(np.int32),
        present.astype(np.int32),
        ib.astype(np.int32),
        pfx16,
        sym_tbl,
    )


def prepare_tables_v3_batch(lengths_batch: np.ndarray):
    """Vectorized batch table build: (B, 858) code lengths -> stacked device
    tables (af (B,10,32) int32, present, ib, pfx16 (B,1,16), sym_tbl
    (B,858)).

    Replaces B calls to `prepare_tables_v3` (per-image python loops over
    symbols) with an all-numpy batch formulation: canonical order via one argsort per
    stream, left-aligned first codes via the identity
    A_i = sum_{j<i} 2^(32 - l_j) (the canonical-code cumsum), per-length
    first-index/presence via counting."""
    lens_all = np.asarray(lengths_batch, dtype=np.int64)
    B = lens_all.shape[0]
    af = np.full((B, C.NUM_STREAMS, 32), 0xFFFFFFFF, dtype=np.uint32)
    present = np.zeros((B, C.NUM_STREAMS, 32), dtype=np.int32)
    ib = np.zeros((B, C.NUM_STREAMS, 32), dtype=np.int32)
    sym_tbl = np.zeros((B, C.TOTAL_SYMBOLS), dtype=np.int32)
    pfx16 = np.zeros((B, 1, 16), dtype=np.int32)
    lvals = np.arange(32, dtype=np.int64)
    for s in range(C.NUM_STREAMS):
        base, size = C.STREAM_BASE[s], C.ALPHABET_SIZES[s]
        lens = lens_all[:, base : base + size]  # (B, size)
        # canonical order: (length asc, symbol asc) — stable keyed argsort
        order = np.argsort(lens * 1024 + np.arange(size), axis=1, kind="stable")
        sorted_lens = np.take_along_axis(lens, order, axis=1)
        sym_tbl[:, base : base + size] = order
        if s == C.SC_PREFIXES:
            pfx16[:, 0, :size] = order
        # left-aligned first codes: A_i = sum_{j<i} 2^(32 - l_j)
        contrib = np.uint64(1) << (np.uint64(32) - sorted_lens.astype(np.uint64))
        A = np.cumsum(contrib, axis=1) - contrib  # exclusive
        # per length l: first canonical index, presence, first code
        cnt_lt = (sorted_lens[:, None, :] < lvals[None, :, None]).sum(axis=2)
        cnt_le = (sorted_lens[:, None, :] <= lvals[None, :, None]).sum(axis=2)
        pres = cnt_le > cnt_lt  # (B, 32)
        first_idx = np.minimum(cnt_lt, size - 1)
        A_first = np.take_along_axis(A, first_idx, axis=1)
        present[:, s] = pres.astype(np.int32)
        ib[:, s] = np.where(pres, cnt_lt, 0).astype(np.int32)
        af[:, s] = np.where(pres, A_first.astype(np.uint32), np.uint32(0xFFFFFFFF))
    return (
        af.view(np.int32),
        present,
        ib,
        pfx16,
        sym_tbl,
    )


def prepare_tables_v3_jnp(lens_b):
    """Device twin of `prepare_tables_v3_batch`: (B, 858) int32 code lengths
    (already on device) -> stacked decode tables, entirely inside the XLA
    program.

    Returns (af (B,10,32) int32 bit patterns, present, ib, pfx16 (B,1,16),
    sym_tbl (B,858), tables_ok (B,) bool).

    tables_ok is the device analogue of `huffman.validate_flat_lengths`:
    lengths in 1..=31 and an exactly complete Kraft sum per stream (the
    uint32 contrib cumsum wraps to 0).  Used by the fused round-trip verify
    (`roundtrip_verify_fused`) so no host-side numpy table build, validation
    or upload sits between the encoder's device lengths and the decoder."""
    lens_all = lens_b.astype(jnp.int32)
    B = lens_all.shape[0]
    af = jnp.full((B, C.NUM_STREAMS, 32), -1, jnp.int32)  # 0xFFFFFFFF
    present = jnp.zeros((B, C.NUM_STREAMS, 32), jnp.int32)
    ib = jnp.zeros((B, C.NUM_STREAMS, 32), jnp.int32)
    sym_tbl = jnp.zeros((B, C.TOTAL_SYMBOLS), jnp.int32)
    pfx16 = jnp.zeros((B, 1, 16), jnp.int32)
    lvals = jnp.arange(32, dtype=jnp.int32)
    ok = jnp.ones(B, jnp.bool_)
    for s in range(C.NUM_STREAMS):
        base, size = C.STREAM_BASE[s], C.ALPHABET_SIZES[s]
        lens = lens_all[:, base : base + size]  # (B, size)
        lens_c = jnp.clip(lens, 1, C.MAX_CODE_LEN)  # keep shifts defined
        ok = ok & jnp.all((lens >= 1) & (lens <= C.MAX_CODE_LEN), axis=1)
        # canonical order: (length asc, symbol asc) via unique keyed argsort
        order = jnp.argsort(lens_c * 1024 + jnp.arange(size, dtype=jnp.int32), axis=1)
        sorted_lens = jnp.take_along_axis(lens_c, order, axis=1)
        sym_tbl = sym_tbl.at[:, base : base + size].set(order)
        if s == C.SC_PREFIXES:
            pfx16 = pfx16.at[:, 0, :size].set(order)
        # left-aligned first codes: A_i = sum_{j<i} 2^(32 - l_j); int32
        # wraparound is exact (exclusive sums < 2^32, SURVEY A.2 canonical)
        contrib = jnp.left_shift(jnp.int32(1), 32 - sorted_lens)
        A = jnp.cumsum(contrib, axis=1) - contrib  # exclusive
        # Kraft completeness: inclusive total wraps to exactly 0 mod 2^32
        ok = ok & (A[:, -1] + contrib[:, -1] == 0)
        cnt_lt = jnp.sum(
            sorted_lens[:, None, :] < lvals[None, :, None], axis=2
        )  # (B, 32)
        cnt_le = jnp.sum(sorted_lens[:, None, :] <= lvals[None, :, None], axis=2)
        pres = cnt_le > cnt_lt
        first_idx = jnp.minimum(cnt_lt, size - 1)
        A_first = jnp.take_along_axis(A, first_idx, axis=1)
        present = present.at[:, s].set(pres.astype(jnp.int32))
        ib = ib.at[:, s].set(jnp.where(pres, cnt_lt, 0))
        af = af.at[:, s].set(jnp.where(pres, A_first, -1))
    return af, present, ib, pfx16, sym_tbl, ok


def run_ladder(call, n: int, *, ladder=LADDER, skip=None, stats=None):
    """Shared retry-ladder orchestration.

    call(rung) -> (ok (n,) bool-ish, aux tuple of per-image
    arrays, gates or None).  Tries each ladder config in order; aux arrays
    are initialized from the first config for every image and overwritten
    per image by the first config whose gates verified it; `skip`ped images
    never verify.  Returns (ok (n,) np.bool_, merged aux list).  stats (if
    given) receives fallbacks / retries / ok / gates-of-last-config."""
    skip = np.zeros(n, bool) if skip is None else np.asarray(skip, bool)
    ok_np = np.zeros(n, bool)
    merged: list | None = None
    retries = 0
    gates_last = None
    for rung in ladder:
        ok, aux, gates = call(rung)
        ok_new = np.asarray(ok) & ~skip
        if gates is not None:
            gates_last = np.asarray(gates)
        if merged is None:
            merged = [np.array(a) for a in aux]
            ok_np = ok_new
        else:
            upd = ok_new & ~ok_np
            for m, a in zip(merged, aux):
                m[upd] = np.asarray(a)[upd]
            ok_np = ok_np | ok_new
        if (ok_np | skip).all():
            break
        retries += 1
    if stats is not None:
        stats["fallbacks"] = int((~ok_np).sum())
        stats["retries"] = retries
        stats["ok"] = [bool(x) for x in ok_np]
        if gates_last is not None:
            stats["gates"] = [[bool(g) for g in row] for row in gates_last]
    return ok_np, (merged if merged is not None else [])


def bucket_chunks(n: int) -> int:
    """n rounded up to one of 4 steps per power of two (at most 25% more
    chunks).  The chunk count fixes the decode program's shapes, so batches
    whose payloads differ by a little share one executable; the extra tail
    chunks start past `wbits` and walk nothing (walk and assembly are a few
    percent of decode time, reconstruction does not depend on chunks)."""
    step = 1 << max(0, n.bit_length() - 3)
    return -(-n // step) * step


def _wcap_one(max_payload_bytes: int, cfg: WalkCfg) -> int:
    """Word-array length needed by one walk config (chunk count bucketed)."""
    nch = bucket_chunks(max(1, -(-max_payload_bytes * 8 // cfg.chunk_bits)))
    return nch * (cfg.chunk_bits // 32) + LOOKAHEAD_WORDS


def _words_cap(max_payload_bytes: int, ladder, chunk_bits: int = CHUNK_BITS) -> int:
    """Wn covering every rung of the ladder (each rung re-derives its
    nch_pad from Wn inside `_decode_core_v3`)."""
    return max(_wcap_one(max_payload_bytes, _as_cfg(r, chunk_bits)) for r in ladder)


def _segs_for(width: int) -> int:
    from nicetpu.kernels.decode_dev import _pick_segs

    return _pick_segs(width)


def prepare_batch_args(
    datas: list[bytes], *, chunk_bits: int = CHUNK_BITS,
    steps_div: int | None = None, rounds: int | None = None,
    ladder: tuple = LADDER,
):
    """Device arrays + static kwargs for `_decode_core_v3` on a same-shape
    batch (host-side header parse, table build, word upload; the word array
    is sized for every rung of `ladder`).  The kwargs default to the first
    ladder config; bench uses this to time the device pipeline with a
    checksum-only fetch."""
    from nicetpu.format import headers, huffman

    shapes = {headers.parse_file_header(d)[:2] for d in datas}
    if len(shapes) != 1:
        raise ValueError("batch decode requires same-shape streams")
    W, H = next(iter(shapes))
    if W < C.MIN_WIDTH:
        raise ValueError(f"width must be >= {C.MIN_WIDTH}")
    N = W * H

    lens, payloads = [], []
    for d in datas:
        if headers.parse_file_header(d)[2] != 3:
            raise ValueError("only channels=3 decode is defined (SURVEY A.8.3)")
        flat_lengths = headers.parse_stream_headers(d[C.FILE_HEADER_BYTES :])
        huffman.validate_flat_lengths(flat_lengths)
        lens.append(flat_lengths)
        payloads.append(d[C.FILE_HEADER_BYTES + C.STREAM_HEADERS_BYTES : len(d) - 4])
    af_b, pr_b, ib_b, pfx_b, sym_b = prepare_tables_v3_batch(np.stack(lens))

    cfg0 = _as_cfg(ladder[0], chunk_bits)
    if chunk_bits != CHUNK_BITS or steps_div is not None or rounds is not None:
        cfg0 = WalkCfg(
            chunk_bits, steps_div or cfg0.steps_div, rounds or cfg0.rounds
        )

    max_bytes = max(len(p) for p in payloads)
    Wn = max(
        _words_cap(max_bytes, ladder, chunk_bits), _wcap_one(max_bytes, cfg0)
    )
    words = np.zeros((len(datas), Wn), dtype=np.uint32)
    wbits = np.zeros(len(datas), dtype=np.int32)
    for i, p in enumerate(payloads):
        src = np.frombuffer(p + b"\0" * ((-len(p)) % 4), dtype=">u4")
        words[i, : src.shape[0]] = src
        wbits[i] = len(p) * 8

    args = (
        jnp.asarray(words.view(np.int32)),
        jnp.asarray(wbits),
        jnp.asarray(af_b),
        jnp.asarray(pr_b),
        jnp.asarray(ib_b),
        jnp.asarray(pfx_b),
        jnp.asarray(sym_b),
    )
    kw = dict(
        n_pixels=N,
        width=W,
        chunk_bits=cfg0.chunk_bits,
        steps=_steps(cfg0.chunk_bits, cfg0.steps_div),
        maxl=WALK_MAXL,
        segs=_segs_for(W),
        rounds=cfg0.rounds,
    )
    return args, kw


def decode_batch_jax_v3(
    datas: list[bytes],
    *,
    chunk_bits: int = CHUNK_BITS,
    ladder: tuple = LADDER,
    serial_recon: bool = False,
    stats: dict | None = None,
) -> list[np.ndarray]:
    """Batched device decode of same-shape `.nice` streams (v3 pipeline).

    Tries each (steps_div, rounds) ladder config in order (fast first); any
    image the device pipeline cannot verify (`ok` False: corrupt stream,
    self-sync miss, step-budget truncation) after the last config falls back
    to the host decoder.  Pass `stats` to receive {"fallbacks": int,
    "retries": int, "ok": list[bool], "gates": list[[consistency,
    crossing, coverage, backref] bools] from the LAST attempted config} —
    bench/tests assert no silent fallback on valid streams and pin which
    gate rejected a corrupt one."""
    from nicetpu.format import headers, huffman

    if not datas:
        return []
    shapes = {headers.parse_file_header(d)[:2] for d in datas}
    if len(shapes) != 1:
        raise ValueError("decode_batch_jax_v3 requires same-shape streams")
    W, H = next(iter(shapes))
    if W < C.MIN_WIDTH:
        raise ValueError(f"width must be >= {C.MIN_WIDTH}")
    N = W * H

    args, base_kw = prepare_batch_args(datas, chunk_bits=chunk_bits)

    def call(rung):
        cfg = _as_cfg(rung, chunk_bits)
        out, ok, gates = _device_decode_v3(
            *args,
            **{
                **base_kw,
                "chunk_bits": cfg.chunk_bits,
                "steps": _steps(cfg.chunk_bits, cfg.steps_div),
                "rounds": cfg.rounds,
                "serial_recon": serial_recon,
            },
        )
        return ok, (out,), gates

    ok_np, (out_np,) = run_ladder(call, len(datas), ladder=ladder, stats=stats)
    result = []
    for i, d in enumerate(datas):
        if bool(ok_np[i]):
            # device output is channel-planar (3, N); untangle on host
            result.append(out_np[i].reshape(3, H, W).transpose(1, 2, 0))
        else:
            from nicetpu.spec import codec

            result.append(codec.decode(d))
    return result


def decode_jax_v3(data: bytes, **kw) -> np.ndarray:
    """Device `.nice` decode (v3): bytes -> (H, W, 3) uint8."""
    return decode_batch_jax_v3([data], **kw)[0]


# ---------------------------------------------------------------------------
# Device-verified round-trip decode (production hybrid path)
# ---------------------------------------------------------------------------


def _decode_verify_core(
    words, wbits, af, present, ib, pfx, sym_tbl, orig, **kw
):
    """Decode + on-device bit-exact comparison against the resident
    original.  orig: (B, N, 3) uint8 (the `pipeline.upload_batch` layout).
    Returns (ok (B,) gates passed, eq (B,) decoded == orig exactly) — only
    2B booleans leave the device, the raster never does (the on-device
    equality checks EVERY byte)."""
    out, ok, _gates = _decode_core_v3(words, wbits, af, present, ib, pfx, sym_tbl, **kw)
    orig_planar = jnp.swapaxes(orig, 1, 2)  # (B, 3, N)
    eq = jnp.all(out == orig_planar, axis=(1, 2))
    return ok, eq


_device_decode_verify = partial(jax.jit, static_argnames=_STATIC_V3)(
    _decode_verify_core
)


def decode_batch_verify_device(
    datas: list[bytes],
    orig_dev,
    *,
    ladder: tuple = LADDER,
    stats: dict | None = None,
) -> np.ndarray:
    """Round-trip verification decode: decode same-shape `.nice` streams on
    device and PROVE each equals the resident (B, N, 3) uint8 original.

    Returns a (B,) bool array `verified`.  Semantics per image:
      * gates ok AND eq      -> True (bit-exact round trip proven on device)
      * gates not ok          -> False (caller decodes that image on host —
        the same fallback contract as `decode_batch_jax_v3`)
      * gates ok but NOT eq  -> RuntimeError: the device pipeline claims a
        consistent decode that differs from the encoder input; that is a
        kernel defect and must surface loudly, never as a silent fallback.
    """
    if not datas:
        return np.zeros(0, bool)
    args, base_kw = prepare_batch_args(datas, ladder=ladder)

    def call(rung):
        cfg = _as_cfg(rung)
        ok, eq = _device_decode_verify(
            *args,
            orig_dev,
            **{
                **base_kw,
                "chunk_bits": cfg.chunk_bits,
                "steps": _steps(cfg.chunk_bits, cfg.steps_div),
                "rounds": cfg.rounds,
            },
        )
        return ok, (eq,), None

    ok_np, (eq_np,) = run_ladder(call, len(datas), ladder=ladder, stats=stats)
    _raise_if_consistent_but_wrong(ok_np, eq_np)
    return ok_np


def _raise_if_consistent_but_wrong(ok_np, eq_np) -> None:
    """A gate-consistent decode that differs from the encoder input is a
    kernel defect and must surface loudly, never as a silent fallback."""
    bad = np.asarray(ok_np, bool) & ~np.asarray(eq_np, bool)
    if bad.any():
        raise RuntimeError(
            f"device decode gate-consistent but NOT equal to the original "
            f"(image {int(np.argmax(bad))}): kernel defect, refusing silent "
            f"fallback"
        )


def verify_words_device(
    words_dev,
    totals: np.ndarray,
    lengths: np.ndarray,
    orig_dev,
    *,
    n_pixels: int,
    width: int,
    skip: np.ndarray | None = None,
    ladder: tuple = LADDER,
    stats: dict | None = None,
) -> np.ndarray:
    """Device-RESIDENT round-trip verification: decode straight from the
    encoder's packed words (still on the device from `encode2.encode_fused`)
    and prove equality with the resident original — the compressed payload
    is never re-uploaded for the decode leg.

    words_dev: (B, w_cap) uint32 device words (payload bit 0 = word 0 MSB,
    zeros beyond the payload — exactly the walk's expected layout);
    totals: (B,) host int payload bit counts; lengths: (B, 858) host code
    lengths (from the fused encode's small fetch); orig_dev: (B, N, 3)
    uint8 resident originals; skip: optional (B,) bool — images whose fused
    encode overflowed (their words/lengths are unusable) are never
    verified and reported False.

    Returns (B,) bool `verified` with the same loud-failure contract as
    `decode_batch_verify_device`."""
    B = int(words_dev.shape[0])
    skip = np.zeros(B, bool) if skip is None else np.asarray(skip, bool)
    if skip.all():
        if stats is not None:
            stats["fallbacks"] = B
            stats["retries"] = 0
        return np.zeros(B, bool)
    from nicetpu.format import huffman

    # per-image tables; a skipped image borrows the first live image's
    # tables (its gates are ignored — `verified` stays False)
    donor = int(np.argmin(skip))
    src_rows = np.where(skip, donor, np.arange(B))
    lens_b = np.asarray(lengths, dtype=np.int64)[src_rows]
    for b in range(B):
        if not skip[b]:
            huffman.validate_flat_lengths(lens_b[b].astype(np.uint8))
    af_b, pr_b, ib_b, pfx_b, sym_b = prepare_tables_v3_batch(lens_b)

    tot = np.where(skip, int(totals[donor]), np.asarray(totals)).astype(np.int64)
    Wn = _words_cap(int(tot.max() + 7) // 8, ladder)
    wi = jax.lax.bitcast_convert_type(words_dev, jnp.int32)
    w_cap = int(wi.shape[1])
    if w_cap >= Wn:
        wi = wi[:, :Wn]
    else:
        wi = jnp.pad(wi, ((0, 0), (0, Wn - w_cap)))
    args = (
        wi,
        jnp.asarray(tot.astype(np.int32)),
        jnp.asarray(af_b),
        jnp.asarray(pr_b),
        jnp.asarray(ib_b),
        jnp.asarray(pfx_b),
        jnp.asarray(sym_b),
    )
    base_kw = dict(
        n_pixels=n_pixels,
        width=width,
        maxl=WALK_MAXL,
        segs=_segs_for(width),
    )

    def call(rung):
        cfg = _as_cfg(rung)
        ok, eq = _device_decode_verify(
            *args,
            orig_dev,
            **base_kw,
            chunk_bits=cfg.chunk_bits,
            steps=_steps(cfg.chunk_bits, cfg.steps_div),
            rounds=cfg.rounds,
        )
        return ok, (eq,), None

    ok_np, (eq_np,) = run_ladder(call, B, ladder=ladder, skip=skip, stats=stats)
    _raise_if_consistent_but_wrong(ok_np, eq_np)
    return ok_np


# ---------------------------------------------------------------------------
# Fused round-trip: encode + device tables + decode + verify, ONE dispatch
# ---------------------------------------------------------------------------

# Optimistic payload cap for the fused round-trip (bits/pixel).  The decode
# walk geometry is static, sized by w_cap — a tighter cap halves the walk
# record volume vs the encoder's 28 bpp safety cap.  Images exceeding it set
# cap_ovf and take the ladder/native fallback like any other overflow.
ROUNDTRIP_CAP_BPP = 16

def _roundtrip_verify_core(
    flat, *, width: int, ndigits_cap: int, w_cap: int,
    cfg: WalkCfg, maxl, segs: int,
):
    """Encode (B, N, 3) uint8 resident images, build decode tables from the
    encoder's device lengths, decode from the device-resident packed words,
    and prove bit-exact equality with the input — all in ONE XLA program.

    Returns (words (B, w_cap) uint32, small2 (B, 862) int32) with small2 =
    [lengths(858), total_bits, ovf, verified_ok, eq].  The only host
    traffic for a verified round trip is the small2 fetch."""
    from nicetpu.kernels.encode2 import encode_fused_core

    B, N, _ = flat.shape
    words, lengths, totals, ovf = encode_fused_core(
        flat, width=width, ndigits_cap=ndigits_cap, w_cap=w_cap
    )
    af, pr, ib, pfx, sym_tbl, tables_ok = prepare_tables_v3_jnp(lengths)

    # w_cap is static here: size the walk exactly, with no bucket
    Wn = -(-32 * (w_cap - 2) // cfg.chunk_bits) * (cfg.chunk_bits // 32) + LOOKAHEAD_WORDS
    wi = jax.lax.bitcast_convert_type(words, jnp.int32)
    wi = wi[:, :Wn] if w_cap >= Wn else jnp.pad(wi, ((0, 0), (0, Wn - w_cap)))
    out, ok, _gates = _decode_core_v3(
        wi, totals, af, pr, ib, pfx, sym_tbl,
        n_pixels=N, width=width, chunk_bits=cfg.chunk_bits,
        steps=_steps(cfg.chunk_bits, cfg.steps_div),
        maxl=maxl, segs=segs, rounds=cfg.rounds,
    )
    eq = jnp.all(out == jnp.swapaxes(flat, 1, 2), axis=(1, 2))
    okf = ok & tables_ok & ~ovf
    small2 = jnp.concatenate(
        [
            lengths,
            totals[:, None],
            ovf.astype(jnp.int32)[:, None],
            okf.astype(jnp.int32)[:, None],
            eq.astype(jnp.int32)[:, None],
        ],
        axis=1,
    )
    return words, small2


_STATIC_RT = ("width", "ndigits_cap", "w_cap", "cfg", "maxl", "segs")
_roundtrip_fused_jit = partial(jax.jit, static_argnames=_STATIC_RT)(
    _roundtrip_verify_core
)


def roundtrip_cap_words(n_pixels: int) -> int:
    return n_pixels * ROUNDTRIP_CAP_BPP // 32 + 1024


def roundtrip_verify_fused(
    flat_dev, *, width: int, w_cap: int | None = None,
    ladder: tuple = LADDER, stats: dict | None = None,
):
    """Device round trip with one dispatch + one small fetch per batch.

    flat_dev: (B, N, 3) uint8 resident batch.  Runs the fused
    encode+table+decode+verify program (fast ladder config, static
    `WALK_MAXL` — exact for any code depth via the deep-code escape);
    images it cannot verify (payload over the optimistic cap, self-sync
    miss, step-budget truncation) retry through the robust
    `verify_words_device` ladder rungs, then fall back to the caller's
    host path.  Returns (words_dev (B, w_cap) uint32, small
    (B, 860) int32 np.ndarray — the `encode_fused` layout — and verified
    (B,) bool).  Same loud-failure contract as `verify_words_device`."""
    B, N, _ = (int(x) for x in flat_dev.shape)
    if w_cap is None:
        w_cap = roundtrip_cap_words(N)
    words, small2_d = _roundtrip_fused_jit(
        flat_dev, width=width, ndigits_cap=3, w_cap=w_cap,
        cfg=_as_cfg(ladder[0]), maxl=WALK_MAXL, segs=_segs_for(width),
    )
    small2 = np.asarray(small2_d)
    small = small2[:, :860]
    okf = small2[:, 860].astype(bool)
    eq = small2[:, 861].astype(bool)
    _raise_if_consistent_but_wrong(okf, eq)
    verified = okf & eq
    ovf = small[:, 859].astype(bool)
    retry = ~verified & ~ovf
    if stats is not None:
        stats["retries"] = int(retry.sum())
    if retry.any() and len(ladder) > 1:
        sub: dict = {}
        v2 = verify_words_device(
            words, small[:, 858], small[:, :858], flat_dev,
            skip=~retry, n_pixels=N, width=width, ladder=ladder[1:],
            stats=sub,
        )
        verified = verified | v2
    if stats is not None:
        stats["fallbacks"] = int((~verified).sum())
        stats["ok"] = [bool(x) for x in verified]
    return words, small, verified
