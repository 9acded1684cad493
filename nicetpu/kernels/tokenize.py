"""Vectorized `.nice` tokenizer + histogram as a jittable JAX program.

Data-parallel reformulation of the reference's per-pixel serial cascade
(ref code.rs:159-414): all predictors become statically-shifted tensor reads,
mode selection is a priority select over per-mode validity masks, run lengths
come from a log-doubling suffix-min over change indices, and the histogram is
a masked scatter-add over the flat 858-bin layout.

The core (`cascade`, `assemble_slots`) operates on a halo-extended local
pixel range so the same math serves single-chip whole-image encoding and
shard_map'ed row-block shards (halo = 4 rows covers every predictor offset,
max reach 3W+3 pixels; SURVEY §5 long-context analogue).  Every mode decision
depends only on raw input bytes (SURVEY §3.1), so shard-local tokenization
composes exactly: run-covered pixels emit nothing on any shard, and a run
crossing a shard boundary is emitted whole by the shard owning its head.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from nicetpu.format import constants as C
from nicetpu.kernels.scan import suffix_min


def halo_pixels(width: int) -> int:
    """Halo (in pixels) a shard needs before its first pixel: 4 rows covers
    the deepest predictor reach 3W+3 (ref code.rs:141-145) for any W >= 4."""
    return 4 * width


def cascade(x_ext: jnp.ndarray, g0, n_local: int, *, width: int, halo: int):
    """Mode cascade for n_local pixels given a halo-extended flat raster.

    x_ext: (halo + n_local, 3) int32 — halo pixels precede the local range.
    g0: global pixel index of local pixel 0 (traced or static).
    Returns per-pixel dict: mode, per-mode symbols, residuals, change mask.
    """
    W = width
    r_, g_, b_ = x_ext[:, 0], x_ext[:, 1], x_ext[:, 2]
    pos = g0 + jnp.arange(n_local, dtype=jnp.int32)

    def sh(x, off):
        """ref[i] = x_ext[halo + i - off] for local pixel i (zeros if OOB)."""
        start = halo - off
        if start >= 0:
            return jax.lax.dynamic_slice_in_dim(x, start, n_local)
        return jnp.pad(x, (-start, 0))[: n_local]

    r, g, b = sh(r_, 0), sh(g_, 0), sh(b_, 0)
    row0 = pos < W

    pr, pg, pb = sh(r_, 1), sh(g_, 1), sh(b_, 1)
    ur, ug, ub = sh(r_, W), sh(g_, W), sh(b_, W)

    # --- BACK_REF: first exact match over 5 offsets (priority select)
    br_hit = jnp.zeros(n_local, dtype=jnp.bool_)
    br_idx = jnp.zeros(n_local, dtype=jnp.int32)
    for i, off in enumerate(C.back_ref_offsets(W)):
        eq = (pos >= off) & (r == sh(r_, off)) & (g == sh(g_, off)) & (b == sh(b_, off))
        new = eq & ~br_hit
        br_idx = jnp.where(new, i, br_idx)
        br_hit = br_hit | eq

    # --- SMALL_DIFF (ref code.rs:210-247)
    avg_r, avg_g, avg_b = (ur + pr) // 2, (ug + pg) // 2, (ub + pb) // 2
    sd_r = r - jnp.where(row0, pr, avg_r)
    sd_g = g - jnp.where(row0, pg, avg_g)
    sd_b = b - jnp.where(row0, pb, avg_b)
    sd_hit = (
        (pos > 0) & (jnp.abs(sd_r) <= 3) & (jnp.abs(sd_g) <= 3) & (jnp.abs(sd_b) <= 3)
    )
    sd_code = (3 + sd_r) + 7 * (3 + sd_g) + 49 * (3 + sd_b)

    def luma_diffs(rr, rg, rb):
        dg = (g - rg) & 255
        dr = (r - rr - dg) & 255
        db = (b - rb - dg) & 255
        ok = (
            ((dg >= 224) | (dg < 32))
            & ((dr >= 240) | (dr < 16))
            & ((db >= 240) | (db < 16))
        )
        return dg, dr, db, ok

    # --- COLOR_LUMA2 (ref code.rs:252-292)
    l2_g, l2_r, l2_b, l2_ok = luma_diffs(avg_r, avg_g, avg_b)
    l2_hit = (~row0) & l2_ok

    # --- COLOR_LUMA: 11 refs, first in-range wins (ref code.rs:295-339)
    lu_hit = jnp.zeros(n_local, dtype=jnp.bool_)
    lu_idx = jnp.zeros(n_local, dtype=jnp.int32)
    lu_g = jnp.zeros(n_local, dtype=jnp.int32)
    lu_r = jnp.zeros(n_local, dtype=jnp.int32)
    lu_b = jnp.zeros(n_local, dtype=jnp.int32)
    for i, off in enumerate(C.luma_ref_offsets(W)):
        dg, dr, db, ok = luma_diffs(sh(r_, off), sh(g_, off), sh(b_, off))
        ok = ok & (pos >= off)
        new = ok & ~lu_hit
        lu_idx = jnp.where(new, i, lu_idx)
        lu_g = jnp.where(new, dg, lu_g)
        lu_r = jnp.where(new, dr, lu_r)
        lu_b = jnp.where(new, db, lu_b)
        lu_hit = lu_hit | ok

    # --- RGB residuals (ref code.rs:341-366); pixel-0 predictor = 0
    res_r = jnp.where(row0, (r - jnp.where(pos > 0, pr, 0)) & 255, (r - avg_r) & 255)
    res_g = jnp.where(row0, (g - jnp.where(pos > 0, pg, 0)) & 255, (g - avg_g) & 255)
    res_b = jnp.where(row0, (b - jnp.where(pos > 0, pb, 0)) & 255, (b - avg_b) & 255)

    mode = jnp.where(
        br_hit,
        C.PREFIX_BACK_REF,
        jnp.where(
            sd_hit,
            C.PREFIX_SMALL_DIFF,
            jnp.where(
                l2_hit,
                C.PREFIX_COLOR_LUMA2,
                jnp.where(lu_hit, C.PREFIX_COLOR_LUMA, C.PREFIX_RGB),
            ),
        ),
    )

    changed = ((r != pr) | (g != pg) | (b != pb)) | (pos == 0)

    return {
        "pos": pos,
        "mode": mode,
        "br_idx": br_idx,
        "sd_code": sd_code,
        "l2": (l2_g, l2_r, l2_b),
        "lu": (lu_idx, lu_g, lu_r, lu_b),
        "res": (res_r, res_g, res_b),
        "changed": changed,
    }


def assemble_slots(cas: dict, run_len: jnp.ndarray):
    """Token slot assembly: (n, TOKEN_SLOTS) stream/symbol/valid arrays in
    serial token order (SURVEY A.6).  run_len is the globally-correct run
    length per pixel (only meaningful at encoded pixels)."""
    mode = cas["mode"]
    n = mode.shape[0]
    enc = cas["changed"]
    br_idx = cas["br_idx"]
    sd_code = cas["sd_code"]
    l2_g, l2_r, l2_b = cas["l2"]
    lu_idx, lu_g, lu_r, lu_b = cas["lu"]
    res_r, res_g, res_b = cas["res"]

    is_br = mode == C.PREFIX_BACK_REF
    is_sd = mode == C.PREFIX_SMALL_DIFF
    is_l2 = mode == C.PREFIX_COLOR_LUMA2
    is_lu = mode == C.PREFIX_COLOR_LUMA
    is_rgb = mode == C.PREFIX_RGB

    has_run = enc & (run_len > 0)
    v = jnp.maximum(run_len - 1, 0)
    ndigits = jnp.ones(n, dtype=jnp.int32)
    for j in range(1, C.MAX_RUN_DIGITS):
        ndigits = ndigits + (v >= (1 << (3 * j))).astype(jnp.int32)

    def sel(cond_vals, default):
        out = default
        for cond, val in reversed(cond_vals):
            out = jnp.where(cond, val, out)
        return out

    full = lambda v_: jnp.full(n, v_, jnp.int32)
    slot_streams = [full(C.SC_PREFIXES)]
    slot_symbols = [mode]
    slot_valid = [enc]

    slot_streams.append(
        sel(
            [
                (is_br, full(C.SC_BACK_REF)),
                (is_sd, full(C.SC_SMALL_DIFF)),
                (is_l2, full(C.SC_LUMA_BASE_DIFF2)),
                (is_lu, full(C.SC_LUMA_BACK_REF)),
            ],
            full(C.SC_RGB),
        )
    )
    slot_symbols.append(
        sel(
            [(is_br, br_idx), (is_sd, sd_code), (is_l2, (l2_g + 32) & 255), (is_lu, lu_idx)],
            res_r,
        )
    )
    slot_valid.append(enc)

    slot_streams.append(
        sel(
            [(is_l2, full(C.SC_LUMA_OTHER_DIFF2)), (is_lu, full(C.SC_LUMA_BASE_DIFF))],
            full(C.SC_RGB),
        )
    )
    slot_symbols.append(sel([(is_l2, (l2_r + 16) & 255), (is_lu, (lu_g + 32) & 255)], res_g))
    slot_valid.append(enc & (is_l2 | is_lu | is_rgb))

    slot_streams.append(
        sel(
            [(is_l2, full(C.SC_LUMA_OTHER_DIFFB2)), (is_lu, full(C.SC_LUMA_OTHER_DIFF))],
            full(C.SC_RGB),
        )
    )
    slot_symbols.append(sel([(is_l2, (l2_b + 16) & 255), (is_lu, (lu_r + 16) & 255)], res_b))
    slot_valid.append(enc & (is_l2 | is_lu | is_rgb))

    slot_streams.append(full(C.SC_LUMA_OTHER_DIFF))
    slot_symbols.append((lu_b + 16) & 255)
    slot_valid.append(enc & is_lu)

    for j in range(C.MAX_RUN_DIGITS):
        slot_streams.append(full(C.SC_PREFIXES))
        slot_symbols.append(((v >> (3 * j)) & 7) + C.PREFIX_RUN_BASE)
        slot_valid.append(has_run & (j < ndigits))

    streams = jnp.stack(slot_streams, axis=1)
    symbols = jnp.stack(slot_symbols, axis=1)
    valid = jnp.stack(slot_valid, axis=1)
    streams = jnp.where(valid, streams, 0)
    symbols = jnp.where(valid, symbols, 0)
    return streams, symbols, valid


def assemble_bins(cas: dict, run_len: jnp.ndarray, *, ndigits_cap: int, invalid_bin: int):
    """Token slots directly as flat histogram bins (N, 5 + ndigits_cap).

    Gather-free: stream-base offsets are compile-time constants folded into
    the per-slot select chains (no per-slot `STREAM_BASE[streams]` gather).
    Invalid slots get `invalid_bin`.  Slot order == serial token order.
    """
    mode = cas["mode"]
    n = mode.shape[0]
    enc = cas["changed"]
    br_idx = cas["br_idx"]
    sd_code = cas["sd_code"]
    l2_g, l2_r, l2_b = cas["l2"]
    lu_idx, lu_g, lu_r, lu_b = cas["lu"]
    res_r, res_g, res_b = cas["res"]

    is_br = mode == C.PREFIX_BACK_REF
    is_sd = mode == C.PREFIX_SMALL_DIFF
    is_l2 = mode == C.PREFIX_COLOR_LUMA2
    is_lu = mode == C.PREFIX_COLOR_LUMA

    has_run = enc & (run_len > 0)
    v = jnp.maximum(run_len - 1, 0)
    ndigits = jnp.ones(n, dtype=jnp.int32)
    for j in range(1, C.MAX_RUN_DIGITS):
        ndigits = ndigits + (v >= (1 << (3 * j))).astype(jnp.int32)

    B = C.STREAM_BASE
    inv = jnp.full(n, invalid_bin, jnp.int32)

    def gate(cond, val):
        return jnp.where(cond, val, inv)

    slots = []
    # slot 0: prefix
    slots.append(gate(enc, B[C.SC_PREFIXES] + mode))
    # slot 1
    s1 = jnp.where(
        is_br,
        B[C.SC_BACK_REF] + br_idx,
        jnp.where(
            is_sd,
            B[C.SC_SMALL_DIFF] + sd_code,
            jnp.where(
                is_l2,
                B[C.SC_LUMA_BASE_DIFF2] + ((l2_g + 32) & 255),
                jnp.where(
                    is_lu, B[C.SC_LUMA_BACK_REF] + lu_idx, B[C.SC_RGB] + res_r
                ),
            ),
        ),
    )
    slots.append(gate(enc, s1))
    # slot 2
    s2 = jnp.where(
        is_l2,
        B[C.SC_LUMA_OTHER_DIFF2] + ((l2_r + 16) & 255),
        jnp.where(
            is_lu, B[C.SC_LUMA_BASE_DIFF] + ((lu_g + 32) & 255), B[C.SC_RGB] + res_g
        ),
    )
    slots.append(gate(enc & ~(is_br | is_sd), s2))
    # slot 3
    s3 = jnp.where(
        is_l2,
        B[C.SC_LUMA_OTHER_DIFFB2] + ((l2_b + 16) & 255),
        jnp.where(
            is_lu, B[C.SC_LUMA_OTHER_DIFF] + ((lu_r + 16) & 255), B[C.SC_RGB] + res_b
        ),
    )
    slots.append(gate(enc & ~(is_br | is_sd), s3))
    # slot 4 (COLOR_LUMA only)
    slots.append(gate(enc & is_lu, B[C.SC_LUMA_OTHER_DIFF] + ((lu_b + 16) & 255)))
    # run digit slots
    for j in range(ndigits_cap):
        slots.append(
            gate(
                has_run & (j < ndigits),
                B[C.SC_PREFIXES] + ((v >> (3 * j)) & 7) + C.PREFIX_RUN_BASE,
            )
        )
    bins = jnp.stack(slots, axis=1)
    overflow = (
        jnp.any(has_run & (ndigits > ndigits_cap))
        if ndigits_cap < C.MAX_RUN_DIGITS
        else jnp.bool_(False)
    )
    return bins, overflow


def histogram(streams, symbols, valid):
    base = jnp.asarray(np.asarray(C.STREAM_BASE, dtype=np.int32))
    bins = base[streams] + symbols
    return (
        jnp.zeros(C.TOTAL_SYMBOLS, dtype=jnp.int32)
        .at[bins.reshape(-1)]
        .add(valid.reshape(-1).astype(jnp.int32), mode="drop")
    )


def histogram_bins(bins: jnp.ndarray) -> jnp.ndarray:
    """Histogram of flat bins with invalid entries >= TOTAL_SYMBOLS."""
    flat = bins.reshape(-1)
    live = flat < C.TOTAL_SYMBOLS
    return (
        jnp.zeros(C.TOTAL_SYMBOLS, dtype=jnp.int32)
        .at[jnp.where(live, flat, 0)]
        .add(live.astype(jnp.int32), mode="drop")
    )


@partial(jax.jit, static_argnames=("width",))
def tokenize_and_count(img_flat: jnp.ndarray, *, width: int):
    """Single-chip whole-image tokenizer.  img_flat: (N, 3) uint8.

    Returns dict with (N, TOKEN_SLOTS) slot arrays and the (858,) histogram.
    """
    N = img_flat.shape[0]
    x = img_flat.astype(jnp.int32)
    cas = cascade(x, jnp.int32(0), N, width=width, halo=0)

    pos = cas["pos"]
    enc = cas["changed"]
    change_idx = jnp.where(enc, pos, N)
    sfx = suffix_min(change_idx)
    next_change = jnp.concatenate([sfx[1:], jnp.array([N], jnp.int32)])
    run_len = next_change - pos - 1

    streams, symbols, valid = assemble_slots(cas, run_len)
    counts = histogram(streams, symbols, valid)
    return {"streams": streams, "symbols": symbols, "valid": valid, "counts": counts}
