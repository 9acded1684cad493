"""Encode pipeline v2: batched tokenize, histogram, Huffman join and packing.

  1. Tokenize: the per-pixel mode cascade as shifted-tensor ops; token slots
     stay in serial slot order with INVALID_BIN holes (no compaction).
  2. Histogram (scatter-add) and Huffman-table join (gather) per image.
  3. Packing: a grouped fold packs 8 pixels' codes into one bit record, an
     exclusive `jnp.cumsum` gives each record's bit offset, and (capw + 1)
     word scatters place it.  The slot layout is adaptive: 3 run-digit slots
     (runs <= 512 pixels) on the fast path; a device-computed overflow flag
     triggers the full 11-digit layout only when an image has longer runs.
  4. The whole pipeline is batched over same-shape images with per-image
     Huffman tables (`encode_batch`: two dispatches with host tables;
     `encode_fused`: one dispatch with on-device tables).

All arithmetic is integer; `jnp.cumsum` on int32 is exact on every backend.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from nicetpu.format import constants as C
from nicetpu.format import headers
from nicetpu.kernels.bitpack import words_to_payload
from nicetpu.kernels.scan import suffix_min
from nicetpu.kernels.tokenize import assemble_bins, cascade


INVALID_BIN = 1023  # any bin >= C.TOTAL_SYMBOLS (858) means "no token"


def _tokenize_core(img_flat, *, width: int, ndigits_cap: int):
    """(N, 3) -> (bins (M,), overflow): flat token bins in serial slot order
    with INVALID_BIN holes for empty slots.

    No compaction: slot order IS serial token order (SURVEY A.6), and holes
    cost nothing downstream (aob 0 -> zero contribution at a repeated bit
    offset), so no sort is needed.  Bins are built gather-free
    (assemble_bins folds stream bases in).
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

    bins, overflow = assemble_bins(
        cas, run_len, ndigits_cap=ndigits_cap, invalid_bin=INVALID_BIN
    )
    return bins.reshape(-1), overflow


@partial(jax.jit, static_argnames=("width", "ndigits_cap"))
def tokenize_compact(imgs_flat, *, width: int, ndigits_cap: int):
    """Dispatch A (batched): imgs_flat (B, N, 3) uint8.

    Returns (bins (B, M) int32 in serial slot order with INVALID_BIN holes,
    stats (B, 859) int32) where stats = per-image histogram ++ [overflow].
    """
    core = partial(_tokenize_core, width=width, ndigits_cap=ndigits_cap)
    with jax.named_scope("tokenize"):
        bins, overflow = jax.vmap(core)(imgs_flat)
    with jax.named_scope("histogram"):
        counts = _histogram(bins)
    stats = jnp.concatenate([counts, overflow.astype(jnp.int32).reshape(-1, 1)], axis=1)
    return bins, stats


def _histogram(bins):
    """(B, M) bins with INVALID_BIN holes -> (B, 858) int32 counts."""

    def hist1(b):
        live = b < C.TOTAL_SYMBOLS
        return (
            jnp.zeros(C.TOTAL_SYMBOLS, dtype=jnp.int32)
            .at[jnp.where(live, b, 0)]
            .add(live.astype(jnp.int32), mode="drop")
        )

    return jax.vmap(hist1)(bins)


def _join(bins, aob_tbl, code_tbl):
    """Per-image table lookup: (B, M) bins -> (aob (B, M) int32, code (B, M)
    uint32); holes get (0, 0)."""

    def join1(b, at, ct):
        live = b < C.TOTAL_SYMBOLS
        bi = jnp.clip(b, 0, C.TOTAL_SYMBOLS - 1)
        return jnp.where(live, at[bi], 0), jnp.where(live, ct[bi], jnp.uint32(0))

    return jax.vmap(join1)(bins, aob_tbl, code_tbl)


def _place(aob, code, *, w_cap: int):
    """Exclusive-scan offsets + two-word scatter placement (one image)."""
    incl = jnp.cumsum(aob)
    offs = incl - aob
    total_bits = incl[-1]
    w = (offs >> 5).astype(jnp.int32)
    rb = offs & 31
    L = aob
    fits = rb + L <= 32
    k = jnp.where(fits, 0, rb + L - 32)
    shift_hi = jnp.clip(jnp.where(fits, 32 - rb - L, k), 0, 31).astype(jnp.uint32)
    hi = jnp.where(fits, code << shift_hi, code >> shift_hi)
    mask_k = (jnp.uint32(1) << k.astype(jnp.uint32)) - jnp.uint32(1)
    shift_lo = jnp.clip(32 - k, 0, 31).astype(jnp.uint32)
    lo = jnp.where(fits, jnp.uint32(0), (code & mask_k) << shift_lo)
    words = jnp.zeros(w_cap, dtype=jnp.uint32)
    words = words.at[w].add(hi, mode="drop")
    words = words.at[w + 1].add(lo, mode="drop")
    return words, total_bits


def _fold_pixel_records(aob2, code2, capw: int):
    """Per-pixel left-aligned bit records from per-slot (aob, code).

    aob2/code2: (N, S).  Builds only `capw` record words (contents beyond
    32*capw bits are dropped — the caller's overflow check catches it).
    Returns (rec: list of capw (N,) uint32 words, kbits (N,) int32)."""
    N, S = aob2.shape
    rec = [jnp.zeros(N, jnp.uint32) for _ in range(capw)]
    cum = jnp.zeros(N, jnp.int32)
    for s in range(S):
        L = aob2[:, s]
        cd = code2[:, s]
        sw = cum >> 5
        sb = cum & 31
        fits = sb + L <= 32
        k = jnp.where(fits, 0, sb + L - 32)
        shift_hi = jnp.clip(jnp.where(fits, 32 - sb - L, k), 0, 31).astype(jnp.uint32)
        hi = jnp.where(fits, cd << shift_hi, cd >> shift_hi)
        mask_k = (jnp.uint32(1) << k.astype(jnp.uint32)) - jnp.uint32(1)
        shift_lo = jnp.clip(32 - k, 0, 31).astype(jnp.uint32)
        lo = jnp.where(fits, jnp.uint32(0), (cd & mask_k) << shift_lo)
        for j in range(min(capw, s + 2)):  # cum <= 31*s => sw <= s, lo at sw+1
            rec[j] = (
                rec[j]
                | jnp.where(sw == j, hi, jnp.uint32(0))
                | jnp.where(sw == j - 1, lo, jnp.uint32(0))
            )
        cum = cum + L
    return rec, cum


# Grouped fold: 8 consecutive pixels fold into one <= 320-bit record, so
# the final scatter is (GROUP_CAPW+1) words per 8 PIXELS (1.375 updates per
# pixel vs 4/pixel for a per-pixel fold).  320 bits/group = 40 bits
# avg/pixel; RGB-heavy noise runs ~33 bits/pixel, so real images fit.  The
# fold is a single elementwise pass over the group's G*S slots.
GROUP_CAPW = 10
GROUP = 8


def _fold_place_grouped(aob2, code2, *, w_cap: int, capw: int = GROUP_CAPW):
    """Group fold + (capw+1)-word scatter (one image).

    Folds GROUP consecutive pixels' slots into one left-aligned bit record
    (one `_fold_pixel_records` pass over G*S slots), then scatters each
    group record at its exclusive-scan bit offset.  Byte-identical to
    the per-slot `_place` whenever neither path overflows; a group exceeding
    32*capw bits sets the overflow flag (caller falls back to an exact
    path)."""
    N, S = aob2.shape
    G = GROUP
    pad = (-N) % G
    if pad:
        aob2 = jnp.pad(aob2, ((0, pad), (0, 0)))
        code2 = jnp.pad(code2, ((0, pad), (0, 0)))
    M = aob2.shape[0] // G
    rec, k = _fold_pixel_records(
        aob2.reshape(M, G * S), code2.reshape(M, G * S), capw
    )
    overflow = jnp.any(k > 32 * capw)

    incl = jnp.cumsum(k)
    total_bits = incl[-1]
    offs = incl - k

    w = (offs >> 5).astype(jnp.int32)
    r = (offs & 31).astype(jnp.uint32)
    r_nz = r > 0
    words = jnp.zeros(w_cap, dtype=jnp.uint32)
    for j in range(capw + 1):
        cur = rec[j] if j < capw else jnp.zeros(M, jnp.uint32)
        prev = rec[j - 1] if 0 < j <= capw else jnp.zeros(M, jnp.uint32)
        val = cur >> r
        val = val | jnp.where(r_nz, prev << (jnp.uint32(32) - r), jnp.uint32(0))
        words = words.at[w + j].add(val, mode="drop")
    return words, total_bits, overflow


def _fold_place_grouped_batched(aob3, code3, *, w_cap: int, capw: int = GROUP_CAPW):
    """Batched grouped fold + place: (B, N, S) -> (words (B, w_cap), totals
    (B,), overflow (B,))."""
    return jax.vmap(partial(_fold_place_grouped, w_cap=w_cap, capw=capw))(
        aob3, code3
    )


@partial(jax.jit, static_argnames=("w_cap", "slots", "mode"))
def pack_compact(bins, aob_tbl, code_tbl, *, w_cap: int, slots: int, mode: str = "fold"):
    """Dispatch B (batched): join per-image tables, scan offsets, place.

    bins (B, N*slots) with INVALID_BIN holes; aob_tbl (B, 858) int32;
    code_tbl (B, 858) uint32.
    Returns (words (B, w_cap) uint32, total_bits (B,) int32, overflow (B,)).
    """
    with jax.named_scope("join"):
        aob, code = _join(bins, aob_tbl, code_tbl)
    with jax.named_scope("fold_place"):
        if mode == "fold":
            B, M = aob.shape
            aob2 = aob.reshape(B, M // slots, slots)
            code2 = code.reshape(B, M // slots, slots)
            return _fold_place_grouped_batched(aob2, code2, w_cap=w_cap)
        words, totals = jax.vmap(partial(_place, w_cap=w_cap))(aob, code)
        return words, totals, jnp.zeros(words.shape[0], jnp.bool_)


def _bucket(n: int, buckets=(1, 2, 3, 4, 6, 8, 12, 16)) -> int:
    """Round a size up to a stable bucket (limits jit recompiles)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def encode_batch(imgs: np.ndarray) -> list[bytes]:
    """Encode a (B, H, W, 3) uint8 batch of same-shape images on the
    device, with per-image Huffman tables (BASELINE configs 2/4)."""
    from nicetpu.format.huffman import build_tables_host

    if imgs.ndim != 4 or imgs.shape[3] != 3 or imgs.dtype != np.uint8:
        raise ValueError("expected (B, H, W, 3) uint8 batch")
    B, H, W, _ = imgs.shape
    if W < C.MIN_WIDTH:
        raise ValueError(f"width must be >= {C.MIN_WIDTH} (SURVEY A.8.7)")
    N = H * W
    flat = jnp.asarray(imgs.reshape(B, N, 3))

    bins, stats_d = tokenize_compact(flat, width=W, ndigits_cap=3)
    stats = np.asarray(stats_d).astype(np.int64)
    if stats[:, -1].any():  # some run needs > 3 digits: full-layout fallback
        bins, stats_d = tokenize_compact(
            flat, width=W, ndigits_cap=C.MAX_RUN_DIGITS
        )
        stats = np.asarray(stats_d).astype(np.int64)

    counts = stats[:, :-1]  # (B, 858)
    tables = [build_tables_host(counts[b]) for b in range(B)]
    aob_np = np.stack([t[0] for t in tables]).astype(np.int32)
    code_np = np.stack([t[1] for t in tables])
    needed_bits = (counts * aob_np.astype(np.int64)).sum(axis=1)

    needed_words = int(needed_bits.max()) // 32 + 2
    w_cap = max(
        _bucket(-(-needed_words * 8 // max(N, 8))) * (N // 8 + 1) + 2,
        needed_words + 2,
    )
    slots = bins.shape[1] // N

    words_d, totals_d, ovf_d = pack_compact(
        bins, jnp.asarray(aob_np), jnp.asarray(code_np), w_cap=w_cap, slots=slots
    )
    if bool(np.asarray(ovf_d).any()):
        # Rare: some group packs > 32*GROUP_CAPW bits; exact slot-level path.
        words_d, totals_d, _ = pack_compact(
            bins,
            jnp.asarray(aob_np),
            jnp.asarray(code_np),
            w_cap=w_cap,
            slots=slots,
            mode="slots",
        )
    words = np.asarray(words_d)
    totals = np.asarray(totals_d)

    out = []
    for b in range(B):
        total_bits = int(totals[b])
        assert total_bits == int(needed_bits[b]), (b, total_bits, needed_bits[b])
        out.append(
            headers.pack_file_header(W, H, 3)
            + headers.pack_stream_headers(aob_np[b].astype(np.uint8))
            + words_to_payload(words[b], total_bits)
        )
    return out


def encode_fused_core(imgs_flat, *, width: int, ndigits_cap: int, w_cap: int):
    """Traceable body of `encode_fused`: tokenize + histogram + on-device
    Huffman tables + join + fold + place, no jit wrapper — composable into
    larger fused dispatches (decode3's single-dispatch round-trip verify).

    Returns (words (B, w_cap) uint32, lengths (B, 858) int32,
    totals (B,) int32, ovf (B,) bool)."""
    from nicetpu.kernels.huffman_dev import build_tables_device

    core = partial(_tokenize_core, width=width, ndigits_cap=ndigits_cap)
    with jax.named_scope("tokenize"):
        bins, run_ovf = jax.vmap(core)(imgs_flat)
    with jax.named_scope("histogram"):
        counts = _histogram(bins)
    with jax.named_scope("huffman_tables"):
        lengths, codes, len_ovf = build_tables_device(counts)
    with jax.named_scope("join"):
        aob, code = _join(bins, lengths, codes)

    B, M = aob.shape
    slots = M // imgs_flat.shape[1]
    aob2 = aob.reshape(B, M // slots, slots)
    code2 = code.reshape(B, M // slots, slots)
    # Grouped fold: 8 pixels per scattered record (11 updates / 8 pixels vs
    # 4/pixel); 320-bit group cap = 40 bits avg/pixel, so long RGB-residual
    # pixels borrow headroom from their group instead of overflowing a
    # per-pixel cap.
    with jax.named_scope("fold_place"):
        words, totals, fold_ovf = _fold_place_grouped_batched(aob2, code2, w_cap=w_cap)

    cap_ovf = totals > jnp.int32(32 * (w_cap - 2))
    ovf = run_ovf | len_ovf | fold_ovf | cap_ovf
    return words, lengths, totals, ovf


@partial(jax.jit, static_argnames=("width", "ndigits_cap", "w_cap"))
def encode_fused(imgs_flat, *, width: int, ndigits_cap: int, w_cap: int):
    """Whole encode as ONE device dispatch: tokenize + histogram + on-device
    Huffman tables (kernels/huffman_dev.py) + join + fold + place.

    No host round-trip between histogram and packing (the two-dispatch
    `encode_batch` syncs once to build its tables on the host).

    imgs_flat: (B, N, 3) uint8.  Returns (words (B, w_cap) uint32,
    small (B, 860) int32) where small = per-image [flat code lengths (858),
    total payload bits, overflow flag].  When the overflow flag is set (run
    needs > ndigits_cap digits, a group packs > 32*GROUP_CAPW bits, or a
    Huffman length exceeds 31 bits) the caller must fall back to an exact
    host path; the fused outputs for that image are not usable.
    """
    words, lengths, totals, ovf = encode_fused_core(
        imgs_flat, width=width, ndigits_cap=ndigits_cap, w_cap=w_cap
    )
    small = jnp.concatenate(
        [lengths, totals[:, None], ovf.astype(jnp.int32)[:, None]], axis=1
    )
    return words, small


def encode_jax_v2(img: np.ndarray) -> bytes:
    """Encode an (H, W, 3) uint8 image on the device (batch of one)."""
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError("expected (H, W, 3) uint8 image")
    return encode_batch(img[None])[0]
