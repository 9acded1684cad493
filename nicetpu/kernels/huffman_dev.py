"""On-device Huffman table construction (all 10 streams, batched).

Device twin of `nicetpu.format.huffman`: given per-image flat histograms it
produces the SAME code lengths and canonical codes as the host builder —
byte-identical bitstreams — entirely inside one XLA program, so a whole
encode becomes a single device dispatch with no host round-trip for table
building.

Semantics (must match `format.huffman._huffman_lengths_once`, which itself
defines this repo's deterministic replacement for the reference's
unspecified Rust BinaryHeap order, ref hfe.rs:62-84 / SURVEY §7.3.4):

  * every live symbol starts a leaf node with aob 1; repeatedly merge the two
    minimum nodes until 2 remain (the skipped root merge is what the aob=1
    init accounts for, ref hfe.rs:62/72),
  * node order is lexicographic (weight asc, leaves before internals,
    min-symbol-under-node asc).  The host heap always pops the global
    minimum, so a masked global argmin reproduces its merge sequence exactly
    (min-symbol is unique among live nodes, making the key total).

The merge loop is a `lax.fori_loop` over max(n)-2 iterations with all 10
streams (and B images) running as vector lanes; streams with smaller
alphabets go inactive once their merges are done.  Code lengths > 31 bits
cannot be written to the 5-bit max_aob header field (SURVEY §2.3.4); the
kernel returns an overflow flag and the caller falls back to the host
package-merge path (`format.huffman.code_lengths`).

Canonical code assignment matches `format.huffman.canonical_codes`
((length asc, symbol asc), counting up from 0 — the verified-equivalent form
of ref hfe.rs:255-296).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from nicetpu.format import constants as C

NSTREAMS = C.NUM_STREAMS
PMAX = max(C.ALPHABET_SIZES)  # 343
NODES = 2 * PMAX  # leaves [0, PMAX) + internals [PMAX, PMAX + PMAX-2)
BIG = jnp.int32(2**31 - 1)

_SIZES = np.asarray(C.ALPHABET_SIZES, dtype=np.int32)  # (10,)


def _counts_to_streams(flat_counts: jnp.ndarray) -> jnp.ndarray:
    """(B, 858) -> (B, 10, PMAX) with dead lanes zero."""
    B = flat_counts.shape[0]
    out = jnp.zeros((B, NSTREAMS, PMAX), flat_counts.dtype)
    for s in range(NSTREAMS):
        base, size = C.STREAM_BASE[s], C.ALPHABET_SIZES[s]
        out = out.at[:, s, :size].set(flat_counts[:, base : base + size])
    return out


def _streams_to_flat(per_stream: jnp.ndarray) -> jnp.ndarray:
    """(B, 10, PMAX) -> (B, 858)."""
    parts = [
        per_stream[:, s, : C.ALPHABET_SIZES[s]] for s in range(NSTREAMS)
    ]
    return jnp.concatenate(parts, axis=1)


def _argmin_node(w, internal, min_sym, live):
    """Global argmin by (w asc, internal asc, min_sym asc) over live nodes.

    Returns (idx, w_min).  min_sym is unique among live nodes, so the key is
    total and the result deterministic — the exact heap pop order of the
    host builder.
    """
    w_m = jnp.where(live, w, BIG)
    m1 = jnp.min(w_m, axis=-1, keepdims=True)
    c1 = live & (w_m == m1)
    i_m = jnp.where(c1, internal, jnp.int32(2))
    m2 = jnp.min(i_m, axis=-1, keepdims=True)
    c2 = c1 & (i_m == m2)
    s_m = jnp.where(c2, min_sym, BIG)
    m3 = jnp.min(s_m, axis=-1, keepdims=True)
    idx = jnp.argmax(c2 & (s_m == m3), axis=-1)
    return idx, jnp.squeeze(m1, -1)


def _merge_lengths(cs: jnp.ndarray) -> jnp.ndarray:
    """Min-variance Huffman merge for (B, 10, PMAX) per-stream counts.

    Returns (B, 10, PMAX) int32 lengths (>= 1 on live lanes, 0 on dead)."""
    B = cs.shape[0]
    sym_ids = jnp.arange(PMAX, dtype=jnp.int32)
    is_live_sym = sym_ids[None, :] < _SIZES[:, None]  # (10, PMAX)
    live0 = jnp.broadcast_to(is_live_sym, (B, NSTREAMS, PMAX))

    node_w = jnp.concatenate(
        [jnp.where(live0, cs, 0), jnp.zeros((B, NSTREAMS, PMAX), jnp.int32)], -1
    )
    node_min = jnp.concatenate(
        [
            jnp.broadcast_to(sym_ids, (B, NSTREAMS, PMAX)),
            jnp.full((B, NSTREAMS, PMAX), BIG),
        ],
        -1,
    )
    node_internal = jnp.concatenate(
        [jnp.zeros((B, NSTREAMS, PMAX), jnp.int32), jnp.ones((B, NSTREAMS, PMAX), jnp.int32)],
        -1,
    )
    node_live = jnp.concatenate(
        [live0, jnp.zeros((B, NSTREAMS, PMAX), jnp.bool_)], -1
    )
    node_of_sym = jnp.broadcast_to(sym_ids, (B, NSTREAMS, PMAX))
    lengths = jnp.where(live0, 1, 0)

    merges_needed = (_SIZES - 2)[None, :]  # (1, 10)

    def body(it, state):
        node_w, node_min, node_live, node_of_sym, lengths = state
        active = (it < merges_needed)[..., None]  # (1, 10, 1) -> broadcast

        ia, wa = _argmin_node(node_w, node_internal, node_min, node_live)
        live2 = node_live & (
            jnp.arange(NODES)[None, None, :] != ia[..., None]
        )
        ib, wb = _argmin_node(node_w, node_internal, node_min, live2)

        take_a = jnp.take_along_axis  # alias
        min_a = jnp.squeeze(take_a(node_min, ia[..., None], -1), -1)
        min_b = jnp.squeeze(take_a(node_min, ib[..., None], -1), -1)

        m = PMAX + it  # new internal node id (static per iteration lane)
        node_arange = jnp.arange(NODES)[None, None, :]
        is_m = node_arange == m

        under = (node_of_sym == ia[..., None]) | (node_of_sym == ib[..., None])
        under = under & active
        lengths = lengths + under.astype(jnp.int32)
        node_of_sym = jnp.where(under, m, node_of_sym)

        rm = (node_arange == ia[..., None]) | (node_arange == ib[..., None])
        node_live = jnp.where(active, node_live & ~rm | is_m, node_live)
        node_w = jnp.where(
            active & is_m, (wa + wb)[..., None], node_w
        )
        node_min = jnp.where(
            active & is_m, jnp.minimum(min_a, min_b)[..., None], node_min
        )
        return node_w, node_min, node_live, node_of_sym, lengths

    state = (node_w, node_min, node_live, node_of_sym, lengths)
    state = jax.lax.fori_loop(0, PMAX - 2, body, state)
    return state[4]


def code_lengths_device(counts: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Huffman code lengths for all streams of a batch of images.

    counts: (B, 858) int32 flat histograms.
    Implements the same length-limiting clamp as the host
    (`format.huffman.code_lengths`): streams whose raw merge exceeds the
    31-bit header limit get every count clamped up to `clamp_floor(total)`
    and re-merged (`lax.cond`-gated so the clean case pays nothing).

    Returns (flat_lengths (B, 858) int32 >= 1, overflow (B,) bool — true
    only if a clamped stream STILL exceeds 31 bits, which the Fibonacci
    bound rules out; kept as a safety net for a host fallback).
    """
    cs = _counts_to_streams(counts.astype(jnp.int32))  # (B, 10, PMAX)
    lengths = _merge_lengths(cs)

    ovf_stream = jnp.any(lengths > C.MAX_CODE_LEN, axis=-1)  # (B, 10)
    totals = jnp.sum(cs, axis=-1)  # (B, 10)
    floor_w = (totals >> 20) + 1  # format.huffman.clamp_floor
    cs2 = jnp.where(
        ovf_stream[..., None], jnp.maximum(cs, floor_w[..., None]), cs
    )
    lengths = jax.lax.cond(
        jnp.any(ovf_stream), _merge_lengths, lambda _: lengths, cs2
    )

    overflow = jnp.any(lengths > C.MAX_CODE_LEN, axis=(1, 2))
    return _streams_to_flat(lengths), overflow


def canonical_codes_device(flat_lengths: jnp.ndarray) -> jnp.ndarray:
    """Canonical codes, (length asc, symbol asc) counting up from 0.

    flat_lengths: (B, 858) int32 (>= 1 for live symbols).
    Returns (B, 858) uint32 codes (valid in the low `length` bits).
    """
    ls = _counts_to_streams(flat_lengths)  # (B, 10, PMAX); dead lanes 0
    L = C.MAX_CODE_LEN + 1  # lengths 0..31; 0 = dead lane

    oh = (ls[..., None] == jnp.arange(1, L + 1)[None, None, None, :]).astype(
        jnp.int32
    )  # (B, 10, PMAX, L) one-hot over length-1
    cnt = jnp.sum(oh, axis=2)  # (B, 10, L) count of symbols per length

    # first_code[l] = (first_code[l-1] + cnt[l-1]) << 1, first_code[min] = 0
    def scan_fn(carry, c):
        first = (carry[0] + carry[1]) * 2
        return (first, c), first

    (_, _), firsts = jax.lax.scan(
        scan_fn,
        (jnp.zeros(cnt.shape[:2], jnp.int32), jnp.zeros(cnt.shape[:2], jnp.int32)),
        jnp.moveaxis(cnt, -1, 0),
    )
    firsts = jnp.moveaxis(firsts, 0, -1)  # (B, 10, L); firsts[..., l-1]
    # firsts computed as: for l=1: (0+0)*2 = 0 ✓; for l: (first[l-1]+cnt[l-1])*2

    # rank among same-length symbols, symbol asc = exclusive cumsum of one-hot
    rank = jnp.cumsum(oh, axis=2) - oh  # (B, 10, PMAX, L)
    own = jnp.sum((rank + 0) * oh, axis=-1)  # rank at own length
    first_own = jnp.sum(firsts[:, :, None, :] * oh, axis=-1)
    codes = (first_own + own).astype(jnp.uint32)
    codes = jnp.where(ls > 0, codes, 0)
    return _streams_to_flat(codes)


@jax.jit
def build_tables_device(counts: jnp.ndarray):
    """(B, 858) histograms -> (lengths (B,858) i32, codes (B,858) u32,
    overflow (B,) bool).  Byte-identical to format.huffman.build_all_tables
    whenever overflow is False."""
    lengths, overflow = code_lengths_device(counts)
    codes = canonical_codes_device(lengths)
    return lengths, codes, overflow
