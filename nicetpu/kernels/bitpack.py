"""Parallel bit-pack as a hierarchical bitstring merge (scatter-free).

Data-parallel replacement of the reference's serial Bitwriter loop
(ref hfe.rs:110-113, bitwriter.rs:55-73).  Rather than scattering each code at
an exclusive-scanned bit offset, packing is a log-depth reduction: every token is a left-aligned
bitstring; adjacent bitstrings are concatenated pairwise level by level.

Layout invariants:
  * level k node i occupies the 2^k u32 words [i*2^k, (i+1)*2^k) of a flat
    (M,) buffer, bits left-aligned (bit 0 = MSB of word 0), zero-padded.
  * 2^k words always suffice: node bit length <= 31 * 2^k < 32 * 2^k
    (code lengths are capped at 31 by the 5-bit max_aob field, SURVEY §2.3.4).
  * merging node pairs is IN-PLACE in the flat buffer: the left child already
    sits in the low half of the parent's region; the right child's words are
    gathered, funnel-shifted right by the left length, and OR-ed in.

The whole pack is a lax.fori_loop over log2(M) levels of pure gathers and
element-wise ops — no scatter, no cumsum, tiny compiled program.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from nicetpu.format import constants as C


@partial(jax.jit, static_argnames=("levels",))
def merge_pack(aob: jnp.ndarray, code: jnp.ndarray, *, levels: int):
    """Pack M = 2^levels tokens (aob int32 lengths, code uint32 right-aligned)
    into a flat (M,) uint32 word buffer.  Invalid/padding tokens use aob 0.

    Returns (words, total_bits): the payload is the first ceil(total/32)
    words, bits MSB-first.
    """
    M = 1 << levels
    assert aob.shape == (M,) and code.shape == (M,)
    shift0 = jnp.clip(32 - aob, 0, 31).astype(jnp.uint32)
    buf = jnp.where(aob > 0, code << shift0, jnp.uint32(0))
    lens = aob.astype(jnp.int32)
    pos = jnp.arange(M, dtype=jnp.int32)

    def level(k, carry):
        buf, lens = carry
        mask = (jnp.int32(1) << (k + 1)) - 1
        half = jnp.int32(1) << k
        node_base = pos & ~mask
        j = pos & mask
        La = lens[node_base]
        Lb = lens[node_base + half]
        sw = La >> 5
        sb = (La & 31).astype(jnp.uint32)
        src = j - sw
        b_idx = node_base + half + src
        g1 = jnp.where(
            (src >= 0) & (src < half), buf[jnp.clip(b_idx, 0, M - 1)], jnp.uint32(0)
        )
        g2 = jnp.where(
            (src >= 1) & (src <= half), buf[jnp.clip(b_idx - 1, 0, M - 1)], jnp.uint32(0)
        )
        sh = jnp.where(sb > 0, (g1 >> sb) | (g2 << (jnp.uint32(32) - sb)), g1)
        a_part = jnp.where(j < half, buf, jnp.uint32(0))
        new_buf = a_part | sh
        new_lens = jnp.where(j == 0, La + Lb, lens)
        return new_buf, new_lens

    buf, lens = jax.lax.fori_loop(0, levels, level, (buf, lens))
    return buf, lens[0]


def words_to_payload(words: np.ndarray, total_bits: int) -> bytes:
    """Host-side: big-endian word dump -> payload bytes + 5-byte flush tail
    [B, B, 0, 0, 0] (SURVEY A.1/A.6)."""
    n_bytes = (total_bits + 7) // 8
    raw = words[: (n_bytes + 3) // 4 + 1].astype(">u4").tobytes()
    full = total_bits // 8
    B = raw[full] if total_bits % 8 else 0
    return raw[:full] + bytes([B, B, 0, 0, 0])
