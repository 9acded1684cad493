"""Sharded `.nice` encode over a device mesh (data parallelism over row blocks).

Design (SURVEY §2.2): the raster is sharded into contiguous row blocks across
the mesh's data axis.  Each device:
  1. receives its 4-row halo from the previous device via `ppermute`,
  2. tokenizes its block locally (mode decisions depend only on input bytes,
     SURVEY §3.1, so shard-local tokenization composes exactly),
  3. fixes cross-shard run lengths with one tiny `all_gather` of per-shard
     first-change indices,
  4. contributes to the per-image global histogram via `psum`,
  5. bit-packs its own token range locally.
Huffman tables are built once from the psum'd histogram (identical on every
host — deterministic builder) and broadcast as replicated inputs.  Final
payload assembly concatenates the shards' bitstreams in shard order on the
host, bit-shifting each to its global offset (exclusive scan of shard bit
totals — the "ordered gather" of SURVEY §2.2).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nicetpu.format import constants as C
from nicetpu.format import headers
from nicetpu.kernels.scan import suffix_min
from nicetpu.kernels.tokenize import assemble_bins, cascade, halo_pixels, histogram_bins


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), ("d",))


def _tokenize_block(img_block, *, width: int, rows_per: int, n_dev: int):
    """shard_map body: img_block (rows_per, W, 3) uint8 on each device.

    Returns (bins (n_local, S) with INVALID holes, counts_psum).
    """
    W = width
    n_local = rows_per * W
    halo = halo_pixels(W)
    N = n_dev * n_local

    dev = jax.lax.axis_index("d")
    g0 = dev.astype(jnp.int32) * n_local

    x = img_block.reshape(n_local, 3).astype(jnp.int32)
    # Halo: previous device's last 4 rows (device 0 keeps zeros; its halo
    # reads are masked by the pos >= offset validity tests).
    tail = x[n_local - halo :, :]
    halo_rows = jax.lax.ppermute(
        tail, "d", [(i, i + 1) for i in range(n_dev - 1)]
    )
    x_ext = jnp.concatenate([halo_rows, x], axis=0)

    cas = cascade(x_ext, g0, n_local, width=W, halo=halo)

    pos = cas["pos"]
    enc = cas["changed"]
    change_idx = jnp.where(enc, pos, N)
    sfx = suffix_min(change_idx)
    # First change in this shard (global index; N if none — can't happen
    # since pixel 0 of... a shard may be fully run-covered, so N is possible).
    first_change = sfx[0]
    # Gather every shard's first change; tail fix = min over later shards.
    all_first = jax.lax.all_gather(first_change, "d")  # (n_dev,)
    later = jnp.where(jnp.arange(n_dev) > dev, all_first, N)
    tail_change = jnp.min(later)
    next_change = jnp.minimum(
        jnp.concatenate([sfx[1:], jnp.array([N], jnp.int32)]), tail_change
    )
    run_len = next_change - pos - 1

    bins, _ = assemble_bins(
        cas, run_len, ndigits_cap=C.MAX_RUN_DIGITS, invalid_bin=C.TOTAL_SYMBOLS
    )
    counts = jax.lax.psum(histogram_bins(bins), "d")
    return bins.reshape(-1), counts


def _pack_block(bins, aob_lut, code_lut, *, w_cap: int):
    """shard_map body: per-device local bit-pack of its own token range."""
    from nicetpu.kernels.encode2 import _place

    live = bins < C.TOTAL_SYMBOLS
    bi = jnp.clip(bins, 0, C.TOTAL_SYMBOLS - 1)
    aob = jnp.where(live, aob_lut[bi], 0)
    code = jnp.where(live, code_lut[bi], jnp.uint32(0))
    words, total_bits = _place(aob, code, w_cap=w_cap)
    return words, total_bits.reshape(1)


@lru_cache(maxsize=8)  # a rebuilt jit recompiles
def build_sharded_encode(mesh: Mesh, height: int, width: int):
    """Returns jitted (tokenize_fn, pack_fn) for (height, width) rasters
    sharded by rows over mesh axis 'd'."""
    n_dev = mesh.devices.size
    if height % n_dev:
        raise ValueError(f"height {height} not divisible by {n_dev} devices")
    rows_per = height // n_dev
    n_local = rows_per * width
    # Local payload can't exceed ~62 bits/pixel even in adversarial streams
    # (5 tokens + digits, lengths <= 31 amortized against run structure);
    # stitch_payload asserts the actual totals fit.
    w_cap = 2 * n_local + 64

    tok = jax.jit(
        jax.shard_map(
            partial(_tokenize_block, width=width, rows_per=rows_per, n_dev=n_dev),
            mesh=mesh,
            in_specs=P("d", None, None),
            out_specs=(P("d"), P()),
            check_vma=False,
        )
    )
    pack = jax.jit(
        jax.shard_map(
            partial(_pack_block, w_cap=w_cap),
            mesh=mesh,
            in_specs=(P("d"), P(), P()),
            out_specs=(P("d"), P("d")),
            check_vma=False,
        )
    )
    return tok, pack


def stitch_payload(
    shard_words: np.ndarray, shard_bits: np.ndarray, n_dev: int
) -> tuple[bytes, int]:
    """Host-side ordered gather: concatenate per-shard bitstreams at their
    global bit offsets (exclusive scan of shard totals)."""
    words_per = shard_words.shape[0] // n_dev
    if int(shard_bits.max()) > 32 * words_per:
        raise ValueError(
            "shard payload exceeded its word capacity; re-run with a larger "
            "w_cap (pathological bits/pixel)"
        )
    total_bits = int(shard_bits.sum())
    out = np.zeros((total_bits + 31) // 32 + 2, dtype=np.uint64)
    base = 0
    for d in range(n_dev):
        bits = int(shard_bits[d])
        if bits == 0:
            continue
        w = shard_words[d * words_per : d * words_per + (bits + 31) // 32].astype(
            np.uint64
        )
        sw, sb = base >> 5, base & 31
        if sb == 0:
            out[sw : sw + len(w)] |= w
        else:
            out[sw : sw + len(w)] |= w >> sb
            out[sw + 1 : sw + 1 + len(w)] |= (w << (32 - sb)) & 0xFFFFFFFF
        base += bits
    return out.astype(np.uint32).astype(">u4").tobytes(), total_bits


def encode_sharded(
    img: np.ndarray, mesh: Mesh, fetch=np.asarray, gather=None
) -> bytes:
    """Full sharded encode of an (H, W, 3) uint8 image over the mesh.

    `fetch` reads a device array back to host numpy — the default works for
    fully-addressable (single-process) arrays; dist.multihost passes a
    replicating fetch for cross-process meshes.  `gather(words, bits) ->
    (shard_words, shard_bits)` overrides the payload fetch entirely
    (dist.multihost's bounded-memory ordered gather, SURVEY §7.3.6).
    """
    from nicetpu.format.huffman import build_tables_host

    H, W, _ = img.shape
    n_dev = mesh.devices.size
    tok, pack = build_sharded_encode(mesh, H, W)

    sharding = NamedSharding(mesh, P("d", None, None))
    dev_img = jax.device_put(img, sharding)
    bins, counts = tok(dev_img)

    counts_np = np.asarray(counts).astype(np.int64)
    flat_lengths, flat_codes = build_tables_host(counts_np)
    needed_bits = int((counts_np * flat_lengths.astype(np.int64)).sum())

    rep = NamedSharding(mesh, P())
    aob = jax.device_put(jnp.asarray(flat_lengths.astype(np.int32)), rep)
    codes = jax.device_put(jnp.asarray(flat_codes), rep)
    words, bits = pack(bins, aob, codes)

    if gather is not None:
        w_np, bits_np = gather(words, bits)
    else:
        w_np, bits_np = fetch(words), fetch(bits)
    payload, total_bits = stitch_payload(w_np, bits_np, n_dev)
    assert total_bits == needed_bits, (total_bits, needed_bits)

    n_bytes = total_bits // 8
    B = payload[n_bytes] if total_bits % 8 else 0
    return (
        headers.pack_file_header(W, H, 3)
        + headers.pack_stream_headers(flat_lengths)
        + payload[:n_bytes]
        + bytes([B, B, 0, 0, 0])
    )
