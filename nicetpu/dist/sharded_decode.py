"""Sharded `.nice` decode over a device mesh.

Two shardings (SURVEY §2.2 / §5):

* **Batch mode** (`decode_batch_sharded`): a same-shape batch is sharded one
  image per device along the batch axis — every phase of the v3 decoder is
  batch-parallel, so XLA partitions it with zero collectives.

* **Single-raster mode** (`decode_sharded`): ONE bitstream decoded across
  the mesh.  The shard body runs the same walk as the single-device path
  (`decode3.walk_batch`: the GPU kernel on a GPU mesh, the plain scan on
  the virtual CPU mesh), with `chunk0` telling it which global chunks its
  local word slice holds.  The speculative chunk walk is sharded by chunk
  ranges (each device holds only its slice of the payload words + a small
  halo); entry propagation between walk rounds crosses shards with a
  `ppermute` of one scalar per device — the same anchored-induction
  consistency gate as the single-device path, with its boundary checks
  crossing devices.  Slot-space assembly uses local cumsums + tiny
  `all_gather`s of per-shard totals for the global offsets (digit count,
  coverage) and a cross-shard running max for the digit->pixel attachment.
  Reconstruction is row-sharded: records are all_gathered (the
  ordered-gather analogue), each device keeps its row block, and the 4-row
  carry (the deepest predictor reach, ref code.rs:141-145) pipelines
  device-to-device via `ppermute` — the halo'd sharded reconstruction
  SURVEY §5 plans.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nicetpu.format import constants as C
from nicetpu.kernels import decode3 as d3
from nicetpu.kernels.decode_dev import F_ADD1, _const_offsets, _sel, reconstruct_rows


def _unpack_rec(recN, width: int):
    offs = _const_offsets(width)
    form = recN & 7
    refi = (recN >> 3) & 15
    # channel-planar (3, n_local) — see decode_dev.reconstruct_rows layout
    delta = jnp.stack(
        [(recN >> 7) & 255, (recN >> 15) & 255, (recN >> 23) & 255], axis=0
    )
    refoff = _sel(refi, (0,) + tuple(offs))
    return form, delta, refoff


def _decode_shard_body(
    words_l, wbits1, af, present, ib, pfx, sym_tbl,
    *, n_pixels, width, height, chunk_bits, steps, maxl, segs, rounds, n_dev, nlc,
):
    """shard_map body: one device's slice of the single-raster decode.

    words_l: (nlc * chunk_bits/32 + LOOKAHEAD_WORDS,) int32 local words
    (with halo); tables replicated.  Returns (rows_block (3, n_local) uint8
    channel-planar, ok (1,))."""
    dev = jax.lax.axis_index("d")
    words_l = words_l.reshape(-1)  # shard_map local leading dim
    wbits = wbits1[0]
    chunk0 = dev * nlc
    starts = (chunk0 + jnp.arange(nlc, dtype=jnp.int32)) * chunk_bits
    fwd = [(i, i + 1) for i in range(n_dev - 1)]
    aff, dD, inc = d3.derive_walk_tables(
        af[None], present[None], ib[None]
    )  # (1, 10, 32) each

    def walk(e):
        recs = d3.walk_batch(
            words_l[None], e[None], aff, dD, inc, pfx, wbits[None],
            chunk0[None], chunk_bits=chunk_bits, steps=steps, maxl=maxl,
        )
        return tuple(r[0] for r in recs)

    # Speculative rounds with cross-shard entry propagation (anchor: device
    # 0's first entry is bit 0 — ppermute delivers 0 to device 0's slot).
    e = starts
    for _ in range(rounds - 1):
        _, _, _, _, exits = walk(e)
        prev_exit = jax.lax.ppermute(exits[-1:], "d", fwd)
        e = jnp.concatenate([prev_exit, exits[:-1]])
    pos, sym, i12, i34, ex2 = walk(e)

    # Gates (single-chip logic + the shard boundary via one more ppermute)
    prev_exit2 = jax.lax.ppermute(ex2[-1:], "d", fwd)[0]
    ok_in = (ex2[:-1] == e[1:]) | (ex2[:-1] >= wbits)
    first_ok = (prev_exit2 == e[0]) | (prev_exit2 >= wbits) | (dev == 0)
    bounds = starts + chunk_bits
    walked = e < wbits
    crossed = ex2 >= jnp.minimum(bounds, wbits)
    ok_local = jnp.all(ok_in) & first_ok & jnp.all(crossed | ~walked)
    ok_walk = jnp.min(jax.lax.all_gather(ok_local.astype(jnp.int32), "d")) > 0

    # slot-space assembly with cross-shard offsets
    S_l = nlc * steps
    posf = pos.reshape(S_l)
    symf = sym.reshape(S_l)
    i12f = i12.reshape(S_l)
    i34f = i34.reshape(S_l)
    valid = (posf >= 0) & (posf < wbits)
    is_pfx = valid & (symf < C.PREFIX_RUN_BASE)
    is_dig = valid & (symf >= C.PREFIX_RUN_BASE)

    def xoffset(total):
        alltot = jax.lax.all_gather(total, "d")  # (n_dev,)
        return jnp.sum(jnp.where(jnp.arange(n_dev) < dev, alltot, 0))

    cd_loc = jnp.cumsum(is_dig.astype(jnp.int32))
    cd = cd_loc + xoffset(cd_loc[-1])
    m_loc = jax.lax.cummax(jnp.where(is_pfx, cd, -1))
    allm = jax.lax.all_gather(m_loc[-1], "d")
    prevm = jnp.max(jnp.where(jnp.arange(n_dev) < dev, allm, -1))
    cd_base = jnp.maximum(m_loc, prevm)
    kk = cd - cd_base - 1
    dig_ok = is_dig & (cd_base >= 0) & (kk >= 0) & (kk < C.MAX_RUN_DIGITS)
    kcl = jnp.clip(kk, 0, C.MAX_RUN_DIGITS - 1)
    dv = symf - C.PREFIX_RUN_BASE
    dv = jnp.where(kcl == C.MAX_RUN_DIGITS - 1, jnp.minimum(dv, 1), dv)
    cov = is_pfx.astype(jnp.int32) + jnp.where(
        dig_ok, (dv << (3 * kcl)) + (kk == 0), 0
    )
    cov = jnp.minimum(cov, n_pixels)
    inc_loc = jnp.cumsum(cov)
    start = inc_loc - cov + xoffset(inc_loc[-1])
    real = is_pfx & (start < n_pixels)
    total_cov = jax.lax.psum(inc_loc[-1], "d")
    ok_cov = total_cov >= n_pixels

    # payload symbols (per-slot gathers from tiny tables)
    bins = d3._payload_bins(symf[None], i12f[None], i34f[None])
    syms = [d3._sym_join(b, sym_tbl[None])[0] for b in bins]
    rec, dst = d3.slot_records(
        is_pfx, symf, syms[0], syms[1], syms[2], syms[3], start, real,
        n_pixels, width,
    )

    # row-sharded reconstruction: all_gather ordered records, keep my rows,
    # pipeline the 4-row carry device-to-device
    rec_g = jax.lax.all_gather(rec, "d").reshape(-1)
    dst_g = jax.lax.all_gather(dst, "d").reshape(-1)
    rows_per = height // n_dev
    n_local = rows_per * width
    base = dev * n_local
    mine = (dst_g >= base) & (dst_g < base + n_local)
    idx = jnp.where(mine, dst_g - base, n_local)
    recN = (
        jnp.full(n_local + 1, F_ADD1, jnp.int32).at[idx].set(
            jnp.where(mine, rec_g, F_ADD1), mode="drop"
        )[:n_local]
    )
    form, delta, refoff = _unpack_rec(recN, width)

    def stage_step(stage, state):
        # stage k: device k reconstructs its block from the carry device
        # k-1 sent, then hands its last 4 rows on (one program copy of the
        # row scan for all stages)
        carry, out = state
        blk, tail = reconstruct_rows(
            form, delta, refoff, n_local, width, segs, prev4=carry
        )
        active = dev == stage
        out = jnp.where(active, blk, out)
        carry = jax.lax.ppermute(jnp.where(active, tail, 0), "d", fwd)
        return carry, out

    _, out = jax.lax.fori_loop(
        0, n_dev, stage_step,
        (jnp.zeros((3, 4 * width), jnp.int32), jnp.zeros((3, n_local), jnp.int32)),
    )
    ok = ok_walk & ok_cov
    return out.astype(jnp.uint8), ok[None]


def build_sharded_decode(
    mesh: Mesh, height: int, width: int, wbits_max: int,
    *, chunk_bits: int = d3.CHUNK_BITS, steps_div: int = d3.STEPS_DIV, rounds: int = 3,
    maxl=d3.WALK_MAXL,
):
    """Jitted shard_map decode for (height, width) rasters on mesh axis 'd',
    with each device's chunk count `nlc` bucketed (`decode3.bucket_chunks`)
    so that payloads of nearly one size share one program.  Returns (fn,
    nlc, steps)."""
    n_dev = mesh.devices.size
    if height % n_dev or (height // n_dev) < 4:
        raise ValueError(f"height {height} must split into >= 4-row blocks over {n_dev}")
    nch = max(1, -(-wbits_max // chunk_bits))
    nlc = d3.bucket_chunks(-(-nch // n_dev))
    steps = d3._steps(chunk_bits, steps_div)
    fn = _sharded_decode_program(
        mesh, height, width, nlc,
        chunk_bits=chunk_bits, steps=steps, rounds=rounds, maxl=maxl,
    )
    return fn, nlc, steps


@lru_cache(maxsize=8)  # a rebuilt jit recompiles
def _sharded_decode_program(
    mesh: Mesh, height: int, width: int, nlc: int,
    *, chunk_bits: int, steps: int, rounds: int, maxl,
):
    n_dev = mesh.devices.size
    body = partial(
        _decode_shard_body,
        n_pixels=height * width,
        width=width,
        height=height,
        chunk_bits=chunk_bits,
        steps=steps,
        maxl=maxl,
        segs=d3._segs_for(width),
        rounds=rounds,
        n_dev=n_dev,
        nlc=nlc,
    )
    return jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P("d"), P(), P(), P(), P(), P(), P()),
            out_specs=(P(None, "d"), P("d")),
            check_vma=False,
        )
    )


def decode_sharded(
    data: bytes, mesh: Mesh, *, rounds: int = 3,
    steps_div: int = d3.STEPS_DIV, fetch=np.asarray
) -> np.ndarray:
    """Decode one `.nice` stream sharded across the mesh (single-raster
    mode).  Falls back to the host spec decoder if the device gates fail.

    `fetch` reads a device array back to host numpy — the default works for
    fully-addressable (single-process) arrays; dist.multihost passes a
    replicating fetch for cross-process meshes (SURVEY §2.2 ordered
    gather analogue for the decoded raster)."""
    from nicetpu.format import headers, huffman

    W, H, channels = headers.parse_file_header(data)
    if channels != 3:
        raise ValueError("only channels=3 decode is defined (SURVEY A.8.3)")
    n_dev = mesh.devices.size
    if H % n_dev or (H // n_dev) < 4 or W < C.MIN_WIDTH:
        # unshardable geometry on this mesh: decode on the host instead of
        # failing — same contract as the gate-failure fallback
        from nicetpu.spec import codec

        return codec.decode(data)
    flat_lengths = headers.parse_stream_headers(data[C.FILE_HEADER_BYTES :])
    huffman.validate_flat_lengths(flat_lengths)
    af, present, ib, pfx16, sym_tbl = d3.prepare_tables_v3(flat_lengths)

    payload = data[C.FILE_HEADER_BYTES + C.STREAM_HEADERS_BYTES : len(data) - 4]
    wbits = len(payload) * 8
    chunk_bits = d3.CHUNK_BITS
    fn, nlc, steps = build_sharded_decode(
        mesh, H, W, wbits, rounds=rounds, steps_div=steps_div,
    )
    wpc = chunk_bits // 32
    look = d3.LOOKAHEAD_WORDS
    flat = np.zeros(n_dev * nlc * wpc + look, dtype=np.uint32)
    src = np.frombuffer(payload + b"\0" * ((-len(payload)) % 4), dtype=">u4")
    flat[: len(src)] = src
    words_l = np.stack(
        [flat[d * nlc * wpc : (d + 1) * nlc * wpc + look] for d in range(n_dev)]
    )

    shard = NamedSharding(mesh, P("d"))
    rep = NamedSharding(mesh, P())
    dput = lambda x, s: jax.device_put(jnp.asarray(x), s)
    out, ok = fn(
        dput(words_l.view(np.int32), shard),
        dput(np.array([wbits], np.int32), rep),
        dput(af.view(np.int32), rep),
        dput(present.astype(np.int32), rep),
        dput(ib.astype(np.int32), rep),
        dput(pfx16, rep),
        dput(sym_tbl, rep),
    )
    if not bool(fetch(ok).all()):
        from nicetpu.spec import codec

        return codec.decode(data)
    # device output is channel-planar (3, N); untangle on host
    return fetch(out).reshape(3, H, W).transpose(1, 2, 0)


def decode_batch_sharded(
    datas: list[bytes], mesh: Mesh, *, stats: dict | None = None
) -> list[np.ndarray]:
    """Decode a same-shape batch sharded one-image-per-device (data
    parallelism over images — every v3 phase is batch-parallel, so XLA
    partitions the jit with no collectives).

    Retries through the same (steps_div, rounds) LADDER as
    `decode_batch_jax_v3` before falling back per image to the host spec
    decoder; pass `stats` to receive {"fallbacks", "retries", "ok"}."""
    n_dev = mesh.devices.size
    if len(datas) % n_dev:
        raise ValueError(f"batch size must be a multiple of {n_dev} devices")
    args, base_kw = d3.prepare_batch_args(datas)
    shard = NamedSharding(mesh, P("d"))
    args = tuple(jax.device_put(a, shard) for a in args)

    def call(rung):
        cfg = d3._as_cfg(rung)
        out, ok, _gates = d3._device_decode_v3(
            *args,
            **{
                **base_kw,
                "chunk_bits": cfg.chunk_bits,
                "steps": d3._steps(cfg.chunk_bits, cfg.steps_div),
                "rounds": cfg.rounds,
            },
        )
        return ok, (out,), None

    ok_np, (out_np,) = d3.run_ladder(
        call, len(datas), ladder=d3.LADDER, stats=stats
    )
    from nicetpu.format import headers

    W, H, _ = headers.parse_file_header(datas[0])
    result = []
    for i, d in enumerate(datas):
        if bool(ok_np[i]):
            result.append(out_np[i].reshape(3, H, W).transpose(1, 2, 0))
        else:
            from nicetpu.spec import codec

            result.append(codec.decode(d))
    return result
