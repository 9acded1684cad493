"""Multi-host encode of giant rasters (BASELINE config 5: 16K x 16K).

Bring-up: `jax.distributed.initialize` (process coordination), then a
global mesh over every process's devices.  The row-block sharded pipeline
of `dist/sharded.py` runs unchanged — XLA lowers the halo `ppermute` and
the histogram `psum` to collectives within and across hosts.

Ordered gather: every process holds only its shards' packed words; the final
bitstream needs them concatenated in global shard order at bit granularity.
We reshard (words, bits) to a replicated layout with one jitted identity
(XLA inserts the all_gather), read the now fully-addressable
arrays on process 0, and stitch them there (SURVEY §2.2 "ordered gather").

Tested with 2 local CPU processes in tests/test_multihost.py (SURVEY §4's
multi-host-simulation plan); across real hosts the same code runs unchanged.
"""

from __future__ import annotations

import numpy as np

import jax


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """`jax.distributed.initialize` wrapper; no-op when single-process."""
    if num_processes in (None, 1):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def _fetch_replicated(x, mesh) -> np.ndarray:
    """Read a (possibly cross-process sharded) array on every process.

    Single-process arrays are fully addressable already; multi-process
    arrays are resharded to replicated first (one all_gather under jit).
    """
    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(mesh, P())
    return np.asarray(jax.jit(lambda a: a, out_shardings=rep)(x))


def _fetch_words_bounded(words, bits, mesh, n_dev: int):
    """Bounded-memory ordered-gather fetch of the sharded packed payload
    (SURVEY §7.3.6).

    The naive replicated fetch moves every shard's FULL w_cap-word buffer
    (~2x raw + padding) to every host.  Instead: (1) all_gather only the
    per-shard BIT COUNTS (n_dev int32 — bytes); (2) one jitted slice trims
    every shard's words to the maximum ACTUAL word count (sharded-axis
    preserving, no data motion); (3) replicate the trimmed words — peak
    per-host extra memory is ~ the compressed payload itself, not the
    padded capacity.  (A strictly host-0-only payload fetch needs a
    point-to-point transport; jax collectives are collective, so the
    per-host bound is 1x compressed — recorded in BENCH config 5.)

    Returns (shard_words (n_dev * k_max,), shard_bits (n_dev,), k_max)
    where shard d's words are rows [d*k_max, d*k_max + k_max)."""
    if jax.process_count() == 1:
        bits_np = np.asarray(bits)
    else:
        bits_np = _fetch_replicated(bits, mesh)
    n_local = words.shape[0] // n_dev
    k_max = int(min(n_local, (int(bits_np.max()) + 31) // 32 + 1))
    from jax.sharding import NamedSharding, PartitionSpec as P

    shard = NamedSharding(mesh, P("d"))

    def trim(w):
        return w.reshape(n_dev, n_local)[:, :k_max].reshape(-1)

    trimmed = jax.jit(trim, out_shardings=shard)(words)
    if jax.process_count() == 1:
        w_np = np.asarray(trimmed)
    else:
        w_np = _fetch_replicated(trimmed, mesh)
    return w_np, bits_np, k_max


def encode_multihost(img: np.ndarray, mesh=None) -> bytes | None:
    """Encode a raster across all hosts; returns bytes on process 0, None
    elsewhere.

    Every process passes the SAME full raster (or a loader provides it);
    jax.device_put with the mesh sharding places only the local row blocks
    on each process's devices.  Single-process this is exactly
    dist.sharded.encode_sharded.
    """
    from nicetpu.dist.sharded import encode_sharded, make_mesh

    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    gather = lambda w, b: _fetch_words_bounded(w, b, mesh, n_dev)[:2]
    if jax.process_count() == 1:
        return encode_sharded(img, mesh, gather=gather)
    data = encode_sharded(
        img, mesh, fetch=lambda x: _fetch_replicated(x, mesh), gather=gather
    )
    return data if jax.process_index() == 0 else None


def decode_multihost(data: bytes, mesh=None, **kw) -> np.ndarray | None:
    """Decode a `.nice` raster sharded across all hosts; returns the raster
    on process 0, None elsewhere.

    Every process passes the SAME bytes; the row-sharded decode pipeline of
    `dist/sharded_decode.py` runs over the global mesh (the speculative
    walk's entry propagation and the 4-row reconstruction carry ride
    `ppermute` across the process boundary), and the decoded channel-planar
    raster reshards to replicated for the process-0 read."""
    from nicetpu.dist.sharded import make_mesh
    from nicetpu.dist.sharded_decode import decode_sharded

    mesh = mesh or make_mesh()
    if jax.process_count() == 1:
        return decode_sharded(data, mesh, **kw)
    out = decode_sharded(
        data, mesh, fetch=lambda x: _fetch_replicated(x, mesh), **kw
    )
    return out if jax.process_index() == 0 else None
