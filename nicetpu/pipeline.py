"""Threaded streaming encode/round-trip pipeline for the device codec.

Throughput comes from (a) SUB-BATCHING — one fused dispatch
(`kernels.encode2.encode_fused`, on-device Huffman tables, zero
mid-pipeline syncs) plus one small fetch and one 2-D payload fetch per batch
of images — and (b) a thread pool keeping several batches in flight so
host-to-device copies, device compute, device-to-host copies and host-side
assembly/decode overlap.

Any image the fused fast path cannot represent (a run needing > 3 base-8
digits, a pixel packing > 96 payload bits, or the payload overflowing the
device buffer) falls back to the byte-identical native encoder and is
counted — correctness never depends on the fast path.  A device error
(compile or runtime) propagates to the caller.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np

from nicetpu.format import constants as C
from nicetpu.format import headers
from nicetpu.kernels.bitpack import words_to_payload

# Payload capacity: 28 bits/pixel covers photos and mild expansion; noisy
# images that exceed it take the native fallback (cap_ovf flag).
CAP_BITS_PER_PIXEL = 28
FETCH_BUCKET_WORDS = 2048  # payload fetches rounded up to 8 KiB buckets
DEFAULT_BATCH = 4
DEFAULT_WORKERS = 4


# Every routing away from the device is counted here; `pop_stats` hands the
# counters to API callers / bench, which assert they are 0 on valid input:
#   device_fallbacks   - images the device round trip could not verify
#                        (walk gates failed after the ladder), host-decoded;
#   overflow_fallbacks - images the fused encoder could not represent,
#                        encoded by the native codec.
_STATS_LOCK = threading.Lock()
_STATS = {"device_fallbacks": 0, "overflow_fallbacks": 0}


def _count(key: str, n: int = 1) -> None:
    with _STATS_LOCK:
        _STATS[key] += n


def pop_stats() -> dict:
    """Return and reset the pipeline's device-fallback counters."""
    with _STATS_LOCK:
        out = dict(_STATS)
        for k in _STATS:
            _STATS[k] = 0
    return out


def _w_cap(n_pixels: int) -> int:
    return n_pixels * CAP_BITS_PER_PIXEL // 32 + 1024


def encode_batch_fused(imgs: Sequence[np.ndarray]) -> list[bytes]:
    """Encode same-shape (H, W, 3) uint8 images in ONE fused dispatch with
    per-image Huffman tables; two device-to-host fetches in total (smalls +
    payloads)."""
    return encode_batch_resident(upload_batch(imgs), imgs[0].shape, imgs)


def upload_batch(imgs: Sequence[np.ndarray]):
    """One-time H2D of a same-shape image batch -> (B, N, 3) device array.

    Resident batches let repeated encodes skip the raw-pixel upload, so only
    compressed payloads leave the device (the device-memory analogue of the
    serial baseline keeping its images in host RAM)."""
    import jax

    H, W, _ = imgs[0].shape
    return jax.device_put(np.stack([im.reshape(H * W, 3) for im in imgs]))


def encode_batch_resident(flat, shape, imgs=None, return_device: bool = False):
    """Fused encode of an already-resident (B, N, 3) device batch.

    shape: the (H, W, 3) image shape.  imgs (host copies) are only needed
    for the rare capacity-overflow fallback to the native encoder.

    return_device=True returns (datas, words_dev, small) — the packed
    payload words still on the device plus the fetched (B, 860) small
    array — so the caller can run the device-resident decode leg without
    re-uploading the payload."""
    from nicetpu.kernels.encode2 import encode_fused

    H, W, _ = shape
    if W < C.MIN_WIDTH:
        raise ValueError(f"width must be >= {C.MIN_WIDTH} (SURVEY A.8.7)")
    words_d, small_d = encode_fused(flat, width=W, ndigits_cap=3, w_cap=_w_cap(H * W))
    small = np.asarray(small_d)  # (B, 860): [lengths(858), total_bits, ovf]
    out = _assemble_payloads(words_d, small, shape, flat=flat, imgs=imgs)
    if return_device:
        return out, words_d, small
    return out


def _assemble_payloads(words_d, small, shape, flat=None, imgs=None) -> list[bytes]:
    """.nice byte strings from the fused encoder's device words + fetched
    small array; per-image native fallback on overflow (counted)."""
    B = small.shape[0]
    H, W, _ = shape
    w_cap = int(words_d.shape[1])
    totals = small[:, 858]
    ovf = small[:, 859].astype(bool)

    kmax = int(totals[~ovf].max()) // 32 + 2 if (~ovf).any() else 0
    kmax = min(-(-kmax // FETCH_BUCKET_WORDS) * FETCH_BUCKET_WORDS, w_cap)
    words = np.asarray(words_d[:, :kmax]).astype(np.uint32) if kmax else None

    out: list[bytes] = []
    file_hdr = headers.pack_file_header(W, H, 3)
    for b in range(B):
        if ovf[b]:
            _count("overflow_fallbacks")
            from nicetpu.hostref import oracle

            host_img = (
                imgs[b]
                if imgs is not None
                else np.asarray(flat[b]).reshape(H, W, 3)
            )
            out.append(oracle.encode_native(host_img))
            continue
        lengths = small[b, :858].astype(np.uint8)
        out.append(
            file_hdr
            + headers.pack_stream_headers(lengths)
            + words_to_payload(words[b], int(totals[b]))
        )
    return out


def roundtrip_batch_resident(flat_dev, shape, imgs=None):
    """Full production round trip of a resident (B, N, 3) uint8 batch in ONE
    fused dispatch (decode3.roundtrip_verify_fused): encode, on-device
    decode-table build, decode from the device-resident words, on-device
    bit-exact verification — one small2 fetch plus the payload fetch leave
    the device.  Returns (datas, verified (B,) bool).

    Images the device could not verify (overflow past the optimistic
    ROUNDTRIP_CAP_BPP cap, deep tables, self-sync residue after the exact
    ladder) report verified=False and are counted in `pop_stats`; the
    caller decodes those on the host."""
    from nicetpu.kernels import decode3

    H, W, _ = shape
    if W < C.MIN_WIDTH:
        raise ValueError(f"width must be >= {C.MIN_WIDTH} (SURVEY A.8.7)")
    words_d, small, verified = decode3.roundtrip_verify_fused(flat_dev, width=W)
    datas = _assemble_payloads(words_d, small, shape, flat=flat_dev, imgs=imgs)
    ovf = small[:, 859].astype(bool)
    unverified = int((~verified & ~ovf).sum())
    if unverified:
        _count("device_fallbacks", unverified)
    return datas, verified


def roundtrip_hybrid(
    batches: "list[tuple[list[np.ndarray], object]]",
    *,
    device_threads: int = 3,
    cpu_threads: int = 1,
) -> tuple[list[list[tuple[bytes, np.ndarray]]], dict]:
    """Heterogeneous round-trip: the device and host CPUs drain one work
    queue.

    batches: list of (host_imgs, dev_batch) where dev_batch is an uploaded
    (B, N, 3) device array (see `upload_batch`) or None for host-only
    entries.  Device workers pop batches from the FRONT (fused encode dispatch
    + payload fetch + device-resident v3 decode proven bit-exact ON device
    against the uploaded original); CPU workers pop from the BACK
    (serial native encode+decode, releasing the GIL inside ctypes).  The
    two ends meet wherever the resources balance — work stealing, no static
    split; the reference burns one core and leaves everything else idle
    (ref main.rs single-shot loop).

    Returns (results ordered like batches, stats with device_batches and
    cpu_batches).  Any exception on the device leg (a device error or a
    kernel defect) propagates out of the worker threads and fails the call.
    """
    from nicetpu.hostref import oracle

    n = len(batches)
    results: list = [None] * n
    lock = threading.Lock()
    lo, hi = 0, n - 1  # queue front / back cursors
    stats = {"device_batches": 0, "cpu_batches": 0}

    def pop_front():
        nonlocal lo
        with lock:
            if lo > hi:
                return None
            i = lo
            lo += 1
            return i

    def pop_back():
        nonlocal hi
        with lock:
            if lo > hi:
                return None
            i = hi
            hi -= 1
            return i

    def do_cpu(i: int) -> None:
        host_imgs, _ = batches[i]
        out = []
        for im in host_imgs:
            d = oracle.encode_native(im)
            out.append((d, oracle.decode_native(d)))
        results[i] = out

    def do_device(i: int) -> bool:
        host_imgs, dev = batches[i]
        if dev is None:
            return False
        # ONE fused dispatch: encode + on-device decode-table build + decode
        # from the device-resident packed words + on-device bit-exact
        # verification against the resident original — only the small2 flags
        # and the payload leave the device.  Images whose gates fail (or
        # whose fused encode overflowed) decode on the host; a
        # gate-consistent mismatch RAISES (kernel defect — never silently
        # rerouted).
        datas, verified = roundtrip_batch_resident(
            dev, host_imgs[0].shape, host_imgs
        )
        out = []
        for b, d in enumerate(datas):
            if verified[b]:
                # bit-exactness proven on device; the original IS the decode
                out.append((d, host_imgs[b]))
            else:
                out.append((d, oracle.decode_native(d)))
        results[i] = out
        return True

    hard_errors: list[BaseException] = []

    def device_worker() -> None:
        while True:
            i = pop_front()
            if i is None:
                return
            try:
                ok = do_device(i)
            except Exception as e:  # device error or kernel bug: fail the call
                with lock:
                    hard_errors.append(e)
                do_cpu(i)  # keep results complete for post-mortem
                return
            if ok:
                with lock:
                    stats["device_batches"] += 1
            else:
                do_cpu(i)
                with lock:
                    stats["cpu_batches"] += 1

    def cpu_worker() -> None:
        while True:
            i = pop_back()
            if i is None:
                return
            do_cpu(i)
            with lock:
                stats["cpu_batches"] += 1

    threads = [threading.Thread(target=device_worker) for _ in range(device_threads)]
    threads += [threading.Thread(target=cpu_worker) for _ in range(cpu_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if hard_errors:
        raise hard_errors[0]
    return results, stats


def encode_one(img: np.ndarray) -> bytes:
    """Encode one (H, W, 3) uint8 image via the fused single-dispatch device
    path, falling back to the byte-identical native encoder on overflow."""
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError("expected (H, W, 3) uint8 image")
    return encode_batch_fused([img])[0]


class Pipeline:
    """Thread-pool + sub-batch pipeline keeping several fused dispatches in
    flight.

    The distributed analogue of the reference's single-shot CLI loop: each
    worker owns a whole sub-batch (upload, fused dispatch, two fetches, host
    assembly, native decode) so transfers, device compute, and host work
    overlap across batches.
    """

    def __init__(
        self,
        workers: int | None = None,
        batch: int | None = None,
        config=None,
    ) -> None:
        if config is None:
            from nicetpu.config import RuntimeConfig

            config = RuntimeConfig.from_env()
        self.config = config
        self.batch = batch if batch is not None else config.batch_size
        self._pool = ThreadPoolExecutor(
            max_workers=workers if workers is not None else config.workers
        )

    def _chunks(self, imgs: Sequence[np.ndarray]) -> list[list[np.ndarray]]:
        """Group into same-shape runs of at most `batch` images (order kept)."""
        groups: list[list[np.ndarray]] = []
        for im in imgs:
            if (
                groups
                and len(groups[-1]) < self.batch
                and groups[-1][0].shape == im.shape
            ):
                groups[-1].append(im)
            else:
                groups.append([im])
        return groups

    def warmup(self, imgs: Sequence[np.ndarray]) -> None:
        """Compile the fused executables for every distinct (shape, batch)
        serially, so worker threads never compile the same program twice."""
        seen = set()
        for chunk in self._chunks(imgs):
            key = (chunk[0].shape, len(chunk))
            if key not in seen:
                seen.add(key)
                encode_batch_fused(chunk)

    def encode_many(self, imgs: Sequence[np.ndarray]) -> list[bytes]:
        outs = self._pool.map(encode_batch_fused, self._chunks(imgs))
        return [d for chunk in outs for d in chunk]

    def roundtrip_many(
        self, imgs: Sequence[np.ndarray]
    ) -> list[tuple[bytes, np.ndarray]]:
        def rt(chunk: list[np.ndarray]) -> list[tuple[bytes, np.ndarray]]:
            from nicetpu.hostref import oracle

            datas = encode_batch_fused(chunk)
            return list(zip(datas, oracle.decode_batch_native(datas)))

        outs = self._pool.map(rt, self._chunks(imgs))
        return [p for chunk in outs for p in chunk]

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "Pipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
