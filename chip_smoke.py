"""Smoke run of the codec's device path on one GPU (four with --four).

    python chip_smoke.py          # one card: phases 1-5 below
    python chip_smoke.py --four   # four cards: the sharded 8192^2 round trip

Drives the main path through the entry points users call, at the sizes
they run, with content generated from a seed (photo-like: smooth gradients
plus noise; screen-like: flat fills, long runs, repeated tiles), and checks
every result bit-exact against the C++ oracle:

  1. device check: JAX's first device is a GPU, g++ builds the oracle;
  2. photo batch, Kodak shape (24 x 512x768): api.encode_batch /
     api.decode_batch with backend="jax";
  3. fused device round trip (8 x 512x512): pipeline.roundtrip_batch_resident;
  4. large raster (4096x4096 screen-like): api.encode / api.decode;
  5. walk parity: the GPU walk kernel against walk_ref at the phase-2 widths.

Each phase prints its set-up (first call, compile included) and one warm
wall time — a smoke time, not a benchmark — with peak_bytes_in_use and the
memory analysis of its own largest compiled step (for an encode, the
tokenize + histogram program, which holds most of its device time).  Any
failure raises and exits non-zero; the last line of a passing run is one
JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time

import numpy as np

from nicetpu import api, device, pipeline
from nicetpu.config import apply_compilation_cache
from nicetpu.hostref import oracle
from nicetpu.kernels import decode3
from nicetpu.synth import photo_image, screen_image


class SmokeFailure(RuntimeError):
    """A phase's result differs from the oracle, or a fallback was taken."""


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _peak_bytes():
    """Device 0's peak_bytes_in_use so far (None where the backend keeps no
    memory stats, as the CPU does)."""
    import jax

    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def _memory(jitted, *args, **kw) -> dict:
    """Compile seconds and memory analysis of one jitted step."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args, **kw).compile()
    secs = time.perf_counter() - t0
    m = compiled.memory_analysis()
    fields = (
        "argument_size_in_bytes",
        "output_size_in_bytes",
        "temp_size_in_bytes",
        "generated_code_size_in_bytes",
    )
    return {"compile_s": round(secs, 3), **{f: int(getattr(m, f)) for f in fields}}


def _decode_memory(datas: list[bytes]) -> dict:
    """`_memory` of the fast-rung decode program, compiled with exactly the
    arguments `decode3.decode_batch_jax_v3` passes, so its call reuses it."""
    args, kw = decode3.prepare_batch_args(datas)
    return _memory(decode3._device_decode_v3, *args, **kw, serial_recon=False)


def _words_shape(datas: list[bytes]) -> tuple:
    """The decode word array's shape: beyond the image shape, the one thing
    that selects the decode program for a same-shape batch."""
    return decode3.prepare_batch_args(datas)[0][0].shape


def _encode_memory(imgs) -> dict:
    """`_memory` of the encode's tokenize + histogram program (most of the
    encode's device time), compiled with the arguments `encode2.encode_batch`
    passes on valid content."""
    import jax.numpy as jnp

    from nicetpu.kernels import encode2

    B, (H, W, _) = len(imgs), imgs[0].shape
    flat = jnp.asarray(np.stack(imgs).reshape(B, H * W, 3))
    return _memory(encode2.tokenize_compact, flat, width=W, ndigits_cap=3)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def report(
    name: str, first_s: float, warm_s: float, largest: dict, step: str = "largest", **extra
) -> None:
    """One phase line; `largest` holds the set-up compile seconds and memory
    analysis of one program of this phase (`step` names it), compiled before
    its first call."""
    print(
        f"[{name}] set-up (first call, compile of the other programs included): {first_s:.3f} s; "
        f"warm wall time {warm_s:.3f} s (smoke, not a benchmark); "
        f"peak_bytes_in_use {_peak_bytes()}; {step} step {json.dumps(largest)}"
        + "".join(f"; {k} {v}" for k, v in extra.items()),
        flush=True,
    )


def phase_photo_batch(n: int = 24, h: int = 512, w: int = 768, seed: int = 0):
    """Phase 2: Kodak-shaped photo batch through api.encode_batch /
    api.decode_batch (backend="jax").  Returns the encoded streams."""
    imgs = [photo_image(h, w, seed + i) for i in range(n)]
    want = oracle.encode_batch_native(imgs)

    def encode():
        s: dict = {}
        out = api.encode_batch(imgs, backend="jax", stats=s)
        check(s["backend"] == "jax", f"encode_batch served by {s['backend']}")
        check(s["overflow_fallbacks"] == 0, f"encode overflow fallbacks: {s}")
        check(out == want, "encode_batch bytes differ from the oracle")
        return out

    def decode(streams=want, originals=imgs):
        s: dict = {}
        out = api.decode_batch(streams, backend="jax", stats=s)
        check(s["backend"] == "jax", f"decode_batch served by {s['backend']}")
        check(s["fallbacks"] == 0, f"decode walk fallbacks: {s['fallbacks']}")
        for i, (got, im) in enumerate(zip(out, originals)):
            check(np.array_equal(got, im), f"decode_batch image {i} differs")
        return out

    enc_largest = _encode_memory(imgs)
    _, enc_first = _timed(encode)
    _, enc_warm = _timed(encode)
    dec_largest = _decode_memory(want)
    _, dec_first = _timed(decode)
    _, dec_warm = _timed(decode)
    raw = sum(im.nbytes for im in imgs)
    report(
        f"photo batch {n}x{h}x{w} encode", enc_first, enc_warm, enc_largest,
        step="tokenize", ratio=round(raw / sum(map(len, want)), 3),
    )
    report(f"photo batch {n}x{h}x{w} decode", dec_first, dec_warm, dec_largest)

    # Other images of the same shape: their payload sizes differ, and the
    # decode program is reused when their chunk count falls in the same
    # bucket (no compile), else one more is compiled.
    imgs2 = [photo_image(h, w, seed + n + i) for i in range(n)]
    want2 = oracle.encode_batch_native(imgs2)
    before = decode3._device_decode_v3._cache_size()
    _, first2 = _timed(lambda: decode(want2, imgs2))
    print(
        f"[photo batch {n}x{h}x{w} decode, other images] first call {first2:.3f} s "
        f"(smoke, not a benchmark); word array {_words_shape(want2)} against "
        f"{_words_shape(want)}; decode programs compiled {before} -> "
        f"{decode3._device_decode_v3._cache_size()}",
        flush=True,
    )
    return want


def phase_fused_roundtrip(n: int = 8, h: int = 512, w: int = 512, seed: int = 100):
    """Phase 3: one fused encode + decode + on-device verify dispatch."""
    imgs = [photo_image(h, w, seed + i) for i in range(n)]
    want = oracle.encode_batch_native(imgs)
    dev = pipeline.upload_batch(imgs)

    def roundtrip():
        pipeline.pop_stats()
        datas, verified = pipeline.roundtrip_batch_resident(dev, imgs[0].shape, imgs)
        s = pipeline.pop_stats()
        check(bool(np.all(verified)), f"device round trip unverified: {verified}")
        check(s == {"device_fallbacks": 0, "overflow_fallbacks": 0}, f"fallbacks: {s}")
        check(datas == want, "fused round-trip bytes differ from the oracle")

    largest = _memory(
        decode3._roundtrip_fused_jit, dev, width=w, ndigits_cap=3,
        w_cap=decode3.roundtrip_cap_words(h * w), cfg=decode3.LADDER[0],
        maxl=decode3.WALK_MAXL, segs=decode3._segs_for(w),
    )
    _, first = _timed(roundtrip)
    _, warm = _timed(roundtrip)
    report(f"fused round trip {n}x{h}x{w}", first, warm, largest)


def phase_large_raster(h: int = 4096, w: int = 4096, seed: int = 200):
    """Phase 4: one screen-like raster through api.encode / api.decode."""
    img = screen_image(h, w, seed)
    want = oracle.encode_native(img)

    def encode():
        check(api.encode(img, backend="jax") == want, "encode bytes differ")

    def decode():
        check(np.array_equal(api.decode(want, backend="jax"), img), "decode differs")

    def decode_counted():
        s: dict = {}
        out = api.decode_batch([want], backend="jax", stats=s)[0]
        check(s["fallbacks"] == 0, f"decode walk fallbacks: {s['fallbacks']}")
        check(np.array_equal(out, img), "decode differs")

    enc_largest = _encode_memory([img])
    _, enc_first = _timed(encode)
    _, enc_warm = _timed(encode)
    dec_largest = _decode_memory([want])
    _, dec_first = _timed(decode)
    _, dec_warm = _timed(decode_counted)
    ratio = round(img.nbytes / len(want), 3)
    report(
        f"large raster {h}x{w} encode", enc_first, enc_warm, enc_largest,
        step="tokenize", ratio=ratio,
    )
    report(f"large raster {h}x{w} decode", dec_first, dec_warm, dec_largest)


def phase_walk_parity(datas: list[bytes], *, interpret: bool = False):
    """Phase 5: the GPU walk kernel against walk_ref, both ladder rungs,
    round-1 and round-2 entries, on the phase-2 streams."""
    import jax
    import jax.numpy as jnp

    for cfg in decode3.LADDER:
        args, kw = decode3.prepare_batch_args(
            datas, chunk_bits=cfg.chunk_bits, steps_div=cfg.steps_div, rounds=cfg.rounds
        )
        words, wbits, af, present, ib, pfx, _sym = args
        B, wn = words.shape
        nch = (wn - decode3.LOOKAHEAD_WORDS) // (cfg.chunk_bits // 32)
        aff, dD, inc = decode3.derive_walk_tables(af, present, ib)
        wkw = dict(chunk_bits=cfg.chunk_bits, steps=kw["steps"], maxl=kw["maxl"])
        chunk0 = jnp.zeros((B,), jnp.int32)

        @jax.jit
        def ref(e):
            return jax.vmap(
                lambda wd, ee, a, d, ic, pf, wb: decode3.walk_ref(
                    wd, ee, a, d, ic, pf, wb, **wkw
                )
            )(words, e, aff, dD, inc, pfx[:, 0], wbits)

        @jax.jit
        def kernel(e):
            return decode3.walk_gpu(
                words, e, aff, dD, inc, pfx[:, 0], wbits, chunk0,
                interpret=interpret, **wkw,
            )

        e = jnp.broadcast_to(jnp.arange(nch, dtype=jnp.int32) * cfg.chunk_bits, (B, nch))
        for rnd in (1, 2):
            want = jax.block_until_ready(ref(e))
            got, secs = _timed(lambda: jax.block_until_ready(kernel(e)))
            for name, g, w_ in zip(("pos", "sym", "i12", "i34", "exits"), got, want):
                check(
                    np.array_equal(np.asarray(g), np.asarray(w_)),
                    f"walk kernel {name} differs from walk_ref ({cfg}, round {rnd})",
                )
            print(
                f"[walk parity] {cfg} round {rnd}: {B} images x {nch} chunks x "
                f"{kw['steps']} steps identical; kernel call {secs:.3f} s "
                f"(round 1 compiles it; smoke, not a benchmark)",
                flush=True,
            )
            e = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), want[4][:, :-1]], axis=1)


def phase_sharded(n_dev: int = 4, h: int = 8192, w: int = 8192, seed: int = 300):
    """--four: one photo-like raster encoded and decoded across a 1-D mesh."""
    from nicetpu.dist.sharded import encode_sharded, make_mesh
    from nicetpu.dist.sharded_decode import decode_sharded

    mesh = make_mesh(n_dev)
    img = photo_image(h, w, seed)
    want = oracle.encode_native(img)

    def roundtrip():
        data = encode_sharded(img, mesh)
        check(data == want, "sharded encode bytes differ from the oracle")
        check(np.array_equal(decode_sharded(data, mesh), img), "sharded decode differs")

    _, first = _timed(roundtrip)
    _, warm = _timed(roundtrip)
    print(
        f"[sharded {h}x{w} over {n_dev} devices] set-up (first call, compile "
        f"included): {first:.3f} s; warm wall time {warm:.3f} s (smoke, not a "
        f"benchmark); peak_bytes_in_use (device 0) {_peak_bytes()}; "
        f"ratio {round(img.nbytes / len(want), 3)}",
        flush=True,
    )


def device_check(count: int):
    """Phase 1: a GPU (or `count` of them), and g++ for the C++ oracle."""
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu", f"no GPU: JAX's first device is {devs[0].platform!r}")
    check(len(devs) >= count, f"needs {count} GPUs, JAX found {len(devs)}")
    check(shutil.which("g++") is not None, "g++ not found: the C++ oracle cannot build")
    oracle.get_lib()
    return devs[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true", help="sharded path on 4 GPUs only")
    args = ap.parse_args(argv)
    apply_compilation_cache()
    count = 4 if args.four else 1
    try:
        dev = device_check(count)
    except SmokeFailure as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    print(device.gpu_name_and_power_limit(), flush=True)
    print(f"device: {dev.platform} {dev.device_kind} x{count}", flush=True)
    if args.four:
        phase_sharded(count)
    else:
        datas = phase_photo_batch()
        phase_fused_roundtrip()
        phase_large_raster()
        phase_walk_parity(datas)
    import jax

    found = {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}
    print(json.dumps({"ok": True, "device": found}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
