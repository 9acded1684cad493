"""Interim benchmark runner: prints ONE JSON line with the headline metric.

Headline: encode+decode throughput (MB/s) for bit-exact 512x512 RGB8
round-trips (BASELINE config 1), batches resident in device memory (one
untimed upload — the device analogue of the serial C++ baseline holding its
images in host RAM).  The timed pipeline is the heterogeneous scheduler
(`pipeline.roundtrip_hybrid`): device workers drain batches from the front
of a work queue (fused single-dispatch encode with on-device Huffman
tables, payload fetch, then the v3 device decode straight from the
device-resident packed words, proven bit-exact on device against the
uploaded original) while host workers drain from the back with the
byte-identical native codec.

vs_baseline is the speedup over the all-serial C++ oracle round-trip on the
same images (the stand-in for the unrunnable single-threaded Rust reference,
BASELINE.md).  Extra JSON fields split what the headline hides:
  device_only      - fused encode dispatch throughput (device compute +
                     small table fetch, no payload transfer)
  device_roundtrip - encode + device-resident decode + on-device bit-exact
                     verification, flags-only fetch
  decode_device    - v3 device decoder (kernels/decode3.py) compute alone
                     (checksum fetch); decode_device_e2e adds the raster fetch
  device_share     - fraction of batches the device stream won in the race
  ratio            - compressed-size ratio raw/nice on the bench images

It runs on a GPU only and exits non-zero anywhere else; any device error
fails the run.  Every line names the device it ran on.

One measurement on the Kodak-shaped batch (24 x 512x768 photo-like) runs
instead of the headline when asked for:
  --trace DIR  one profiler trace of a warm api.encode_batch and
               api.decode_batch (trace and HLO dump kept in DIR); prints
               device time per named stage.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time

import numpy as np

from nicetpu import device
from nicetpu.config import apply_compilation_cache

N_IMAGES = 64
BATCH = 8
DEVICE_THREADS = 2
CPU_THREADS = 2
TIME_BUDGET_S = 480  # shrink rep counts (never skip sections) near this


def make_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 60 * np.sin(xx / 37.0) + 50 * np.cos(yy / 23.0)).astype(np.int32)
    img = np.stack(
        [base, base + np.sin(xx / 11.0) * 20, base - np.cos(yy / 7.0) * 15], axis=-1
    )
    return np.clip(img + rng.integers(-3, 4, img.shape), 0, 255).astype(np.uint8)


def gpu_device_info() -> dict:
    """platform, device_kind, count and the card's name/power limit; exits
    when JAX's first device is not a GPU."""
    import jax

    dev0 = jax.devices()[0]
    if dev0.platform != "gpu":
        raise SystemExit(f"bench needs a GPU; JAX found {dev0.platform!r}")
    return {
        "platform": dev0.platform,
        "kind": dev0.device_kind,
        "count": len(jax.devices()),
        "nvidia_smi": device.gpu_name_and_power_limit(),
    }


def kodak_batch():
    """24 photo-like 512x768 images (the Kodak suite's shape) and their
    oracle streams."""
    from nicetpu.hostref import oracle
    from nicetpu.synth import photo_image

    imgs = [photo_image(512, 768, s) for s in range(24)]
    return imgs, oracle.encode_batch_native(imgs)


# Named scopes (jax.named_scope in encode2/decode3) the trace reduces to.
STAGES = (
    "tokenize", "histogram", "huffman_tables", "join", "fold_place",
    "walk", "assemble", "reconstruct",
)


def _stage_of(op_name: str) -> str:
    return next((p for p in op_name.split("/") if p in STAGES), "other")


def _module_stages(lines) -> dict:
    """Stage of every instruction of one optimized-HLO module: its own
    op_name scope, else (fusions, loops, calls) the first stage found in the
    computations it calls, else its neighbours' (see below)."""
    header = re.compile(r"^(?:ENTRY )?%?([\w.\-]+) \(.*\{\s*$")
    inst = re.compile(r"^\s*(?:ROOT )?%?([\w.\-]+) = (.*)$")
    callee = re.compile(r"(?:calls|to_apply|body|condition)=%?([\w.\-]+)")
    own: dict = {}  # instruction -> stage from its own op_name
    calls: dict = {}  # instruction -> called computations
    members: dict = {}  # computation -> its instructions
    comp = None
    for line in lines:
        h = header.match(line)
        if h:
            comp = h.group(1)
            members[comp] = []
            continue
        m = inst.match(line)
        if not m or comp is None:
            continue
        name, rest = m.groups()
        members[comp].append(name)
        op = re.search(r'op_name="([^"]*)"', rest)
        own[name] = _stage_of(op.group(1)) if op else "other"
        branches = re.search(r"branch_computations=\{([^}]*)\}", rest)
        calls[name] = callee.findall(rest) + (
            [c.strip().lstrip("%") for c in branches.group(1).split(",")] if branches else []
        )

    memo: dict = {}

    def stage(name, seen):
        if name in memo:
            return memo[name]
        result = own.get(name, "other")
        if result == "other":
            for c in calls.get(name, []):
                if c in seen:
                    continue
                seen.add(c)
                result = next(
                    (st for st in (stage(i, seen) for i in members.get(c, [])) if st != "other"),
                    "other",
                )
                if result != "other":
                    break
        memo[name] = result
        return result

    result = {name: stage(name, set()) for name in own}
    # Ops whose metadata lost the scope path (inner jits such as cumsum's)
    # take the stage of the nearest earlier op of their computation: stages
    # are contiguous in program order.
    for names in members.values():
        last = next((result[n] for n in names if result[n] != "other"), "other")
        for n in names:
            if result[n] == "other":
                result[n] = last
            else:
                last = result[n]
    return result


def _op_scopes(dump_dir: str) -> tuple[dict, dict]:
    """Stage of every HLO instruction in XLA's optimized-HLO dumps, keyed by
    (module, instruction) and, where the name is unambiguous, by name."""
    by_key: dict = {}
    by_name: dict = {}
    for path in glob.glob(os.path.join(dump_dir, "*after_optimizations.txt")):
        m = re.match(r"module_\d+\.([^.]+)\.", os.path.basename(path))
        module = m.group(1) if m else os.path.basename(path)
        with open(path) as f:
            for name, st in _module_stages(f).items():
                name = _kernel_name(name)
                by_key[(module, name)] = st
                if by_name.setdefault(name, st) != st:
                    by_name[name] = None  # ambiguous across modules
    return by_key, by_name


def _kernel_name(name: str) -> str:
    """An HLO instruction name as the GPU kernel it becomes is named."""
    return re.sub(r"[.\-]", "_", name)


def device_time_by_stage(trace_dir: str, dump_dir: str) -> dict:
    """Sum of GPU kernel durations per named stage, and the busy time and
    window of the device timeline, from one `.xplane.pb` trace.  An event's
    stage comes from its kernel (or hlo_op) name in the HLO dumps, else from
    a stage-named kernel or a scope path in its string stats; `unmatched`
    samples the rest."""
    from jax.profiler import ProfileData

    by_key, by_name = _op_scopes(dump_dir)
    path = sorted(glob.glob(os.path.join(trace_dir, "plugins/profile/*/*.xplane.pb")))[-1]
    totals: dict = {}
    kernels: dict = {}  # (module, kernel, stage) -> ns
    spans = []
    unmatched = []
    lines_seen = set()
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                st = {k: v for k, v in ev.stats}
                if "hlo_op" not in st:
                    continue
                lines_seen.add(line.name)
                mod = str(st.get("hlo_module", "")).split("(")[0]
                # inside a command buffer hlo_op names the buffer, and the
                # event (kernel) name names the fused instruction
                stage = None
                for op in (_kernel_name(ev.name), _kernel_name(str(st["hlo_op"]))):
                    stage = stage or by_key.get((mod, op)) or by_name.get(op)
                if stage is None:  # kernels named after their stage (walk_gpu)
                    stage = next((g for g in STAGES if ev.name.startswith(g)), None)
                if stage is None:
                    stage = next(
                        (
                            _stage_of(v)
                            for v in st.values()
                            if isinstance(v, str) and _stage_of(v) != "other"
                        ),
                        "other",
                    )
                    if stage == "other" and len(unmatched) < 8:
                        unmatched.append([mod, ev.name, str(st["hlo_op"])])
                totals[stage] = totals.get(stage, 0.0) + ev.duration_ns
                key = (mod, ev.name, stage)
                kernels[key] = kernels.get(key, 0.0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s0, e0 in spans:
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    return {
        "device_ns_by_stage": totals,
        "device_busy_ns": busy,
        "device_window_ns": window,
        "kernel_events": len(spans),
        "top_kernels": [
            [*k, v] for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
        ],
        "device_lines": sorted(lines_seen),
        "hlo_instructions_mapped": len(by_key),
        "hlo_modules": sorted({k[0] for k in by_key})[:12],
        "unmatched": unmatched,
    }


def trace(trace_dir: str) -> dict:
    """Trace one warm Kodak-batch encode_batch + decode_batch and reduce it
    to device time per stage.  Compiles without the persistent cache so
    XLA dumps every program's optimized HLO (the stage map)."""
    import jax

    from nicetpu import api

    imgs, datas = kodak_batch()

    def encode():
        s: dict = {}
        out = api.encode_batch(imgs, backend="jax", stats=s)
        assert out == datas and s["overflow_fallbacks"] == 0

    def decode():
        s: dict = {}
        out = api.decode_batch(datas, backend="jax", stats=s)
        assert s["fallbacks"] == 0
        assert all(np.array_equal(o, im) for o, im in zip(out, imgs))

    result = {}
    for name, fn in (("encode_batch", encode), ("decode_batch", decode)):
        fn()  # compile
        t0 = time.perf_counter()
        fn()
        warm = time.perf_counter() - t0
        sub = os.path.join(trace_dir, name)
        jax.profiler.start_trace(sub)
        t0 = time.perf_counter()
        fn()
        traced = time.perf_counter() - t0
        jax.profiler.stop_trace()
        result[name] = {
            "warm_s": warm,
            "traced_s": traced,
            **device_time_by_stage(sub, os.environ["NICETPU_XLA_DUMP"]),
        }
        print(json.dumps({name: result[name]}), file=sys.stderr, flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="interim benchmark runner (GPU only)")
    ap.add_argument("--trace", metavar="DIR", help="trace one Kodak-batch encode + decode into DIR")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if args.trace:
        # dump optimized HLO (instruction -> named scope) beside the trace;
        # no persistent cache, so every program compiles and is dumped
        dump = os.path.join(os.path.abspath(args.trace), "hlo")
        os.environ["NICETPU_XLA_DUMP"] = dump
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + f" --xla_dump_to={dump} --xla_dump_hlo_as_text"
        ).strip()
    else:
        apply_compilation_cache()
    import jax
    import jax.numpy as jnp

    if args.trace:
        jax.config.update("jax_enable_compilation_cache", False)
    device_info = gpu_device_info()
    print(json.dumps({"device": device_info}), file=sys.stderr, flush=True)
    if args.trace:
        print(json.dumps({"trace": trace(args.trace), "device": device_info}))
        return 0

    def reps_left(want: int) -> int:
        """Adaptive rep count: shrink toward 1 as the budget tightens."""
        remain = TIME_BUDGET_S - (time.perf_counter() - t_start)
        if remain < 60:
            return 1
        if remain < 150:
            return max(1, want - 1)
        return want

    from nicetpu import pipeline
    from nicetpu.hostref import oracle
    from nicetpu.kernels import decode3
    from nicetpu.kernels.encode2 import encode_fused
    from nicetpu.pipeline import _w_cap, encode_batch_resident, roundtrip_hybrid, upload_batch

    imgs = [make_image(512, 512, s) for s in range(N_IMAGES)]
    mb = sum(im.nbytes for im in imgs) / 1e6

    # Serial C++ baseline round-trip (single-threaded, like the reference);
    # best-of-2 passes over 8 images to damp host CPU noise.
    data_ref = oracle.encode_native(imgs[0])
    assert np.array_equal(oracle.decode_native(data_ref), imgs[0])
    t_ref = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        for im in imgs[:8]:
            out = oracle.decode_native(oracle.encode_native(im))
        t_ref = min(t_ref, (time.perf_counter() - t0) / 8)
    assert np.array_equal(out, imgs[7])
    base_mbs = imgs[0].nbytes / 1e6 / t_ref

    extras: dict = {}
    value = 0.0
    shape = imgs[0].shape
    H, W, _ = shape
    N = H * W
    w_cap = _w_cap(N)
    host_batches = [imgs[i : i + BATCH] for i in range(0, N_IMAGES, BATCH)]
    batches = [(hb, upload_batch(hb)) for hb in host_batches]

    # compile every device executable serially, then one full hybrid pass
    # proving bit-exactness
    print("warmup...", file=sys.stderr, flush=True)
    encode_batch_resident(batches[0][1], shape, batches[0][0])
    wver = decode3.roundtrip_verify_fused(batches[0][1], width=W)[2]
    assert wver.all(), "warmup device round-trip not verified"
    pipeline.pop_stats()
    results, stats = roundtrip_hybrid(
        batches, device_threads=DEVICE_THREADS, cpu_threads=CPU_THREADS
    )
    blobs_all = []
    for out, hb in zip(results, host_batches):
        for (d, dec), im in zip(out, hb):
            assert np.array_equal(dec, im), "round-trip mismatch"
            blobs_all.append(d)
    extras["ratio"] = round(mb * 1e6 / sum(len(b) for b in blobs_all), 3)
    # independent anchor: a device-produced blob must decode to the
    # original through the UNRELATED native decoder too
    assert np.array_equal(oracle.decode_native(blobs_all[0]), imgs[0])

    # device-only encode throughput: fused dispatches pipelined (async
    # enqueue, one sync at the end) — payload stays on device, only the
    # (B, 860) table/stats fetch leaves it per batch
    best = 0.0
    for _ in range(reps_left(3)):
        t0 = time.perf_counter()
        smalls = [
            encode_fused(dev, width=W, ndigits_cap=3, w_cap=w_cap)[1]
            for _, dev in batches[:4]
        ]
        for sm in smalls:
            np.asarray(sm)
        best = max(best, 4 * BATCH * imgs[0].nbytes / 1e6 / (time.perf_counter() - t0))
    extras["device_only"] = round(best, 2)

    # pure device ROUND-TRIP: ONE fused dispatch per batch (encode +
    # on-device table build + decode + bit-exact verify); only the (B, 862)
    # small2 leaves the device.  Fails the run if verification fails.
    rt_kw = dict(
        width=W, ndigits_cap=3, w_cap=decode3.roundtrip_cap_words(N),
        cfg=decode3.LADDER[0], maxl=decode3.WALK_MAXL,
        segs=decode3._segs_for(W),
    )

    def dev_rt_round(n_batches: int) -> None:
        outs = [
            decode3._roundtrip_fused_jit(dev, **rt_kw)[1]
            for _, dev in batches[:n_batches]
        ]
        for small2_d in outs:
            small2 = np.asarray(small2_d)
            ver = small2[:, 860].astype(bool) & small2[:, 861].astype(bool)
            assert ver.all(), "device round-trip not verified"

    dev_rt_round(1)  # warm
    best = 0.0
    for _ in range(reps_left(3)):
        t0 = time.perf_counter()
        dev_rt_round(4)
        best = max(best, 4 * BATCH * imgs[0].nbytes / 1e6 / (time.perf_counter() - t0))
    extras["device_roundtrip"] = round(best, 2)

    # v3 device batch decode.  The run FAILS if any valid stream fell back.
    blob8 = blobs_all[:BATCH]
    dstats: dict = {}
    decs = decode3.decode_batch_jax_v3(blob8, stats=dstats)
    assert dstats["fallbacks"] == 0, "device decode fell back on valid streams"
    for dec, im in zip(decs, imgs[:BATCH]):
        assert np.array_equal(dec, im)
    extras["decode_fallbacks"] = dstats["fallbacks"]
    ts = []
    for _ in range(reps_left(2)):
        t0 = time.perf_counter()
        decode3.decode_batch_jax_v3(blob8, stats=dstats)
        assert dstats["fallbacks"] == 0
        ts.append(time.perf_counter() - t0)
    extras["decode_device_e2e"] = round(BATCH * imgs[0].nbytes / 1e6 / min(ts), 2)

    # compute-only: same pipeline, per-image checksum + ok fetch
    args, kw = decode3.prepare_batch_args(blob8)
    csum = jax.jit(
        lambda *a: (
            lambda o, k, g: (jnp.sum(o.astype(jnp.int32), axis=(1, 2)), k)
        )(*decode3._decode_core_v3(*a, **kw))
    )
    s_d, ok_d = jax.block_until_ready(csum(*args))
    assert bool(np.asarray(ok_d).all()), "device decode not ok"
    assert [int(x) for x in np.asarray(s_d)] == [
        int(im.astype(np.int64).sum()) for im in imgs[:BATCH]
    ]
    ts = []
    for _ in range(reps_left(2)):
        t0 = time.perf_counter()
        s_d, ok_d = csum(*args)
        np.asarray(s_d)
        ts.append(time.perf_counter() - t0)
    extras["decode_device"] = round(BATCH * imgs[0].nbytes / 1e6 / min(ts), 2)

    shares = []
    pipeline.pop_stats()
    for rep in range(reps_left(3)):
        t0 = time.perf_counter()
        results, stats = roundtrip_hybrid(
            batches, device_threads=DEVICE_THREADS, cpu_threads=CPU_THREADS
        )
        dt = time.perf_counter() - t0
        value = max(value, mb / dt)
        shares.append(stats["device_batches"] / len(batches))
        # per-rep anchor: one device-produced blob must decode to the
        # original through the UNRELATED native decoder too (the
        # device-verified images return the resident original as their
        # decode, so the host equality assert alone would be tautological)
        anchor = rep % N_IMAGES
        ad = results[anchor // BATCH][anchor % BATCH][0]
        assert np.array_equal(oracle.decode_native(ad), imgs[anchor])
        print(
            f"rep {rep}: {mb / dt:.1f} MB/s device_share={shares[-1]:.2f}",
            file=sys.stderr,
            flush=True,
        )
    for out, hb in zip(results, host_batches):
        for (d, dec), im in zip(out, hb):
            assert np.array_equal(dec, im), "round-trip mismatch"
    extras["device_share"] = round(max(shares), 3)
    pstats = pipeline.pop_stats()
    extras["encode_overflow_fallbacks"] = pstats["overflow_fallbacks"]
    extras["device_fallbacks"] = pstats["device_fallbacks"]
    assert pstats["overflow_fallbacks"] == 0, "valid images must not overflow"

    print(
        json.dumps(
            {
                "metric": "encode+decode MB/s (512x512 RGB8 bit-exact round-trips, hybrid device+host pipeline)",
                "value": round(value, 2),
                "unit": "MB/s",
                "vs_baseline": round(value / base_mbs, 3),
                "baseline_native_mbs": round(base_mbs, 2),
                "device": device_info,
                **extras,
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
