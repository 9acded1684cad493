"""Streamed corpus encoding with checkpoint/resume and error isolation.

SURVEY §5 gaps the reference leaves open, made first-class here:
  * checkpoint/resume: a JSONL manifest records every completed image
    (path, size, ratio, backend); resuming skips completed entries.
  * failure isolation: one bad image doesn't abort the run — errors are
    recorded in the manifest and the stream continues (the reference
    panics, SURVEY §5 "failure detection").
  * observability: per-image mode-distribution stats (this codec's analogue
    of the reference's debug counters, ref code.rs:429-438).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np

from nicetpu.format import constants as C
from nicetpu.format import headers


@dataclass
class CorpusResult:
    total_images: int
    encoded: int
    skipped: int
    failed: int
    raw_bytes: int
    compressed_bytes: int
    seconds: float


def mode_stats(counts: np.ndarray) -> dict:
    """Mode-distribution stats from a flat (858,) histogram.

    The prefix stream (id 1) holds one symbol per encoded pixel plus run
    digits — the same observability the reference's debug counters provide.
    """
    base = C.STREAM_BASE[C.SC_PREFIXES]
    pfx = counts[base : base + 13]
    return {
        "back_ref": int(pfx[C.PREFIX_BACK_REF]),
        "rgb": int(pfx[C.PREFIX_RGB]),
        "luma": int(pfx[C.PREFIX_COLOR_LUMA]),
        "small_diff": int(pfx[C.PREFIX_SMALL_DIFF]),
        "luma2": int(pfx[C.PREFIX_COLOR_LUMA2]),
        "run_digits": {d: int(pfx[C.PREFIX_RUN_BASE + d]) for d in range(8)},
        "total_tokens": int(counts.sum()),
    }


def stats_from_bitstream(data: bytes) -> dict:
    """Mode stats recovered from an encoded file's stream headers + C++
    decode-side counting is unnecessary: re-derive from a decode pass."""
    from nicetpu import api
    from nicetpu.spec import codec

    img = api.decode(data)
    plan = codec.tokenize(img)
    return mode_stats(codec.histogram(plan))


def encode_corpus(
    paths: list[str],
    out_dir: str,
    manifest_path: str | None = None,
    backend: str = "auto",
    resume: bool = True,
) -> CorpusResult:
    """Encode a list of image paths to `<out_dir>/<name>.nice`, streaming,
    with manifest checkpointing and per-image error isolation."""
    from nicetpu import api

    os.makedirs(out_dir, exist_ok=True)
    manifest_path = manifest_path or os.path.join(out_dir, "manifest.jsonl")

    done: set[str] = set()
    if resume and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if rec.get("status") == "ok":
                    done.add(rec["path"])

    t0 = time.perf_counter()
    encoded = skipped = failed = raw = comp = 0
    with open(manifest_path, "a") as mf:
        for path in paths:
            if path in done:
                skipped += 1
                continue
            name = os.path.splitext(os.path.basename(path))[0] + ".nice"
            rec: dict = {"path": path, "out": os.path.join(out_dir, name)}
            try:
                img = api.imread(path)
                data = api.encode(img, backend=backend)
                with open(rec["out"], "wb") as f:
                    f.write(data)
                rec.update(
                    status="ok",
                    raw=int(img[:, :, :3].nbytes),
                    compressed=len(data),
                    ratio=round(len(data) / img[:, :, :3].nbytes, 4),
                )
                encoded += 1
                raw += rec["raw"]
                comp += rec["compressed"]
            except Exception as e:  # isolate per-image failures
                rec.update(status="error", error=f"{type(e).__name__}: {e}")
                failed += 1
            mf.write(json.dumps(rec) + "\n")
            mf.flush()
    return CorpusResult(
        total_images=len(paths),
        encoded=encoded,
        skipped=skipped,
        failed=failed,
        raw_bytes=raw,
        compressed_bytes=comp,
        seconds=time.perf_counter() - t0,
    )
