"""User-facing API: encode / decode / PNG bridges.

Mirrors the reference CLI's capabilities (ref main.rs:17-139): PNG <-> `.nice`
conversion for RGB and RGBA (alpha is dropped, matching the reference encoder;
we write channels=3 instead of reproducing the reference's undecodable
channels=4 files — SURVEY A.8.3).

Backend selection: "auto" takes the JAX device codec on a GPU
(`nicetpu.device`) and the native C++ codec elsewhere; the numpy spec codec
is the always-available fallback when the native library cannot load.  An
explicit "jax" always runs the JAX codec, and a device error propagates.
"""

from __future__ import annotations

import numpy as np

from nicetpu import device


def _resolve_backend(backend: str | None, config=None) -> str:
    """Backend resolution: explicit arg > config > NICETPU_BACKEND > auto."""
    if backend is not None and backend != "config":
        return backend
    if config is None:
        from nicetpu.config import RuntimeConfig

        config = RuntimeConfig.from_env()
    return config.backend


def _to_rgb(img: np.ndarray, alpha: str = "drop") -> np.ndarray:
    """Normalize to (H, W, 3) uint8.

    The `.nice` wire format cannot round-trip alpha: the reference encoder
    accepts RGBA but its decoder reconstructs 3 bytes/pixel unconditionally
    (ref code.rs:659; SURVEY A.8.3), so reference channels=4 files are
    undecodable even by the reference itself.  This codec therefore always
    writes channels=3; `alpha` controls the RGBA policy:
      "drop"  - discard the alpha plane (the reference encoder's behavior)
      "error" - refuse RGBA input outright
    """
    if img.ndim != 3 or img.dtype != np.uint8:
        raise ValueError("expected (H, W, C) uint8 image")
    if img.shape[2] == 4:
        if alpha == "error":
            raise ValueError(
                "RGBA input refused (alpha='error'): .nice cannot round-trip "
                "alpha (SURVEY A.8.3)"
            )
        if alpha != "drop":
            raise ValueError(f"unknown alpha policy {alpha!r}")
        img = img[:, :, :3]
    if img.shape[2] != 3:
        raise ValueError("expected RGB or RGBA image")
    return np.ascontiguousarray(img)


def encode(
    img: np.ndarray, backend: str | None = None, config=None, alpha: str = "drop"
) -> bytes:
    """Encode an (H, W, 3|4) uint8 array to `.nice` bytes.

    backend: "auto" | "jax" | "native" | "spec"; None resolves it from
    `config` (a RuntimeConfig) or the NICETPU_BACKEND environment.
    alpha: RGBA policy — "drop" (reference behavior) or "error" (see _to_rgb).
    """
    backend = _resolve_backend(backend, config)
    img = _to_rgb(img, alpha)
    if backend == "jax" or (backend == "auto" and device.is_gpu()):
        from nicetpu.kernels.encode2 import encode_jax_v2

        return encode_jax_v2(img)
    if backend in ("auto", "native"):
        try:
            from nicetpu.hostref.oracle import encode_native

            return encode_native(img)
        except (ImportError, OSError):
            if backend == "native":
                raise
    from nicetpu.spec import codec

    return codec.encode(img)


def decode(data: bytes, backend: str | None = None, config=None) -> np.ndarray:
    """Decode `.nice` bytes to an (H, W, 3) uint8 array.

    backend: "auto" | "jax" | "native" | "spec"; None resolves it from
    `config` or the NICETPU_BACKEND environment.  "jax" is the device v3
    decoder (speculative chunk walk + segment-LUT reconstruction,
    kernels/decode3.decode_jax_v3); "native" is the serial C++ decoder.
    "auto" takes native for single images; batch decode on a GPU routes to
    the device decoder via decode_batch.
    """
    backend = _resolve_backend(backend, config)
    if backend == "jax":
        from nicetpu.kernels.decode3 import decode_jax_v3

        return decode_jax_v3(data)
    if backend in ("auto", "native"):
        try:
            from nicetpu.hostref.oracle import decode_native

            return decode_native(data)
        except (ImportError, OSError):
            if backend == "native":
                raise
    from nicetpu.spec import codec

    return codec.decode(data)


def encode_batch(
    imgs: list[np.ndarray],
    backend: str | None = None,
    config=None,
    stats: dict | None = None,
) -> list[bytes]:
    """Batch encode (BASELINE configs 2/4).  Same-shape batches use the
    device pipeline with per-image Huffman tables; mixed sizes use the
    OpenMP native path (or per-image fallback).

    Pass `stats` (a dict) to receive {"backend": the path that served the
    call, plus the pipeline's device-fallback counters (pipeline.pop_stats)
    when the device path ran} — callers can assert fallbacks == 0 rather
    than trusting silence."""
    backend = _resolve_backend(backend, config)
    imgs = [_to_rgb(im) for im in imgs]
    same_shape = len({im.shape for im in imgs}) == 1
    if (backend == "jax" or (backend == "auto" and device.is_gpu())) and same_shape:
        from nicetpu.kernels.encode2 import encode_batch as jb

        out = jb(np.stack(imgs))
        if stats is not None:
            from nicetpu.pipeline import pop_stats

            stats.update(pop_stats())
            stats["backend"] = "jax"
        return out
    if backend in ("auto", "native", "jax"):
        try:
            from nicetpu.hostref.oracle import encode_batch_native

            out = encode_batch_native(imgs)
            if stats is not None:
                stats["backend"] = "native"
            return out
        except (ImportError, OSError):
            if backend == "native":
                raise
    if stats is not None:
        stats["backend"] = "spec"
    return [encode(im, backend="spec") for im in imgs]


def decode_batch(
    datas: list[bytes],
    backend: str | None = None,
    config=None,
    stats: dict | None = None,
) -> list[np.ndarray]:
    """Batch decode.  On a GPU, "auto" routes same-shape batches to the
    device v3 decoder (kernels/decode3.decode_batch_jax_v3 — the production
    device decode path) with a per-image host fallback for streams the
    device pipeline cannot verify; "native" is the OpenMP host path.  Pass `stats` to receive the v3 decoder's
    {"fallbacks", "retries", "ok"} plus {"backend"}."""
    backend = _resolve_backend(backend, config)
    same_shape = False
    if backend in ("jax", "auto"):
        try:
            from nicetpu.format.headers import parse_file_header

            same_shape = len({parse_file_header(d)[:2] for d in datas}) == 1
        except Exception:
            same_shape = False
    if backend == "jax" or (backend == "auto" and device.is_gpu() and same_shape):
        from nicetpu.kernels.decode3 import decode_batch_jax_v3

        out = decode_batch_jax_v3(datas, stats=stats)
        if stats is not None:
            stats["backend"] = "jax"
        return out
    if backend in ("auto", "native"):
        try:
            from nicetpu.hostref.oracle import decode_batch_native

            out = decode_batch_native(datas)
            if stats is not None:
                stats["backend"] = "native"
            return out
        except (ImportError, OSError):
            if backend == "native":
                raise
    if stats is not None:
        stats["backend"] = "spec"
    return [decode(d, backend="spec") for d in datas]


def imread(path: str) -> np.ndarray:
    """Read a PNG (or any PIL-supported image) as (H, W, 3|4) uint8."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode not in ("RGB", "RGBA"):
            im = im.convert("RGB")
        return np.asarray(im, dtype=np.uint8)


def imwrite(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img).save(path)
