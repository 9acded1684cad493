"""Seeded synthetic content for smoke runs and benchmarks.

Two classes a lossless codec serves, generated in bulk with numpy so runs
need no image files: photo-like rasters (smooth gradients plus sensor-like
noise, exercising the difference modes and the Huffman streams) and
screen-like rasters (flat fills, long runs and repeated text-like tiles,
exercising runs and the back-reference modes).
"""

from __future__ import annotations

import numpy as np


def photo_image(h: int, w: int, seed: int) -> np.ndarray:
    """Photo-like RGB: smooth gradients with per-image phases, plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = rng.uniform(0.5, 2.0, 6)
    ph = rng.uniform(0, 2 * np.pi, 6)
    base = 128 + 55 * np.sin(xx / (37 * f[0]) + ph[0]) + 45 * np.cos(yy / (23 * f[1]) + ph[1])
    img = np.stack(
        [
            base,
            base + 20 * np.sin(xx / (11 * f[2]) + ph[2]),
            base - 15 * np.cos(yy / (7 * f[3]) + ph[3]) + 10 * np.sin((xx + yy) / (19 * f[4])),
        ],
        axis=-1,
    )
    noise = rng.integers(-3, 4, img.shape)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def screen_image(h: int, w: int, seed: int) -> np.ndarray:
    """Screen-like RGB: a flat desktop, flat windows with borders, long
    runs, and text-like tiles repeated along rows (back-reference modes)."""
    rng = np.random.default_rng(seed)
    img = np.empty((h, w, 3), np.uint8)
    img[:] = rng.integers(0, 256, 3, dtype=np.uint8)
    palette = rng.integers(0, 256, (8, 3), dtype=np.uint8)
    tiles = [palette[rng.integers(0, 8, (16, 12))] for _ in range(24)]
    for _ in range(max(1, h * w // 400_000)):
        y0, x0 = int(rng.integers(0, h - 64)), int(rng.integers(0, w - 64))
        y1 = min(h, y0 + int(rng.integers(64, max(65, h // 3))))
        x1 = min(w, x0 + int(rng.integers(64, max(65, w // 3))))
        img[y0:y1, x0:x1] = palette[rng.integers(0, 8)]
        img[y0:y1, [x0, x1 - 1]] = 0
        img[[y0, y1 - 1], x0:x1] = 0
        for ty in range(y0 + 20, y1 - 16, 18):  # lines of "text"
            n = int(rng.integers(0, (x1 - x0 - 8) // 12))
            for k in range(n):
                x = x0 + 4 + 12 * k
                img[ty : ty + 16, x : x + 12] = tiles[int(rng.integers(0, 24))]
    return img
