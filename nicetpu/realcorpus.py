"""Real-image benchmark corpus from images bundled with installed packages.

The reference's implied corpus is the QOI suite (ref .vscode/launch.json:
qoi-master/images) which is not available offline; this module assembles the
natural photographic content that IS present in the environment — a portrait
photo, camera captures, and large photographic textures — so compression
ratios and mode distributions are measured on real data, not sinusoids.
"""

from __future__ import annotations

import glob
import os

import numpy as np

_SP = "/opt/venv/lib/python3.12/site-packages"

# Deterministic corpus: (name, path) — photos and photographic textures.
_CANDIDATES = [
    ("hopper", f"{_SP}/matplotlib/mpl-data/sample_data/grace_hopper.jpg"),
    ("camera_rgb", f"{_SP}/pygame/docs/generated/_images/camera_rgb.jpg"),
    ("camera_hsv", f"{_SP}/pygame/docs/generated/_images/camera_hsv.jpg"),
    ("camera_avg", f"{_SP}/pygame/docs/generated/_images/camera_average.jpg"),
    (
        "wood",
        f"{_SP}/gymnasium_robotics/envs/assets/kitchen_franka/kitchen_assets/textures/wood1.png",
    ),
    (
        "marble",
        f"{_SP}/gymnasium_robotics/envs/assets/kitchen_franka/kitchen_assets/textures/white_marble_tile2.png",
    ),
    (
        "skin",
        f"{_SP}/gymnasium_robotics/envs/assets/adroit_hand/resources/textures/skin.png",
    ),
]
# the soccer jersey textures are byte-identical to each other; keep one
_SOCCER = sorted(
    glob.glob(f"{_SP}/dm_control/locomotion/soccer/assets/humanoid/B_0*.png")
)[:1]


def load_corpus(max_dim: int | None = None) -> list[tuple[str, np.ndarray]]:
    """Load the available real images as (name, (H, W, 3) uint8) pairs.

    max_dim: optionally center-crop to at most max_dim on each side (keeps
    bench runtimes bounded for the big textures)."""
    from nicetpu.api import imread

    out: list[tuple[str, np.ndarray]] = []
    paths = list(_CANDIDATES) + [
        (f"soccer{i}", p) for i, p in enumerate(_SOCCER)
    ]
    for name, path in paths:
        if not os.path.exists(path):
            continue
        img = imread(path)
        if img.shape[2] == 4:
            img = img[:, :, :3]
        if max_dim is not None and (img.shape[0] > max_dim or img.shape[1] > max_dim):
            h0 = (img.shape[0] - min(img.shape[0], max_dim)) // 2
            w0 = (img.shape[1] - min(img.shape[1], max_dim)) // 2
            img = img[h0 : h0 + max_dim, w0 : w0 + max_dim]
        out.append((name, np.ascontiguousarray(img)))
    return out
