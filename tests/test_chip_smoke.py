"""chip_smoke.py's phases at tiny sizes on the CPU (the device check is
skipped by calling the phases directly), plus its refusal to run without a
GPU."""

import subprocess
import sys

import numpy as np

import chip_smoke
from nicetpu.hostref import oracle


def test_generators_are_seeded_and_screen_has_runs():
    a = chip_smoke.photo_image(24, 40, seed=1)
    assert a.shape == (24, 40, 3) and a.dtype == np.uint8
    assert np.array_equal(a, chip_smoke.photo_image(24, 40, seed=1))
    assert not np.array_equal(a, chip_smoke.photo_image(24, 40, seed=2))
    s = chip_smoke.screen_image(256, 320, seed=3)
    # flat fills and repeated tiles compress far better than photo content
    photo = chip_smoke.photo_image(256, 320, seed=3)
    assert len(oracle.encode_native(s)) * 3 < len(oracle.encode_native(photo))


def test_phase_photo_batch_tiny():
    datas = chip_smoke.phase_photo_batch(n=2, h=16, w=24)
    assert len(datas) == 2


def test_phase_fused_roundtrip_tiny():
    chip_smoke.phase_fused_roundtrip(n=2, h=16, w=16)


def test_phase_large_raster_tiny():
    chip_smoke.phase_large_raster(h=128, w=96)


def test_phase_walk_parity_tiny_interpret():
    imgs = [chip_smoke.photo_image(12, 20, seed=s) for s in range(2)]
    chip_smoke.phase_walk_parity(oracle.encode_batch_native(imgs), interpret=True)


def test_refuses_without_gpu():
    """Here JAX finds only the CPU: exit non-zero, print no result line."""
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        capture_output=True, text=True, timeout=300,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
