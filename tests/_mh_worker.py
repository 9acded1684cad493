"""Worker for the 2-process jax.distributed multihost test.

Usage: python tests/_mh_worker.py <coordinator> <num_procs> <pid> <out_file>
Launched by tests/test_multihost.py with JAX_PLATFORMS=cpu so each process exposes 4 virtual CPU devices (8 global).
"""

from __future__ import annotations

import os
import sys

import numpy as np


def make_image() -> np.ndarray:
    rng = np.random.default_rng(7)
    img = (rng.integers(0, 5, (64, 32, 1)) * 47 + rng.integers(0, 4, (64, 32, 3))).astype(
        np.uint8
    )
    img[20:29] = img[19, -1]  # run crossing process boundaries
    return img


def main() -> int:
    coordinator, n_procs, pid, out_file = (
        sys.argv[1],
        int(sys.argv[2]),
        int(sys.argv[3]),
        sys.argv[4],
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    from nicetpu.dist.multihost import (
        decode_multihost,
        encode_multihost,
        initialize_distributed,
    )

    initialize_distributed(coordinator, n_procs, pid)
    assert jax.process_count() == n_procs, jax.process_count()
    assert len(jax.devices()) == 4 * n_procs, jax.devices()

    img = make_image()
    data = encode_multihost(img)
    if pid == 0:
        assert data is not None
        # atomic publish: write to a temp path, then rename — a reader can
        # never observe a partially written blob
        tmp = out_file + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, out_file)
    else:
        assert data is None

    # decode leg: every process needs the bytes; proc 0 broadcasts via the
    # out_file (the coordinator-visible filesystem stands in for the
    # loader's side channel)
    import time

    blob = None
    for _ in range(100):
        try:
            blob = open(out_file, "rb").read()
            break
        except FileNotFoundError:
            time.sleep(0.1)
    assert blob, f"proc {pid}: encoded blob never appeared at {out_file}"
    out = decode_multihost(blob)
    if pid == 0:
        assert out is not None
        assert np.array_equal(out, img), "multihost decode mismatch"
    else:
        assert out is None
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
