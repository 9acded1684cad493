"""Multi-host encode test: 2 local jax.distributed processes (SURVEY §4).

Spawns two fresh CPU-backend processes (4 virtual devices each -> 8-device
global mesh over 2 processes), runs dist.multihost.encode_multihost on an
identical raster in both, and asserts the process-0 output is byte-identical
to the serial spec encoder.  This executes the real multi-process branch —
`jax.distributed.initialize`, cross-process device_put, the all_gather
reshard of the packed payload, and the host-0 ordered stitch.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_encode_matches_spec(tmp_path):
    n_procs = 2
    port = _free_port()
    out_file = str(tmp_path / "mh.nice")

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_COMPILATION_CACHE_DIR"] = ""
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    procs = [
        subprocess.Popen(
            [
                sys.executable,
                os.path.join(REPO, "tests", "_mh_worker.py"),
                f"localhost:{port}",
                str(n_procs),
                str(pid),
                out_file,
            ],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(n_procs)
    ]
    outputs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outputs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, f"worker failed:\n{out}"

    from nicetpu.spec import codec
    from _mh_worker import make_image

    img = make_image()
    with open(out_file, "rb") as f:
        got = f.read()
    assert got == codec.encode(img)
    assert np.array_equal(codec.decode(got), img)
