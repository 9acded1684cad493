"""The one place that decides which platform the device path compiles for.

Every path that has a platform-specific choice asks here: `api`'s "auto"
routing and the decoder's walk (`kernels.decode3`).  Two platforms are
supported:

  "gpu" - the device path, with the hand-written walk kernel;
  "cpu" - the same programs with the plain `lax` walk (tests, rehearsals).

Any other JAX backend raises: nothing falls back silently.
"""

from __future__ import annotations

PLATFORMS = ("gpu", "cpu")


def platform() -> str:
    """JAX's default backend, checked against `PLATFORMS`."""
    import jax

    p = jax.default_backend()
    if p not in PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {p!r}: the device path runs on "
            f"{' or '.join(PLATFORMS)}"
        )
    return p


def is_gpu() -> bool:
    """True on a GPU, the one platform decision.  There the decoder's walk
    runs as the GPU kernel (`decode3.walk_gpu`, else the plain `lax.scan`
    `decode3.walk_ref`), and "auto" routes to the JAX codec: on a CPU-only
    host the native C++ codec answers in milliseconds while XLA's CPU
    compile of the fused programs takes minutes."""
    return platform() == "gpu"


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them; every device number is reported beside this line."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip()

