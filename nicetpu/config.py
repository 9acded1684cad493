"""Typed runtime configuration (SURVEY §5 — the reference has none).

Format constants stay frozen in `format/constants.py`; this config only
covers runtime choices: backend selection, batching, cache dirs.
Resolution order: explicit kwargs > environment (NICETPU_*) > defaults.
"""

from __future__ import annotations

import dataclasses
import os

# The checkout's root (the directory above the `nicetpu` package).
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compilation_cache_dir() -> str:
    """Where JAX's persistent compile cache lives: `JAX_COMPILATION_CACHE_DIR`
    when it is set, otherwise `<checkout>/.jax_cache`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, ".jax_cache"
    )


def apply_compilation_cache() -> str:
    """Point JAX's persistent compile cache at `compilation_cache_dir()`
    (call before the first compile).  Returns the directory."""
    import jax

    path = compilation_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path


@dataclasses.dataclass
class RuntimeConfig:
    backend: str = "auto"  # auto | jax | native | spec
    batch_size: int = 4  # images per device batch dispatch (pipeline)
    workers: int = 4  # pipeline thread-pool width
    omp_threads: int = 0  # 0 = OpenMP default
    verbose: bool = False  # stage-timing prints (cli / pipeline)

    @classmethod
    def from_env(cls, **overrides) -> "RuntimeConfig":
        cfg = cls()
        for f in dataclasses.fields(cls):
            env = os.environ.get(f"NICETPU_{f.name.upper()}")
            if env is not None:
                val = type(f.default)(env) if not isinstance(f.default, bool) else env.lower() in ("1", "true", "yes")
                setattr(cfg, f.name, val)
        for k, v in overrides.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown config field {k!r}")
            setattr(cfg, k, v)
        return cfg

    def apply(self) -> None:
        """Apply process-level settings (call before first jax use)."""
        apply_compilation_cache()
        if self.omp_threads:
            os.environ["OMP_NUM_THREADS"] = str(self.omp_threads)
