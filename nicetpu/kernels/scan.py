"""Log-doubling scan primitives that compile small and run at bandwidth.

These unrolled log-step formulations are pure pad/slice/elementwise ops that
XLA fuses into a few memory-bound passes.
"""

from __future__ import annotations

import jax.numpy as jnp


def suffix_min(x: jnp.ndarray) -> jnp.ndarray:
    """out[i] = min(x[i:]) via log2(n) shift-min steps (1-D)."""
    n = x.shape[0]
    pad_val = x.dtype.type(jnp.iinfo(x.dtype).max)
    s = 1
    while s < n:
        shifted = jnp.concatenate([x[s:], jnp.full(min(s, n), pad_val, x.dtype)])
        x = jnp.minimum(x, shifted)
        s *= 2
    return x
