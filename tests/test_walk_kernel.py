"""The GPU walk kernel (`decode3.walk_gpu`) against its plain oracle.

The kernel runs here in Pallas interpret mode; on the card the same
comparison runs compiled (`test_walk_kernel_on_gpu`, marked `gpu`).  Every
check is exact equality of the walk records and exits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nicetpu import device
from nicetpu.format import constants as C
from nicetpu.format import headers
from nicetpu.hostref import oracle
from nicetpu.kernels import decode3 as d3


def _walk_inputs(img, chunk_bits):
    """Walk arguments for one natively encoded image, batch of one."""
    data = oracle.encode_native(img)
    payload = data[C.FILE_HEADER_BYTES + C.STREAM_HEADERS_BYTES : len(data) - 4]
    flat_lengths = headers.parse_stream_headers(data[C.FILE_HEADER_BYTES :])
    af, present, ib, pfx16, _sym = d3.prepare_tables_v3(flat_lengths)
    wn = d3._wcap_one(len(payload), d3.WalkCfg(chunk_bits, 1, 1))
    nch = (wn - d3.LOOKAHEAD_WORDS) // (chunk_bits // 32)
    words = np.zeros((1, wn), np.uint32)
    src = np.frombuffer(payload + b"\0" * ((-len(payload)) % 4), dtype=">u4")
    words[0, : src.shape[0]] = src
    aff, dD, inc = d3.derive_walk_tables(
        jnp.asarray(af.view(np.int32)[None]),
        jnp.asarray(present.astype(np.int32)[None]),
        jnp.asarray(ib.astype(np.int32)[None]),
    )
    entries = jnp.arange(nch, dtype=jnp.int32)[None] * chunk_bits
    return dict(
        words=jnp.asarray(words.view(np.int32)),
        entries=entries,
        aff=aff,
        dD=dD,
        inc=inc,
        pfx=jnp.asarray(pfx16),
        wbits=jnp.asarray([len(payload) * 8], jnp.int32),
        maxl=d3.WALK_MAXL,
    )


def _image(seed, h=40, w=48):
    rng = np.random.default_rng(seed)
    img = (rng.integers(0, 18, (h, w, 3)) * 7).astype(np.uint8)
    img[h // 3 : h // 2] = img[h // 3, 0]  # runs
    return img


def _ref(a, *, chunk_bits, steps, chunk0=0):
    return d3.walk_ref(
        a["words"][0], a["entries"][0], a["aff"][0], a["dD"][0], a["inc"][0],
        a["pfx"][0], a["wbits"][0], chunk_bits=chunk_bits, steps=steps,
        maxl=a["maxl"], chunk0=chunk0,
    )


def _kernel(a, *, chunk_bits, steps, chunk0=0, interpret=True):
    return d3.walk_gpu(
        a["words"], a["entries"], a["aff"], a["dD"], a["inc"], a["pfx"],
        a["wbits"], jnp.asarray([chunk0], jnp.int32), chunk_bits=chunk_bits,
        steps=steps, maxl=a["maxl"], interpret=interpret,
    )


def _assert_same(got, want):
    names = ("pos", "sym", "i12", "i34", "exits")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(np.asarray(g)[0], np.asarray(w), err_msg=name)


@pytest.mark.parametrize("rung", [0, 1])
@pytest.mark.parametrize("seed", [3, 11])
def test_walk_kernel_interpret_matches_ref(monkeypatch, seed, rung):
    """Both ladder rungs' step budgets, at small chunks so several chunks
    (and, with 4 chunks per program, several programs with a ragged tail)
    walk a tiny image."""
    monkeypatch.setattr(d3, "WALK_CHUNKS", 4)
    cfg = d3.LADDER[rung]
    chunk_bits = cfg.chunk_bits // 8
    steps = d3._steps(chunk_bits, cfg.steps_div)
    a = _walk_inputs(_image(seed), chunk_bits)
    assert a["entries"].shape[1] > 4  # more than one program
    want = _ref(a, chunk_bits=chunk_bits, steps=steps)
    got = _kernel(a, chunk_bits=chunk_bits, steps=steps)
    _assert_same(got, want)
    # mid-chunk entries (later rounds): re-walk from the first round's exits
    e = jnp.concatenate([jnp.zeros((1, 1), jnp.int32), want[4][None, :-1]], axis=1)
    a2 = {**a, "entries": e}
    _assert_same(
        _kernel(a2, chunk_bits=chunk_bits, steps=steps),
        _ref(a2, chunk_bits=chunk_bits, steps=steps),
    )


def test_walk_kernel_shard_slice():
    """chunk0 > 0: a shard-local word slice walks global bit positions
    (dist.sharded_decode), the same as the full walk's tail chunks."""
    chunk_bits, steps = 256, d3._steps(256, 8)
    a = _walk_inputs(_image(5), chunk_bits)
    nch = a["entries"].shape[1]
    c0 = nch // 2
    wpc = chunk_bits // 32
    sl = {
        **a,
        "words": a["words"][:, c0 * wpc :],
        "entries": a["entries"][:, c0:],
    }
    want = _ref(sl, chunk_bits=chunk_bits, steps=steps, chunk0=c0)
    full = _ref(a, chunk_bits=chunk_bits, steps=steps)
    for w_, f_ in zip(want, full):
        np.testing.assert_array_equal(np.asarray(w_), np.asarray(f_)[c0:])
    _assert_same(_kernel(sl, chunk_bits=chunk_bits, steps=steps, chunk0=c0), want)


@pytest.mark.parametrize("backend,kernel", [("gpu", True), ("cpu", False)])
def test_walk_batch_follows_platform(monkeypatch, backend, kernel):
    """walk_batch takes the kernel exactly when the platform module says
    "gpu"; on "cpu" it takes the plain scan."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert device.is_gpu() is kernel
    called = []
    monkeypatch.setattr(d3, "walk_gpu", lambda *a, **k: called.append(1))
    monkeypatch.setattr(
        d3, "walk_ref", lambda *a, **k: called.append(0) or (jnp.zeros(1),) * 5
    )
    z = jnp.zeros((1, 4), jnp.int32)
    t = jnp.zeros((1, 10, 32), jnp.int32)
    d3.walk_batch(
        z, z, t, t, t, jnp.zeros((1, 16), jnp.int32), z[:, 0], z[:, 0],
        chunk_bits=32, steps=1, maxl=8,
    )
    assert called == [1 if kernel else 0]


@pytest.mark.gpu
def test_walk_kernel_on_gpu(gpu):
    """Compiled kernel vs walk_ref on the card, both rungs, full chunks."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:256, 0:384]
    base = 128 + 60 * np.sin(xx / 37.0) + 50 * np.cos(yy / 23.0)
    img = np.clip(
        base[..., None] + rng.integers(-6, 7, (256, 384, 3)), 0, 255
    ).astype(np.uint8)
    for cfg in d3.LADDER:
        steps = d3._steps(cfg.chunk_bits, cfg.steps_div)
        a = _walk_inputs(img, cfg.chunk_bits)
        want = jax.jit(
            lambda: _ref(a, chunk_bits=cfg.chunk_bits, steps=steps)
        )()
        got = _kernel(a, chunk_bits=cfg.chunk_bits, steps=steps, interpret=False)
        _assert_same(got, want)
