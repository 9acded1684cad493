"""Sharded decode tests on the 8-device virtual CPU mesh."""

import numpy as np

from nicetpu.dist.sharded import make_mesh
from nicetpu.dist import sharded_decode as sd
from nicetpu.spec import codec


def mkimg(h, w, seed=0):
    rng = np.random.default_rng(seed)
    img = (rng.integers(0, 5, (h, w, 1)) * 50 + rng.integers(0, 4, (h, w, 3))).astype(
        np.uint8
    )
    img[h // 3] = img[h // 3, 0]  # run row
    return img


def test_single_raster_sharded_decode():
    mesh = make_mesh(8)
    img = mkimg(64, 128, 0)
    data = codec.encode(img)
    out = sd.decode_sharded(data, mesh)
    assert np.array_equal(out, img)


def test_single_raster_sharded_decode_noisy():
    mesh = make_mesh(8)
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    data = codec.encode(img)
    out = sd.decode_sharded(data, mesh)
    assert np.array_equal(out, img)


def test_batch_sharded_decode():
    mesh = make_mesh(8)
    imgs = [mkimg(32, 64, s) for s in range(8)]
    datas = [codec.encode(im) for im in imgs]
    outs = sd.decode_batch_sharded(datas, mesh)
    for out, im in zip(outs, imgs):
        assert np.array_equal(out, im)


def test_sharded_roundtrip_vs_sharded_encode():
    """Full sharded round-trip: encode on the mesh, decode on the mesh."""
    from nicetpu.dist.sharded import encode_sharded

    mesh = make_mesh(8)
    img = mkimg(64, 128, 7)
    data = encode_sharded(img, mesh)
    assert data == codec.encode(img)
    out = sd.decode_sharded(data, mesh)
    assert np.array_equal(out, img)


def test_nearby_payloads_share_one_sharded_program():
    """Payloads of 17 and 19 chunks per device bucket to one program."""
    mesh = make_mesh(8)
    cb = sd.d3.CHUNK_BITS
    fn_a, nlc_a, _ = sd.build_sharded_decode(mesh, 64, 128, 8 * 17 * cb)
    fn_b, nlc_b, _ = sd.build_sharded_decode(mesh, 64, 128, 8 * 19 * cb - 5)
    assert nlc_a == nlc_b == 20
    assert fn_a is fn_b
