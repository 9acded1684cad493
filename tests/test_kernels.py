"""JAX kernel tests on the CPU backend: byte-parity with the numpy spec."""

import numpy as np
import pytest

from nicetpu.spec import codec


def _images(seed=0, count=10):
    rng = np.random.default_rng(seed)
    for t in range(count):
        h = int(rng.integers(1, 20))
        w = int(rng.integers(4, 24))
        style = t % 4
        if style == 0:
            yield rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        elif style == 1:
            yield (rng.integers(0, 3, (h, w, 3)) * 100).astype(np.uint8)
        elif style == 2:
            yield (
                rng.integers(0, 8, (h, w, 1)) * 30 + rng.integers(0, 4, (h, w, 3))
            ).astype(np.uint8)
        else:
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            img[h // 2 :] = img[max(h // 2 - 1, 0), 0]
            yield img


class TestJaxEncoder:
    def test_byte_identical_to_spec(self):
        from nicetpu.kernels.encode2 import encode_jax_v2

        for img in _images(seed=10):
            assert encode_jax_v2(img) == codec.encode(img)

    def test_tokenize_matches_spec_plan(self):
        import jax.numpy as jnp

        from nicetpu.kernels.tokenize import tokenize_and_count

        rng = np.random.default_rng(11)
        img = (rng.integers(0, 6, (12, 16, 1)) * 40 + rng.integers(0, 4, (12, 16, 3))).astype(np.uint8)
        plan = codec.tokenize(img)
        tok = tokenize_and_count(jnp.asarray(img.reshape(-1, 3)), width=16)
        np.testing.assert_array_equal(np.asarray(tok["valid"]), plan.valid)
        np.testing.assert_array_equal(
            np.asarray(tok["streams"]), plan.streams.astype(np.int32)
        )
        np.testing.assert_array_equal(
            np.asarray(tok["symbols"]), plan.symbols.astype(np.int32)
        )
        np.testing.assert_array_equal(
            np.asarray(tok["counts"]), codec.histogram(plan).astype(np.int32)
        )


class TestMergePack:
    def test_matches_numpy_reference(self):
        import jax.numpy as jnp

        from nicetpu.kernels.bitpack import merge_pack

        rng = np.random.default_rng(12)
        for levels in (4, 8, 11):
            M = 1 << levels
            aob = rng.integers(0, 32, M).astype(np.int32)
            aob[rng.random(M) < 0.4] = 0
            code = np.array(
                [rng.integers(0, 1 << int(a)) if a else 0 for a in aob],
                dtype=np.uint32,
            )
            words, total = merge_pack(
                jnp.asarray(aob), jnp.asarray(code), levels=levels
            )
            total = int(total)
            assert total == int(aob.sum())
            # serial reference pack
            acc = bytearray()
            cache, nbits = 0, 0
            for a, c in zip(aob, code):
                cache = (cache << int(a)) | int(c)
                nbits += int(a)
                while nbits >= 8:
                    nbits -= 8
                    acc.append((cache >> nbits) & 0xFF)
            if nbits:
                acc.append((cache << (8 - nbits)) & 0xFF)
            got = np.asarray(words).astype(">u4").tobytes()[: len(acc)]
            assert got == bytes(acc)


class TestGroupedFold:
    """Grouped bit placement (encode2._fold_place_grouped) must be
    bit-identical to the per-slot exact path whenever it does not overflow,
    and the fused encode built on it must stay byte-identical to the spec."""

    def test_matches_slot_place(self):
        import jax
        import jax.numpy as jnp

        from nicetpu.kernels.encode2 import _fold_place_grouped, _place

        rng = np.random.default_rng(31)
        for N, S in ((512, 8), (1000, 8), (64, 13)):
            aob = rng.integers(0, 12, (N, S)).astype(np.int32)
            aob[rng.random((N, S)) < 0.5] = 0
            code = np.array(
                [[rng.integers(0, 1 << a) if a else 0 for a in row] for row in aob],
                dtype=np.uint32,
            )
            w_cap = int(aob.sum()) // 32 + 8
            words_g, total_g, ovf = _fold_place_grouped(
                jnp.asarray(aob), jnp.asarray(code), w_cap=w_cap
            )
            assert not bool(ovf)
            words_s, total_s = _place(
                jnp.asarray(aob.reshape(-1)), jnp.asarray(code.reshape(-1)), w_cap=w_cap
            )
            assert int(total_g) == int(total_s)
            np.testing.assert_array_equal(np.asarray(words_g), np.asarray(words_s))

    def test_overflow_flag_on_dense_groups(self):
        import jax.numpy as jnp

        from nicetpu.kernels.encode2 import _fold_place_grouped

        N, S = 64, 8
        aob = np.full((N, S), 31, np.int32)  # 248 bits/pixel >> every cap
        code = np.zeros((N, S), np.uint32)
        _, _, ovf = _fold_place_grouped(
            jnp.asarray(aob), jnp.asarray(code), w_cap=1024
        )
        assert bool(ovf)

    def test_fused_encode_byte_identical(self):
        from nicetpu.pipeline import encode_batch_fused

        imgs = [im for im in _images(seed=32, count=6) if im.shape[0] * im.shape[1] >= 8]
        for img in imgs:
            got = encode_batch_fused([img])[0]
            assert got == codec.encode(img)


class TestSharded:
    def test_sharded_encode_matches_spec(self):
        from nicetpu.dist.sharded import encode_sharded, make_mesh

        mesh = make_mesh(8)
        rng = np.random.default_rng(13)
        cases = []
        img = rng.integers(0, 256, (32, 16, 3), dtype=np.uint8)
        cases.append(img)
        img = (rng.integers(0, 4, (64, 8, 1)) * 60 + rng.integers(0, 4, (64, 8, 3))).astype(np.uint8)
        cases.append(img)
        img = rng.integers(0, 256, (40, 12, 3), dtype=np.uint8)
        img[13:27] = img[12, -1]  # run crossing shard boundaries
        cases.append(img)
        cases.append(np.full((48, 8, 3), 77, dtype=np.uint8))  # whole-image run
        for img in cases:
            assert encode_sharded(img, mesh) == codec.encode(img)

    def test_sharded_2048_scale(self):
        """BASELINE config-5 stepping stone: a
        2048x2048 raster on the 8-mesh whose runs span >8^3 pixels and cross
        multiple shard boundaries (multi-digit run folds + the all_gather
        tail fix), byte-equal to the spec encoder."""
        from nicetpu.dist.sharded import encode_sharded, make_mesh

        mesh = make_mesh(8)
        rng = np.random.default_rng(21)
        img = rng.integers(0, 256, (2048, 2048, 3), dtype=np.uint8)
        # a >1.2M-pixel run crossing shards 1-3 (shard = 256 rows);
        # v = 1259519 needs 7 base-8 digits
        img[300:900] = img[299, -1]
        # a medium run ending exactly on a shard boundary
        img[1024 - 40 : 1024] = img[1024 - 41, -1]
        # smooth gradient region (mode-cascade variety, short runs)
        yy, xx = np.mgrid[0:512, 0:2048]
        img[1300:1812] = (
            np.stack([xx // 8 + yy, xx // 16, yy // 4], axis=-1) % 256
        ).astype(np.uint8)
        assert encode_sharded(img, mesh) == codec.encode(img)


class TestGraftEntry:
    def test_entry_compiles(self):
        import jax

        import __graft_entry__ as ge

        fn, args = ge.entry()
        counts, nvalid = fn(*args)
        assert int(np.asarray(counts).sum()) == int(nvalid)

    def test_dryrun_multichip(self):
        import __graft_entry__ as ge

        ge.dryrun_multichip(8)
