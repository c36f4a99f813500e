"""Filtered search (``row_mask`` / engine ``where=``): restrict ranking to
a predicate-selected subset of the corpus — the FAISS ``IDSelector``
counterpart (the reference's evaluation itself slices by session kind,
e.g. purchase sessions, test_amazon_filterd.py metric family)."""

import numpy as np
import pytest

import jax.numpy as jnp

from sessionsimilaritysearch.index import DenseIndex, build_index
from sessionsimilaritysearch.ops.topk import (
    chunked_topk,
    l2_normalize,
    oracle_topk_np,
)


class TestChunkedTopkRowMask:
    def test_matches_oracle_on_masked_subset(self, rng):
        corpus = rng.standard_normal((512, 32)).astype(np.float32)
        queries = rng.standard_normal((9, 32)).astype(np.float32)
        mask = rng.random(512) < 0.3
        vals, idx = chunked_topk(
            jnp.asarray(queries), jnp.asarray(corpus), 7, chunk_size=128,
            row_mask=jnp.asarray(mask),
        )
        keep = np.flatnonzero(mask)
        ovals, oidx = oracle_topk_np(queries, corpus[keep], 7)
        np.testing.assert_allclose(np.asarray(vals), ovals, rtol=1e-4)
        np.testing.assert_array_equal(np.asarray(idx), keep[oidx])

    def test_composes_with_valid_count(self, rng):
        corpus = rng.standard_normal((256, 16)).astype(np.float32)
        queries = rng.standard_normal((5, 16)).astype(np.float32)
        mask = np.ones(256, bool)
        mask[::2] = False
        vals, idx = chunked_topk(
            jnp.asarray(queries), jnp.asarray(corpus), 5, chunk_size=64,
            valid_count=jnp.asarray(100, jnp.int32),
            row_mask=jnp.asarray(mask),
        )
        keep = np.flatnonzero(mask[:100])
        ovals, oidx = oracle_topk_np(queries, corpus[keep], 5)
        np.testing.assert_allclose(np.asarray(vals), ovals, rtol=1e-4)
        np.testing.assert_array_equal(np.asarray(idx), keep[oidx])

    def test_empty_mask_yields_missing_slots(self, rng):
        corpus = rng.standard_normal((64, 8)).astype(np.float32)
        queries = rng.standard_normal((3, 8)).astype(np.float32)
        vals, idx = chunked_topk(
            jnp.asarray(queries), jnp.asarray(corpus), 4, chunk_size=64,
            row_mask=jnp.zeros(64, bool),
        )
        assert np.all(np.asarray(idx) == -1)
        assert np.all(np.isneginf(np.asarray(vals)))

    def test_approx_mode_respects_mask(self, rng):
        corpus = rng.standard_normal((512, 16)).astype(np.float32)
        queries = rng.standard_normal((4, 16)).astype(np.float32)
        mask = rng.random(512) < 0.2
        _, idx = chunked_topk(
            jnp.asarray(queries), jnp.asarray(corpus), 5, chunk_size=128,
            mode="approx", row_mask=jnp.asarray(mask),
        )
        idx = np.asarray(idx)
        assert np.all(mask[idx[idx >= 0]])


class TestDenseIndexRowMask:
    def test_masked_search(self, rng):
        emb = rng.standard_normal((200, 24)).astype(np.float32)
        idx = build_index(emb, metric="cos")
        mask = rng.random(200) < 0.4
        q = rng.standard_normal((6, 24)).astype(np.float32)
        D, I = idx.search(q, 5, row_mask=mask)
        assert np.all(mask[I[I >= 0]])
        cn = np.asarray(l2_normalize(jnp.asarray(emb)))
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        keep = np.flatnonzero(mask)
        ovals, oidx = oracle_topk_np(qn, cn[keep], 5)
        np.testing.assert_allclose(D, ovals, rtol=1e-4)
        np.testing.assert_array_equal(I, keep[oidx])

    def test_mask_shorter_than_capacity_pads(self, rng):
        emb = rng.standard_normal((50, 8)).astype(np.float32)
        idx = DenseIndex(dim=8, capacity=128, metric="cos")
        idx.add(emb)
        mask = np.zeros(50, bool)
        mask[7] = True
        _, I = idx.search(emb[:3], 1, row_mask=mask)
        np.testing.assert_array_equal(I[:, 0], [7, 7, 7])

    def test_fresh_masks_never_retrace(self, rng):
        emb = rng.standard_normal((64, 8)).astype(np.float32)
        idx = build_index(emb, metric="cos")
        q = rng.standard_normal((4, 8)).astype(np.float32)
        idx.search(q, 3, row_mask=np.ones(64, bool))
        before = chunked_topk._cache_size()
        for _ in range(3):
            idx.search(q, 3, row_mask=rng.random(64) < 0.5)
        assert chunked_topk._cache_size() == before

    def test_bad_mask_length_raises(self, rng):
        emb = rng.standard_normal((50, 8)).astype(np.float32)
        idx = DenseIndex(dim=8, capacity=128, metric="cos")
        idx.add(emb)
        with pytest.raises(AssertionError, match="row_mask length"):
            idx.search(emb[:2], 1, row_mask=np.ones(60, bool))


@pytest.fixture(scope="module")
def mesh():
    from sessionsimilaritysearch.parallel import create_mesh

    return create_mesh()


class TestShardedRowMask:
    def test_gid_keyed_mask(self, mesh, rng):
        from sessionsimilaritysearch.index.sharded import (
            ShardedDenseIndex,
        )

        corpus = rng.standard_normal((160, 16)).astype(np.float32)
        idx = ShardedDenseIndex(dim=16, capacity=256, mesh=mesh,
                                metric="cos", chunk_size=64)
        idx.add(corpus)
        mask = rng.random(160) < 0.3
        cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
        D, I = idx.search(cn[:6], 5, row_mask=mask)
        assert np.all(mask[I[I >= 0]])
        keep = np.flatnonzero(mask)
        ovals, oidx = oracle_topk_np(cn[:6], cn[keep], 5)
        np.testing.assert_allclose(D, ovals, rtol=1e-4)
        np.testing.assert_array_equal(I, keep[oidx])

    def test_mask_stays_valid_across_removal(self, mesh, rng):
        from sessionsimilaritysearch.index.sharded import (
            ShardedDenseIndex,
        )

        corpus = rng.standard_normal((64, 8)).astype(np.float32)
        idx = ShardedDenseIndex(dim=8, capacity=128, mesh=mesh,
                                metric="cos", chunk_size=64)
        idx.add(corpus)
        idx.remove_ids([0, 9, 33])  # gids stay stable for survivors
        mask = np.zeros(64, bool)
        mask[40] = True
        cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
        _, I = idx.search(cn[:3], 1, row_mask=mask)
        np.testing.assert_array_equal(I[:, 0], [40, 40, 40])


class TestEngineWhere:
    def _engine(self, gen, tokenizer, mesh=None, prefilter=None):
        import jax

        from sessionsimilaritysearch.config import tiny_test_config
        from sessionsimilaritysearch.engine import SessionSearchEngine
        from sessionsimilaritysearch.models import (
            build_text_session_encoder,
        )
        from sessionsimilaritysearch.data.graph import (
            batch_graphs,
            sequence_to_graph,
        )

        cfg = tiny_test_config()
        enc = build_text_session_encoder(cfg)
        sample = batch_graphs([
            sequence_to_graph(0, *gen.datum(), tokenizer, cfg.dims)
        ] * 8)
        params = enc.init(jax.random.PRNGKey(0), sample)
        encode_fn = jax.jit(lambda g: enc.apply(params, g))
        return SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=128,
            batch_size=8, mesh=mesh, prefilter=prefilter,
        )

    def test_where_restricts_results(self, gen, tokenizer):
        eng = self._engine(gen, tokenizer)
        data = gen.dataset(24)
        eng.add_sessions(data)
        allowed = {id(eng.sessions[i]) for i in range(0, 24, 3)}
        pred = lambda s: id(s) in allowed  # noqa: E731
        D, I = eng.search(data[:4], k=4, where=pred)
        for row in I:
            for i in row:
                if i >= 0:
                    assert id(eng.sessions[i]) in allowed
        # predicate composes with dedup
        _, I2 = eng.search(data[:2], k=3, dedup=True, where=pred)
        assert np.all((I2 < 0) | (I2 % 3 == 0))

    def test_where_on_sharded_engine(self, gen, tokenizer, mesh):
        eng = self._engine(gen, tokenizer, mesh=mesh)
        data = gen.dataset(16)
        eng.add_sessions(data)
        targets = [d[0] for d in data[8:]]
        D, I = eng.search(data[:4], k=3,
                          where=lambda s: s in targets)
        assert np.all((I < 0) | (I >= 8))

    def test_where_on_twostage_engine(self, gen, tokenizer):
        eng = self._engine(gen, tokenizer, prefilter="binary")
        data = gen.dataset(24)
        eng.add_sessions(data)
        allowed = {id(eng.sessions[i]) for i in range(0, 24, 3)}
        _, I = eng.search(data[:4], k=4, where=lambda s: id(s) in allowed)
        for row in I:
            for i in row:
                if i >= 0:
                    assert id(eng.sessions[i]) in allowed

    def test_where_on_sharded_twostage_engine(self, gen, tokenizer, mesh):
        eng = self._engine(gen, tokenizer, mesh=mesh, prefilter="binary")
        data = gen.dataset(16)
        eng.add_sessions(data)
        targets = [d[0] for d in data[8:]]
        _, I = eng.search(data[:4], k=3, where=lambda s: s in targets)
        assert np.all((I < 0) | (I >= 8))


class TestHammingRowMask:
    """Filtered search through the binary scan family (packed XLA scan
    and sign-matmul scan)."""

    @pytest.fixture(scope="class")
    def signs(self):
        r = np.random.default_rng(11)
        c = np.where(r.random((600, 96)) < 0.5, 1.0, -1.0).astype(np.float32)
        q = np.where(r.random((9, 96)) < 0.5, 1.0, -1.0).astype(np.float32)
        mask = r.random(600) < 0.25
        return q, c, mask

    def test_hamming_topk_masked_matches_oracle(self, signs):
        from sessionsimilaritysearch.ops.hamming import (
            hamming_topk,
            oracle_hamming_np,
            pack_bits_np,
        )

        q, c, mask = signs
        d, i = hamming_topk(
            jnp.asarray(pack_bits_np(q)), jnp.asarray(pack_bits_np(c)),
            7, chunk_size=128, row_mask=jnp.asarray(mask),
        )
        d, i = np.asarray(d), np.asarray(i)
        assert np.all(mask[i[i >= 0]])
        ov, _ = oracle_hamming_np(q, c[mask], 7)
        np.testing.assert_array_equal(np.sort(d, 1), np.sort(ov, 1))

    def test_hamming_topk_mask_composes_with_valid_count(self, signs):
        from sessionsimilaritysearch.ops.hamming import (
            hamming_topk,
            oracle_hamming_np,
            pack_bits_np,
        )

        q, c, mask = signs
        d, i = hamming_topk(
            jnp.asarray(pack_bits_np(q)), jnp.asarray(pack_bits_np(c)),
            5, chunk_size=128,
            valid_count=jnp.asarray(300, jnp.int32),
            row_mask=jnp.asarray(mask),
        )
        d, i = np.asarray(d), np.asarray(i)
        assert np.all(i < 300) and np.all(mask[i[i >= 0]])
        ov, _ = oracle_hamming_np(q, c[:300][mask[:300]], 5)
        np.testing.assert_array_equal(np.sort(d, 1), np.sort(ov, 1))

    def test_sign_topk_masked_matches_oracle(self, signs):
        from sessionsimilaritysearch.ops.hamming import (
            oracle_hamming_np,
            sign_topk,
        )

        q, c, mask = signs
        d, i = sign_topk(
            jnp.asarray(q), jnp.asarray(c), 7, n_bits=96,
            row_mask=jnp.asarray(mask),
        )
        d, i = np.asarray(d), np.asarray(i)
        assert np.all(mask[i[i >= 0]])
        ov, _ = oracle_hamming_np(q, c[mask], 7)
        np.testing.assert_array_equal(np.sort(d, 1), np.sort(ov, 1))

class TestBinaryIndexRowMask:
    @pytest.fixture(scope="class")
    def signs(self):
        r = np.random.default_rng(5)
        c = np.where(r.random((300, 64)) < 0.5, 1.0, -1.0).astype(np.float32)
        q = c[:6]
        mask = r.random(300) < 0.3
        return q, c, mask

    @pytest.mark.parametrize("mode", ["sign", "packed"])
    def test_masked_search_matches_oracle(self, signs, mode):
        from sessionsimilaritysearch.index.binary import BinaryIndex
        from sessionsimilaritysearch.ops.hamming import oracle_hamming_np

        q, c, mask = signs
        idx = BinaryIndex(n_bits=64, capacity=512, mode=mode)
        idx.add(c)
        d, i = idx.search(q, 5, row_mask=mask)
        assert np.all(mask[i[i >= 0]])
        ov, _ = oracle_hamming_np(q, c[mask], 5)
        np.testing.assert_array_equal(np.sort(d, 1), np.sort(ov, 1))

    def test_bad_mask_length_raises(self, signs):
        from sessionsimilaritysearch.index.binary import BinaryIndex

        q, c, _ = signs
        idx = BinaryIndex(n_bits=64, capacity=512, mode="sign")
        idx.add(c)
        with pytest.raises(AssertionError, match="row_mask length"):
            idx.search(q, 3, row_mask=np.ones(100, bool))


class TestTwoStageRowMask:
    @pytest.fixture(scope="class")
    def data(self):
        r = np.random.default_rng(9)
        corpus = r.standard_normal((800, 48)).astype(np.float32)
        queries = r.standard_normal((7, 48)).astype(np.float32)
        mask = r.random(800) < 0.3
        return queries, corpus, mask

    @pytest.mark.parametrize("prefilter", ["binary", "int8x8", "pca"])
    def test_full_pool_masked_recovers_subset_exact(self, data, prefilter):
        """pool == corpus size + mask: stage 1 nominates every allowed
        row, so the result must be the exact full-dim ranking over the
        allowed subset (at bf16 storage precision)."""
        from sessionsimilaritysearch.index.twostage import (
            build_twostage_index,
        )
        from sessionsimilaritysearch.ops.topk import value_recall_at_k

        q, c, mask = data
        idx = build_twostage_index(c, prefilter=prefilter, n_bits=64,
                                   pca_dim=16)
        D, I = idx.search(q, 10, pool=800, row_mask=mask)
        assert np.all(mask[I[I >= 0]])
        keep = np.flatnonzero(mask)
        qn = np.asarray(l2_normalize(jnp.asarray(q)))
        cn = np.asarray(l2_normalize(jnp.asarray(c)))
        sub = {int(g): p for p, g in enumerate(keep)}
        I_sub = np.vectorize(lambda g: sub.get(int(g), -1))(I)
        tol = 2 * 2.0**-8
        assert value_recall_at_k(I_sub, qn, cn[keep], 10,
                                 rel_tol=tol) == 1.0

    def test_default_pool_mask_membership(self, data):
        from sessionsimilaritysearch.index.twostage import (
            build_twostage_index,
        )

        q, c, mask = data
        idx = build_twostage_index(c, prefilter="binary", n_bits=128)
        _, I = idx.search(q, 10, row_mask=mask)
        assert np.all(mask[I[I >= 0]])

    def test_bad_mask_length_raises(self, data):
        from sessionsimilaritysearch.index.twostage import (
            build_twostage_index,
        )

        q, c, _ = data
        idx = build_twostage_index(c, prefilter="binary", n_bits=64)
        with pytest.raises(AssertionError, match="row_mask length"):
            idx.search(q, 3, row_mask=np.ones(123, bool))


class TestShardedTwoStageRowMask:
    def test_gid_keyed_mask(self, mesh, rng):
        from sessionsimilaritysearch.index.twostage import (
            ShardedTwoStageIndex,
        )
        from sessionsimilaritysearch.ops.topk import value_recall_at_k

        corpus = rng.standard_normal((160, 16)).astype(np.float32)
        idx = ShardedTwoStageIndex(dim=16, capacity=256, mesh=mesh,
                                   metric="cos", prefilter="binary",
                                   n_bits=64)
        idx.add(corpus)
        mask = rng.random(160) < 0.3
        cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
        # pool == shard size: stage 1 nominates every allowed local row
        D, I = idx.search(cn[:6], 5, pool=32, row_mask=mask)
        assert np.all(mask[I[I >= 0]])
        keep = np.flatnonzero(mask)
        sub = {int(g): p for p, g in enumerate(keep)}
        I_sub = np.vectorize(lambda g: sub.get(int(g), -1))(I)
        tol = 2 * 2.0**-8
        assert value_recall_at_k(I_sub, cn[:6], cn[keep], 5,
                                 rel_tol=tol) == 1.0

    def test_mask_stays_valid_across_removal(self, mesh, rng):
        from sessionsimilaritysearch.index.twostage import (
            ShardedTwoStageIndex,
        )

        corpus = rng.standard_normal((64, 8)).astype(np.float32)
        idx = ShardedTwoStageIndex(dim=8, capacity=128, mesh=mesh,
                                   metric="cos", prefilter="binary",
                                   n_bits=64)
        idx.add(corpus)
        idx.remove_ids([0, 9, 33])  # gids stay stable for survivors
        mask = np.zeros(64, bool)
        mask[40] = True
        cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
        _, I = idx.search(cn[:3], 1, pool=16, row_mask=mask)
        np.testing.assert_array_equal(I[:, 0], [40, 40, 40])


class TestDeviceResidentServing:
    """``out='device'`` + device-resident capacity masks: the serving forms
    with no per-call host crossing."""

    def test_out_device_matches_np(self, rng):
        import jax

        corpus = rng.standard_normal((300, 24)).astype(np.float32)
        queries = rng.standard_normal((6, 24)).astype(np.float32)
        ix = DenseIndex(dim=24, capacity=512, chunk_size=128)
        ix.add(corpus)
        dn, in_ = ix.search(queries, 9)
        dd, id_ = ix.search(jnp.asarray(queries), 9, out="device")
        assert isinstance(dd, jax.Array) and isinstance(id_, jax.Array)
        assert dd.shape == dn.shape == (6, 9)
        np.testing.assert_allclose(np.asarray(dd), dn, rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(id_), in_)

    def test_out_device_l2_sign(self, rng):
        corpus = rng.standard_normal((100, 8)).astype(np.float32)
        ix = DenseIndex(dim=8, capacity=128, metric="l2", chunk_size=64)
        ix.add(corpus)
        dn, _ = ix.search(corpus[:4], 3)
        dd, _ = ix.search(corpus[:4], 3, out="device")
        np.testing.assert_allclose(np.asarray(dd), dn, rtol=1e-5)
        # ascending squared distances (self-distance ~0 up to f32 fuzz)
        assert float(np.asarray(dd)[0, -1]) >= float(np.asarray(dd)[0, 0])

    def test_device_capacity_mask_passthrough(self, rng):
        corpus = rng.standard_normal((200, 16)).astype(np.float32)
        queries = rng.standard_normal((5, 16)).astype(np.float32)
        ix = DenseIndex(dim=16, capacity=256, chunk_size=64)
        ix.add(corpus)
        mask = np.zeros(256, bool)
        mask[:200] = rng.random(200) < 0.4
        dn, in_ = ix.search(queries, 7, row_mask=mask[:200])
        dd, id_ = ix.search(queries, 7, row_mask=jnp.asarray(mask),
                            out="device")
        np.testing.assert_allclose(np.asarray(dd), dn, rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(id_), in_)

    def test_sharded_out_device_matches_np(self, rng):
        import jax
        from jax.sharding import Mesh

        from sessionsimilaritysearch.index.sharded import (
            ShardedDenseIndex,
        )

        mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
        corpus = rng.standard_normal((256, 16)).astype(np.float32)
        queries = rng.standard_normal((5, 16)).astype(np.float32)
        ix = ShardedDenseIndex(dim=16, capacity=512, mesh=mesh,
                               chunk_size=64)
        ix.add(corpus)
        dn, in_ = ix.search(queries, 9)
        dd, id_ = ix.search(queries, 9, out="device")
        assert isinstance(dd, jax.Array)
        np.testing.assert_allclose(np.asarray(dd), dn, rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(id_), in_)
