"""Two-stage serving tests: rerank_topk exactness-over-pool, TwoStageIndex
prefilter modes, streaming no-retrace contract, persistence, engine wiring."""

import numpy as np
import pytest

import jax.numpy as jnp

from sessionsimilaritysearch.index import DenseIndex, TwoStageIndex
from sessionsimilaritysearch.index.dense import _quantize_rows_int8
from sessionsimilaritysearch.ops.hamming import sign_topk
from sessionsimilaritysearch.ops.projection import (
    fit_itq,
    fit_pca,
    itq_codes,
)
from sessionsimilaritysearch.ops.topk import (
    chunked_topk,
    l2_normalize,
    oracle_topk_np,
    rerank_topk,
    value_recall_at_k,
)

BF16_TOL = 2 * 2.0**-8


@pytest.fixture()
def gen(tiny_cfg):
    # Shadows the session-scoped `gen` for this module: the engine tests
    # assert self-top-1 through tiny untrained encoders whose embeddings
    # sit close together, so the margin is data-dependent — a fresh seeded
    # generator pins the draw so outcomes cannot depend on how many
    # sessions earlier tests consumed from the shared stream (the conftest
    # order-dependence rule; same fix as test_models.TestTitleTableCache).
    from sessionsimilaritysearch.data.synthetic import (
        SyntheticSessionGenerator,
    )

    return SyntheticSessionGenerator(asin_num=tiny_cfg.asin_num, seed=0)


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(7)
    corpus = r.standard_normal((1000, 64)).astype(np.float32)
    queries = r.standard_normal((17, 64)).astype(np.float32)
    return queries, corpus


class TestRerankTopk:
    def test_exact_when_pool_contains_truth(self, data):
        q, c = data
        ov, oi = oracle_topk_np(q, c, 10)
        # pool = oracle top-10 + 22 distinct distractors, shuffled (stage-1
        # top-k candidates are always unique, so pools carry no duplicates)
        r = np.random.default_rng(1)
        cand = np.stack([
            r.permutation(
                np.concatenate([
                    row,
                    np.setdiff1d(r.permutation(c.shape[0])[:40], row)[:22],
                ])
            )
            for row in oi
        ]).astype(np.int32)
        vals, idx = rerank_topk(jnp.asarray(q), jnp.asarray(c),
                                jnp.asarray(cand), 10)
        np.testing.assert_allclose(np.asarray(vals), ov, rtol=1e-5,
                                   atol=1e-5)
        assert value_recall_at_k(np.asarray(idx), q, c, 10) == 1.0

    def test_masks_missing_slots(self, data):
        q, c = data
        _, oi = oracle_topk_np(q, c, 5)
        cand = np.full((q.shape[0], 12), -1, np.int32)
        cand[:, :5] = oi
        vals, idx = rerank_topk(jnp.asarray(q), jnp.asarray(c),
                                jnp.asarray(cand), 8)
        vals, idx = np.asarray(vals), np.asarray(idx)
        assert np.all(np.isfinite(vals[:, :5]))
        assert np.all(idx[:, 5:] == -1) and np.all(np.isneginf(vals[:, 5:]))

    def test_k_exceeds_pool_pads(self, data):
        q, c = data
        _, oi = oracle_topk_np(q, c, 4)
        vals, idx = rerank_topk(jnp.asarray(q), jnp.asarray(c),
                                jnp.asarray(oi.astype(np.int32)), 6)
        assert idx.shape == (q.shape[0], 6)
        assert np.all(np.asarray(idx)[:, 4:] == -1)

    def test_q_chunk_tiling_transparent(self, data):
        q, c = data
        _, oi = oracle_topk_np(q, c, 10)
        a = rerank_topk(jnp.asarray(q), jnp.asarray(c),
                        jnp.asarray(oi.astype(np.int32)), 10, q_chunk=4)
        b = rerank_topk(jnp.asarray(q), jnp.asarray(c),
                        jnp.asarray(oi.astype(np.int32)), 10, q_chunk=128)
        np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))

    def test_int8_corpus_scales(self, data):
        q, c = data
        qn = np.asarray(l2_normalize(jnp.asarray(q)))
        cn = np.asarray(l2_normalize(jnp.asarray(c)))
        codes, scales = _quantize_rows_int8(jnp.asarray(cn))
        _, oi = oracle_topk_np(qn, cn, 10)
        r = np.random.default_rng(2)
        cand = np.concatenate(
            [oi, r.integers(0, c.shape[0], size=(q.shape[0], 22))], axis=1
        ).astype(np.int32)
        _, idx = rerank_topk(jnp.asarray(qn), codes, jnp.asarray(cand), 10,
                             corpus_scales=scales)
        assert value_recall_at_k(np.asarray(idx), qn, cn, 10,
                                 rel_tol=4 / 127) == 1.0

    def test_l2_metric(self, data):
        q, c = data
        ov, oi = oracle_topk_np(q, c, 5, metric="l2")
        r = np.random.default_rng(3)
        cand = np.concatenate(
            [oi, r.integers(0, c.shape[0], size=(q.shape[0], 11))], axis=1
        ).astype(np.int32)
        _, idx = rerank_topk(jnp.asarray(q), jnp.asarray(c),
                             jnp.asarray(cand), 5, metric="l2")
        assert value_recall_at_k(np.asarray(idx), q, c, 5,
                                 metric="l2", rel_tol=1e-6) == 1.0


def _fit_projector(prefilter, c, dim=32):
    rows = np.asarray(l2_normalize(jnp.asarray(c)))
    if prefilter == "pca":
        return fit_pca(rows, dim)
    if prefilter == "itq":
        return fit_itq(rows, dim, iters=20)
    return None


class TestITQ:
    """Learned binary prefilter codes (ops.projection.fit_itq)."""

    @pytest.fixture(scope="class")
    def cone(self):
        """Cone-collapsed corpus: strong shared mean + rank-8 residual —
        the measured geometry of trained session encoders (participation
        ratio 9-14 at 1600-d nominal)."""
        r = np.random.default_rng(11)
        basis = np.linalg.qr(r.standard_normal((64, 9)))[0]
        mean_dir, U = basis[:, 0], basis[:, 1:]
        z = r.standard_normal((2000, 8)).astype(np.float32)
        x = 5.0 * mean_dir[None, :] + z @ U.T
        x = np.asarray(l2_normalize(jnp.asarray(x, jnp.float32)))
        return x

    def test_components_orthonormal(self, data):
        _, c = data
        proj = fit_itq(c, 16, iters=10)
        gram = proj.components @ proj.components.T
        np.testing.assert_allclose(gram, np.eye(16), atol=1e-4)

    def test_rotation_reduces_quantization_loss(self, data):
        """The ITQ alternation must not quantize worse than raw PCA signs
        (it starts from a random rotation and monotonically descends)."""
        _, c = data
        pca = fit_pca(c, 16)
        itq = fit_itq(c, 16, iters=30)

        def qloss(p):
            v = (c - p.mean) @ p.components.T
            return float(((np.sign(v) - v) ** 2).sum())

        assert qloss(itq) <= qloss(pca) * 1.01

    def test_itq_beats_simhash_on_cone(self, cone):
        """THE reason this prefilter exists: on cone-collapsed embeddings
        random SimHash bits all point at the shared mean and the stage-1
        pool carries ~no signal (the measured 1M null);
        centered learned codes recover the neighborhood structure."""
        from sessionsimilaritysearch.ops.hamming import (
            oracle_hamming_np,
            simhash_codes,
        )

        c, q = cone[:1800], cone[1800:1850]
        _, oracle = oracle_topk_np(q, c, 10, metric="ip")
        proj = fit_itq(c, 64, iters=30)

        def pool_containment(qc, cc, pool=64):
            _, pools = oracle_hamming_np(qc, cc, pool)
            hits = [
                len(set(oracle[i]) & set(pools[i])) / 10.0
                for i in range(q.shape[0])
            ]
            return float(np.mean(hits))

        itq_cont = pool_containment(itq_codes(q, proj), itq_codes(c, proj))
        sim_cont = pool_containment(
            simhash_codes(q, 64), simhash_codes(c, 64)
        )
        # measured 0.90 vs 0.68 at these shapes; thresholds leave
        # room for pool-boundary tie churn across platforms
        assert itq_cont >= 0.82, itq_cont
        assert itq_cont > sim_cont + 0.12, (itq_cont, sim_cont)

    def test_index_itq_beats_binary_at_small_pool(self, cone):
        """End-to-end TwoStageIndex on the cone corpus: at a small pool the
        learned prefilter must retrieve what the random one cannot."""
        c, q = cone[:1800], cone[1800:1850]
        proj = fit_itq(c, 64, iters=30)
        res = {}
        for pf, pj in (("itq", proj), ("binary", None)):
            idx = TwoStageIndex(dim=64, capacity=2048, prefilter=pf,
                                n_bits=64, projector=pj)
            idx.add(c)
            _, I = idx.search(q, 10, pool=64)
            res[pf] = value_recall_at_k(I, q, c, 10, rel_tol=BF16_TOL)
        # measured 0.994 vs 0.906 — value-recall is tie-tolerant so both
        # read high; the learned prefilter must still clearly lead
        assert res["itq"] >= 0.95, res
        assert res["itq"] > res["binary"] + 0.04, res


class TestTwoStageIndex:
    @pytest.mark.parametrize("prefilter", ["binary", "itq", "int8x8", "pca"])
    def test_full_pool_recovers_exact(self, data, prefilter):
        """pool == corpus size makes stage 1 irrelevant: the result must be
        the full-dim exact ranking (at bf16 storage precision)."""
        q, c = data
        projector = _fit_projector(prefilter, c)
        idx = TwoStageIndex(dim=64, capacity=1024, prefilter=prefilter,
                            n_bits=64, projector=projector)
        idx.add(c)
        D, I = idx.search(q, 10, pool=1000)
        qn = np.asarray(l2_normalize(jnp.asarray(q)))
        cn = np.asarray(l2_normalize(jnp.asarray(c)))
        assert value_recall_at_k(I, qn, cn, 10, rel_tol=BF16_TOL) == 1.0

    def test_default_pool_quality(self, data):
        """At the default pool the prefilter governs recall; clustered
        signals this size should retrieve essentially the exact set."""
        q, c = data
        idx = TwoStageIndex(dim=64, capacity=1024, prefilter="binary",
                            n_bits=128)
        idx.add(c)
        D, I = idx.search(q, 10)  # pool=512 over 1000 rows
        qn = np.asarray(l2_normalize(jnp.asarray(q)))
        cn = np.asarray(l2_normalize(jnp.asarray(c)))
        assert value_recall_at_k(I, qn, cn, 10, rel_tol=BF16_TOL) >= 0.9

    def test_values_descend_and_selfmatch(self, data):
        _, c = data
        idx = TwoStageIndex(dim=64, capacity=1024, prefilter="binary",
                            n_bits=128)
        idx.add(c)
        D, I = idx.search(c[:8], 5, pool=256)
        assert np.all(np.diff(D, axis=1) <= 1e-6)
        np.testing.assert_array_equal(I[:, 0], np.arange(8))  # self top-1

    def test_streaming_insert_no_retrace(self, rng):
        idx = TwoStageIndex(dim=32, capacity=2048, prefilter="binary",
                            n_bits=64, pool=64)
        rows = rng.standard_normal((1200, 32)).astype(np.float32)
        q = rows[:8]
        idx.add(rows[:100])
        idx.search(q, 5)
        before = (sign_topk._cache_size(), rerank_topk._cache_size())
        for lo in range(100, 1200, 100):
            idx.add(rows[lo:lo + 100])
            D, I = idx.search(q, 5)
            assert I.max() < lo + 100
        assert (sign_topk._cache_size(),
                rerank_topk._cache_size()) == before
        np.testing.assert_array_equal(I[:, 0], np.arange(8))

    def test_int8x8_streaming_no_retrace(self, rng):
        idx = TwoStageIndex(dim=32, capacity=2048, prefilter="int8x8",
                            pool=64)
        rows = rng.standard_normal((600, 32)).astype(np.float32)
        q = rows[:8]
        idx.add(rows[:200])
        idx.search(q, 5)
        before = (chunked_topk._cache_size(), rerank_topk._cache_size())
        for lo in range(200, 600, 200):
            idx.add(rows[lo:lo + 200])
            D, I = idx.search(q, 5)
        assert (chunked_topk._cache_size(),
                rerank_topk._cache_size()) == before
        np.testing.assert_array_equal(I[:, 0], np.arange(8))

    def test_capacity_overflow_raises(self, rng):
        idx = TwoStageIndex(dim=16, capacity=10, prefilter="binary")
        with pytest.raises(ValueError, match="full"):
            idx.add(rng.standard_normal((11, 16)).astype(np.float32))

    @pytest.mark.parametrize("prefilter", ["binary", "itq", "pca"])
    def test_build_twostage_index(self, data, prefilter):
        """One-shot builder fits the PCA/ITQ projector itself and indexes
        the whole corpus; full-pool search matches the exact ranking."""
        from sessionsimilaritysearch.index import build_twostage_index

        q, c = data
        idx = build_twostage_index(c, prefilter=prefilter, pca_dim=32,
                                   n_bits=64)
        assert idx.size == c.shape[0]
        if prefilter == "pca":
            assert idx._proj_comp.shape == (32, 64)
        if prefilter == "itq":
            assert idx._proj_comp.shape == (64, 64)
            assert idx.n_bits == 64
        _, I = idx.search(q, 10, pool=1000)
        qn = np.asarray(l2_normalize(jnp.asarray(q)))
        cn = np.asarray(l2_normalize(jnp.asarray(c)))
        assert value_recall_at_k(I, qn, cn, 10, rel_tol=BF16_TOL) == 1.0

    @pytest.mark.parametrize("prefilter", ["binary", "itq", "int8x8", "pca"])
    def test_save_load_roundtrip(self, data, tmp_path, prefilter):
        q, c = data
        projector = _fit_projector(prefilter, c)
        idx = TwoStageIndex(dim=64, capacity=1024, prefilter=prefilter,
                            n_bits=64, pool=300, projector=projector)
        idx.add(c)
        D1, I1 = idx.search(q, 10)
        path = str(tmp_path / f"ts_{prefilter}")
        idx.save(path)
        idx2 = TwoStageIndex.load(path)
        assert (idx2.prefilter, idx2.pool, idx2.size) == (prefilter, 300,
                                                          1000)
        D2, I2 = idx2.search(q, 10)
        np.testing.assert_array_equal(I1, I2)
        np.testing.assert_allclose(D1, D2, rtol=1e-5, atol=1e-5)


class TestPackedStage1:
    """stage1='packed': the unpack+matmul scan over transposed-packed
    codes (BinaryIndex packed semantics; XLA unpack+matmul twin on CPU)
    replaces the sign matmul for the 'binary'/'itq' prefilters — 1 bit/bit
    of stage-1 memory and an EXACT Hamming top-pool."""

    @pytest.mark.parametrize("prefilter", ["binary", "itq"])
    def test_full_pool_recovers_exact(self, data, prefilter):
        q, c = data
        projector = _fit_projector(prefilter, c)
        idx = TwoStageIndex(dim=64, capacity=1024, prefilter=prefilter,
                            n_bits=64, projector=projector, stage1="packed")
        idx.add(c)
        D, I = idx.search(q, 10, pool=1000)
        qn = np.asarray(l2_normalize(jnp.asarray(q)))
        cn = np.asarray(l2_normalize(jnp.asarray(c)))
        assert value_recall_at_k(I, qn, cn, 10, rel_tol=BF16_TOL) == 1.0

    def test_packed_pool_supersets_matmul(self, data):
        """At equal pool the packed scan's stage-1 is the EXACT Hamming
        top-pool while the matmul path approx-selects — end-to-end top-k
        quality must be at least the matmul path's."""
        q, c = data
        qn = np.asarray(l2_normalize(jnp.asarray(q)))
        cn = np.asarray(l2_normalize(jnp.asarray(c)))
        mm = TwoStageIndex(dim=64, capacity=1024, prefilter="binary",
                           n_bits=128)
        pk = TwoStageIndex(dim=64, capacity=1024, prefilter="binary",
                           n_bits=128, stage1="packed")
        mm.add(c)
        pk.add(c)
        _, I_mm = mm.search(q, 10, pool=64)
        _, I_pk = pk.search(q, 10, pool=64)
        vr_mm = value_recall_at_k(I_mm, qn, cn, 10, rel_tol=BF16_TOL)
        vr_pk = value_recall_at_k(I_pk, qn, cn, 10, rel_tol=BF16_TOL)
        assert vr_pk >= vr_mm - 1e-9

    def test_streaming_insert_no_retrace(self, rng):
        from sessionsimilaritysearch.ops.hamming import hamming_topk

        c = rng.standard_normal((64, 32)).astype(np.float32)
        idx = TwoStageIndex(dim=32, capacity=256, prefilter="binary",
                            n_bits=64, stage1="packed")
        idx.add(c[:32])
        q = rng.standard_normal((8, 32)).astype(np.float32)
        idx.search(q, 5, pool=16)
        before = hamming_topk._cache_size()
        for s in range(4):
            idx.add(c[32 + 8 * s : 40 + 8 * s])
            idx.search(q, 5, pool=16)
        assert hamming_topk._cache_size() == before

    def test_row_mask_and_removal(self, rng):
        c = rng.standard_normal((120, 32)).astype(np.float32)
        idx = TwoStageIndex(dim=32, capacity=256, prefilter="binary",
                            n_bits=64, stage1="packed")
        idx.add(c)
        mask = rng.random(120) < 0.3
        _, I = idx.search(c[:5], 5, pool=120, row_mask=mask)
        assert np.all(mask[I[I >= 0]])
        # positional compaction moves rows AND packed codes together
        idx.remove_ids(np.flatnonzero(~mask))
        D2, I2 = idx.search(c[:5], 5, pool=idx.size)
        keep = np.flatnonzero(mask)
        cn = c / np.linalg.norm(c, axis=1, keepdims=True)
        ov, oi = oracle_topk_np(cn[:5], cn[keep], 5)
        np.testing.assert_allclose(D2, ov, rtol=2e-2, atol=2e-2)

    def test_save_load_roundtrip(self, data, tmp_path):
        q, c = data
        idx = TwoStageIndex(dim=64, capacity=1024, prefilter="binary",
                            n_bits=64, pool=200, stage1="packed")
        idx.add(c)
        D1, I1 = idx.search(q, 10)
        path = str(tmp_path / "ts_packed")
        idx.save(path)
        idx2 = TwoStageIndex.load(path)
        assert idx2.stage1 == "packed" and idx2._codes_index is not None
        assert idx2._codes_index.size == idx2.size == 1000
        D2, I2 = idx2.search(q, 10)
        np.testing.assert_array_equal(I1, I2)
        np.testing.assert_allclose(D1, D2, rtol=1e-5, atol=1e-5)

    def test_packed_rejects_non_sign_prefilters(self):
        with pytest.raises(AssertionError, match="packed"):
            TwoStageIndex(dim=16, capacity=64, prefilter="int8x8",
                          stage1="packed")

    def test_engine_packed_stage1(self, gen, tokenizer):
        import jax

        from sessionsimilaritysearch.config import tiny_test_config
        from sessionsimilaritysearch.data.graph import (
            batch_graphs,
            sequence_to_graph,
        )
        from sessionsimilaritysearch.engine import SessionSearchEngine
        from sessionsimilaritysearch.models import (
            build_text_session_encoder,
        )

        cfg = tiny_test_config()
        enc = build_text_session_encoder(cfg)
        sample = batch_graphs([
            sequence_to_graph(0, *gen.datum(), tokenizer, cfg.dims)
        ] * 8)
        params = enc.init(jax.random.PRNGKey(0), sample)
        encode_fn = jax.jit(lambda g: enc.apply(params, g))
        eng = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=128,
            batch_size=8, prefilter="binary", stage1="packed",
        )
        data = gen.dataset(24)
        eng.add_sessions(data)
        D, I = eng.search(data[:4], k=4)
        assert I.shape == (4, 4) and np.all(I[:, 0] >= 0)
        assert eng.index._codes_index is not None


class TestShardedTwoStage:
    """Multi-chip two-stage serving on the 8-device virtual CPU mesh."""

    @pytest.fixture(scope="class")
    def mesh(self):
        from sessionsimilaritysearch.parallel import create_mesh

        return create_mesh()

    def test_collective_full_pool_matches_oracle(self, mesh, rng):
        from sessionsimilaritysearch.index.twostage import _simhash_signs
        from sessionsimilaritysearch.parallel.collectives import (
            shard_corpus,
            sharded_twostage_topk,
        )

        corpus = rng.standard_normal((1024, 48)).astype(np.float32)
        queries = rng.standard_normal((9, 48)).astype(np.float32)
        codes = _simhash_signs(jnp.asarray(corpus), 64, 0)
        vals, ids = sharded_twostage_topk(
            jnp.asarray(queries, jnp.bfloat16),
            _simhash_signs(jnp.asarray(queries), 64, 0),
            shard_corpus(jnp.asarray(corpus, jnp.bfloat16), mesh),
            shard_corpus(codes, mesh),
            7, mesh, pool=128,  # pool == shard size: stage 1 can't miss
        )
        assert value_recall_at_k(np.asarray(ids), queries, corpus, 7,
                                 rel_tol=BF16_TOL) == 1.0
        assert np.all(np.diff(np.asarray(vals), axis=1) <= 1e-6)

    def test_index_streaming_global_ids(self, mesh, rng):
        from sessionsimilaritysearch.index import ShardedTwoStageIndex

        idx = ShardedTwoStageIndex(dim=32, capacity=1024, mesh=mesh,
                                   n_bits=64, pool=64)
        rows = rng.standard_normal((640, 32)).astype(np.float32)
        idx.add(rows[:320])
        D, I = idx.search(rows[:8], 5, pool=40)  # self top-1 under cos
        np.testing.assert_array_equal(I[:, 0], np.arange(8))
        idx.add(rows[320:])
        assert idx.ntotal == 640
        D, I = idx.search(rows[632:640], 5, pool=40)
        np.testing.assert_array_equal(I[:, 0], np.arange(632, 640))

    def test_index_full_pool_exact(self, mesh, rng):
        from sessionsimilaritysearch.index import ShardedTwoStageIndex

        corpus = rng.standard_normal((512, 24)).astype(np.float32)
        q = rng.standard_normal((5, 24)).astype(np.float32)
        idx = ShardedTwoStageIndex(dim=24, capacity=512, mesh=mesh,
                                   n_bits=64)
        idx.add(corpus)
        _, I = idx.search(q, 6, pool=64)  # 64/shard == whole shard
        qn = np.asarray(l2_normalize(jnp.asarray(q)))
        cn = np.asarray(l2_normalize(jnp.asarray(corpus)))
        assert value_recall_at_k(I, qn, cn, 6, rel_tol=BF16_TOL) == 1.0

    def test_index_itq_prefilter(self, mesh, rng):
        """Learned (ITQ) sign codes flow through the sharded form: full-
        pool search matches exact, snapshots round-trip the projector."""
        from sessionsimilaritysearch.index import ShardedTwoStageIndex

        corpus = rng.standard_normal((512, 24)).astype(np.float32)
        q = rng.standard_normal((5, 24)).astype(np.float32)
        cn = np.asarray(l2_normalize(jnp.asarray(corpus)))
        proj = fit_itq(cn, 24, iters=10)
        idx = ShardedTwoStageIndex(dim=24, capacity=512, mesh=mesh,
                                   prefilter="itq", projector=proj)
        assert idx.n_bits == 24  # derived from the projector
        idx.add(corpus)
        _, I = idx.search(q, 6, pool=64)  # 64/shard == whole shard
        qn = np.asarray(l2_normalize(jnp.asarray(q)))
        assert value_recall_at_k(I, qn, cn, 6, rel_tol=BF16_TOL) == 1.0

    def test_itq_save_load_restripe(self, mesh, tmp_path, rng):
        import jax as _jax

        from sessionsimilaritysearch.index import ShardedTwoStageIndex
        from sessionsimilaritysearch.parallel import create_mesh

        corpus = rng.standard_normal((256, 16)).astype(np.float32)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        proj = fit_itq(
            np.asarray(l2_normalize(jnp.asarray(corpus))), 16, iters=10
        )
        idx = ShardedTwoStageIndex(dim=16, capacity=512, mesh=mesh,
                                   prefilter="itq", projector=proj, pool=48)
        idx.add(corpus)
        D1, I1 = idx.search(q, 5)
        path = str(tmp_path / "sts_itq")
        idx.save(path)
        mesh4 = create_mesh(devices=_jax.devices()[:4])
        idx2 = ShardedTwoStageIndex.load(path, mesh=mesh4)
        assert (idx2.prefilter, idx2.ndev, idx2.size) == ("itq", 4, 256)
        D2, I2 = idx2.search(q, 5)
        np.testing.assert_array_equal(I1, I2)
        np.testing.assert_allclose(D1, D2, rtol=1e-5, atol=1e-5)

    def test_index_int8x8_prefilter(self, mesh, rng):
        """The measured-fastest single-chip prefilter (int8x8) scales out:
        per-shard int8 stage-1 + exact full-dim re-rank; a full pool
        makes the end-to-end result exact regardless of int8 noise."""
        from sessionsimilaritysearch.index import ShardedTwoStageIndex

        corpus = rng.standard_normal((512, 24)).astype(np.float32)
        q = rng.standard_normal((5, 24)).astype(np.float32)
        idx = ShardedTwoStageIndex(dim=24, capacity=512, mesh=mesh,
                                   prefilter="int8x8")
        assert idx.n_bits == 24  # full-width int8 rows
        idx.add(corpus[:256])
        idx.add(corpus[256:])  # streaming insert writes scales too
        _, I = idx.search(q, 6, pool=64)  # 64/shard == whole shard
        qn = np.asarray(l2_normalize(jnp.asarray(q)))
        cn = np.asarray(l2_normalize(jnp.asarray(corpus)))
        assert value_recall_at_k(I, qn, cn, 6, rel_tol=BF16_TOL) == 1.0

    def test_index_pca_prefilter(self, mesh, rng):
        from sessionsimilaritysearch.index import ShardedTwoStageIndex

        corpus = rng.standard_normal((512, 24)).astype(np.float32)
        q = rng.standard_normal((5, 24)).astype(np.float32)
        cn = np.asarray(l2_normalize(jnp.asarray(corpus)))
        proj = fit_pca(cn, 24)  # full-rank: stage 1 is lossless here
        idx = ShardedTwoStageIndex(dim=24, capacity=512, mesh=mesh,
                                   prefilter="pca", projector=proj)
        idx.add(corpus)
        _, I = idx.search(q, 6, pool=64)  # 64/shard == whole shard
        qn = np.asarray(l2_normalize(jnp.asarray(q)))
        assert value_recall_at_k(I, qn, cn, 6, rel_tol=BF16_TOL) == 1.0

    @pytest.mark.parametrize("prefilter", ["int8x8", "pca"])
    def test_int8x8_pca_save_load_restripe(self, mesh, tmp_path, rng,
                                           prefilter):
        import jax as _jax

        from sessionsimilaritysearch.index import ShardedTwoStageIndex
        from sessionsimilaritysearch.parallel import create_mesh

        corpus = rng.standard_normal((256, 16)).astype(np.float32)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        proj = None
        if prefilter == "pca":
            proj = fit_pca(
                np.asarray(l2_normalize(jnp.asarray(corpus))), 16
            )
        idx = ShardedTwoStageIndex(dim=16, capacity=512, mesh=mesh,
                                   prefilter=prefilter, projector=proj,
                                   pool=48)
        idx.add(corpus)
        D1, I1 = idx.search(q, 5)
        path = str(tmp_path / f"sts_{prefilter}")
        idx.save(path)
        mesh4 = create_mesh(devices=_jax.devices()[:4])
        idx2 = ShardedTwoStageIndex.load(path, mesh=mesh4)
        assert (idx2.prefilter, idx2.ndev, idx2.size) == (prefilter, 4, 256)
        D2, I2 = idx2.search(q, 5)
        np.testing.assert_array_equal(I1, I2)
        np.testing.assert_allclose(D1, D2, rtol=1e-5, atol=1e-5)

    def test_save_load_restripe(self, mesh, tmp_path, rng):
        import jax as _jax

        from sessionsimilaritysearch.index import ShardedTwoStageIndex
        from sessionsimilaritysearch.parallel import create_mesh

        corpus = rng.standard_normal((256, 16)).astype(np.float32)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        idx = ShardedTwoStageIndex(dim=16, capacity=512, mesh=mesh,
                                   n_bits=64, pool=48)
        idx.add(corpus)
        D1, I1 = idx.search(q, 5)
        path = str(tmp_path / "sts")
        idx.save(path)
        # restore onto a 4-device mesh: rows re-stripe, results identical
        mesh4 = create_mesh(devices=_jax.devices()[:4])
        idx2 = ShardedTwoStageIndex.load(path, mesh=mesh4)
        assert (idx2.ndev, idx2.size, idx2.pool) == (4, 256, 48)
        D2, I2 = idx2.search(q, 5)
        np.testing.assert_array_equal(I1, I2)
        np.testing.assert_allclose(D1, D2, rtol=1e-5, atol=1e-5)

    def test_index_packed_stage1_full_pool_exact(self, mesh, rng):
        """stage1='packed' sharded: per-chip 1 bit/bit transposed-packed
        code buffers scanned by the unpack+matmul scan. Full per-shard
        pool == exact."""
        from sessionsimilaritysearch.index import ShardedTwoStageIndex

        cap = 8 * 2048  # whole pack blocks per shard (the packed minimum)
        corpus = rng.standard_normal((1024, 24)).astype(np.float32)
        q = rng.standard_normal((5, 24)).astype(np.float32)
        idx = ShardedTwoStageIndex(dim=24, capacity=cap, mesh=mesh,
                                   n_bits=64, stage1="packed")
        idx.add(corpus)
        _, I = idx.search(q, 6, pool=2048)  # pool == whole shard
        qn = np.asarray(l2_normalize(jnp.asarray(q)))
        cn = np.asarray(l2_normalize(jnp.asarray(corpus)))
        assert value_recall_at_k(I, qn, cn, 6, rel_tol=BF16_TOL) == 1.0

    def test_sharded_packed_matches_matmul_pools(self, mesh, rng):
        """At equal prefilter codes the packed stage-1 pool is exact
        Hamming top-p while matmul approx-selects: the packed result at a
        given pool must be at least as good. Compare both at full pool
        (identical exact results) and streaming fills."""
        from sessionsimilaritysearch.index import ShardedTwoStageIndex

        cap = 8 * 2048
        rows = rng.standard_normal((2048, 24)).astype(np.float32)
        packed = ShardedTwoStageIndex(dim=24, capacity=cap, mesh=mesh,
                                      n_bits=64, stage1="packed")
        matmul = ShardedTwoStageIndex(dim=24, capacity=cap, mesh=mesh,
                                      n_bits=64, stage1="matmul")
        packed.add(rows[:1024]); matmul.add(rows[:1024])
        packed.add(rows[1024:]); matmul.add(rows[1024:])
        q = rows[:7]
        Dp, Ip = packed.search(q, 5, pool=2048)
        Dm, Im = matmul.search(q, 5, pool=2048)
        np.testing.assert_allclose(Dp, Dm, rtol=1e-2, atol=1e-2)
        np.testing.assert_array_equal(Ip[:, 0], np.arange(7))  # self top-1

    def test_sharded_packed_remove_readd(self, mesh, rng):
        """Stable-id removals + re-adds over the packed code buffers: the
        per-shard freed-range zeroing must keep later scatter-OR appends
        clean (the transposed-layout invariant, sharded form)."""
        from sessionsimilaritysearch.index import ShardedTwoStageIndex

        cap = 8 * 2048
        rows = rng.standard_normal((512, 24)).astype(np.float32)
        idx = ShardedTwoStageIndex(dim=24, capacity=cap, mesh=mesh,
                                   n_bits=64, stage1="packed")
        idx.add(rows[:256])
        idx.remove_ids(np.arange(0, 256, 3))
        idx.add(rows[256:512])  # re-occupies freed per-shard slots
        q = rows[256:261]
        _, I = idx.search(q, 3, pool=2048)
        np.testing.assert_array_equal(I[:, 0], np.arange(256, 261))
        # removed gids never resurface
        _, I_all = idx.search(rows[:8], 10, pool=2048)
        removed = set(range(0, 256, 3))
        assert not (set(I_all.reshape(-1).tolist()) & removed)

    def test_sharded_packed_save_load_restripe(self, mesh, tmp_path, rng):
        import jax as _jax

        from sessionsimilaritysearch.index import ShardedTwoStageIndex
        from sessionsimilaritysearch.parallel import create_mesh

        cap = 8 * 2048
        rows = rng.standard_normal((512, 24)).astype(np.float32)
        idx = ShardedTwoStageIndex(dim=24, capacity=cap, mesh=mesh,
                                   n_bits=64, stage1="packed")
        idx.add(rows)
        p = str(tmp_path / "sp")
        idx.save(p)
        mesh4 = create_mesh(devices=_jax.devices()[:4])
        back = ShardedTwoStageIndex.load(p, mesh=mesh4)
        assert back.stage1 == "packed" and back.ntotal == 512
        D1, I1 = idx.search(rows[:6], 5, pool=2048)
        D2, I2 = back.search(rows[:6], 5, pool=4096)
        np.testing.assert_array_equal(I1[:, 0], I2[:, 0])
        np.testing.assert_allclose(D1, D2, rtol=1e-2, atol=1e-2)

    def test_engine_sharded_prefilter(self, mesh, gen, tokenizer):
        import jax as _jax

        from sessionsimilaritysearch.config import tiny_test_config
        from sessionsimilaritysearch.engine import SessionSearchEngine
        from sessionsimilaritysearch.index import ShardedTwoStageIndex
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
        params = enc.init(_jax.random.PRNGKey(0), sample)
        encode_fn = _jax.jit(lambda g: enc.apply(params, g))
        eng = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=128,
            batch_size=8, mesh=mesh, prefilter="binary", pool=16,
        )
        assert isinstance(eng.index, ShardedTwoStageIndex)
        data = gen.dataset(24)
        eng.add_sessions(data)
        D, I = eng.search(data[:5], k=3)
        np.testing.assert_array_equal(I[:, 0], np.arange(5))  # self top-1


class TestEngineTwoStage:
    def test_engine_prefilter_mode(self, gen, tokenizer):
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
        eng = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=128,
            batch_size=8, prefilter="binary", pool=64,
        )
        assert isinstance(eng.index, TwoStageIndex)
        data = gen.dataset(20)
        eng.add_sessions(data)
        D, I = eng.search(data[:5], k=3)
        np.testing.assert_array_equal(I[:, 0], np.arange(5))  # self top-1
        # snapshot round-trips the two-stage configuration
        import tempfile, os

        with tempfile.TemporaryDirectory() as td:
            eng.save(os.path.join(td, "snap"))
            eng2 = SessionSearchEngine(
                cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=128,
                batch_size=8, prefilter="binary", pool=64,
            )
            eng2.restore(os.path.join(td, "snap"))
            D2, I2 = eng2.search(data[:5], k=3)
            np.testing.assert_array_equal(I, I2)

    def test_engine_pca_projector_passthrough(self, gen, tokenizer, rng):
        """prefilter='pca' reaches the index with the caller's fitted
        projector (engine.py pass-through)."""
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
        proj = fit_pca(
            rng.standard_normal((256, cfg.n_out)).astype(np.float32), 8
        )
        eng = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=128,
            batch_size=8, prefilter="pca", pool=64, projector=proj,
        )
        assert eng.index.prefilter == "pca"
        assert eng.index._proj_comp.shape == (8, cfg.n_out)
        data = gen.dataset(16)
        eng.add_sessions(data)
        D, I = eng.search(data[:4], k=3)
        np.testing.assert_array_equal(I[:, 0], np.arange(4))  # self top-1
