"""Eval harness tests: metric suite hand-checks, sparse baselines, kNN
recommendation, end-to-end harness run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sessionsimilaritysearch.config import tiny_test_config
from sessionsimilaritysearch.data import schema
from sessionsimilaritysearch.evalharness import harness, knn, metrics
from sessionsimilaritysearch.index import sparse as sparse_index


def _session(items):
    return [
        schema.Action(float(i), "c", None, f"A{a}", f"type{a % 3}", None,
                      f"title {a}", a)
        for i, a in enumerate(items)
    ]


class TestMetrics:
    def test_average_precision(self):
        assert metrics.average_precision([1, 1, 0, 0]) == 1.0
        assert metrics.average_precision([0, 0, 0]) == 0.0
        # hit at ranks 1 and 3: AP = (1/1 + 2/3) / 2
        assert abs(metrics.average_precision([1, 0, 1]) - (1 + 2 / 3) / 2) < 1e-9

    def test_future_map_perfect_retrieval(self):
        corpus = [_session([1, 2]), _session([9, 8])]
        test_data = [(_session([5]), _session([1]))]
        I = np.array([[0, 1]])
        # corpus[0] shares item 1 with the future -> hit at rank 1
        assert metrics.get_future_map(I, test_data, corpus) == 1.0
        I2 = np.array([[1, 0]])
        assert metrics.get_future_map(I2, test_data, corpus) == 0.5

    def test_jaccard_and_recall(self):
        corpus = [_session([1, 2]), _session([3])]
        test_data = [(_session([1, 2]), [])]
        I = np.array([[0]])
        assert metrics.get_cur_jaccard(I, test_data, corpus) == 1.0
        assert metrics.get_cur_recall(I, test_data, corpus) == 1.0
        I2 = np.array([[1]])
        assert metrics.get_cur_jaccard(I2, test_data, corpus) == 0.0

    def test_query_metric(self):
        s_q = [schema.Action(0, "s", "red lamp", None, None, None, None)]
        corpus = [s_q + _session([1])]
        test_data = [(s_q, [])]
        I = np.array([[0]])
        assert metrics.get_query_metric(I, test_data, corpus, "cur", "recall") == 1.0
        assert metrics.get_query_metric(I, test_data, corpus, "cur", "score") == 1.0

    def test_recall_above_threshold(self):
        corpus = [_session([1]), _session([99])]
        test_data = [(_session([1]), [])]
        I = np.array([[0, 1]])
        r = metrics.get_recall_above_threshold(
            test_data, corpus, I, "all_jaccard", 0.5
        )
        assert r == 0.5

    def test_full_report_keys(self, gen):
        test_data = gen.dataset(3)
        corpus = [gen.session() for _ in range(5)]
        I = np.zeros((3, 2), dtype=int)
        D = np.zeros((3, 2))
        rep = metrics.full_report(D, I, test_data, corpus)
        assert "ave_all_product_type_score" in rep
        assert "future_map" in rep and "frac_above_0.5" in rep


class TestSparse:
    def test_stan_vec_decay(self):
        s = _session([1, 2])
        v = sparse_index.sequence_to_stan_vec(s, 10, lammy=1.0)
        assert v[2] > v[1] > 0  # later items weighted higher
        assert abs(np.linalg.norm(v) - 1.0) < 1e-9

    def test_binary_vec(self):
        s = _session([1, 1, 3])
        v = sparse_index.sequence_to_binary_vec(s, 10)
        assert v[1] > 0 and v[3] > 0 and v[0] == 0

    def test_sparse_search_self_retrieval(self):
        sessions = [_session([1, 2]), _session([3, 4]), _session([5])]
        corpus = sparse_index.build_sparse_corpus(sessions, 10)
        q = np.stack([
            sparse_index.sequence_to_binary_vec(s, 10) for s in sessions
        ])
        D, I = sparse_index.find_K_sparse_dense(corpus, q, 1)
        np.testing.assert_array_equal(I[:, 0], [0, 1, 2])

    def test_stan_score_runs(self):
        sessions = [_session([1, 2]), _session([3])]
        test_data = [(_session([1]), [])]
        I = np.array([[0, 1]])
        s = sparse_index.get_STAN_score(I, test_data, sessions, 10)
        assert np.isfinite(s)


class TestKnn:
    def test_prediction_by_knn(self):
        corpus = [_session([1, 2]), _session([2, 3])]
        pred = knn.get_prediction_by_knn(
            np.array([1.0, 0.5]), np.array([0, 1]), corpus, 2
        )
        assert pred[0] == 2  # item 2 appears in both -> weight 1.5

    def test_p_r(self):
        p, r = knn.get_p_r({1, 2}, [1, 9], 2)
        assert p == 0.5 and r == 0.5

    def test_recommendation_recall(self):
        corpus = [_session([1, 2]), _session([7, 8])]
        test_data = [(_session([1]), _session([2]))]
        D = np.array([[1.0, 0.1]])
        I = np.array([[0, 1]])
        r = knn.knn_recommendation_recall(D, I, test_data, corpus, K=2)
        assert r == 1.0  # item 2 predicted from corpus[0]


class TestHarness:
    def test_evaluate_encoder_end_to_end(self, gen, tokenizer):
        cfg = tiny_test_config()
        from sessionsimilaritysearch.models import build_text_session_encoder
        from sessionsimilaritysearch.data.graph import batch_graphs

        enc = build_text_session_encoder(cfg)
        corpus_data = gen.dataset(12)
        test_data = gen.dataset(4)
        # init params from one sample batch
        import jax

        sample = batch_graphs([
            __import__(
                "sessionsimilaritysearch.data.graph", fromlist=["sequence_to_graph"]
            ).sequence_to_graph(0, corpus_data[0][0], corpus_data[0][1],
                                tokenizer, cfg.dims)
        ])
        params = enc.init(jax.random.PRNGKey(0), sample)
        encode_fn = jax.jit(lambda g: enc.apply(params, g))
        res = harness.evaluate_encoder(
            cfg, tokenizer, encode_fn, corpus_data, test_data, k=5,
            batch_size=8,
        )
        assert res.I.shape == (4, 5)
        assert res.qps > 0
        assert "ave_all_jaccard" in res.report

    def test_pipeline_device_out_parity(self, gen, tokenizer):
        # out='device' keeps the corpus on-device (zero host round-trips
        # for index builds); rows must be bit-identical to the 'np' path
        cfg = tiny_test_config()
        import jax

        from sessionsimilaritysearch.models import (
            build_text_session_encoder,
        )

        enc = build_text_session_encoder(cfg)
        data = gen.dataset(13)  # non-multiple of batch: exercises the slice
        from sessionsimilaritysearch.data.graph import (
            batch_graphs,
            sequence_to_graph,
        )

        sample = batch_graphs([
            sequence_to_graph(0, data[0][0], data[0][1], tokenizer, cfg.dims)
        ])
        params = enc.init(jax.random.PRNGKey(0), sample)
        encode_fn = jax.jit(lambda g: enc.apply(params, g))
        pipe = harness.EmbeddingPipeline(cfg, tokenizer, encode_fn,
                                         batch_size=4)
        a = pipe(data)
        b = pipe(data, out="device")
        assert a.shape == b.shape and a.shape[0] == 13
        assert not isinstance(b, np.ndarray)  # stayed on device
        np.testing.assert_array_equal(a, np.asarray(b))

    def test_evaluate_sparse(self, gen):
        cfg = tiny_test_config()
        corpus_sessions = [gen.session() for _ in range(10)]
        test_data = gen.dataset(3)
        res = harness.evaluate_sparse(
            cfg, corpus_sessions, test_data, kind="binary", k=4
        )
        assert res.I.shape == (3, 4)
        assert res.report is not None

    def test_evaluate_binary(self, gen, rng):
        corpus_sessions = [gen.session() for _ in range(8)]
        test_data = gen.dataset(2)
        db = np.sign(rng.standard_normal((8, 32))).astype(np.float32)
        q = db[:2]
        res = harness.evaluate_binary(db, q, corpus_sessions, test_data, k=3)
        np.testing.assert_array_equal(res.I[:, 0], [0, 1])  # self-retrieval


class TestKnnRecommendationMode:
    def test_evaluate_knn_recommendation(self, gen, tokenizer):
        cfg = tiny_test_config()
        from sessionsimilaritysearch.models import build_text_session_encoder
        from sessionsimilaritysearch.data.graph import batch_graphs, sequence_to_graph

        enc = build_text_session_encoder(cfg)
        sample = batch_graphs([
            sequence_to_graph(0, *gen.datum(), tokenizer, cfg.dims)
        ])
        params = enc.init(jax.random.PRNGKey(0), sample)
        encode_fn = jax.jit(lambda g: enc.apply(params, g))
        corpus_data = gen.dataset(16)
        test_data = gen.dataset(4)
        out = harness.evaluate_knn_recommendation(
            cfg, tokenizer, encode_fn, corpus_data, test_data, K=5,
            sample_size=8, batch_size=8,
        )
        assert 0.0 <= out["recall_at_k"] <= 1.0
        assert out["qps"] > 0

    def test_evaluate_knn_pairings(self, gen, tokenizer):
        # the reference's three query/db pairing matrix
        # (test_amazon_filterd.py:189-201)
        cfg = tiny_test_config()
        from sessionsimilaritysearch.models import (
            build_text_session_encoder,
        )
        from sessionsimilaritysearch.data.graph import (
            batch_graphs,
            sequence_to_graph,
        )

        sample = batch_graphs([
            sequence_to_graph(0, *gen.datum(), tokenizer, cfg.dims)
        ])
        fns = []
        for seed in (0, 1):
            enc = build_text_session_encoder(cfg)
            params = enc.init(jax.random.PRNGKey(seed), sample)
            fns.append(jax.jit(
                lambda g, e=enc, p=params: e.apply(p, g)
            ))
        corpus_data = gen.dataset(16)
        test_data = gen.dataset(4)
        out = harness.evaluate_knn_pairings(
            cfg, tokenizer, fns[0], fns[1], corpus_data, test_data, K=5,
            sample_size=8, batch_size=8,
        )
        for key in ("recall_subsession_session",
                    "recall_subsession_subsession",
                    "recall_session_session"):
            assert 0.0 <= out[key] <= 1.0
        # the two towers differ, so Q:subsession vs the two corpora are
        # genuinely different retrievals (same-corpus pairing uses the
        # matching tower's embedding space)
        assert out["K"] == 5


class TestHybrid:
    def _encode_fn(self, tokenizer, data):
        from sessionsimilaritysearch.data.graph import (
            batch_graphs,
            sequence_to_graph,
        )
        from sessionsimilaritysearch.models import (
            build_text_session_encoder,
        )

        cfg = tiny_test_config()
        enc = build_text_session_encoder(cfg)
        sample = batch_graphs([
            sequence_to_graph(0, data[0][0], data[0][1], tokenizer, cfg.dims)
        ])
        params = enc.init(jax.random.PRNGKey(0), sample)
        return cfg, jax.jit(lambda g: enc.apply(params, g))

    def test_alpha_endpoints_recover_single_systems(self, gen, tokenizer):
        corpus_data = gen.dataset(20)
        test_data = gen.dataset(5)
        cfg, encode_fn = self._encode_fn(tokenizer, corpus_data)
        dense = harness.evaluate_encoder(
            cfg, tokenizer, encode_fn, corpus_data, test_data, k=5,
            batch_size=8, with_report=False,
        )
        sparse = harness.evaluate_sparse(
            cfg, [d[0] for d in corpus_data], test_data, kind="binary",
            k=5, with_report=False,
        )
        h1 = harness.evaluate_hybrid(
            cfg, tokenizer, encode_fn, corpus_data, test_data, k=5,
            alpha=1.0, batch_size=8, with_report=False,
        )
        h0 = harness.evaluate_hybrid(
            cfg, tokenizer, encode_fn, corpus_data, test_data, k=5,
            alpha=0.0, batch_size=8, with_report=False,
        )
        # alpha=1 reproduces dense top-1; alpha=0 the sparse top-1 SCORES
        # (tie order may differ between argsort kinds, so compare values)
        np.testing.assert_array_equal(h1.I[:, 0], dense.I[:, 0])
        np.testing.assert_allclose(h0.D[:, 0], sparse.D[:, 0], atol=1e-6)
        np.testing.assert_allclose(
            np.sort(h0.D, axis=1), np.sort(sparse.D, axis=1), atol=1e-6
        )

    def test_mid_alpha_report(self, gen, tokenizer):
        corpus_data = gen.dataset(16)
        test_data = gen.dataset(4)
        cfg, encode_fn = self._encode_fn(tokenizer, corpus_data)
        res = harness.evaluate_hybrid(
            cfg, tokenizer, encode_fn, corpus_data, test_data, k=6,
            alpha=0.5, batch_size=8,
        )
        assert res.I.shape == (4, 6)
        assert (res.I >= 0).all()
        assert "ave_all_product_type_score" in res.report

    def test_stan_kind_matches_stan_oracle_at_alpha0(self, gen, tokenizer):
        corpus_data = gen.dataset(18)
        test_data = gen.dataset(4)
        cfg, encode_fn = self._encode_fn(tokenizer, corpus_data)
        sparse = harness.evaluate_sparse(
            cfg, [d[0] for d in corpus_data], test_data, kind="stan",
            k=5, with_report=False,
        )
        h0 = harness.evaluate_hybrid(
            cfg, tokenizer, encode_fn, corpus_data, test_data, k=5,
            alpha=0.0, kind="stan", batch_size=8, with_report=False,
        )
        np.testing.assert_allclose(
            np.sort(h0.D, axis=1), np.sort(sparse.D, axis=1), atol=1e-6
        )

    def test_rrf_fusion_ranks(self, gen, tokenizer):
        corpus_data = gen.dataset(16)
        test_data = gen.dataset(3)
        cfg, encode_fn = self._encode_fn(tokenizer, corpus_data)
        res = harness.evaluate_hybrid(
            cfg, tokenizer, encode_fn, corpus_data, test_data, k=5,
            fusion="rrf", kind="stan", batch_size=8, with_report=False,
        )
        assert res.I.shape == (3, 5) and (res.I >= 0).all()
        # rrf scores are bounded by 2/60 and strictly positive for real rows
        assert (res.D > 0).all() and (res.D <= 2.0 / 60.0 + 1e-9).all()
        # rank-0 in both systems would be 2/60; the top slot must be the
        # best achievable fused score of its row (descending order holds)
        assert (np.diff(res.D, axis=1) <= 1e-12).all()
