"""Retrieval backbone tests: chunked top-k vs numpy oracle (recall == 1.0),
dense/binary index semantics, streaming inserts, persistence."""

import numpy as np
import pytest

from sessionsimilaritysearch.index import BinaryIndex, DenseIndex, build_index
from sessionsimilaritysearch.ops import (
    chunked_topk,
    exact_topk,
    hamming_topk,
    l2_normalize,
    merge_topk,
    oracle_topk_np,
    pack_bits_np,
    sign_topk,
)
from sessionsimilaritysearch.ops.hamming import oracle_hamming_np, pack_bits
from sessionsimilaritysearch.ops.topk import recall_at_k, rerank_topk

import jax.numpy as jnp


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(0)
    corpus = r.standard_normal((1000, 64)).astype(np.float32)
    queries = r.standard_normal((17, 64)).astype(np.float32)
    return queries, corpus


def assert_topk_equiv(vals, idx, ovals, oidx, rtol=1e-4, atol=1e-5):
    """Exactness check robust to fp ties at the k-boundary: the retrieved
    score sequence must match the oracle's; indices must agree wherever the
    oracle scores are not tied."""
    vals, idx = np.asarray(vals), np.asarray(idx)
    np.testing.assert_allclose(vals, ovals, rtol=rtol, atol=atol)
    strict = recall_at_k(idx, oidx)
    assert strict > 0.9  # ties are rare in random data


class TestChunkedTopk:
    @pytest.mark.parametrize("chunk", [64, 100, 1000, 4096])
    def test_matches_oracle_ip(self, data, chunk):
        q, c = data
        vals, idx = chunked_topk(jnp.asarray(q), jnp.asarray(c), 10, chunk_size=chunk)
        ovals, oidx = oracle_topk_np(q, c, 10)
        assert_topk_equiv(vals, idx, ovals, oidx)

    def test_matches_oracle_l2(self, data):
        q, c = data
        vals, idx = chunked_topk(
            jnp.asarray(q), jnp.asarray(c), 10, chunk_size=128, metric="l2"
        )
        ovals, oidx = oracle_topk_np(q, c, 10, metric="l2")
        assert_topk_equiv(vals, idx, ovals, oidx)

    def test_values_sorted_descending(self, data):
        q, c = data
        vals, _ = chunked_topk(jnp.asarray(q), jnp.asarray(c), 10, chunk_size=128)
        vals = np.asarray(vals)
        assert np.all(np.diff(vals, axis=1) <= 1e-6)

    def test_valid_count_masks_tail(self, data):
        q, c = data
        # only the first 100 rows are valid
        _, idx = chunked_topk(
            jnp.asarray(q),
            jnp.asarray(c),
            10,
            chunk_size=64,
            valid_count=jnp.asarray(100),
        )
        assert np.asarray(idx).max() < 100
        vals2, oidx = oracle_topk_np(q, c[:100], 10)
        # scores of returned rows must match the oracle over the valid prefix
        got = np.take_along_axis(q @ c[:100].T, np.asarray(idx), axis=1)
        np.testing.assert_allclose(got, vals2, rtol=1e-4)

    def test_k_exceeds_corpus(self):
        q = np.eye(3, 8, dtype=np.float32)
        c = np.eye(2, 8, dtype=np.float32)
        vals, idx = chunked_topk(jnp.asarray(q), jnp.asarray(c), 5, chunk_size=2)
        vals, idx = np.asarray(vals), np.asarray(idx)
        assert (idx[:, 2:] == -1).all()
        assert np.isneginf(vals[:, 2:]).all()

    def test_exact_topk_agrees(self, data):
        q, c = data
        v1, i1 = exact_topk(jnp.asarray(q), jnp.asarray(c), 7)
        v2, i2 = chunked_topk(jnp.asarray(q), jnp.asarray(c), 7, chunk_size=333)
        np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), rtol=1e-5)

    def test_merge_topk(self):
        va = jnp.asarray([[3.0, 1.0]])
        ia = jnp.asarray([[0, 1]])
        vb = jnp.asarray([[2.0, 0.5]])
        ib = jnp.asarray([[2, 3]])
        v, i = merge_topk(va, ia, vb, ib, 3)
        np.testing.assert_array_equal(np.asarray(v), [[3.0, 2.0, 1.0]])
        np.testing.assert_array_equal(np.asarray(i), [[0, 2, 1]])


class TestNormalize:
    def test_matches_reference_clip(self):
        x = np.array([[3.0, 4.0], [0.0, 0.0]], np.float32)
        out = np.asarray(l2_normalize(jnp.asarray(x)))
        np.testing.assert_allclose(out[0], [0.6, 0.8], rtol=1e-6)
        # zero row: divided by sqrt(clip(0, 1e-6)) = 1e-3, stays finite
        assert np.all(np.isfinite(out[1]))
        np.testing.assert_allclose(out[1], [0.0, 0.0])


class TestDenseIndex:
    def test_cosine_search_matches_oracle(self, data):
        q, c = data
        index = build_index(c, metric="cos")
        D, I = index.search(q, 10)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        cn = c / np.linalg.norm(c, axis=1, keepdims=True)
        ovals, oidx = oracle_topk_np(qn, cn, 10)
        assert_topk_equiv(D, I, ovals, oidx, rtol=1e-3, atol=1e-4)
        assert D.shape == (17, 10)

    def test_l2_search_ascending(self, data):
        q, c = data
        index = build_index(c, metric="l2")
        D, I = index.search(q, 5)
        assert np.all(np.diff(D, axis=1) >= -1e-4)
        ovals, oidx = oracle_topk_np(q, c, 5, metric="l2")
        assert_topk_equiv(-D, I, ovals, oidx, rtol=1e-3, atol=1e-3)

    def test_streaming_insert(self, rng):
        index = DenseIndex(dim=16, capacity=100, metric="ip", chunk_size=32)
        a = rng.standard_normal((30, 16)).astype(np.float32)
        b = rng.standard_normal((40, 16)).astype(np.float32)
        index.add(a)
        q = a[:3]
        _, I1 = index.search(q, 3)
        assert I1.max() < 30
        index.add(b)
        assert index.ntotal == 70
        _, I2 = index.search(q, 3)
        full = np.concatenate([a, b])
        ovals, oidx = oracle_topk_np(q, full, 3)
        got = np.take_along_axis(q @ full.T, I2, axis=1)
        np.testing.assert_allclose(got, ovals, rtol=1e-4)

    def test_capacity_overflow_raises(self, rng):
        index = DenseIndex(dim=8, capacity=10, metric="ip")
        with pytest.raises(ValueError):
            index.add(rng.standard_normal((11, 8)).astype(np.float32))

    def test_int8x8_search_quality(self, data):
        """quantize='int8x8' (int8 x int8 -> int32 matmul scan): retrieved
        rows' TRUE scores reach the oracle's within the combined two-sided
        quantization tolerance."""
        from sessionsimilaritysearch.ops.topk import value_recall_at_k

        q, c = data
        index = build_index(c, metric="cos", quantize="int8x8")
        D, I = index.search(q, 10)
        assert D.shape == (17, 10) and I.min() >= 0
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        cn = c / np.linalg.norm(c, axis=1, keepdims=True)
        vr = value_recall_at_k(I, qn, cn, 10, rel_tol=4 / 127)
        assert vr == 1.0, vr
        # returned D is the dequantized true-scale score, not raw int32
        true = np.take_along_axis(qn @ cn.T, I, axis=1)
        np.testing.assert_allclose(D, true, atol=0.05)

    def test_query_batch_padding_transparent(self, rng):
        """search() buckets query batches to powers of two internally
        (bounded retraces for variable-batch serving); every batch size
        must return exactly the unpadded result."""
        c = rng.standard_normal((200, 16)).astype(np.float32)
        index = build_index(c, metric="cos")
        qs = rng.standard_normal((13, 16)).astype(np.float32)
        D_all, I_all = index.search(qs, 4)
        for nq in (1, 2, 3, 5, 8, 13):
            D, I = index.search(qs[:nq], 4)
            assert D.shape == (nq, 4) and I.shape == (nq, 4)
            np.testing.assert_array_equal(I, I_all[:nq])
            np.testing.assert_allclose(D, D_all[:nq], rtol=1e-6)

    def test_save_load_roundtrip(self, tmp_path, rng):
        c = rng.standard_normal((50, 8)).astype(np.float32)
        index = build_index(c, metric="cos")
        p = str(tmp_path / "idx.npz")
        index.save(p)
        loaded = DenseIndex.load(p)
        q = c[:4]
        D1, I1 = index.search(q, 5)
        D2, I2 = loaded.search(q, 5)
        np.testing.assert_array_equal(I1, I2)
        np.testing.assert_allclose(D1, D2, rtol=1e-6)


class TestCenteredCosine:
    """``DenseIndex(center=...)`` — centered-cosine serving, the measured
    fix for cone-collapsed encoder embeddings whose raw cosine saturates
    (1M flagship artifact)."""

    def _cone(self, rng, n=400, d=48, n_types=4, proto_s=0.05, noise_s=0.01):
        """Collapsed-cone corpus: dominant shared direction, small
        informative cluster signal, smaller noise. At
        ``proto_s=0.005`` all pairwise raw cosines land within one bf16
        score step of 1.0 (the saturation regime the 1M artifact hit)."""
        common = np.ones((1, d), np.float32) / np.sqrt(d)
        labels = rng.integers(0, n_types, size=n)
        proto = rng.standard_normal((n_types, d)).astype(np.float32) * proto_s
        noise = rng.standard_normal((n, d)).astype(np.float32) * noise_s
        return (common + proto[labels] + noise).astype(np.float32), labels

    @staticmethod
    def _centered_np(x, mean=None):
        xn = x / np.linalg.norm(x, axis=1, keepdims=True)
        mean = xn.mean(axis=0) if mean is None else mean
        xc = xn - mean
        return xc / np.linalg.norm(xc, axis=1, keepdims=True), mean

    def test_auto_center_matches_centered_oracle(self, rng):
        x, _ = self._cone(rng)
        q = x[:9]
        idx = build_index(x, center="auto")
        D, I = idx.search(q, 10)
        cn, mean = self._centered_np(x)
        qn, _ = self._centered_np(q, mean)
        ovals, oidx = oracle_topk_np(qn, cn, 10)
        assert_topk_equiv(D, I, ovals, oidx, rtol=1e-3, atol=1e-4)

    def test_fixed_center_equals_auto(self, rng):
        x, _ = self._cone(rng)
        xn = x / np.linalg.norm(x, axis=1, keepdims=True)
        a = build_index(x, center="auto")
        b = build_index(x, center=xn.mean(axis=0))
        Da, Ia = a.search(x[:7], 5)
        Db, Ib = b.search(x[:7], 5)
        np.testing.assert_array_equal(Ia, Ib)
        np.testing.assert_allclose(Da, Db, rtol=1e-6)

    def test_centering_recovers_cluster_structure(self, rng):
        """The index-level replica of the 1M finding. The mechanism needs
        BOTH ingredients: cone collapse pushes every raw cosine into a
        band narrower than the production bf16 score resolution (2^-8),
        so raw-cos top-k degenerates to tie-breaking; centering
        renormalizes the informative residual to O(1) where bf16
        resolves it. (In f32 scores raw cos still ranks fine — constant
        offsets don't cost precision — which is why the artifact only
        surfaced in the bf16-scored serving modes.)"""
        x, labels = self._cone(rng, n=600, proto_s=0.005, noise_s=0.001)
        q, ql = x[:50], labels[:50]

        def purity(I):
            return float((labels[I[:, 1:6]] == ql[:, None]).mean())

        def served(center):
            idx = DenseIndex(
                dim=x.shape[1], capacity=x.shape[0],
                score_dtype=jnp.bfloat16, center=center,
            )
            idx.add(x)
            return idx.search(q, 6)[1]

        p_raw, p_ctr = purity(served(None)), purity(served("auto"))
        assert p_ctr >= p_raw + 0.15, (p_raw, p_ctr)

    def test_save_load_roundtrip(self, rng, tmp_path):
        x, _ = self._cone(rng)
        idx = build_index(x, center="auto")
        D1, I1 = idx.search(x[:6], 5)
        path = str(tmp_path / "ctr")
        idx.save(path)
        idx2 = DenseIndex.load(path)
        assert idx2.center_mode == "auto"
        assert idx2._center is not None
        D2, I2 = idx2.search(x[:6], 5)
        np.testing.assert_array_equal(I1, I2)
        np.testing.assert_allclose(D1, D2, rtol=1e-6)
        # the fitted mean is frozen: further adds must not refit
        before = np.asarray(idx2._center).copy()
        idx3 = DenseIndex.load(path, capacity=2 * x.shape[0])
        idx3.add(rng.standard_normal((8, x.shape[1])).astype(np.float32))
        np.testing.assert_array_equal(np.asarray(idx3._center), before)

    def test_quantize_composes(self, rng):
        from sessionsimilaritysearch.ops.topk import value_recall_at_k

        x, _ = self._cone(rng)
        q = x[:9]
        idx = build_index(x, center="auto", quantize="int8x8")
        _, I = idx.search(q, 10)
        cn, mean = self._centered_np(x)
        qn, _ = self._centered_np(q, mean)
        assert value_recall_at_k(I, qn, cn, 10, rel_tol=4 / 127) == 1.0


class TestHamming:
    def test_pack_bits_np_vs_device(self, rng):
        signs = rng.choice([-1.0, 1.0], size=(10, 70)).astype(np.float32)
        a = pack_bits_np(signs)
        b = np.asarray(pack_bits(jnp.asarray(signs)))
        np.testing.assert_array_equal(a, b)

    def test_hamming_topk_matches_oracle(self, rng):
        c = rng.choice([-1.0, 1.0], size=(300, 96)).astype(np.float32)
        q = rng.choice([-1.0, 1.0], size=(9, 96)).astype(np.float32)
        qc, cc = jnp.asarray(pack_bits_np(q)), jnp.asarray(pack_bits_np(c))
        d, i = hamming_topk(qc, cc, 7, chunk_size=64)
        od, oi = oracle_hamming_np(q, c, 7)
        d, i = np.asarray(d), np.asarray(i)
        np.testing.assert_array_equal(np.sort(d, axis=1), d)  # ascending
        # distances match the oracle's (indices may tie-swap)
        np.testing.assert_array_equal(d, od)

    def test_sign_topk_identity(self, rng):
        """+-1 matmul ranking == XOR+popcount ranking (exact distances)."""
        c = rng.choice([-1.0, 1.0], size=(256, 128)).astype(np.float32)
        q = rng.choice([-1.0, 1.0], size=(5, 128)).astype(np.float32)
        d, i = sign_topk(jnp.asarray(q), jnp.asarray(c), 9, n_bits=128, chunk_size=64)
        od, _ = oracle_hamming_np(q, c, 9)
        np.testing.assert_array_equal(np.asarray(d), od)

    def test_binary_index_modes_agree(self, rng):
        c = rng.choice([-1.0, 1.0], size=(200, 64)).astype(np.float32)
        q = rng.choice([-1.0, 1.0], size=(4, 64)).astype(np.float32)
        for mode in ("packed", "sign"):
            idx = BinaryIndex(n_bits=64, capacity=256, mode=mode)
            idx.add(c)
            d, i = idx.search(q, 6)
            od, _ = oracle_hamming_np(q, c, 6)
            np.testing.assert_array_equal(d, od)

    def test_odd_bit_width(self, rng):
        """250-bit codes (the reference's code_len, config.py:4)."""
        c = rng.choice([-1.0, 1.0], size=(64, 250)).astype(np.float32)
        q = c[:3]
        idx = BinaryIndex(n_bits=250, capacity=64, mode="packed")
        idx.add(c)
        d, i = idx.search(q, 1)
        np.testing.assert_array_equal(d[:, 0], [0, 0, 0])
        np.testing.assert_array_equal(i[:, 0], [0, 1, 2])


class TestScoreDtype:
    def test_bf16_scores_close_to_exact(self, data):
        q, c = data
        v32, i32 = chunked_topk(jnp.asarray(q), jnp.asarray(c), 10,
                                chunk_size=256)
        v16, i16 = chunked_topk(jnp.asarray(q), jnp.asarray(c), 10,
                                chunk_size=256, score_dtype=jnp.bfloat16)
        # scores agree to bf16 precision; the candidate sets overlap heavily
        np.testing.assert_allclose(np.asarray(v16), np.asarray(v32),
                                   rtol=2e-2, atol=1e-2)
        assert recall_at_k(np.asarray(i16), np.asarray(i32)) > 0.85

    def test_value_recall_credits_ties_and_bf16(self, data, rng):
        from sessionsimilaritysearch.ops.topk import value_recall_at_k

        # exact duplicate rows: index-set recall cannot distinguish which
        # copy the engine returns, value recall credits either
        base = rng.standard_normal((64, 32)).astype(np.float32)
        corpus = np.concatenate([base, base[:16]])  # rows 64..79 dup 0..15
        q = base[:8] + 0.01 * rng.standard_normal((8, 32)).astype(np.float32)
        _, i_dev = chunked_topk(jnp.asarray(q), jnp.asarray(corpus), 5,
                                chunk_size=64)
        assert value_recall_at_k(i_dev, q, corpus, 5) == 1.0

        # bf16-scored scan over well-separated data: every retrieved row's
        # true score reaches the oracle's k-th within 2 bf16 ulps
        qq, cc = data
        _, i16 = chunked_topk(jnp.asarray(qq), jnp.asarray(cc), 10,
                              chunk_size=256, score_dtype=jnp.bfloat16)
        vr = value_recall_at_k(np.asarray(i16), qq, cc, 10,
                               rel_tol=2 * 2.0**-8)
        assert vr == 1.0, vr
        # and a genuinely wrong result is NOT credited
        wrong = np.zeros_like(np.asarray(i16))
        worst = np.argmin(qq @ cc.T, axis=1)
        wrong[:] = worst[:, None]
        assert value_recall_at_k(wrong, qq, cc, 10) < 0.2


class TestBinaryStreaming:
    def test_streaming_insert(self, rng):
        """Interleaved add/search; appends are O(batch) donated updates
        results identical to one-shot build."""
        c = rng.choice([-1.0, 1.0], size=(96, 64)).astype(np.float32)
        q = rng.choice([-1.0, 1.0], size=(4, 64)).astype(np.float32)
        for mode in ("packed", "sign"):
            inc = BinaryIndex(n_bits=64, capacity=128, mode=mode)
            for s in range(0, 96, 16):
                inc.add(c[s : s + 16])
                d, i = inc.search(q, 3)
                assert (i < inc.ntotal).all()
            one = BinaryIndex(n_bits=64, capacity=128, mode=mode)
            one.add(c)
            di, ii = inc.search(q, 6)
            do, io = one.search(q, 6)
            np.testing.assert_array_equal(di, do)
            np.testing.assert_array_equal(ii, io)

    def test_capacity_overflow_raises(self, rng):
        idx = BinaryIndex(n_bits=32, capacity=8)
        idx.add(rng.choice([-1.0, 1.0], size=(8, 32)))
        with pytest.raises(ValueError):
            idx.add(rng.choice([-1.0, 1.0], size=(1, 32)))

    def test_missing_slots_are_int32_max(self, rng):
        """k > corpus: missing slots read (INT32_MAX, -1) in BOTH modes --
        pins the sign-mode inf->int conversion fix."""
        c = rng.choice([-1.0, 1.0], size=(3, 64)).astype(np.float32)
        for mode in ("packed", "sign"):
            idx = BinaryIndex(n_bits=64, capacity=8, mode=mode)
            idx.add(c)
            d, i = idx.search(c[:2], 5)
            assert (i[:, 3:] == -1).all()
            assert (d[:, 3:] == np.iinfo(np.int32).max).all()
            assert (i[:, 0] == [0, 1]).all() and (d[:, 0] == 0).all()


class TestValueRecallAdversarial:
    """The bench's bf16 guard must catch genuinely wrong retrievals
    value_recall_at_k is only a valid headline metric
    if it penalizes dropped true neighbors, not just forgives tie churn."""

    def test_dropped_true_top1_reads_below_one(self, rng):
        from sessionsimilaritysearch.ops.topk import (
            oracle_topk_np,
            value_recall_at_k,
        )

        corpus = rng.standard_normal((128, 32)).astype(np.float32)
        q = corpus[:4] * 2.0  # unambiguous nearest: the row itself
        _, oracle_idx = oracle_topk_np(q, corpus, 5)
        wrong = oracle_idx.copy()
        wrong[:, 0] = oracle_idx[:, -1]  # drop true top-1 (wide margin)
        vr = value_recall_at_k(wrong, q, corpus, 5)
        assert vr < 1.0
        # exactly one of five slots per query now misses the k-th bar
        assert abs(vr - 0.8) < 1e-9

    def test_garbage_retrieval_reads_near_zero(self, rng):
        from sessionsimilaritysearch.ops.topk import value_recall_at_k

        corpus = rng.standard_normal((64, 16)).astype(np.float32)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        worst = np.argsort(q @ corpus.T, axis=1)[:, :5]  # bottom-5 rows
        assert value_recall_at_k(worst, q, corpus, 5) == 0.0

    def test_tie_churn_reads_one_while_set_recall_does_not(self, rng):
        from sessionsimilaritysearch.ops.topk import (
            oracle_topk_np,
            recall_at_k,
            value_recall_at_k,
        )

        base = rng.standard_normal((32, 16)).astype(np.float32)
        corpus = np.concatenate([base, base])  # every row duplicated
        q = base[:4]
        _, oracle_idx = oracle_topk_np(q, corpus, 3)
        churned = (oracle_idx + 32) % 64  # same scores, other copy
        # the set metric punishes the churn (only the rows whose BOTH
        # copies rank in the top-k survive the swap); the value metric
        # correctly reads a perfect retrieval
        assert recall_at_k(churned, oracle_idx) < 1.0
        assert value_recall_at_k(churned, q, corpus, 3) == 1.0


class TestInt8Quantized:
    """DenseIndex(quantize='int8'): 4x corpus memory reduction with a
    value-recall guard."""

    def test_self_retrieval_and_recall_guard(self, rng):
        from sessionsimilaritysearch.ops.topk import value_recall_at_k

        corpus = rng.standard_normal((2000, 128)).astype(np.float32)
        idx = DenseIndex(dim=128, capacity=2048, metric="cos",
                         quantize="int8", chunk_size=512)
        idx.add(corpus)
        assert idx._buf.dtype == jnp.int8
        q = corpus[:64]
        D, I = idx.search(q, 10)
        assert (I[:, 0] == np.arange(64)).all()  # exact self top-1
        # true (f32) quality of the quantized retrieval: every retrieved
        # row's real score reaches the oracle's 10th within the int8
        # resolution of the score scale
        cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
        vr = value_recall_at_k(I, cn[:64], cn, 10, rel_tol=2.0**-6)
        assert vr >= 0.999, vr

    def test_scores_match_f32_within_quant_error(self, rng):
        corpus = rng.standard_normal((512, 64)).astype(np.float32)
        qf = DenseIndex(dim=64, capacity=512, metric="ip", chunk_size=256)
        qi = DenseIndex(dim=64, capacity=512, metric="ip",
                        quantize="int8", chunk_size=256)
        qf.add(corpus)
        qi.add(corpus)
        q = corpus[:16]
        Df, _ = qf.search(q, 5)
        Di, _ = qi.search(q, 5)
        scale = np.abs(Df).max()
        assert np.abs(Df - Di).max() / scale < 0.02

    def test_streaming_and_save_load(self, rng, tmp_path):
        corpus = rng.standard_normal((300, 32)).astype(np.float32)
        idx = DenseIndex(dim=32, capacity=512, metric="cos",
                         quantize="int8", chunk_size=128)
        for s in range(0, 300, 100):
            idx.add(corpus[s : s + 100])
        D1, I1 = idx.search(corpus[:8], 4)
        path = str(tmp_path / "q8")
        idx.save(path)
        idx2 = DenseIndex.load(path)
        assert idx2.quantize == "int8"
        D2, I2 = idx2.search(corpus[:8], 4)
        np.testing.assert_array_equal(I1, I2)
        np.testing.assert_allclose(D1, D2, atol=1e-6)

    def test_l2_rejected(self):
        with pytest.raises(AssertionError):
            DenseIndex(dim=8, capacity=8, metric="l2", quantize="int8")


class TestSimhash:
    """Training-free cosine LSH codes (ops.hamming.simhash_codes)."""

    def test_shared_projection_and_determinism(self, rng):
        from sessionsimilaritysearch.ops.hamming import simhash_codes

        emb = rng.standard_normal((20, 32)).astype(np.float32)
        a = simhash_codes(emb, 64, seed=3)
        b = simhash_codes(emb, 64, seed=3)
        np.testing.assert_array_equal(a, b)  # same seed -> same projection
        assert set(np.unique(a)) <= {-1.0, 1.0}
        assert a.shape == (20, 64)
        # scaling an embedding never changes its code (angular hash)
        np.testing.assert_array_equal(
            simhash_codes(emb * 7.5, 64, seed=3), a
        )

    def test_hamming_ranking_tracks_cosine(self, rng):
        """On well-separated clusters, 256-bit simhash Hamming top-1
        recovers the cosine top-1 (the angular-estimate guarantee)."""
        from sessionsimilaritysearch.ops.hamming import simhash_codes

        centers = rng.standard_normal((8, 48)).astype(np.float32) * 4
        corpus = np.concatenate(
            [c + 0.05 * rng.standard_normal((10, 48)) for c in centers]
        ).astype(np.float32)
        queries = (centers + 0.05 * rng.standard_normal((8, 48))).astype(
            np.float32
        )
        cq = simhash_codes(queries, 256, seed=0)
        cc = simhash_codes(corpus, 256, seed=0)
        _, I = sign_topk(jnp.asarray(cq, jnp.bfloat16),
                         jnp.asarray(cc, jnp.bfloat16), 1, n_bits=256)
        got_cluster = np.asarray(I)[:, 0] // 10
        np.testing.assert_array_equal(got_cluster, np.arange(8))


class TestSignApprox:
    """sign_topk(mode='approx') wiring (lax.approx_max_k selection; on CPU
    approx_max_k reduces to exact top-k, so this pins plumbing +
    ranking)."""

    def test_binary_index_approx_selection(self, rng):
        from sessionsimilaritysearch.index.binary import BinaryIndex

        signs = np.where(rng.standard_normal((512, 64)) > 0, 1.0, -1.0)
        q = signs[:9]
        exact = BinaryIndex(n_bits=64, capacity=512, mode="sign")
        approx = BinaryIndex(n_bits=64, capacity=512, mode="sign",
                             selection="approx", recall_target=0.95)
        exact.add(signs)
        approx.add(signs)
        De, Ie = exact.search(q, 5)
        Da, Ia = approx.search(q, 5)
        np.testing.assert_array_equal(De[:, 0], 0)  # self at distance 0
        np.testing.assert_array_equal(Da[:, 0], 0)
        # tie-aware: every approx distance must match the exact bar per slot
        np.testing.assert_array_equal(np.sort(Da, 1), np.sort(De, 1))

    def test_approx_requires_sign_mode(self):
        from sessionsimilaritysearch.index.binary import BinaryIndex

        with pytest.raises(AssertionError):
            BinaryIndex(n_bits=64, capacity=128, mode="packed",
                        selection="approx")


class TestFastestDenseMode:
    def test_int8x8_approx_combination(self, data):
        """The README's fastest dense mode: quantize='int8x8' +
        mode='approx' (on CPU approx_max_k reduces to exact selection, so
        this pins the combination's plumbing and quality)."""
        from sessionsimilaritysearch.index.dense import DenseIndex
        from sessionsimilaritysearch.ops.topk import value_recall_at_k

        q, c = data
        index = DenseIndex(dim=64, capacity=1000, metric="cos",
                           quantize="int8x8", mode="approx")
        index.add(c)
        D, I = index.search(q, 10)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        cn = c / np.linalg.norm(c, axis=1, keepdims=True)
        assert value_recall_at_k(I, qn, cn, 10, rel_tol=4 / 127) == 1.0


class TestNoRetraceOnInsert:
    """Streaming inserts must never recompile the
    search. The buffer is allocated at capacity once and searches scan it
    with a dynamic valid_count mask, so the traced shapes are
    insert-invariant; these tests pin the jit cache growth to the single
    initial trace."""

    def test_binary_sign_no_retrace(self, rng):
        idx = BinaryIndex(n_bits=64, capacity=4096, mode="sign")
        codes = np.sign(rng.standard_normal((1200, 64))).astype(np.float32)
        q = codes[:8]
        idx.add(codes[:100])
        idx.search(q, 5)
        before = sign_topk._cache_size()
        for lo in range(100, 1200, 100):  # crosses many former slice sizes
            idx.add(codes[lo:lo + 100])
            d, i = idx.search(q, 5)
            assert i.max() < lo + 100
        assert sign_topk._cache_size() == before
        # correctness at the final fill
        ov, _ = oracle_hamming_np(q, codes, 5)
        np.testing.assert_array_equal(np.sort(d, 1), np.sort(ov, 1))

    def test_binary_packed_xla_no_retrace(self, rng):
        from sessionsimilaritysearch.ops.hamming import packed_t_topk

        idx = BinaryIndex(n_bits=64, capacity=4096, mode="packed")
        codes = np.sign(rng.standard_normal((1200, 64))).astype(np.float32)
        q = codes[:8]
        idx.add(codes[:100])
        idx.search(q, 5)
        before = packed_t_topk._cache_size()
        assert before > 0  # the fallback scan really is the path traced
        for lo in range(100, 1200, 100):
            idx.add(codes[lo:lo + 100])
            d, i = idx.search(q, 5)
        assert packed_t_topk._cache_size() == before
        ov, _ = oracle_hamming_np(q, codes, 5)
        np.testing.assert_array_equal(np.sort(d, 1), np.sort(ov, 1))

    def test_dense_no_retrace(self, rng):
        idx = DenseIndex(dim=16, capacity=2048, metric="cos")
        rows = rng.standard_normal((1000, 16)).astype(np.float32)
        q = rows[:8]
        idx.add(rows[:100])
        idx.search(q, 5)
        before = chunked_topk._cache_size()
        for lo in range(100, 1000, 100):
            idx.add(rows[lo:lo + 100])
            idx.search(q, 5)
        assert chunked_topk._cache_size() == before


class TestSnapshotFidelity:
    """Snapshots persist the full
    serving configuration, so a tuned engine restores tuned."""

    def test_dense_config_roundtrip(self, tmp_path, rng):
        c = rng.standard_normal((64, 8)).astype(np.float32)
        idx = DenseIndex(dim=8, capacity=64, metric="cos", mode="approx",
                         score_dtype=jnp.bfloat16, chunk_size=32)
        idx.add(c)
        p = str(tmp_path / "tuned")
        idx.save(p)
        loaded = DenseIndex.load(p)
        assert loaded.mode == "approx"
        assert loaded.score_dtype == jnp.dtype(jnp.bfloat16)
        assert loaded.chunk_size == 32
        D1, I1 = idx.search(c[:4], 5)
        D2, I2 = loaded.search(c[:4], 5)
        np.testing.assert_array_equal(I1, I2)
        # explicit override still wins
        assert DenseIndex.load(p, mode="exact").mode == "exact"

    def test_dense_quantize_override_rejected(self, tmp_path, rng):
        c = rng.standard_normal((32, 8)).astype(np.float32)
        idx = DenseIndex(dim=8, capacity=32, metric="cos", quantize="int8")
        idx.add(c)
        p = str(tmp_path / "q8")
        idx.save(p)
        assert DenseIndex.load(p, quantize="int8").quantize == "int8"
        with pytest.raises(ValueError, match="quantize"):
            DenseIndex.load(p, quantize=None)

    def test_dense_bf16_storage_roundtrip(self, tmp_path, rng):
        c = rng.standard_normal((32, 8)).astype(np.float32)
        idx = DenseIndex(dim=8, capacity=32, metric="ip", dtype=jnp.bfloat16)
        idx.add(c)
        p = str(tmp_path / "bf16")
        idx.save(p)
        loaded = DenseIndex.load(p)
        assert loaded.dtype == jnp.dtype(jnp.bfloat16)
        np.testing.assert_array_equal(
            np.asarray(loaded._buf.astype(jnp.float32)),
            np.asarray(idx._buf.astype(jnp.float32)),
        )

    @pytest.mark.parametrize("mode", ["sign", "packed"])
    def test_binary_roundtrip(self, tmp_path, rng, mode):
        codes = np.sign(rng.standard_normal((200, 64))).astype(np.float32)
        idx = BinaryIndex(n_bits=64, capacity=512, mode=mode,
                          selection="approx" if mode == "sign" else "exact",
                          recall_target=0.9)
        idx.add(codes)
        p = str(tmp_path / f"bin_{mode}")
        idx.save(p)
        loaded = BinaryIndex.load(p)
        assert loaded.mode == mode
        assert loaded.selection == idx.selection
        assert loaded.recall_target == 0.9
        assert loaded.size == 200
        D1, I1 = idx.search(codes[:5], 7)
        D2, I2 = loaded.search(codes[:5], 7)
        np.testing.assert_array_equal(np.sort(D1, 1), np.sort(D2, 1))
        # streaming continues after restore without retracing shapes
        loaded.add(codes[:50])
        assert loaded.size == 250

    def test_binary_packed_legacy_snapshot_migrates(self, tmp_path, rng):
        """Pre-transposed snapshots stored row-major packed words (no
        ``layout`` field); load must unpack and re-ingest them."""
        codes = np.sign(rng.standard_normal((100, 64))).astype(np.float32)
        p = str(tmp_path / "legacy.npz")
        np.savez(
            p, buf=pack_bits(jnp.asarray(codes)),
            n_bits=64, capacity=256, mode="packed",
            selection="exact", recall_target=0.95, size=100,
        )
        loaded = BinaryIndex.load(p)
        assert loaded.size == 100
        fresh = BinaryIndex(n_bits=64, capacity=256, mode="packed")
        fresh.add(codes)
        D1, I1 = loaded.search(codes[:5], 7)
        D2, I2 = fresh.search(codes[:5], 7)
        np.testing.assert_array_equal(np.asarray(D1), np.asarray(D2))
        np.testing.assert_array_equal(np.asarray(I1), np.asarray(I2))


class TestExactCert:
    """Exact-with-certificate selection: approx bucket
    selection, bucket-max certificate, lax.cond fallback."""

    def test_matches_oracle(self, rng):
        c = rng.standard_normal((4096, 32)).astype(np.float32)
        q = rng.standard_normal((16, 32)).astype(np.float32)
        v, i = chunked_topk(q, c, 10, chunk_size=4096, mode="exact_cert",
                            bucket=128)
        ov, oi = oracle_topk_np(q, c, 10)
        np.testing.assert_allclose(np.asarray(v), ov, rtol=1e-4, atol=1e-5)
        assert recall_at_k(np.asarray(i), oi) > 0.95

    def test_dense_index_mode(self, rng):
        c = rng.standard_normal((2048, 16)).astype(np.float32)
        exact = DenseIndex(dim=16, capacity=2048, metric="cos",
                           chunk_size=2048)
        cert = DenseIndex(dim=16, capacity=2048, metric="cos",
                          mode="exact_cert", chunk_size=2048)
        exact.add(c)
        cert.add(c)
        D1, I1 = exact.search(c[:8], 10)
        D2, I2 = cert.search(c[:8], 10)
        np.testing.assert_allclose(D1, D2, rtol=1e-5)
        np.testing.assert_array_equal(np.sort(I1, 1), np.sort(I2, 1))

    def test_fallback_branch_is_exact(self, rng):
        """Force the violation branch by monkeypatching approx_max_k to
        return the WORST buckets -- the certificate must catch it and the
        fallback must still return the exact answer."""
        import jax as _jax
        from sessionsimilaritysearch.ops import topk as topk_mod

        c = rng.standard_normal((4096, 16)).astype(np.float32)
        q = rng.standard_normal((8, 16)).astype(np.float32)
        real = _jax.lax.approx_max_k

        def worst(x, kk, recall_target=0.95, **kw):
            nv, ni = real(-x, kk, recall_target=recall_target, **kw)
            return -nv, ni

        orig = topk_mod.jax.lax.approx_max_k
        topk_mod.jax.lax.approx_max_k = worst
        try:
            # fresh trace: different python callable is not in jit cache
            v, i = topk_mod.chunked_topk.__wrapped__(
                jnp.asarray(q), jnp.asarray(c), 10, chunk_size=4096,
                mode="exact_cert", bucket=128,
            )
        finally:
            topk_mod.jax.lax.approx_max_k = orig
        ov, oi = oracle_topk_np(q, c, 10)
        np.testing.assert_allclose(np.asarray(v), ov, rtol=1e-4, atol=1e-5)

    def test_streaming_valid_count(self, rng):
        idx = DenseIndex(dim=16, capacity=1024, metric="ip",
                         mode="exact_cert", chunk_size=1024)
        rows = rng.standard_normal((700, 16)).astype(np.float32)
        idx.add(rows[:300])
        q = rows[:5]
        D, I = idx.search(q, 8)
        assert I.max() < 300
        ov, oi = oracle_topk_np(q, rows[:300], 8)
        np.testing.assert_allclose(D, ov, rtol=1e-4, atol=1e-5)
        idx.add(rows[300:])
        D, I = idx.search(q, 8)
        ov, oi = oracle_topk_np(q, rows, 8)
        np.testing.assert_allclose(D, ov, rtol=1e-4, atol=1e-5)


class TestPCAProjection:
    """Low-rank serving projection (round 3): on a low-effective-rank
    corpus (the measured regime for trained encoders),
    PCA to a width above the effective rank preserves exact retrieval."""

    def test_low_rank_corpus_exact_retrieval(self, rng):
        from sessionsimilaritysearch.ops.projection import (
            PCAProjector, fit_pca,
        )
        from sessionsimilaritysearch.ops.topk import value_recall_at_k

        # rank-12 cloud embedded in 256 dims + small isotropic noise
        basis = rng.standard_normal((12, 256))
        z = rng.standard_normal((3000, 12)) @ basis
        z += 0.01 * rng.standard_normal(z.shape)
        z = z / np.linalg.norm(z, axis=1, keepdims=True)
        proj = fit_pca(z, 32)
        assert proj.explained > 0.99
        cp, qp = proj(z), proj(z[:40])
        idx = build_index(cp, metric="cos")
        _, I = idx.search(qp, 10)
        vr = value_recall_at_k(I, z[:40], z, 10, rel_tol=1e-3)
        assert vr > 0.99
        # save/load round trip preserves the projection bit-exactly
        import tempfile, os
        p = os.path.join(tempfile.mkdtemp(), "proj")
        proj.save(p)
        loaded = PCAProjector.load(p)
        np.testing.assert_array_equal(loaded(z[:5]), proj(z[:5]))

    def test_full_rank_corpus_flags_low_explained(self, rng):
        from sessionsimilaritysearch.ops.projection import fit_pca

        z = rng.standard_normal((2000, 256)).astype(np.float32)
        proj = fit_pca(z, 32)
        assert proj.explained < 0.5  # the deployment guardrail fires


class TestDeviceResidentHelpers:
    """Type-preserving device paths of the serving helpers (the corpus
    never crosses the host link): parity with their host twins."""

    def test_pack_bits_t_device_matches_host(self, rng):
        from sessionsimilaritysearch.ops.hamming import (
            TBLOCK,
            pack_bits_t,
            pack_bits_t_np,
        )

        signs = np.where(
            rng.random((2 * TBLOCK, 96)) > 0.5, 1.0, -1.0
        ).astype(np.float32)
        np.testing.assert_array_equal(
            pack_bits_t_np(signs), np.asarray(pack_bits_t(jnp.asarray(signs)))
        )

    def test_simhash_device_matches_host(self, rng):
        from sessionsimilaritysearch.ops.hamming import simhash_codes

        emb = rng.standard_normal((256, 64)).astype(np.float32)
        h = simhash_codes(emb, 48, seed=5)
        d = simhash_codes(jnp.asarray(emb), 48, seed=5)
        assert isinstance(d, jnp.ndarray)
        np.testing.assert_array_equal(h, np.asarray(d))

    def test_projector_device_matches_host(self, rng):
        from sessionsimilaritysearch.ops.projection import fit_pca

        c = rng.standard_normal((512, 32)).astype(np.float32)
        proj = fit_pca(c, 8)
        np.testing.assert_allclose(
            proj(c[:64]), np.asarray(proj(jnp.asarray(c[:64]))), atol=1e-5
        )

    def test_fitters_sample_device_input(self, rng):
        """fit_pca/fit_itq over a device corpus gather only the sample:
        the fit equals the host fit on the same data."""
        from sessionsimilaritysearch.ops.projection import fit_itq, fit_pca

        big = rng.standard_normal((70_000, 24)).astype(np.float32)
        p1, p2 = fit_pca(big, 6), fit_pca(jnp.asarray(big), 6)
        np.testing.assert_allclose(p1.mean, p2.mean, atol=1e-5)
        assert abs(p1.explained - p2.explained) < 1e-6
        i1 = fit_itq(big, 6, iters=5)
        i2 = fit_itq(jnp.asarray(big), 6, iters=5)
        np.testing.assert_allclose(i1.components, i2.components, atol=1e-3)

    def test_value_recall_from_scores_matches_full(self, rng):
        from sessionsimilaritysearch.ops.topk import (
            value_recall_at_k,
            value_recall_from_scores,
        )

        q = rng.standard_normal((8, 16))
        c = rng.standard_normal((100, 16))
        scores = q @ c.T
        idx = np.argsort(-scores, axis=1)[:, :10]
        idx[0, 3] = idx[0, 0]  # duplicated row: only fills one slot
        idx[1, 9] = -1  # missing slot
        got = np.take_along_axis(scores, np.maximum(idx, 0), axis=1)
        got = np.where(idx >= 0, got, -np.inf)
        oracle = -np.sort(-scores, axis=1)[:, :10]
        scale = np.abs(scores).max(axis=1)
        for tol in (0.0, 0.01):
            full = value_recall_at_k(idx, q, c, 10, rel_tol=tol)
            part = value_recall_from_scores(got, oracle, tol * scale)
            assert abs(full - part) < 1e-12


def _dot_precisions(fn, *args):
    """The ``precision`` of every dot_general in ``fn``'s jaxpr, nested
    jaxprs (scan bodies, inner jits) included."""
    import jax

    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in v if isinstance(v, (list, tuple)) else [v]:
                    if hasattr(sub, "jaxpr"):  # ClosedJaxpr
                        walk(sub.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


class TestScorePrecision:
    """float32 scoring asks for HIGHEST precision (a GPU otherwise runs a
    float32 matmul in TF32); bf16 and int8 scans keep the default."""

    HIGHEST = "Precision.HIGHEST"

    @pytest.mark.parametrize("metric", ["ip", "l2"])
    def test_f32_chunked_topk_is_highest(self, data, metric):
        q, c = jnp.asarray(data[0]), jnp.asarray(data[1])
        precs = _dot_precisions(
            lambda a, b: chunked_topk(a, b, 5, chunk_size=256,
                                      metric=metric), q, c)
        assert precs and all(self.HIGHEST in str(p) for p in precs)

    def test_f32_rerank_is_highest(self, data):
        q, c = jnp.asarray(data[0]), jnp.asarray(data[1])
        cand = jnp.tile(jnp.arange(20, dtype=jnp.int32), (q.shape[0], 1))
        precs = _dot_precisions(
            lambda a, b: rerank_topk(a, b, cand, 5), q, c)
        assert precs and all(self.HIGHEST in str(p) for p in precs)

    def test_bf16_scan_keeps_default_precision(self, data):
        q = jnp.asarray(data[0], jnp.bfloat16)
        c = jnp.asarray(data[1], jnp.bfloat16)
        precs = _dot_precisions(
            lambda a, b: chunked_topk(a, b, 5, chunk_size=256), q, c)
        assert precs and not any(self.HIGHEST in str(p) for p in precs)
