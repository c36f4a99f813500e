"""range_search + merge_from across the index family.

FAISS counterparts the reference relies on implicitly through its flat
indexes (fine_tune_ours.py:844-849): ``faiss.Index.range_search`` /
``merge_from`` and the IndexBinaryFlat forms. Oracles are numpy
brute-force scans; CSR conventions match FAISS (lims/D/I), with the
stronger guarantee that each query's slice is sorted best-first.
"""

import numpy as np
import pytest

from sessionsimilaritysearch.index.binary import BinaryIndex
from sessionsimilaritysearch.index.dense import DenseIndex, build_index


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _csr_rows(lims, d, i):
    return [
        (d[lims[q]: lims[q + 1]], i[lims[q]: lims[q + 1]])
        for q in range(len(lims) - 1)
    ]


class TestDenseRangeSearch:
    def test_cos_matches_bruteforce(self, rng):
        corpus = rng.standard_normal((300, 32)).astype(np.float32)
        queries = rng.standard_normal((7, 32)).astype(np.float32)
        idx = build_index(corpus, metric="cos")
        radius = 0.25
        lims, d, i = idx.range_search(queries, radius, k0=8)
        oracle = _unit(queries) @ _unit(corpus).T  # [q, n]
        for q, (dq, iq) in enumerate(_csr_rows(lims, d, i)):
            want = set(np.nonzero(oracle[q] >= radius)[0])
            assert set(iq.tolist()) == want
            # slice sorted best-first, scores within radius
            assert np.all(np.diff(dq) <= 1e-6)
            assert np.all(dq >= radius)

    def test_l2_matches_bruteforce(self, rng):
        corpus = rng.standard_normal((200, 16)).astype(np.float32)
        queries = corpus[:5] + 0.1 * rng.standard_normal((5, 16)).astype(
            np.float32
        )
        idx = build_index(corpus, metric="l2")
        radius = 2.0
        lims, d, i = idx.range_search(queries, radius, k0=8)
        dist = ((queries[:, None, :] - corpus[None]) ** 2).sum(-1)
        for q, (dq, iq) in enumerate(_csr_rows(lims, d, i)):
            want = set(np.nonzero(dist[q] <= radius)[0])
            assert set(iq.tolist()) == want
            assert np.all(np.diff(dq) >= -1e-5)
            assert np.all(dq <= radius + 1e-5)

    def test_adaptive_doubling_reaches_full_corpus(self, rng):
        # radius covering EVERY row forces the depth loop to total
        corpus = _unit(rng.standard_normal((64, 8)).astype(np.float32))
        idx = build_index(corpus, metric="cos")
        lims, d, i = idx.range_search(corpus[:3], -2.0, k0=8)
        assert np.all(np.diff(lims) == 64)
        assert sorted(i[: lims[1]].tolist()) == list(range(64))

    def test_empty_results_and_empty_index(self, rng):
        corpus = _unit(rng.standard_normal((50, 8)).astype(np.float32))
        idx = build_index(corpus, metric="cos")
        lims, d, i = idx.range_search(corpus[:2], 2.0)  # nothing >= 2
        assert np.all(lims == 0) and d.size == 0 and i.size == 0
        empty = DenseIndex(dim=8, capacity=16)
        lims, d, i = empty.range_search(corpus[:2], -2.0)
        assert np.all(lims == 0) and d.size == 0


class TestDenseMergeFrom:
    def test_matches_single_build(self, rng):
        a = rng.standard_normal((40, 16)).astype(np.float32)
        b = rng.standard_normal((25, 16)).astype(np.float32)
        merged = DenseIndex(dim=16, capacity=80, metric="cos")
        merged.add(a)
        other = build_index(b, metric="cos")
        assert merged.merge_from(other) == 25
        assert merged.ntotal == 65
        ref = build_index(np.concatenate([a, b]), metric="cos")
        q = rng.standard_normal((6, 16)).astype(np.float32)
        dm, im = merged.search(q, 10)
        dr, ir = ref.search(q, 10)
        np.testing.assert_array_equal(im, ir)
        np.testing.assert_allclose(dm, dr, rtol=1e-6)
        # ids shifted by the pre-merge ntotal (FAISS convention)
        np.testing.assert_allclose(
            merged.reconstruct(40), other.reconstruct(0), rtol=1e-6
        )

    def test_quantized_merge_carries_scales(self, rng):
        a = rng.standard_normal((30, 16)).astype(np.float32)
        b = rng.standard_normal((20, 16)).astype(np.float32)
        merged = DenseIndex(dim=16, capacity=64, quantize="int8")
        merged.add(a)
        other = DenseIndex(dim=16, capacity=20, quantize="int8")
        other.add(b)
        merged.merge_from(other)
        ref = DenseIndex(dim=16, capacity=64, quantize="int8")
        ref.add(a)
        ref.add(b)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        dm, im = merged.search(q, 8)
        dr, ir = ref.search(q, 8)
        np.testing.assert_array_equal(im, ir)
        np.testing.assert_allclose(dm, dr, rtol=1e-5)

    def test_mismatch_and_capacity_raise(self, rng):
        a = build_index(rng.standard_normal((4, 8)).astype(np.float32))
        b = build_index(
            rng.standard_normal((4, 8)).astype(np.float32), metric="ip"
        )
        with pytest.raises(ValueError, match="metric"):
            a.merge_from(b)
        c = build_index(rng.standard_normal((4, 8)).astype(np.float32))
        with pytest.raises(ValueError, match="full"):
            a.merge_from(c)  # a is at capacity 4
        # center transform mismatch
        cen = build_index(
            rng.standard_normal((4, 8)).astype(np.float32), center="auto"
        )
        big = DenseIndex(dim=8, capacity=32)
        big.add(rng.standard_normal((2, 8)).astype(np.float32))
        with pytest.raises(ValueError, match="center"):
            big.merge_from(cen)

    def test_auto_center_adopts_fitted_mean(self, rng):
        b = rng.standard_normal((20, 8)).astype(np.float32)
        other = build_index(b, center="auto")
        fresh = DenseIndex(dim=8, capacity=32, center="auto")
        fresh.merge_from(other)
        q = rng.standard_normal((3, 8)).astype(np.float32)
        do, io = other.search(q, 5)
        df, if_ = fresh.search(q, 5)
        np.testing.assert_array_equal(io, if_)
        np.testing.assert_allclose(do, df, rtol=1e-6)


def _codes(rng, n, bits):
    return np.sign(rng.standard_normal((n, bits))).astype(np.float32)


class TestBinaryRangeAndMerge:
    @pytest.mark.parametrize("mode", ["sign", "packed"])
    def test_range_search_matches_bruteforce(self, rng, mode):
        bits = 64
        codes = _codes(rng, 150, bits)
        idx = BinaryIndex(n_bits=bits, capacity=150, mode=mode)
        idx.add(codes)
        q = codes[:4]
        radius = bits // 4
        lims, d, i = idx.range_search(q, radius, k0=8)
        ham = (q[:, None, :] != codes[None]).sum(-1)  # [4, n]
        for qi, (dq, iq) in enumerate(_csr_rows(lims, d, i)):
            want = set(np.nonzero(ham[qi] <= radius)[0])
            assert set(iq.tolist()) == want
            assert np.all(np.diff(dq) >= 0)
            assert np.all(dq <= radius)

    @pytest.mark.parametrize(
        "src_mode,dst_mode",
        [("sign", "sign"), ("packed", "packed"), ("sign", "packed")],
    )
    def test_merge_matches_single_build(self, rng, src_mode, dst_mode):
        bits = 64
        a, b = _codes(rng, 50, bits), _codes(rng, 37, bits)
        merged = BinaryIndex(n_bits=bits, capacity=128, mode=dst_mode)
        merged.add(a)
        other = BinaryIndex(n_bits=bits, capacity=64, mode=src_mode)
        other.add(b)
        assert merged.merge_from(other, batch=16) == 37
        ref = BinaryIndex(n_bits=bits, capacity=128, mode=dst_mode)
        ref.add(np.concatenate([a, b]))
        q = _codes(rng, 5, bits)
        dm, im = merged.search(q, 12)
        dr, ir = ref.search(q, 12)
        np.testing.assert_array_equal(dm, dr)
        # distances identical; ids may permute only within exact ties --
        # verify id sets per tie-class instead of raw order
        for row_m, row_r, drow in zip(im, ir, dm):
            for dist in np.unique(drow):
                sel = drow == dist
                assert set(row_m[sel]) == set(row_r[sel])

    def test_merge_width_mismatch_raises(self, rng):
        a = BinaryIndex(n_bits=64, capacity=8)
        b = BinaryIndex(n_bits=32, capacity=8)
        with pytest.raises(ValueError, match="width"):
            a.merge_from(b)


class TestShardedRangeSearch:
    def test_matches_bruteforce_across_shards(self, rng):
        from sessionsimilaritysearch.index.sharded import (
            ShardedDenseIndex,
        )
        from sessionsimilaritysearch.parallel import create_mesh

        mesh = create_mesh()
        corpus = rng.standard_normal((256, 16)).astype(np.float32)
        idx = ShardedDenseIndex(dim=16, capacity=256, mesh=mesh)
        idx.add(corpus)
        q = rng.standard_normal((5, 16)).astype(np.float32)
        radius = 0.3
        lims, d, i = idx.range_search(q, radius, k0=8)
        oracle = _unit(q) @ _unit(corpus).T
        for qi, (dq, iq) in enumerate(_csr_rows(lims, d, i)):
            want = set(np.nonzero(oracle[qi] >= radius)[0])
            assert set(iq.tolist()) == want  # gids == insertion order here
            assert np.all(np.diff(dq) <= 1e-6)


class TestTwoStageMergeFrom:
    def test_merge_from_twostage_and_dense(self, rng):
        from sessionsimilaritysearch.index.twostage import TwoStageIndex

        a = rng.standard_normal((60, 24)).astype(np.float32)
        b = rng.standard_normal((40, 24)).astype(np.float32)
        merged = TwoStageIndex(
            dim=24, capacity=128, pool=128, n_bits=64
        )
        merged.add(a)
        # source 1: another two-stage with a DIFFERENT prefilter seed
        src_ts = TwoStageIndex(
            dim=24, capacity=40, pool=64, n_bits=32, seed=7
        )
        src_ts.add(b)
        assert merged.merge_from(src_ts, batch=16) == 40
        assert merged.ntotal == 100
        # full pool -> stage 2 is the exact ranking; compare to a dense
        # oracle over the SAME bf16-stored rows
        oracle = build_index(
            np.concatenate([a, b]), metric="cos"
        )
        q = rng.standard_normal((5, 24)).astype(np.float32)
        dm, im = merged.search(q, 10)
        do, io = oracle.search(q, 10)
        np.testing.assert_array_equal(im, io)
        np.testing.assert_allclose(dm, do, atol=2e-2)  # bf16 storage
        # source 2: a plain DenseIndex merges too
        more = rng.standard_normal((20, 24)).astype(np.float32)
        merged.merge_from(build_index(more, metric="cos"))
        assert merged.ntotal == 120
        # centered dense rows must refuse
        cen = build_index(more, metric="cos", center="auto")
        with pytest.raises(ValueError, match="center"):
            merged.merge_from(cen)
        bad = TwoStageIndex(
            dim=16, capacity=8, pool=8, n_bits=32
        )
        with pytest.raises(ValueError, match="dim/metric"):
            merged.merge_from(bad)
