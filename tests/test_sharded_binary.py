"""ShardedBinaryIndex: pure Hamming ranking at scale-out, on the 8-device
virtual CPU mesh.

Reference anchor: faiss.IndexBinaryFlat's serve path
(fine_tune_ours.py:839-879) had no multi-chip analogue before this —
scale-out binary existed only as stage 1 inside ShardedTwoStageIndex.
Every test checks against the exact numpy Hamming oracle
(ops.hamming.oracle_hamming_np); distance VALUES are compared (integer
Hamming scores are heavily tied, so id sets churn while ranking quality
is exact — the repo's tie-aware convention)."""

import numpy as np
import pytest

from sessionsimilaritysearch.index import BinaryIndex, ShardedBinaryIndex
from sessionsimilaritysearch.ops.hamming import oracle_hamming_np
from sessionsimilaritysearch.parallel import create_mesh


@pytest.fixture(scope="module")
def mesh():
    return create_mesh()


def _codes(rng, n, bits):
    return np.sign(rng.standard_normal((n, bits))).astype(np.float32)


@pytest.fixture(scope="module", params=["sign", "packed"])
def mode(request):
    return request.param


class TestShardedBinarySearch:
    def test_matches_hamming_oracle(self, mesh, rng, mode):
        codes = _codes(rng, 1024, 64)
        idx = ShardedBinaryIndex(n_bits=64, capacity=2048, mesh=mesh,
                                 mode=mode)
        idx.add(codes)
        q = _codes(rng, 9, 64)
        D, I = idx.search(q, 10)
        oD, _ = oracle_hamming_np(q, codes, 10)
        np.testing.assert_array_equal(D, oD)
        # every returned id scores its reported distance (exactness of the
        # id->distance pairing, immune to tie churn)
        qb = (q > 0).astype(np.int32)
        cb = (codes > 0).astype(np.int32)
        true = (qb[:, None, :] != cb[None, :, :]).sum(-1)
        np.testing.assert_array_equal(
            np.take_along_axis(true, I.astype(np.int64), axis=1), D
        )

    def test_matches_single_chip(self, mesh, rng, mode):
        codes = _codes(rng, 512, 64)
        sh = ShardedBinaryIndex(n_bits=64, capacity=1024, mesh=mesh,
                                mode=mode)
        sh.add(codes)
        single = BinaryIndex(n_bits=64, capacity=1024, mode="sign")
        single.add(codes)
        q = _codes(rng, 5, 64)
        D1, _ = sh.search(q, 8)
        D2, _ = single.search(q, 8)
        np.testing.assert_array_equal(D1, D2)

    def test_streaming_insert_preserves_global_ids(self, mesh, rng, mode):
        idx = ShardedBinaryIndex(n_bits=64, capacity=2048, mesh=mesh,
                                 mode=mode)
        a = _codes(rng, 256, 64)
        b = _codes(rng, 128, 64)
        idx.add(a)
        idx.add(b)
        assert idx.ntotal == 384
        # querying an exact stored code returns distance 0 with its gid
        # (codes are unique w.h.p. at 64 random bits)
        D, I = idx.search(b[:4], 1)
        assert D[:, 0].tolist() == [0, 0, 0, 0]
        assert I[:, 0].tolist() == [256, 257, 258, 259]

    def test_row_mask_is_gid_keyed(self, mesh, rng, mode):
        codes = _codes(rng, 256, 64)
        idx = ShardedBinaryIndex(n_bits=64, capacity=512, mesh=mesh,
                                 mode=mode)
        idx.add(codes)
        mask = np.zeros(256, bool)
        mask[:64] = True  # only the first 64 gids may rank
        D, I = idx.search(codes[100:104], 5, row_mask=mask)
        assert (I < 64).all() and (I >= 0).all()
        oD, _ = oracle_hamming_np(codes[100:104], codes[:64], 5)
        np.testing.assert_array_equal(D, oD)

    def test_approx_selection_sign(self, mesh, rng):
        codes = _codes(rng, 1024, 64)
        idx = ShardedBinaryIndex(n_bits=64, capacity=2048, mesh=mesh,
                                 mode="sign", selection="approx")
        idx.add(codes)
        D, I = idx.search(codes[:4], 4)
        assert D[:, 0].tolist() == [0, 0, 0, 0]
        assert I[:, 0].tolist() == [0, 1, 2, 3]


class TestShardedBinaryMaintenance:
    def test_remove_ids_stable_gids(self, mesh, rng, mode):
        codes = _codes(rng, 512, 64)
        idx = ShardedBinaryIndex(n_bits=64, capacity=1024, mesh=mesh,
                                 mode=mode)
        idx.add(codes)
        victims = np.asarray([0, 7, 63, 64, 300, 511])
        assert idx.remove_ids(victims) == victims.size
        assert idx.ntotal == 512 - victims.size
        # removed gids never rank again
        D, I = idx.search(codes[victims], 3)
        assert not np.isin(I, victims).any()
        # survivors keep their ids: an exact query still self-retrieves
        keep = [1, 2, 65, 400]
        D, I = idx.search(codes[keep], 1)
        assert D[:, 0].tolist() == [0, 0, 0, 0]
        assert I[:, 0].tolist() == keep
        # ranking over the survivors matches the oracle on the survivor set
        mask = np.ones(512, bool)
        mask[victims] = False
        q = _codes(rng, 6, 64)
        oD, _ = oracle_hamming_np(q, codes[mask], 10)
        D, I = idx.search(q, 10)
        np.testing.assert_array_equal(D, oD)
        # absent ids raise
        with pytest.raises(ValueError):
            idx.remove_ids([0])

    def test_capacity_reuse_after_remove(self, mesh, rng, mode):
        # freed slots are reusable; packed mode exercises the zeroed-
        # freed-range invariant (scatter-OR appends into cleared bits)
        idx = ShardedBinaryIndex(n_bits=64, capacity=512, mesh=mesh,
                                 mode=mode)
        a = _codes(rng, 512, 64)
        idx.add(a)
        idx.remove_ids(np.arange(0, 512, 2))  # halve every shard
        b = _codes(rng, 256, 64)
        idx.add(b)
        assert idx.ntotal == 512
        D, I = idx.search(b[:4], 1)
        assert D[:, 0].tolist() == [0, 0, 0, 0]
        assert I[:, 0].tolist() == [512, 513, 514, 515]
        # full state still matches the oracle over survivors + new rows
        live = np.concatenate([a[1::2], b])
        q = _codes(rng, 5, 64)
        oD, _ = oracle_hamming_np(q, live, 8)
        D, _ = idx.search(q, 8)
        np.testing.assert_array_equal(D, oD)

    def test_reconstruct_by_gid(self, mesh, rng, mode):
        codes = _codes(rng, 256, 64)
        idx = ShardedBinaryIndex(n_bits=64, capacity=512, mesh=mesh,
                                 mode=mode)
        idx.add(codes)
        got = idx.reconstruct_batch([3, 100, 255])
        np.testing.assert_array_equal(got, codes[[3, 100, 255]])
        idx.remove_ids([100])
        np.testing.assert_array_equal(idx.reconstruct(255), codes[255])
        with pytest.raises(KeyError):
            idx.reconstruct(100)

    def test_range_search_csr(self, mesh, rng, mode):
        codes = _codes(rng, 512, 64)
        idx = ShardedBinaryIndex(n_bits=64, capacity=1024, mesh=mesh,
                                 mode=mode)
        idx.add(codes)
        q = codes[:3]
        radius = 24
        lims, D, I = idx.range_search(q, radius)
        qb = (q > 0).astype(np.int32)
        cb = (codes > 0).astype(np.int32)
        true = (qb[:, None, :] != cb[None, :, :]).sum(-1)
        for i in range(3):
            got = np.sort(I[lims[i]:lims[i + 1]])
            want = np.flatnonzero(true[i] <= radius)
            np.testing.assert_array_equal(got, want)
            # slice sorted nearest-first
            sl = D[lims[i]:lims[i + 1]]
            assert (np.diff(sl) >= 0).all()


class TestShardedBinaryPersistence:
    def test_save_load_roundtrip(self, mesh, rng, mode, tmp_path):
        codes = _codes(rng, 256, 64)
        idx = ShardedBinaryIndex(n_bits=64, capacity=512, mesh=mesh,
                                 mode=mode)
        idx.add(codes)
        idx.remove_ids([5, 200])  # divergent fills round-trip too
        p = str(tmp_path / "sb.npz")
        idx.save(p)
        idx2 = ShardedBinaryIndex.load(p, mesh)
        assert idx2.ntotal == idx.ntotal and idx2.mode == mode
        q = _codes(rng, 4, 64)
        D1, I1 = idx.search(q, 6)
        D2, I2 = idx2.search(q, 6)
        np.testing.assert_array_equal(D1, D2)
        np.testing.assert_array_equal(I1, I2)
        # streaming continues with fresh ids after restore
        idx2.add(_codes(rng, 8, 64))
        assert idx2.ntotal == idx.ntotal + 8

    def test_state_dict_roundtrip(self, mesh, rng, mode):
        codes = _codes(rng, 128, 64)
        idx = ShardedBinaryIndex(n_bits=64, capacity=256, mesh=mesh,
                                 mode=mode)
        idx.add(codes)
        state = idx.state_dict()
        idx2 = ShardedBinaryIndex(n_bits=64, capacity=256, mesh=mesh,
                                  mode=mode)
        idx2.load_state(state)
        D1, _ = idx.search(codes[:3], 4)
        D2, _ = idx2.search(codes[:3], 4)
        np.testing.assert_array_equal(D1, D2)
