"""Deletion support: ``remove_ids`` across the index family and
``SessionSearchEngine.remove_sessions``.

Counterpart capability: ``faiss.Index.remove_ids`` over the reference's
flat indexes (fine_tune_ours.py:844-849, test_amazon_filterd.py:207-223)
— session corpora need expiry/erasure. Semantics under test:

- swap-with-last compaction (index.dense.compaction_plan): the first
  new_size rows after removal are exactly the survivors, in the planned
  order, for every aligned buffer (rows, scales, codes);
- freed capacity is immediately reusable by add();
- the search program never retraces across remove/add interleaving.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from sessionsimilaritysearch.index import BinaryIndex, DenseIndex
from sessionsimilaritysearch.index.dense import compaction_plan
from sessionsimilaritysearch.index.twostage import TwoStageIndex
from sessionsimilaritysearch.ops.topk import l2_normalize


def apply_plan(rows: np.ndarray, size: int, ids) -> np.ndarray:
    """Host-side oracle of the compaction: survivors in planned order."""
    src, dst, new_size = compaction_plan(size, ids)
    out = rows[:size].copy()
    out[dst] = out[src]
    return out[:new_size]


class TestCompactionPlan:
    def test_moves_place_survivors(self):
        r = np.random.default_rng(0)
        rows = r.standard_normal((100, 4))
        ids = r.choice(100, size=37, replace=False)
        got = apply_plan(rows, 100, ids)
        assert got.shape[0] == 63
        # same multiset of surviving rows
        keep = np.setdiff1d(np.arange(100), ids)
        assert sorted(map(tuple, got.tolist())) == sorted(
            map(tuple, rows[keep].tolist())
        )
        # rows below new_size that were not removed never move
        untouched = keep[keep < 63]
        surviving_pos = {tuple(v): i for i, v in enumerate(got.tolist())}
        for u in untouched:
            assert surviving_pos[tuple(rows[u].tolist())] == u

    def test_tail_removal_needs_no_moves(self):
        src, dst, new_size = compaction_plan(10, [7, 8, 9])
        assert src.size == 0 and dst.size == 0 and new_size == 7

    def test_duplicates_collapse(self):
        src, dst, new_size = compaction_plan(10, [3, 3, 3])
        assert new_size == 9

    def test_empty_is_noop(self):
        src, dst, new_size = compaction_plan(10, [])
        assert src.size == 0 and new_size == 10

    def test_out_of_range_raises(self):
        with pytest.raises(ValueError):
            compaction_plan(10, [10])
        with pytest.raises(ValueError):
            compaction_plan(10, [-1])

    def test_remove_all(self):
        src, dst, new_size = compaction_plan(5, [0, 1, 2, 3, 4])
        assert new_size == 0 and src.size == 0


class TestDenseRemove:
    def _mk(self, rng, n=96, d=16, **kw):
        emb = rng.standard_normal((n, d)).astype(np.float32)
        idx = DenseIndex(dim=d, capacity=n + 32, metric="cos", **kw)
        idx.add(emb)
        return idx, emb

    def test_search_matches_rebuilt(self, rng):
        idx, emb = self._mk(rng)
        ids = rng.choice(96, size=30, replace=False)
        assert idx.remove_ids(ids) == 30
        assert idx.ntotal == 66
        survivors = apply_plan(
            np.asarray(l2_normalize(jnp.asarray(emb))), 96, ids
        )
        fresh = DenseIndex(dim=16, capacity=66, metric="cos")
        fresh.add(survivors)
        q = rng.standard_normal((7, 16)).astype(np.float32)
        D1, I1 = idx.search(q, 5)
        D2, I2 = fresh.search(q, 5)
        np.testing.assert_array_equal(I1, I2)
        np.testing.assert_allclose(D1, D2, rtol=1e-6)

    def test_removed_rows_never_returned(self, rng):
        idx, emb = self._mk(rng)
        # remove the exact nearest neighbor of query 0
        q = emb[3:4]
        _, I = idx.search(q, 1)
        hit = int(I[0, 0])
        idx.remove_ids([hit])
        _, I2 = idx.search(q, idx.ntotal)
        # row `hit`'s embedding is gone: no returned row matches it
        got = apply_plan(
            np.asarray(l2_normalize(jnp.asarray(emb))), 96, [hit]
        )
        gone = np.asarray(l2_normalize(jnp.asarray(emb)))[hit]
        assert not np.any(np.all(np.isclose(got, gone), axis=1))

    def test_capacity_reusable_after_remove(self, rng):
        emb = rng.standard_normal((10, 8)).astype(np.float32)
        idx = DenseIndex(dim=8, capacity=10, metric="ip")
        idx.add(emb)
        with pytest.raises(ValueError):
            idx.add(emb[:1])
        idx.remove_ids([0, 5, 9])
        idx.add(rng.standard_normal((3, 8)).astype(np.float32))
        assert idx.ntotal == 10

    def test_int8x8_scales_move_with_rows(self, rng):
        idx, emb = self._mk(rng, quantize="int8x8")
        ids = [0, 1, 50, 95]
        idx.remove_ids(ids)
        survivors = apply_plan(
            np.asarray(l2_normalize(jnp.asarray(emb))), 96, ids
        )
        fresh = DenseIndex(dim=16, capacity=92, metric="cos",
                           quantize="int8x8")
        fresh.add(survivors)
        # compacted codes match a fresh build over the survivors (the
        # oracle re-normalizes already-unit rows, so scales carry one extra
        # f32 rounding — compare those to tolerance, codes exactly)
        np.testing.assert_array_equal(
            np.asarray(idx._buf[:92]), np.asarray(fresh._buf[:92])
        )
        np.testing.assert_allclose(
            np.asarray(idx._scales[:92]), np.asarray(fresh._scales[:92]),
            rtol=1e-6,
        )

    def test_no_retrace_across_remove_add(self, rng):
        from sessionsimilaritysearch.ops.topk import chunked_topk

        idx, emb = self._mk(rng)
        q = rng.standard_normal((8, 16)).astype(np.float32)
        idx.search(q, 5)
        idx.remove_ids(list(range(0, 40, 3)))
        idx.search(q, 5)
        before = chunked_topk._cache_size()
        for step in range(3):
            idx.remove_ids([step])
            idx.add(rng.standard_normal((2, 16)).astype(np.float32))
            idx.search(q, 5)
        assert chunked_topk._cache_size() == before

    def test_save_load_after_remove(self, rng, tmp_path):
        idx, emb = self._mk(rng)
        idx.remove_ids([2, 4, 90])
        path = str(tmp_path / "snap")
        idx.save(path)
        back = DenseIndex.load(path)
        assert back.ntotal == 93
        q = rng.standard_normal((4, 16)).astype(np.float32)
        D1, I1 = idx.search(q, 5)
        D2, I2 = back.search(q, 5)
        np.testing.assert_array_equal(I1, I2)


class TestBinaryRemove:
    @pytest.mark.parametrize("mode", ["sign", "packed"])
    def test_matches_rebuilt(self, rng, mode):
        signs = np.where(rng.standard_normal((80, 64)) > 0, 1.0, -1.0)
        idx = BinaryIndex(n_bits=64, capacity=80, mode=mode)
        idx.add(signs)
        ids = rng.choice(80, size=25, replace=False)
        assert idx.remove_ids(ids) == 25
        survivors = apply_plan(signs, 80, ids)
        fresh = BinaryIndex(n_bits=64, capacity=55, mode=mode)
        fresh.add(survivors)
        q = np.where(rng.standard_normal((5, 64)) > 0, 1.0, -1.0)
        D1, I1 = idx.search(q, 7)
        D2, I2 = fresh.search(q, 7)
        np.testing.assert_array_equal(np.asarray(D1), np.asarray(D2))
        np.testing.assert_array_equal(np.asarray(I1), np.asarray(I2))

    def test_capacity_reuse(self, rng):
        signs = np.where(rng.standard_normal((16, 32)) > 0, 1.0, -1.0)
        idx = BinaryIndex(n_bits=32, capacity=16, mode="sign")
        idx.add(signs)
        idx.remove_ids([3, 7])
        idx.add(signs[:2])
        assert idx.ntotal == 16

    def test_packed_freed_slots_rewrite_cleanly(self, rng):
        """The transposed-packed zeroed-range invariant: remove_ids must
        zero freed slots so a later add's scatter-OR lands on clean bits.
        Interleave removals and re-adds across pack-block boundaries and
        pin exact agreement with a fresh rebuild."""
        signs = np.where(rng.standard_normal((300, 96)) > 0, 1.0, -1.0)
        idx = BinaryIndex(n_bits=96, capacity=400, mode="packed")
        rows = signs[:200]
        idx.add(signs[:200])
        for ids, lo, hi in [([0, 5, 199], 200, 230), ([10, 11, 12], 230, 260),
                            (list(range(150, 180)), 260, 300)]:
            idx.remove_ids(ids)
            rows = apply_plan(rows, len(rows), ids)
            idx.add(signs[lo:hi])
            rows = np.concatenate([rows, signs[lo:hi]])
        fresh = BinaryIndex(n_bits=96, capacity=400, mode="packed")
        fresh.add(rows)
        q = np.where(rng.standard_normal((6, 96)) > 0, 1.0, -1.0)
        D1, I1 = idx.search(q, 9)
        D2, I2 = fresh.search(q, 9)
        np.testing.assert_array_equal(np.asarray(D1), np.asarray(D2))
        np.testing.assert_array_equal(np.asarray(I1), np.asarray(I2))

    def test_packed_multi_block_remove_readd(self, rng):
        """Removals whose moves cross PACK-BLOCK boundaries (2048 slots):
        tail survivors living in later blocks must land bit-exactly in
        holes in earlier blocks, and freed multi-block tails must zero.
        (The single-block tests can't catch cross-block coordinate bugs.)"""
        n = 5000  # spans 3 pack blocks
        signs = np.where(rng.standard_normal((n + 500, 64)) > 0, 1.0, -1.0)
        idx = BinaryIndex(n_bits=64, capacity=n + 500, mode="packed")
        idx.add(signs[:n])
        # holes in block 0 and block 1; survivors pulled from block 2
        ids = list(range(10, 40)) + list(range(2100, 2130)) + [4999]
        idx.remove_ids(ids)
        rows = apply_plan(signs[:n], n, ids)
        idx.add(signs[n:n + 500])  # re-occupy freed slots across blocks
        rows = np.concatenate([rows, signs[n:n + 500]])
        fresh = BinaryIndex(n_bits=64, capacity=n + 500, mode="packed")
        fresh.add(rows)
        q = np.where(rng.standard_normal((6, 64)) > 0, 1.0, -1.0)
        D1, I1 = idx.search(q, 9)
        D2, I2 = fresh.search(q, 9)
        np.testing.assert_array_equal(np.asarray(D1), np.asarray(D2))
        np.testing.assert_array_equal(np.asarray(I1), np.asarray(I2))

    def test_packed_tail_only_removal_frees_bits(self, rng):
        """Pure-tail removals produce ZERO moves but still free slots;
        the freed bits must be zeroed or the next add corrupts codes."""
        signs = np.where(rng.standard_normal((60, 64)) > 0, 1.0, -1.0)
        idx = BinaryIndex(n_bits=64, capacity=64, mode="packed")
        idx.add(signs[:50])
        idx.remove_ids(list(range(40, 50)))  # tail: no survivor moves
        idx.add(signs[50:60])  # re-occupies the freed slots
        fresh = BinaryIndex(n_bits=64, capacity=64, mode="packed")
        fresh.add(np.concatenate([signs[:40], signs[50:60]]))
        q = np.where(rng.standard_normal((4, 64)) > 0, 1.0, -1.0)
        D1, I1 = idx.search(q, 8)
        D2, I2 = fresh.search(q, 8)
        np.testing.assert_array_equal(np.asarray(D1), np.asarray(D2))
        np.testing.assert_array_equal(np.asarray(I1), np.asarray(I2))


class TestTwoStageRemove:
    @pytest.mark.parametrize("prefilter", ["binary", "int8x8"])
    def test_matches_rebuilt(self, rng, prefilter):
        emb = rng.standard_normal((128, 24)).astype(np.float32)
        idx = TwoStageIndex(dim=24, capacity=160, metric="cos",
                            prefilter=prefilter, n_bits=32, pool=32)
        idx.add(emb)
        ids = rng.choice(128, size=40, replace=False)
        assert idx.remove_ids(ids) == 40
        survivors = apply_plan(
            np.asarray(l2_normalize(jnp.asarray(emb))), 128, ids
        )
        fresh = TwoStageIndex(dim=24, capacity=88, metric="cos",
                              prefilter=prefilter, n_bits=32, pool=32)
        fresh.add(survivors)
        q = rng.standard_normal((6, 24)).astype(np.float32)
        D1, I1 = idx.search(q, 5, pool=88)
        D2, I2 = fresh.search(q, 5, pool=88)
        np.testing.assert_array_equal(I1, I2)
        np.testing.assert_allclose(D1, D2, rtol=1e-6)

    def test_add_after_remove(self, rng):
        emb = rng.standard_normal((32, 8)).astype(np.float32)
        idx = TwoStageIndex(dim=8, capacity=32, prefilter="binary",
                            n_bits=16, pool=8)
        idx.add(emb)
        idx.remove_ids([0, 31])
        idx.add(rng.standard_normal((2, 8)).astype(np.float32))
        assert idx.ntotal == 32


@pytest.fixture(scope="module")
def mesh():
    from sessionsimilaritysearch.parallel import create_mesh

    return create_mesh()


class TestShardedRemove:
    def test_global_ids_stable(self, mesh, rng):
        from sessionsimilaritysearch.index.sharded import (
            ShardedDenseIndex,
        )
        from sessionsimilaritysearch.ops.topk import oracle_topk_np

        corpus = rng.standard_normal((160, 16)).astype(np.float32)
        idx = ShardedDenseIndex(dim=16, capacity=256, mesh=mesh,
                                metric="cos", chunk_size=64)
        idx.add(corpus)
        gone = [0, 3, 17, 55, 100, 101, 102, 159]
        assert idx.remove_ids(gone) == len(gone)
        assert idx.ntotal == 152
        keep = np.setdiff1d(np.arange(160), gone)
        cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
        q = cn[keep[:6]]
        D, I = idx.search(q, 5)
        # self-retrieval under the ORIGINAL (stable) global ids
        np.testing.assert_array_equal(I[:, 0], keep[:6])
        # scores match the oracle over the survivors
        ovals, _ = oracle_topk_np(q, cn[keep], 5)
        np.testing.assert_allclose(D, ovals, rtol=1e-4)
        # removed ids never come back, at any depth
        _, I_all = idx.search(q, idx.ntotal)
        assert not (set(I_all.ravel().tolist()) & set(gone))

    def test_add_after_remove_continues_ids(self, mesh, rng):
        from sessionsimilaritysearch.index.sharded import (
            ShardedDenseIndex,
        )

        idx = ShardedDenseIndex(dim=8, capacity=64, mesh=mesh,
                                metric="cos", chunk_size=64)
        idx.add(rng.standard_normal((32, 8)).astype(np.float32))
        idx.remove_ids(list(range(8)))
        fresh = rng.standard_normal((8, 8)).astype(np.float32)
        idx.add(fresh)
        assert idx.ntotal == 32
        fn = fresh / np.linalg.norm(fresh, axis=1, keepdims=True)
        _, I = idx.search(fn[:3], 1)
        # new rows get NEW ids past the old high-water mark (no reuse)
        np.testing.assert_array_equal(I[:, 0], [32, 33, 34])

    def test_missing_id_raises(self, mesh, rng):
        from sessionsimilaritysearch.index.sharded import (
            ShardedDenseIndex,
        )

        idx = ShardedDenseIndex(dim=8, capacity=64, mesh=mesh,
                                chunk_size=64)
        idx.add(rng.standard_normal((16, 8)).astype(np.float32))
        idx.remove_ids([5])
        with pytest.raises(ValueError, match="not present"):
            idx.remove_ids([5])

    def test_int8x8_sharded_remove(self, mesh, rng):
        from sessionsimilaritysearch.index.sharded import (
            ShardedDenseIndex,
        )

        corpus = rng.standard_normal((64, 16)).astype(np.float32)
        idx = ShardedDenseIndex(dim=16, capacity=128, mesh=mesh,
                                metric="cos", quantize="int8x8",
                                chunk_size=64)
        idx.add(corpus)
        idx.remove_ids([1, 9, 33])
        cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
        _, I = idx.search(cn[2:5], 1)
        np.testing.assert_array_equal(I[:, 0], [2, 3, 4])

    def test_save_load_roundtrip_after_remove(self, mesh, rng, tmp_path):
        from sessionsimilaritysearch.index.sharded import (
            ShardedDenseIndex,
        )

        corpus = rng.standard_normal((64, 8)).astype(np.float32)
        idx = ShardedDenseIndex(dim=8, capacity=128, mesh=mesh,
                                metric="cos", chunk_size=64)
        idx.add(corpus)
        idx.remove_ids([0, 13, 40])
        path = str(tmp_path / "shard_snap")
        idx.save(path)
        back = ShardedDenseIndex.load(path, mesh=mesh)
        assert back.ntotal == 61 and back._next_id == 64
        cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
        D1, I1 = idx.search(cn[1:4], 3)
        D2, I2 = back.search(cn[1:4], 3)
        np.testing.assert_array_equal(I1, I2)
        np.testing.assert_allclose(D1, D2, rtol=1e-5)
        # removal still works on the restored index
        back.remove_ids([1])
        _, I3 = back.search(cn[1:2], back.ntotal)
        assert 1 not in I3.ravel().tolist()

    def test_twostage_sharded_remove(self, mesh, rng):
        from sessionsimilaritysearch.index.twostage import (
            ShardedTwoStageIndex,
        )

        corpus = rng.standard_normal((64, 16)).astype(np.float32)
        idx = ShardedTwoStageIndex(dim=16, capacity=128, mesh=mesh,
                                   metric="cos", prefilter="binary",
                                   n_bits=32, pool=16)
        idx.add(corpus)
        gone = [2, 8, 9, 40]
        assert idx.remove_ids(gone) == 4
        cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
        keep = np.setdiff1d(np.arange(64), gone)
        D, I = idx.search(cn[keep[:4]], 1, pool=16)
        np.testing.assert_array_equal(I[:, 0], keep[:4])
        _, I_all = idx.search(cn[:4], 16, pool=16)
        assert not (set(I_all.ravel().tolist()) & set(gone))


class TestEngineRemove:
    def _engine(self, gen, tokenizer, mesh=None, capacity=128):
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
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=capacity,
            batch_size=8, mesh=mesh,
        )

    def test_remove_by_ids_single_chip(self, gen, tokenizer):
        eng = self._engine(gen, tokenizer)
        data = gen.dataset(20)
        eng.add_sessions(data)
        # removing the stored copies of queries 0/1 demotes them from
        # self-retrieval; the remaining corpus still self-retrieves
        assert eng.remove_sessions(ids=[0, 1]) == 2
        assert eng.index.ntotal == 18
        _, I = eng.search(data[2:6], k=1)
        stored = [eng.sessions[i] for i in I[:, 0]]
        expect = [d[0] for d in data[2:6]]
        assert stored == expect  # positional metadata tracked the moves

    def test_remove_by_content_single_chip(self, gen, tokenizer):
        eng = self._engine(gen, tokenizer)
        data = gen.dataset(12)
        eng.add_sessions(data)
        n = eng.remove_sessions(data=data[:3])
        assert n == 3 and eng.index.ntotal == 9
        for d in data[:3]:
            assert d[0] not in eng.sessions
        # hybrid + dedup query paths run on the rebuilt metadata
        D, I = eng.search(data[3:6], k=3, dedup=True, hybrid_alpha=0.5)
        stored = [eng.sessions[i] for i in I[:, 0]]
        assert stored == [d[0] for d in data[3:6]]

    def test_remove_matching_pending(self, gen, tokenizer, mesh):
        eng = self._engine(gen, tokenizer, mesh=mesh)
        data = gen.dataset(10)  # 8 insert, 2 stay pending
        eng.add_sessions(data)
        assert eng.stats()["pending"] == 2
        n = eng.remove_sessions(data=data[8:])
        assert n == 0  # nothing inserted yet -- only pending dropped
        assert eng.stats()["pending"] == 0

    def test_remove_sharded_stable_ids(self, gen, tokenizer, mesh):
        eng = self._engine(gen, tokenizer, mesh=mesh)
        data = gen.dataset(16)
        eng.add_sessions(data)
        assert eng.remove_sessions(data=data[:2]) == 2
        assert eng.index.ntotal == 14
        _, I = eng.search(data[2:6], k=1)
        np.testing.assert_array_equal(I[:, 0], [2, 3, 4, 5])  # stable gids
        # metadata rows for survivors still line up (gid -> session), and
        # the report path runs over the tombstoned session list
        assert [eng.sessions[i] for i in I[:, 0]] == [
            d[0] for d in data[2:6]
        ]
        rep = eng.report(data[2:6], I)
        assert np.isfinite(rep["ave_all_jaccard"])
        # content-keyed second removal of the same rows finds nothing
        assert eng.remove_sessions(data=data[:2]) == 0

    def test_ttl_expiry(self, gen, tokenizer):
        eng = self._engine(gen, tokenizer)
        old, new, never = gen.dataset(6), gen.dataset(4), gen.dataset(2)
        eng.add_sessions(old, stamp=100.0)
        eng.add_sessions(new, stamp=200.0)
        eng.add_sessions(never)  # unstamped: exempt from TTL
        assert eng.expire(before=150.0) == 6
        assert eng.index.ntotal == 6
        # the survivors still self-retrieve with aligned metadata
        _, I = eng.search(new[:3], k=1)
        assert [eng.sessions[i] for i in I[:, 0]] == [
            d[0] for d in new[:3]
        ]
        # idempotent; unstamped rows survive any cutoff
        assert eng.expire(before=150.0) == 0
        assert eng.expire(before=1e9) == 4
        assert eng.index.ntotal == 2

    def test_ttl_stamps_survive_snapshot(self, gen, tokenizer, tmp_path):
        eng = self._engine(gen, tokenizer)
        data = gen.dataset(8)
        eng.add_sessions(data[:4], stamp=1.0)
        eng.add_sessions(data[4:], stamp=2.0)
        eng.save(str(tmp_path / "snap"))
        eng2 = self._engine(gen, tokenizer)
        eng2.restore(str(tmp_path / "snap"))
        assert eng2.expire(before=1.5) == 4
        assert eng2.index.ntotal == 4

    def test_async_ingest_carries_stamp(self, gen, tokenizer):
        eng = self._engine(gen, tokenizer)
        eng.add_sessions_async(gen.dataset(4), stamp=10.0)
        eng.flush()
        assert eng.expire(before=11.0) == 4
        eng.close()

    def test_incremental_compaction_matches_full_rebuild(self, gen,
                                                         tokenizer):
        """`_compact_meta` (O(moved), the serving-soak fix for ~18 s/remove
        full rebuilds at 1M rows) must leave every metadata structure
        semantically identical to `_rebuild_meta` — same flat item CSR and
        STAN weights, and the same canonical-EQUALITY classes (raw canon
        ids may differ: the incremental path never renumbers)."""
        eng = self._engine(gen, tokenizer)
        data = gen.dataset(24)
        eng.add_sessions(data)
        eng.add_sessions(data[:4])  # duplicates: exercise canon classes
        eng.remove_sessions(ids=[1, 5, 17, 25])
        eng.add_sessions(gen.dataset(6))  # append after a shrink
        eng.remove_sessions(data=data[7:9])

        n, canon, off, flat, wstan = eng._np_meta()
        eng._rebuild_meta()
        n2, canon2, off2, flat2, wstan2 = eng._np_meta()

        assert n == n2 == len(eng.sessions)
        np.testing.assert_array_equal(off, off2)
        np.testing.assert_array_equal(flat, flat2)
        np.testing.assert_allclose(wstan, wstan2)
        # equality-class isomorphism: rows grouped identically
        remap = {}
        for a, b in zip(canon.tolist(), canon2.tolist()):
            assert remap.setdefault(a, b) == b
        assert len(remap) == len(set(remap.values()))
