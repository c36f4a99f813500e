"""SessionSearchEngine serving-facade tests (single-device and sharded)."""

import jax
import numpy as np
import pytest

from sessionsimilaritysearch.config import tiny_test_config
from sessionsimilaritysearch.engine import SessionSearchEngine
from sessionsimilaritysearch.models import build_text_session_encoder
from sessionsimilaritysearch.parallel import create_mesh


@pytest.fixture(scope="module")
def engine_parts(gen, tokenizer):
    cfg = tiny_test_config()
    enc = build_text_session_encoder(cfg)
    from sessionsimilaritysearch.data.graph import (
        batch_graphs,
        sequence_to_graph,
    )

    sample = batch_graphs([
        sequence_to_graph(0, *gen.datum(), tokenizer, cfg.dims)
    ] * 8)
    params = enc.init(jax.random.PRNGKey(0), sample)
    encode_fn = jax.jit(lambda g: enc.apply(params, g))
    return cfg, encode_fn


class TestEngine:
    def test_add_then_search(self, engine_parts, gen, tokenizer):
        cfg, encode_fn = engine_parts
        eng = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=128,
            batch_size=8,
        )
        data = gen.dataset(20)
        eng.add_sessions(data)
        assert eng.index.ntotal == 20
        D, I = eng.search(data[:5], k=3)
        np.testing.assert_array_equal(I[:, 0], np.arange(5))  # self top-1
        rep = eng.report(data[:5], I)
        assert "ave_all_jaccard" in rep
        stats = eng.stats()
        assert stats["ntotal"] == 20 and "encode" in stats

    def test_streaming_insert_mid_serving(self, engine_parts, gen, tokenizer):
        cfg, encode_fn = engine_parts
        eng = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=128,
            batch_size=8,
        )
        a, b = gen.dataset(10), gen.dataset(6)
        eng.add_sessions(a)
        _, I1 = eng.search(a[:2], k=2)
        eng.add_sessions(b)
        _, I2 = eng.search(b[:2], k=1)
        np.testing.assert_array_equal(I2[:, 0], [10, 11])  # global ids

    def test_sharded_engine(self, engine_parts, gen, tokenizer):
        cfg, encode_fn = engine_parts
        mesh = create_mesh()
        eng = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=128,
            mesh=mesh, batch_size=8,
        )
        data = gen.dataset(20)  # 20 % 8 != 0 -> remainder stays pending
        eng.add_sessions(data)
        assert eng.index.ntotal == 16  # whole stripes only, no duplicates
        assert eng.stats()["pending"] == 4
        D, I = eng.search(data[:5], k=3)
        np.testing.assert_array_equal(I[:, 0], np.arange(5))
        # the pending tail flushes with the next add
        eng.add_sessions(gen.dataset(4))
        assert eng.index.ntotal == 24
        assert eng.stats()["pending"] == 0
        # a late row is findable under its global insertion id
        D2, I2 = eng.search([data[16][0]], k=1)
        assert I2[0, 0] == 16

    def test_async_ingest_and_flush(self, engine_parts, gen, tokenizer):
        cfg, encode_fn = engine_parts
        eng = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=128,
            batch_size=8,
        )
        data = gen.dataset(24)
        eng.add_sessions_async(data[:12])
        eng.add_sessions_async(data[12:])
        eng.flush()
        assert eng.index.ntotal == 24
        # identical to the synchronous path
        ref = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=128,
            batch_size=8,
        )
        ref.add_sessions(data)
        D1, I1 = eng.search(data[:4], k=3)
        D2, I2 = ref.search(data[:4], k=3)
        np.testing.assert_array_equal(I1, I2)
        eng.close()

    def test_dedup_search(self, engine_parts, gen, tokenizer):
        cfg, encode_fn = engine_parts
        eng = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=128,
            batch_size=8,
        )
        data = gen.dataset(10)
        eng.add_sessions(data)
        eng.add_sessions(data[:3])  # replayed stream: rows 10-12 dup 0-2
        D, I = eng.search(data[:3], k=4, dedup=False)
        # without dedup the duplicate occupies a top slot (cos ties)
        first_two = set(I[0, :2].tolist())
        assert first_two == {0, 10}
        Dd, Id = eng.search(data[:3], k=4, dedup=True)
        for r in range(3):
            kept = [i for i in Id[r] if i >= 0]
            keys = [eng._canon[i] for i in kept]
            assert len(set(keys)) == len(keys)  # no duplicate sessions
        assert Id[0, 0] in (0, 10)
        assert 10 not in Id[0] or 0 not in Id[0]

    def test_snapshot_restore(self, engine_parts, gen, tokenizer, tmp_path):
        cfg, encode_fn = engine_parts
        eng = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=128,
            batch_size=8,
        )
        data = gen.dataset(15)
        eng.add_sessions(data)
        D1, I1 = eng.search(data[:4], k=3)
        prefix = str(tmp_path / "snap")
        eng.save(prefix)
        fresh = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=128,
            batch_size=8,
        )
        fresh.restore(prefix)
        assert fresh.index.ntotal == 15
        assert len(fresh.sessions) == 15
        D2, I2 = fresh.search(data[:4], k=3)
        np.testing.assert_array_equal(I1, I2)
        np.testing.assert_allclose(D1, D2, atol=1e-6)
        rep = fresh.report(data[:4], I2)
        assert "ave_all_jaccard" in rep

    def test_save_async_capture_consistency(self, engine_parts,
                                            tokenizer, tmp_path):
        """save_async must persist the CAPTURE point: mutations (add +
        remove) racing the background write must not leak into the
        snapshot, and searches keep answering while it streams."""
        from sessionsimilaritysearch.data.synthetic import (
            SyntheticSessionGenerator,
        )

        cfg, encode_fn = engine_parts
        eng = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=128,
            batch_size=8, dtype=__import__("jax.numpy", fromlist=[""]
                                           ).bfloat16,
        )
        # own generator: the shared `gen` fixture is module-scoped and
        # consuming its stream makes later tests order-dependent
        data = SyntheticSessionGenerator(
            asin_num=cfg.asin_num, seed=991
        ).dataset(30)
        eng.add_sessions(data[:15])
        D1, I1 = eng.search(data[:4], k=3)
        prefix = str(tmp_path / "asnap")
        h = eng.save_async(prefix)
        # mutate while (possibly) still writing; serve a query too
        eng.add_sessions(data[15:])
        eng.remove_sessions(data=data[2:4])
        eng.search(data[:4], k=3)
        h.join()
        assert h.done()
        assert eng.index.ntotal == 28  # live engine saw the mutations
        fresh = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=128,
            batch_size=8,
        )
        fresh.restore(prefix)
        assert fresh.index.ntotal == 15  # the capture point, exactly
        D2, I2 = fresh.search(data[:4], k=3)
        np.testing.assert_array_equal(I1, I2)
        np.testing.assert_allclose(np.asarray(D1), np.asarray(D2),
                                   atol=1e-6)

    def test_restore_frees_old_buffers_first(self, engine_parts, gen,
                                             tokenizer, tmp_path,
                                             monkeypatch):
        """restore() must drop the live index BEFORE the snapshot load
        materializes the new one — holding both capacity-sized corpora
        doubles device memory mid-restore, which can run a device out of
        memory exactly when restore is most needed."""
        cfg, encode_fn = engine_parts
        eng = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=128,
            batch_size=8,
        )
        data = gen.dataset(10)
        eng.add_sessions(data)
        prefix = str(tmp_path / "snap")
        eng.save(prefix)

        from sessionsimilaritysearch.index.dense import DenseIndex

        real_load = DenseIndex.load.__func__
        seen = {}

        def spy_load(cls, path, capacity=None, **kw):
            seen["index_at_load"] = eng.index
            return real_load(cls, path, capacity=capacity, **kw)

        monkeypatch.setattr(DenseIndex, "load", classmethod(spy_load))
        eng.restore(prefix)
        assert seen["index_at_load"] is None  # old buffers already freed
        assert eng.index.ntotal == 10
        D, I = eng.search(data[:3], k=2)
        np.testing.assert_array_equal(np.asarray(I)[:, 0], np.arange(3))

    def test_engine_dtype_passthrough(self, engine_parts, gen, tokenizer,
                                      tmp_path):
        """dtype= reaches the dense index (bf16 production storage) and
        survives a snapshot round-trip."""
        import jax.numpy as jnp

        cfg, encode_fn = engine_parts
        eng = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=64,
            batch_size=8, dtype=jnp.bfloat16,
        )
        assert eng.index.dtype == jnp.bfloat16
        data = gen.dataset(12)
        eng.add_sessions(data)
        D, I = eng.search(data[:4], k=3)
        assert np.asarray(D).shape == (4, 3)
        assert np.all(np.diff(np.asarray(D), axis=1) <= 1e-6)  # sorted
        prefix = str(tmp_path / "snap_bf16")
        eng.save(prefix)
        fresh = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=64,
            batch_size=8,
        )
        fresh.restore(prefix)
        assert fresh.index.dtype == jnp.bfloat16  # persisted, not default

    def test_sharded_snapshot_restore(self, engine_parts, gen, tokenizer,
                                      tmp_path):
        cfg, encode_fn = engine_parts
        mesh = create_mesh()
        eng = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=128,
            mesh=mesh, batch_size=8,
        )
        data = gen.dataset(20)
        eng.add_sessions(data)  # 16 inserted, 4 pending
        prefix = str(tmp_path / "snap")
        eng.save(prefix)
        fresh = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=128,
            mesh=mesh, batch_size=8,
        )
        fresh.restore(prefix)
        assert fresh.index.ntotal == 16
        assert fresh.stats()["pending"] == 4
        D, I = fresh.search(data[:5], k=3)
        np.testing.assert_array_equal(I[:, 0], np.arange(5))
        # pending tail resumes striping after restore
        fresh.add_sessions(gen.dataset(4))
        assert fresh.index.ntotal == 24

    def test_hybrid_search(self, engine_parts, gen, tokenizer):
        cfg, encode_fn = engine_parts
        eng = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=128,
            batch_size=8,
        )
        data = gen.dataset(24)
        eng.add_sessions(data)
        # alpha=1 reproduces plain dense search exactly
        Dd, Id = eng.search(data[:4], k=5)
        Dh, Ih = eng.search(data[:4], k=5, hybrid_alpha=1.0)
        np.testing.assert_array_equal(Ih, Id)
        np.testing.assert_allclose(Dh, np.asarray(Dd), atol=1e-6)
        # alpha=0 ranks candidates purely by item overlap: the query's own
        # session (overlap cos = 1) must rank first
        D0, I0 = eng.search(data[:4], k=5, hybrid_alpha=0.0)
        from sessionsimilaritysearch.engine import _item_set, _overlap_cos
        for r in range(4):
            q_items = _item_set(data[r][0])
            assert _overlap_cos(q_items, eng._items[int(I0[r, 0])]) == 1.0
        # mid alpha: scores equal the fusion formula for every returned hit
        Dm, Im = eng.search(data[:4], k=5, hybrid_alpha=0.5)
        D8, I8 = eng.search(data[:4], k=20)  # the candidate pool (4*5=20)
        for r in range(4):
            q_items = _item_set(data[r][0])
            dmap = {int(i): float(d) for d, i in zip(D8[r], I8[r]) if i >= 0}
            for d, i in zip(Dm[r], Im[r]):
                if i < 0:
                    continue
                want = 0.5 * dmap[int(i)] + 0.5 * _overlap_cos(
                    q_items, eng._items[int(i)]
                )
                assert abs(d - want) < 1e-5


def _bare_engine(n_rows: int, rng: np.random.Generator, max_items=12,
                 asin_num=50_000) -> SessionSearchEngine:
    """Engine shell with synthetic per-row metadata (no encoder/index work):
    exercises the vectorized query-path helpers at serving shapes."""
    from sessionsimilaritysearch.engine import _GrowArr, _session_key

    eng = SessionSearchEngine.__new__(SessionSearchEngine)
    eng._key_to_id = {}
    eng._canon_ids = _GrowArr(np.int64)
    eng._item_flat = _GrowArr(np.int64)
    eng._item_wstan = _GrowArr(np.float64)
    eng._item_lens = _GrowArr(np.int64)
    eng._meta_cache = None
    eng._items = []
    eng._canon = []
    for _ in range(n_rows):
        items = frozenset(
            rng.integers(0, asin_num, size=rng.integers(1, max_items))
            .tolist()
        )
        key = tuple(sorted(items))
        eng._items.append(items)
        eng._canon.append(key)
        eng._canon_ids.append(
            eng._key_to_id.setdefault(key, len(eng._key_to_id))
        )
        ids = list(items)
        eng._item_flat.extend(ids)
        sw = 1.0 / max(len(ids), 1) ** 0.5  # uniform placeholder
        eng._item_wstan.extend([sw] * len(ids))
        eng._item_lens.append(len(ids))
    return eng


class TestVectorizedQueryPaths:
    """The re-rank/dedup helpers at serving shapes:
    equality vs a straightforward per-candidate reference, plus a latency
    budget that a per-row-per-candidate Python loop cannot meet."""

    def _slow_hybrid(self, eng, D2, gid, q_sets, k, alpha):
        from sessionsimilaritysearch.engine import _overlap_cos

        q, m = D2.shape
        D = np.full((q, k), -np.inf, dtype=np.float32)
        I = np.full((q, k), -1, dtype=np.int64)
        for r in range(q):
            fused = []
            for c in range(m):
                g = int(gid[r, c])
                if g < 0:
                    continue
                ov = _overlap_cos(q_sets[r], eng._items[g])
                fused.append(
                    (alpha * float(D2[r, c]) + (1 - alpha) * ov, c)
                )
            fused.sort(key=lambda t: (-t[0], t[1]))
            for w, (s, c) in enumerate(fused[:k]):
                D[r, w], I[r, w] = s, gid[r, c]
        return D, I

    def test_hybrid_rerank_matches_reference(self, rng):
        eng = _bare_engine(512, rng)
        q, m, k = 16, 40, 10
        D2 = np.sort(
            rng.standard_normal((q, m)).astype(np.float32), axis=1
        )[:, ::-1].copy()
        gid = np.stack([
            rng.choice(512, size=m, replace=False) for _ in range(q)
        ]).astype(np.int64)
        gid[:, -3:] = -1  # short rows
        q_sets = [eng._items[int(i)] for i in rng.integers(0, 512, size=q)]
        D, I = eng._hybrid_rerank(D2, gid, q_sets, k, 0.5)
        Ds, Is = self._slow_hybrid(eng, D2, gid, q_sets, k, 0.5)
        np.testing.assert_array_equal(I, Is)
        np.testing.assert_allclose(D, Ds, atol=1e-5)

    def _slow_rrf(self, eng, D2, gid, q_sets, k, k0=60.0):
        from sessionsimilaritysearch.engine import _overlap_cos

        q, m = D2.shape
        D = np.full((q, k), -np.inf, dtype=np.float32)
        I = np.full((q, k), -1, dtype=np.int64)
        for r in range(q):
            present = [c for c in range(m) if gid[r, c] >= 0]
            ovs = {
                c: _overlap_cos(q_sets[r], eng._items[int(gid[r, c])])
                for c in present
            }
            sp_sorted = sorted(present, key=lambda c: (-ovs[c], c))
            sp_rank = {c: w for w, c in enumerate(sp_sorted)}
            fused = sorted(
                ((1.0 / (k0 + c) + 1.0 / (k0 + sp_rank[c]), c)
                 for c in present),
                key=lambda t: (-t[0], t[1]),
            )
            for w, (s, c) in enumerate(fused[:k]):
                D[r, w], I[r, w] = s, gid[r, c]
        return D, I

    def test_hybrid_rerank_rrf_matches_reference(self, rng):
        eng = _bare_engine(512, rng)
        q, m, k = 16, 40, 10
        D2 = np.sort(
            rng.standard_normal((q, m)).astype(np.float32), axis=1
        )[:, ::-1].copy()
        gid = np.stack([
            rng.choice(512, size=m, replace=False) for _ in range(q)
        ]).astype(np.int64)
        gid[:, -3:] = -1  # short rows: missing slots must not shift ranks
        q_sets = [eng._items[int(i)] for i in rng.integers(0, 512, size=q)]
        D, I = eng._hybrid_rerank(D2, gid, q_sets, k, 0.5, fusion="rrf")
        Ds, Is = self._slow_rrf(eng, D2, gid, q_sets, k)
        np.testing.assert_array_equal(I, Is)
        np.testing.assert_allclose(D, Ds, atol=1e-6)

    def test_dedup_matches_reference(self, rng):
        eng = _bare_engine(64, rng)
        # force duplicates: second half of metadata mirrors the first
        for g in range(32, 64):
            eng._canon_ids[g] = eng._canon_ids[g - 32]
        eng._meta_cache = None
        q, m, k = 8, 24, 6
        D2 = np.sort(
            rng.standard_normal((q, m)).astype(np.float32), axis=1
        )[:, ::-1].copy()
        gid = np.stack([
            rng.choice(64, size=m, replace=False) for _ in range(q)
        ]).astype(np.int64)
        D, I = eng._dedup_topk(D2, gid, k)
        for r in range(q):
            kept = [int(i) for i in I[r] if i >= 0]
            keys = [eng._canon_ids[i] for i in kept]
            assert len(set(keys)) == len(keys)
            # best-ranked representative of each key survives
            seen = set()
            want = []
            for c in range(m):
                cid = eng._canon_ids[int(gid[r, c])]
                if cid in seen:
                    continue
                seen.add(cid)
                want.append(int(gid[r, c]))
            assert kept == want[:k]

    def test_serving_shape_latency(self, rng):
        import time

        eng = _bare_engine(100_000, rng)
        q, k, overfetch = 1024, 100, 4
        m = overfetch * k
        D2 = np.sort(
            rng.standard_normal((q, m)).astype(np.float32), axis=1
        )[:, ::-1].copy()
        gid = rng.integers(0, 100_000, size=(q, m)).astype(np.int64)
        q_sets = [
            eng._items[int(i)] for i in rng.integers(0, 100_000, size=q)
        ]
        eng._np_meta()  # build the metadata snapshot outside the timer
        # calibrate to this machine: one lexsort at candidate volume is the
        # kind of single numpy pass the implementations are built from (the
        # dev hosts throttle / page-fault erratically, so an absolute
        # wall-clock bound flakes; what the test pins is "a few vectorized
        # passes", i.e. a small multiple of one such pass -- the old
        # per-candidate Python loops were >100x one pass)
        def best_of(fn, reps=3):
            best = float("inf")
            out = None
            for _ in range(reps):
                t0 = time.perf_counter()
                out = fn()
                best = min(best, time.perf_counter() - t0)
            return best, out

        unit_s, _ = best_of(lambda: np.lexsort(
            (np.tile(np.arange(m), q), rng.standard_normal(q * m),
             np.repeat(np.arange(q), m))
        ))
        unit_s = max(unit_s, 1e-3)
        hybrid_s, (D, I) = best_of(
            lambda: eng._hybrid_rerank(D2, gid, q_sets, k, 0.5)
        )
        dedup_s, (Dd, Id) = best_of(lambda: eng._dedup_topk(D2, gid, k))
        assert I.shape == (q, k) and Id.shape == (q, k)
        assert hybrid_s < 60 * unit_s, (  # 60x: calibration vs timed region
            # can diverge under external host load; Python loops are >100x
            f"hybrid re-rank too slow: {hybrid_s:.2f}s vs unit {unit_s:.3f}s"
        )
        assert dedup_s < 60 * unit_s, (
            f"dedup too slow: {dedup_s:.2f}s vs unit {unit_s:.3f}s"
        )


class TestEngineQuantized:
    @pytest.mark.parametrize("quantize", ["int8", "int8x8"])
    def test_quantized_engine_self_retrieval(self, engine_parts, gen,
                                             tokenizer, quantize):
        """quantize= plumbs through to the index: self-retrieval survives
        the int8 roundtrip (codes quantize the same embedding both sides)."""
        cfg, encode_fn = engine_parts
        eng = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=128,
            batch_size=8, quantize=quantize,
        )
        data = gen.dataset(16)
        eng.add_sessions(data)
        assert eng.index.quantize == quantize
        D, I = eng.search(data[:5], k=3)
        np.testing.assert_array_equal(I[:, 0], np.arange(5))

    def test_quantized_snapshot_roundtrip(self, engine_parts, gen, tokenizer,
                                          tmp_path):
        cfg, encode_fn = engine_parts
        eng = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=64,
            batch_size=8, quantize="int8",
        )
        data = gen.dataset(12)
        eng.add_sessions(data)
        D1, I1 = eng.search(data[:4], k=3)
        eng.save(str(tmp_path / "snap"))
        eng2 = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=64,
            batch_size=8, quantize="int8",
        )
        eng2.restore(str(tmp_path / "snap"))
        assert eng2.index.quantize == "int8"
        D2, I2 = eng2.search(data[:4], k=3)
        np.testing.assert_array_equal(I1, I2)
        np.testing.assert_allclose(D1, D2, rtol=1e-6)


class TestStanHybrid:
    """hybrid_kind='stan': recency-decayed sparse term in the fusion
    re-rank (round 3 -- on overlap-hostile data STAN is the stronger
    sparse signal)."""

    def test_stan_weights_match_sparse_vec(self, gen):
        from sessionsimilaritysearch.engine import _item_stan_weights
        from sessionsimilaritysearch.index.sparse import (
            sequence_to_stan_vec,
        )

        s = gen.session()
        w = _item_stan_weights(s)
        vec = sequence_to_stan_vec(s, 1000)
        for item, wi in w.items():
            np.testing.assert_allclose(wi, vec[item], rtol=1e-9)
        # dot of two weight dicts == STAN cosine of the two vectors
        s2 = gen.session()
        w2 = _item_stan_weights(s2)
        dot = sum(wi * w2.get(i, 0.0) for i, wi in w.items())
        np.testing.assert_allclose(
            dot, float(vec @ sequence_to_stan_vec(s2, 1000)), rtol=1e-9
        )

    def test_search_stan_vs_overlap_kinds(self, engine_parts, gen, tokenizer):
        cfg, encode_fn = engine_parts
        eng = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=128,
            batch_size=8,
        )
        data = gen.dataset(30)
        eng.add_sessions(data)
        # alpha=1: both kinds reduce to pure dense -- identical results
        Do, Io = eng.search(data[:4], k=5, hybrid_alpha=1.0,
                            hybrid_kind="overlap")
        Ds, Is = eng.search(data[:4], k=5, hybrid_alpha=1.0,
                            hybrid_kind="stan")
        np.testing.assert_array_equal(Io, Is)
        # alpha=0, stan: ranking == STAN cosine vs stored sessions
        from sessionsimilaritysearch.index.sparse import (
            sequence_to_stan_vec,
        )

        D0, I0 = eng.search(data[:1], k=3, hybrid_alpha=0.0,
                            hybrid_kind="stan", overfetch=30)
        qv = sequence_to_stan_vec(data[0][0], cfg.asin_num)
        sims = np.asarray([
            float(qv @ sequence_to_stan_vec(s, cfg.asin_num))
            for s in eng.sessions
        ])
        top = np.sort(sims)[::-1][:3]
        np.testing.assert_allclose(np.sort(D0[0])[::-1], top, atol=1e-5)


class TestEngineRangeSearch:
    def test_self_in_radius_and_where_filter(self, engine_parts, gen,
                                             tokenizer):
        cfg, encode_fn = engine_parts
        eng = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=64,
            batch_size=8,
        )
        data = gen.dataset(16)
        eng.add_sessions(data)
        # every stored session is within cosine 0.999 of itself
        lims, D, I = eng.range_search(data[:4], 0.999)
        for q in range(4):
            assert q in I[lims[q]: lims[q + 1]].tolist()
            assert np.all(np.diff(D[lims[q]: lims[q + 1]]) <= 1e-6)
        # CSR against the engine's own top-k path at the same floor
        Dk, Ik = eng.search(data[:4], k=16)
        for q in range(4):
            want = set(Ik[q][Dk[q] >= 0.999].tolist())
            assert set(I[lims[q]: lims[q + 1]].tolist()) == want
        # where= excludes the query's own row
        # the engine stores the session part (d[0]) of (prefix, future)
        first4 = [d[0] if isinstance(d, tuple) else d for d in data[:4]]
        lims2, _, I2 = eng.range_search(
            data[:4], 0.999, where=lambda s: s not in first4,
        )
        for q in range(4):
            assert q not in I2[lims2[q]: lims2[q + 1]].tolist()

    def test_twostage_engine_refuses(self, engine_parts, gen, tokenizer):
        cfg, encode_fn = engine_parts
        eng = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=64,
            batch_size=8, prefilter="binary", pool=16,
        )
        eng.add_sessions(gen.dataset(8))
        with pytest.raises(ValueError, match="two-stage"):
            eng.range_search(gen.dataset(2), 0.5)
