"""Multi-chip sharded search tests on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sessionsimilaritysearch.index.sharded import ShardedDenseIndex
from sessionsimilaritysearch.ops.topk import oracle_topk_np, recall_at_k
from sessionsimilaritysearch.parallel import create_mesh
from sessionsimilaritysearch.parallel.collectives import (
    shard_corpus,
    sharded_topk,
)


@pytest.fixture(scope="module")
def mesh():
    return create_mesh()


class TestShardedTopk:
    def test_matches_oracle(self, mesh, rng):
        corpus = rng.standard_normal((1024, 32)).astype(np.float32)
        queries = rng.standard_normal((9, 32)).astype(np.float32)
        sc = shard_corpus(jnp.asarray(corpus), mesh)
        vals, ids = sharded_topk(jnp.asarray(queries), sc, 7, mesh,
                                 chunk_size=64)
        ovals, oidx = oracle_topk_np(queries, corpus, 7)
        np.testing.assert_allclose(np.asarray(vals), ovals, rtol=1e-4)
        assert recall_at_k(np.asarray(ids), oidx) > 0.9

    def test_single_vs_sharded_identical(self, mesh, rng):
        from sessionsimilaritysearch.ops.topk import chunked_topk

        corpus = rng.standard_normal((512, 16)).astype(np.float32)
        queries = rng.standard_normal((5, 16)).astype(np.float32)
        v1, i1 = chunked_topk(jnp.asarray(queries), jnp.asarray(corpus), 5,
                              chunk_size=64)
        sc = shard_corpus(jnp.asarray(corpus), mesh)
        v2, i2 = sharded_topk(jnp.asarray(queries), sc, 5, mesh, chunk_size=64)
        np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), rtol=1e-5)


class TestShardedDenseIndex:
    def test_build_and_search(self, mesh, rng):
        corpus = rng.standard_normal((800, 24)).astype(np.float32)
        index = ShardedDenseIndex(dim=24, capacity=1024, mesh=mesh,
                                  metric="cos", chunk_size=64)
        index.add(corpus)
        q = corpus[:6]
        D, I = index.search(q, 5)
        assert I[:, 0].tolist() == [0, 1, 2, 3, 4, 5]  # self-retrieval
        cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
        ovals, oidx = oracle_topk_np(cn[:6], cn, 5)
        np.testing.assert_allclose(D, ovals, rtol=1e-4)

    def test_streaming_insert_preserves_global_ids(self, mesh, rng):
        # cosine: self-retrieval is guaranteed top-1 (raw IP is not -- a
        # longer aligned vector can outscore the query itself)
        index = ShardedDenseIndex(dim=16, capacity=512, mesh=mesh,
                                  metric="cos", chunk_size=64)
        a = rng.standard_normal((128, 16)).astype(np.float32)
        b = rng.standard_normal((64, 16)).astype(np.float32)
        index.add(a)
        index.add(b)
        assert index.ntotal == 192
        full = np.concatenate([a, b])
        D, I = index.search(full[:10], 3)
        # global insertion-order ids: row i's best match is itself
        np.testing.assert_array_equal(I[:, 0], np.arange(10))
        # a late-inserted row is findable under its global id
        D2, I2 = index.search(b[:3], 1)
        np.testing.assert_array_equal(I2[:, 0], [128, 129, 130])

    def test_insert_batch_divisibility_enforced(self, mesh, rng):
        index = ShardedDenseIndex(dim=8, capacity=64, mesh=mesh)
        with pytest.raises(AssertionError):
            index.add(rng.standard_normal((5, 8)).astype(np.float32))

    def test_capacity_overflow(self, mesh, rng):
        index = ShardedDenseIndex(dim=8, capacity=64, mesh=mesh)
        index.add(rng.standard_normal((64, 8)).astype(np.float32))
        with pytest.raises(ValueError):
            index.add(rng.standard_normal((8, 8)).astype(np.float32))


class TestCompositeMesh:
    def test_2d_mesh_dp_x_tp(self):
        """data x model mesh: batch sharded over 'data', the asin embedding
        sharded over 'model' -- the composite layout for the 391k-vocab
        logit matmul (SURVEY.md §7 hard part (b))."""
        import jax.numpy as jnp

        from sessionsimilaritysearch.config import tiny_test_config
        from sessionsimilaritysearch.data.graph import (
            batch_graphs,
            sequence_to_graph,
        )
        from sessionsimilaritysearch.data.synthetic import (
            SyntheticSessionGenerator,
        )
        from sessionsimilaritysearch.parallel import (
            create_mesh,
            shard_params,
        )
        from sessionsimilaritysearch.parallel.mesh import batch_sharding
        from sessionsimilaritysearch.tokenizer import get_tokenizer
        from sessionsimilaritysearch.training.pretrain import (
            create_pretrain_state,
            make_train_step,
        )

        mesh = create_mesh(shape=(4, 2), axis_names=("data", "model"))
        cfg = tiny_test_config(asin_num=1024)
        gen = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=3)
        tok = get_tokenizer(cfg.vocab_size)
        graphs = [
            sequence_to_graph(i, *d, tok, cfg.dims)
            for i, d in enumerate(gen.dataset(8))
        ]
        batch = jax.tree.map(jnp.asarray, batch_graphs(graphs))
        rng = jax.random.PRNGKey(0)
        model, state = create_pretrain_state(cfg, rng, batch)

        _, m_ref = make_train_step(model, has_view=False)(state, batch, rng)

        sh = batch_sharding(mesh, "data")
        sharded_batch = jax.tree.map(lambda x: jax.device_put(x, sh), batch)
        sharded_state = state.replace(
            params=shard_params(
                state.params, mesh, shard_axis="model", min_rows=512
            )
        )
        table = sharded_state.params["target_asin_embedding"]["embedding"]
        assert len(table.sharding.device_set) >= 2
        _, m = make_train_step(model, has_view=False)(
            sharded_state, sharded_batch, rng
        )
        np.testing.assert_allclose(
            float(m["loss"]), float(m_ref["loss"]), rtol=2e-3
        )


class TestShardedPersistence:
    def test_save_load_roundtrip(self, mesh, rng, tmp_path):
        index = ShardedDenseIndex(dim=16, capacity=128, mesh=mesh,
                                  metric="cos", chunk_size=32)
        rows = rng.standard_normal((64, 16)).astype(np.float32)
        index.add(rows)
        p = str(tmp_path / "sharded.npz")
        index.save(p)
        loaded = ShardedDenseIndex.load(p, mesh, chunk_size=32)
        D1, I1 = index.search(rows[:4], 3)
        D2, I2 = loaded.search(rows[:4], 3)
        np.testing.assert_array_equal(I1, I2)
        np.testing.assert_allclose(D1, D2, rtol=1e-6)


class TestShardCountMigration:
    def test_load_on_different_shard_count(self, mesh, rng, tmp_path):
        """An index saved on a 4-shard mesh restripes correctly on 8."""
        from sessionsimilaritysearch.parallel import create_mesh
        import jax

        mesh4 = create_mesh(shape=(4,), devices=jax.devices()[:4])
        idx4 = ShardedDenseIndex(dim=8, capacity=64, mesh=mesh4,
                                 metric="cos", chunk_size=16)
        rows = rng.standard_normal((32, 8)).astype(np.float32)
        idx4.add(rows)
        p = str(tmp_path / "m.npz")
        idx4.save(p)
        idx8 = ShardedDenseIndex.load(p, mesh, chunk_size=16)
        assert idx8.size == 32
        D4, I4 = idx4.search(rows[:5], 3)
        D8, I8 = idx8.search(rows[:5], 3)
        np.testing.assert_array_equal(I4, I8)
        np.testing.assert_allclose(D4, D8, rtol=1e-5)


class TestTenMillionRowDryrun:
    """BASELINE config 5 semantics (10M sessions sharded over 8 chips) at
    reduced width: the full 10M-row machinery -- striped insert, per-shard
    fill tracking, cross-shard merge, global-id recovery -- runs on the
    8-device mesh. Width is 16 (not 1600) to keep CI
    memory sane; the per-chip memory math for the real config is asserted
    symbolically below."""

    def test_10m_rows_sharded_search(self, mesh, rng):
        n, d = 10_000_000, 16
        idx = ShardedDenseIndex(
            dim=d, capacity=n, mesh=mesh, metric="cos", chunk_size=262144
        )
        # insert in 2M-row batches (striped across shards per batch)
        marks = {}
        batch = 2_000_000
        for s in range(0, n, batch):
            rows = rng.standard_normal((batch, d)).astype(np.float32)
            # plant recoverable needles at known global ids: distinct
            # one-hot directions (cos exactly 1.0 only with themselves)
            for j in (0, batch // 2):
                gid = s + j
                v = np.zeros(d, np.float32)
                v[gid // 1_000_000] = 1.0 + gid % 7  # distinct axis per needle
                rows[j] = v
                marks[gid] = v
            idx.add(rows)
        assert idx.ntotal == n
        # query the planted needles: cosine self-retrieval must return the
        # exact global insertion ids from whichever shard holds them
        gids = sorted(marks)
        q = np.stack([marks[g] for g in gids])
        D, I = idx.search(q, k=1)
        # needles are sparse one-hot-ish vectors; other random rows can tie
        # in cosine only with negligible probability
        np.testing.assert_array_equal(I[:, 0], gids)
        np.testing.assert_allclose(D[:, 0], 1.0, atol=1e-5)

    def test_flagship_memory_math(self, mesh):
        # a 10M x 1600d bf16 corpus over 8 devices
        n, d, ndev, bytes_bf16 = 10_000_000, 1600, 8, 2
        per_chip = n * d * bytes_bf16 / ndev
        assert per_chip == 4.0e9  # 4 GB per device
        # query-side transient: 1024-query bf16 score chunk per shard
        chunk = 262144
        score_buf = 1024 * chunk * 2 / 1e9
        assert score_buf < 1.0  # < 1 GB


class TestShardedQuantized:
    """int8 / int8x8 sharded modes (the single-chip DenseIndex quantize
    modes, striped): capacity doubles per chip and the int8x8 search runs
    each shard's scan as an int8 x int8 -> int32 matmul."""

    @pytest.mark.parametrize("quantize", ["int8", "int8x8"])
    def test_quantized_matches_oracle(self, mesh, rng, quantize):
        from sessionsimilaritysearch.ops.topk import value_recall_at_k

        corpus = rng.standard_normal((1024, 32)).astype(np.float32)
        queries = rng.standard_normal((16, 32)).astype(np.float32)
        index = ShardedDenseIndex(dim=32, capacity=1024, mesh=mesh,
                                  metric="cos", chunk_size=64,
                                  quantize=quantize)
        index.add(corpus)
        D, I = index.search(queries, 10)
        assert I.min() >= 0
        cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
        qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
        tol = (4 if quantize == "int8x8" else 2) / 127
        vr = value_recall_at_k(I, qn, cn, 10, rel_tol=tol)
        assert vr == 1.0, (quantize, vr)
        # D is the dequantized true-scale cosine, not a raw int32 count
        true = np.take_along_axis(qn @ cn.T, I, axis=1)
        np.testing.assert_allclose(D, true, atol=0.05)

    def test_quantized_streaming_insert(self, mesh, rng):
        index = ShardedDenseIndex(dim=16, capacity=256, mesh=mesh,
                                  metric="cos", chunk_size=32,
                                  quantize="int8")
        a = rng.standard_normal((64, 16)).astype(np.float32)
        b = rng.standard_normal((64, 16)).astype(np.float32)
        index.add(a)
        index.add(b)
        assert index.ntotal == 128
        # self-retrieval of a second-batch row returns its GLOBAL id
        D, I = index.search(b[:4], 1)
        np.testing.assert_array_equal(I[:, 0], [64, 65, 66, 67])

    def test_quantized_save_load_restripe(self, mesh, rng, tmp_path):
        """Scales restripe with their rows across a shard-count change."""
        from sessionsimilaritysearch.parallel import create_mesh

        mesh4 = create_mesh(shape=(4,), devices=jax.devices()[:4])
        idx4 = ShardedDenseIndex(dim=8, capacity=64, mesh=mesh4,
                                 metric="cos", chunk_size=16,
                                 quantize="int8x8")
        rows = rng.standard_normal((32, 8)).astype(np.float32)
        idx4.add(rows)
        p = str(tmp_path / "q.npz")
        idx4.save(p)
        idx8 = ShardedDenseIndex.load(p, mesh, chunk_size=16)
        assert idx8.quantize == "int8x8" and idx8.size == 32
        D4, I4 = idx4.search(rows[:5], 3)
        D8, I8 = idx8.search(rows[:5], 3)
        np.testing.assert_array_equal(I4, I8)
        np.testing.assert_allclose(D4, D8, rtol=1e-5)


class TestShardedApprox:
    def test_approx_mode_wiring(self, mesh, rng):
        """mode='approx' plumbs through the per-shard scan (on CPU
        approx_max_k reduces to exact, pinning plumbing + merge)."""
        corpus = rng.standard_normal((1024, 32)).astype(np.float32)
        queries = rng.standard_normal((9, 32)).astype(np.float32)
        idx = ShardedDenseIndex(dim=32, capacity=1024, mesh=mesh,
                                metric="cos", chunk_size=64, mode="approx")
        idx.add(corpus)
        D, I = idx.search(queries, 7)
        cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
        qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
        ovals, oidx = oracle_topk_np(qn, cn, 7)
        np.testing.assert_allclose(D, ovals, rtol=1e-4)


class TestShardedSnapshotFidelity:
    """load(quantize=...) used to raise duplicate-kwarg or build
    a broken int8 index; serving config must persist."""

    def test_config_roundtrip(self, mesh, rng, tmp_path):
        idx = ShardedDenseIndex(dim=16, capacity=128, mesh=mesh,
                                metric="cos", mode="approx",
                                score_dtype=jnp.bfloat16, chunk_size=32)
        rows = rng.standard_normal((64, 16)).astype(np.float32)
        idx.add(rows)
        p = str(tmp_path / "tuned.npz")
        idx.save(p)
        loaded = ShardedDenseIndex.load(p, mesh)
        assert loaded.mode == "approx"
        assert loaded.score_dtype == jnp.dtype(jnp.bfloat16)
        assert loaded.chunk_size == 32
        D1, I1 = idx.search(rows[:4], 3)
        D2, I2 = loaded.search(rows[:4], 3)
        np.testing.assert_array_equal(I1, I2)

    def test_quantize_kwarg_matching_ok_mismatch_raises(
        self, mesh, rng, tmp_path
    ):
        idx = ShardedDenseIndex(dim=16, capacity=128, mesh=mesh,
                                metric="cos", quantize="int8")
        rows = rng.standard_normal((64, 16)).astype(np.float32)
        idx.add(rows)
        p = str(tmp_path / "q8.npz")
        idx.save(p)
        # matching explicit kwarg: no duplicate-kwarg TypeError
        loaded = ShardedDenseIndex.load(p, mesh, quantize="int8")
        assert loaded.quantize == "int8"
        D1, I1 = idx.search(rows[:4], 3)
        D2, I2 = loaded.search(rows[:4], 3)
        np.testing.assert_array_equal(I1, I2)
        # mismatch on a non-quantized checkpoint: loud, not silent zeros
        idxf = ShardedDenseIndex(dim=16, capacity=128, mesh=mesh,
                                 metric="cos")
        idxf.add(rows)
        pf = str(tmp_path / "f32.npz")
        idxf.save(pf)
        with pytest.raises(ValueError, match="quantize"):
            ShardedDenseIndex.load(pf, mesh, quantize="int8")


class TestCollectiveCompileCache:
    """The sharded collectives must NOT re-trace per call: a fresh
    shard_map over a fresh closure re-lowers every invocation, which at
    serving shapes costs far more than the scan itself. Serving calls
    reuse one cached jitted program per static configuration."""

    def test_repeat_calls_reuse_cached_fn(self, mesh, rng):
        from sessionsimilaritysearch.parallel import collectives

        corpus = rng.standard_normal((512, 16)).astype(np.float32)
        queries = rng.standard_normal((8, 16)).astype(np.float32)
        sc = shard_corpus(jnp.asarray(corpus), mesh)
        key0 = set(collectives._FN_CACHE)
        # k=11 is unique to this test: exactly one entry must appear even
        # when other tests already populated the cache
        v1, i1 = sharded_topk(jnp.asarray(queries), sc, 11, mesh,
                              chunk_size=64)
        new = set(collectives._FN_CACHE) - key0
        assert len(new) == 1  # one program for this configuration
        for _ in range(3):  # repeats: no new cache entries, same results
            v2, i2 = sharded_topk(jnp.asarray(queries), sc, 11, mesh,
                                  chunk_size=64)
        assert set(collectives._FN_CACHE) - key0 == new
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))

    def test_index_search_cache_stable_across_maintenance(self, mesh, rng):
        from sessionsimilaritysearch.parallel import collectives

        ix = ShardedDenseIndex(dim=16, capacity=256, mesh=mesh,
                               chunk_size=32)
        ix.add(rng.standard_normal((128, 16)).astype(np.float32))
        q = rng.standard_normal((4, 16)).astype(np.float32)
        ix.search(q, 5)
        n0 = len(collectives._FN_CACHE)
        ix.add(rng.standard_normal((64, 16)).astype(np.float32))
        ix.search(q, 5)
        ix.remove_ids(np.arange(10))
        ix.search(q, 5)
        assert len(collectives._FN_CACHE) == n0  # streaming: zero retrace
