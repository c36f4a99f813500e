"""reconstruct / reconstruct_batch across the index family.

FAISS counterpart surface (``faiss.Index.reconstruct[_batch]``,
``faiss.IndexBinaryFlat.reconstruct``): return the STORED row — the
decoded approximation for quantized storage, the code row for binary —
under each index's own id semantics (positional single-chip, stable
global ids sharded). Reference context: the flat indexes the reference
builds (fine_tune_ours.py:839-843) expose reconstruct as part of the
FAISS maintenance API.
"""

import numpy as np
import pytest

from sessionsimilaritysearch.index.binary import BinaryIndex
from sessionsimilaritysearch.index.dense import DenseIndex
from sessionsimilaritysearch.index.sharded import ShardedDenseIndex
from sessionsimilaritysearch.index.twostage import (
    ShardedTwoStageIndex,
    TwoStageIndex,
)
from sessionsimilaritysearch.parallel import create_mesh


def l2_normalize_np(x, eps=1e-6):
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, eps)


@pytest.fixture(scope="module")
def mesh():
    return create_mesh()


class TestDenseReconstruct:
    def test_returns_stored_normalized_rows(self, rng):
        emb = rng.standard_normal((40, 16)).astype(np.float32)
        idx = DenseIndex(dim=16, capacity=64)
        idx.add(emb)
        got = idx.reconstruct_batch([3, 0, 39])
        want = l2_normalize_np(emb)[[3, 0, 39]]
        np.testing.assert_allclose(got, want, atol=1e-6)
        np.testing.assert_allclose(idx.reconstruct(7),
                                   l2_normalize_np(emb)[7], atol=1e-6)

    def test_int8_dequantized_approximation(self, rng):
        emb = rng.standard_normal((32, 24)).astype(np.float32)
        idx = DenseIndex(dim=24, capacity=32, quantize="int8x8")
        idx.add(emb)
        got = idx.reconstruct_batch(np.arange(32))
        want = l2_normalize_np(emb)
        # per-row error bounded by the quantization step (scale = max/127)
        step = np.abs(want).max(axis=1, keepdims=True) / 127.0
        assert np.all(np.abs(got - want) <= step + 1e-7)

    def test_centered_mode_returns_scored_form(self, rng):
        emb = rng.standard_normal((30, 12)).astype(np.float32) + 2.0
        idx = DenseIndex(dim=12, capacity=32, center="auto")
        idx.add(emb)
        n = l2_normalize_np(emb)
        want = l2_normalize_np(n - n.mean(axis=0))
        np.testing.assert_allclose(
            idx.reconstruct_batch(np.arange(30)), want, atol=1e-5
        )

    def test_positional_renumbering_after_remove(self, rng):
        emb = rng.standard_normal((10, 8)).astype(np.float32)
        idx = DenseIndex(dim=8, capacity=16)
        idx.add(emb)
        before = idx.reconstruct_batch(np.arange(10))
        idx.remove_ids([1, 4])
        after = idx.reconstruct_batch(np.arange(idx.size))
        # survivors are exactly the non-removed rows (order may change)
        survivors = np.delete(before, [1, 4], axis=0)
        match = [
            np.any(np.all(np.isclose(a, survivors, atol=1e-6), axis=1))
            for a in after
        ]
        assert all(match) and after.shape[0] == 8

    def test_out_of_range_raises(self, rng):
        idx = DenseIndex(dim=8, capacity=16)
        idx.add(rng.standard_normal((4, 8)).astype(np.float32))
        with pytest.raises(IndexError):
            idx.reconstruct_batch([4])
        with pytest.raises(IndexError):
            idx.reconstruct(-1)


class TestBinaryReconstruct:
    @pytest.mark.parametrize("mode", ["sign", "packed"])
    def test_roundtrips_codes(self, rng, mode):
        signs = np.where(
            rng.random((300, 64)) > 0.5, 1.0, -1.0
        ).astype(np.float32)
        idx = BinaryIndex(n_bits=64, capacity=512, mode=mode)
        idx.add(signs)
        ids = np.array([0, 7, 31, 32, 33, 255, 299])
        np.testing.assert_array_equal(idx.reconstruct_batch(ids),
                                      signs[ids])
        np.testing.assert_array_equal(idx.reconstruct(128), signs[128])

    def test_packed_after_remove(self, rng):
        signs = np.where(
            rng.random((100, 32)) > 0.5, 1.0, -1.0
        ).astype(np.float32)
        idx = BinaryIndex(n_bits=32, capacity=128, mode="packed")
        idx.add(signs)
        idx.remove_ids([0, 50])
        got = idx.reconstruct_batch(np.arange(idx.size))
        survivors = np.delete(signs, [0, 50], axis=0)
        match = [
            np.any(np.all(g == survivors, axis=1)) for g in got
        ]
        assert all(match) and got.shape[0] == 98


class TestShardedReconstruct:
    def test_stable_ids_across_remove(self, mesh, rng):
        emb = rng.standard_normal((64, 16)).astype(np.float32)
        idx = ShardedDenseIndex(dim=16, capacity=128, mesh=mesh)
        idx.add(emb)
        want = l2_normalize_np(emb)
        np.testing.assert_allclose(
            idx.reconstruct_batch([5, 63, 0]), want[[5, 63, 0]],
            atol=1e-6,
        )
        idx.remove_ids([5, 20])
        # surviving global ids still reconstruct to the SAME rows
        np.testing.assert_allclose(
            idx.reconstruct_batch([63, 0, 21]), want[[63, 0, 21]],
            atol=1e-6,
        )
        with pytest.raises(KeyError):
            idx.reconstruct_batch([5])

    def test_quantized_rows_dequantize(self, mesh, rng):
        emb = rng.standard_normal((32, 16)).astype(np.float32)
        idx = ShardedDenseIndex(dim=16, capacity=64, mesh=mesh,
                                quantize="int8x8")
        idx.add(emb)
        got = idx.reconstruct_batch(np.arange(32))
        want = l2_normalize_np(emb)
        step = np.abs(want).max(axis=1, keepdims=True) / 127.0
        assert np.all(np.abs(got - want) <= step + 1e-7)


class TestTwoStageReconstruct:
    def test_single_chip(self, rng):
        emb = rng.standard_normal((48, 16)).astype(np.float32)
        idx = TwoStageIndex(dim=16, capacity=64, n_bits=32, pool=8)
        idx.add(emb)
        got = idx.reconstruct_batch([2, 47])
        want = l2_normalize_np(emb)[[2, 47]]
        # stored at store_dtype (bf16) precision
        np.testing.assert_allclose(got, want, atol=1e-2)

    def test_sharded_stable_ids(self, mesh, rng):
        emb = rng.standard_normal((64, 16)).astype(np.float32)
        idx = ShardedTwoStageIndex(dim=16, capacity=128, mesh=mesh,
                                   n_bits=32, pool=8)
        idx.add(emb)
        want = l2_normalize_np(emb)
        idx.remove_ids([3])
        np.testing.assert_allclose(
            idx.reconstruct_batch([63, 4]), want[[63, 4]], atol=1e-2
        )
        with pytest.raises(KeyError):
            idx.reconstruct(3)


class TestEngineReconstruct:
    def test_passthrough(self, tokenizer):
        import jax

        from sessionsimilaritysearch.config import tiny_test_config
        from sessionsimilaritysearch.data.graph import (
            batch_graphs,
            sequence_to_graph,
        )
        from sessionsimilaritysearch.data.synthetic import (
            SyntheticSessionGenerator,
        )
        from sessionsimilaritysearch.engine import SessionSearchEngine
        from sessionsimilaritysearch.models import (
            build_text_session_encoder,
        )

        cfg = tiny_test_config()
        gen = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=7)
        enc = build_text_session_encoder(cfg)
        sample = batch_graphs([
            sequence_to_graph(0, *gen.datum(), tokenizer, cfg.dims)
        ] * 4)
        params = enc.init(jax.random.PRNGKey(0), sample)
        encode_fn = jax.jit(lambda g: enc.apply(params, g))
        eng = SessionSearchEngine(
            cfg, tokenizer, encode_fn, dim=cfg.n_out, capacity=32,
            batch_size=4,
        )
        eng.add_sessions(gen.dataset(12))
        rows = eng.reconstruct([0, 5])
        assert rows.shape == (2, cfg.n_out)
        np.testing.assert_allclose(
            np.linalg.norm(rows, axis=1), 1.0, atol=1e-2
        )
