"""Loss library tests: numerics vs hand-computed references
(SURVEY.md §7 hard part (e): clip/weighting quirks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sessionsimilaritysearch.training import losses


class TestContrastive:
    def test_identical_views_low_loss(self, rng):
        x = jnp.asarray(rng.standard_normal((6, 8)), jnp.float32)
        same = losses.contrastive_loss(x, x)
        perm = losses.contrastive_loss(x, jnp.roll(x, 1, axis=0))
        assert float(same) < float(perm)

    def test_matches_hand_formula(self):
        v = jnp.asarray([[1.0, 0.0], [0.0, 1.0]])
        out = float(losses.contrastive_loss(v, v))
        # score matrix = I clipped to 0.9999 / 1e-4
        s_pos, s_neg = 0.9999, 1e-4
        js = np.log(1 - s_neg) * 2  # two off-diagonal entries
        pos = 10 * np.log(s_pos) * 2
        expected = -(js + pos) / (4 + 18)
        assert abs(out - expected) < 1e-5

    def test_binary_regularize(self):
        out = jnp.asarray([[1.0, -1.0], [0.0, 0.5]])
        # mean(|1-|x||) = mean([0,0,1,0.5]) = 0.375
        assert abs(float(losses.binary_regularize(out)) - 0.375) < 1e-6


class TestTokenLosses:
    def test_make_token_mask_respects_special_ids(self, rng):
        ids = jnp.asarray([[0, 2, 3, 4, 5, 100]])
        m = losses.make_token_mask(jax.random.PRNGKey(0), ids, 1.0)
        np.testing.assert_array_equal(
            np.asarray(m), [[False, False, False, False, True, True]]
        )

    def test_mlm_loss_perfect_prediction(self):
        V = 10
        gt = jnp.asarray([[5, 6]])
        logits = jax.nn.one_hot(gt, V) * 100.0
        mask = jnp.asarray([[True, True]])
        assert float(losses.mlm_loss(logits, gt, mask)) < 1e-3

    def test_electra_loss(self):
        ids = jnp.asarray([[5, 6]])
        gt = jnp.asarray([[5, 7]])  # second token replaced
        pred = jnp.asarray([[0.0, 1.0]])  # perfectly detected
        assert float(losses.electra_loss(pred, ids, gt)) < 1e-4
        pred_bad = jnp.asarray([[1.0, 0.0]])
        assert float(losses.electra_loss(pred_bad, ids, gt)) > 5.0


class TestTextEmbeddingLosses:
    def test_next_text_diag_semantics(self, rng):
        rep = jnp.eye(3, 4, dtype=jnp.float32)  # orthogonal rows
        target = rep * 10  # aligned -> diagonal sigmoid ~ 1
        valid = jnp.ones(3)
        aligned = float(losses.next_text_embedding_loss(rep, target, valid))
        misaligned = float(
            losses.next_text_embedding_loss(rep, -target, valid)
        )
        assert aligned < misaligned

    def test_next_text_mask_zeroes_positive(self, rng):
        rep = jnp.asarray(rng.standard_normal((2, 4)), jnp.float32)
        target = rep * 5
        # with valid=0 the diagonal becomes a negative target
        l1 = float(losses.next_text_embedding_loss(rep, target, jnp.ones(2)))
        l0 = float(losses.next_text_embedding_loss(rep, target, jnp.zeros(2)))
        assert l0 > l1

    def test_all_text_membership(self, rng):
        B, T, d = 3, 2, 4
        rep = jnp.eye(B, d, dtype=jnp.float32)  # orthogonal rows
        targets = jnp.tile(rep[:, None, :], (1, T, 1)) * 8
        node_mask = jnp.ones((B, T))
        l_align = float(
            losses.all_text_embedding_loss(rep, targets, node_mask)
        )
        l_anti = float(
            losses.all_text_embedding_loss(rep, -targets, node_mask)
        )
        assert l_align < l_anti

    def test_all_text_padding_excluded(self, rng):
        B, T, d = 2, 3, 4
        rep = jnp.asarray(rng.standard_normal((B, d)), jnp.float32)
        targets = jnp.asarray(rng.standard_normal((B, T, d)), jnp.float32)
        node_mask = jnp.asarray([[1.0, 1.0, 0.0], [1.0, 0.0, 0.0]])
        base = losses.all_text_embedding_loss(rep, targets, node_mask)
        # corrupt padded rows: loss must not change
        targets2 = targets.at[:, 2, :].set(99.0)
        targets2 = targets2.at[1, 1, :].set(-55.0)
        out = losses.all_text_embedding_loss(rep, targets2, node_mask)
        np.testing.assert_allclose(float(base), float(out), rtol=1e-6)


class TestAsinLosses:
    def test_onehot_scatter(self):
        y = losses.product_target_onehot(
            jnp.asarray([[2, 5, 0]]), jnp.asarray([[1.0, 1.0, 0.0]]), 8
        )
        expected = np.zeros((1, 8))
        expected[0, [2, 5]] = 1
        np.testing.assert_array_equal(np.asarray(y), expected)

    def test_asin_loss_direction(self, rng):
        A, d, B = 50, 8, 4
        table = jnp.asarray(rng.standard_normal((A, d)), jnp.float32)
        tgt = jnp.asarray(rng.integers(1, A, (B, 3)), jnp.int32)
        mask = jnp.ones((B, 3))
        # rep aligned with its targets scores lower loss
        rep_good = table[tgt[:, 0]] * 3
        rep_bad = -table[tgt[:, 0]] * 3
        k = jax.random.PRNGKey(0)
        lg = float(losses.product_asin_loss(k, rep_good, table, tgt, mask, 50))
        lb = float(losses.product_asin_loss(k, rep_bad, table, tgt, mask, 50))
        assert lg < lb

    def test_precision_recall(self):
        table = jnp.eye(4, dtype=jnp.float32)  # 4 asins, identity embeddings
        rep = jnp.asarray([[10.0, 5.0, 0.0, 0.0]])
        tgt = jnp.asarray([[0, 1]])
        mask = jnp.ones((1, 2))
        p, r = losses.product_asin_precision_recall(rep, table, tgt, mask, 2)
        assert float(p) == 1.0 and float(r) == 1.0
        p1, r1 = losses.product_asin_precision_recall(rep, table, tgt, mask, 4)
        assert float(p1) == 0.5 and float(r1) == 1.0

    def test_no_target_graphs_skipped(self):
        table = jnp.eye(4, dtype=jnp.float32)
        rep = jnp.asarray([[1.0, 0, 0, 0], [0, 1.0, 0, 0]])
        tgt = jnp.asarray([[0, 0], [1, 0]])
        mask = jnp.asarray([[0.0, 0.0], [1.0, 0.0]])  # graph 0 has no targets
        p, r = losses.product_asin_precision_recall(rep, table, tgt, mask, 1)
        assert float(r) == 1.0  # only graph 1 counted


class TestFineTuneLosses:
    def test_pair_loss_zero_when_matching(self, rng):
        a = jnp.asarray(rng.standard_normal((4, 6)), jnp.float32)
        lab = losses.cosine_similarity(a, a)
        assert float(losses.pair_loss(a, a, lab)) < 1e-10

    def test_pair_loss_l1_vs_mse(self, rng):
        a = jnp.asarray(rng.standard_normal((4, 6)), jnp.float32)
        b = jnp.asarray(rng.standard_normal((4, 6)), jnp.float32)
        lab = jnp.zeros(4)
        mse = float(losses.pair_loss(a, b, lab, "MSE"))
        l1 = float(losses.pair_loss(a, b, lab, "L1"))
        assert mse > 0 and l1 > 0 and mse != l1

    def test_sim_matrix_weighting(self):
        out = jnp.asarray([[1.0, 0.0], [0.0, 1.0]])
        label = jnp.asarray([[1.0, 0.0], [0.0, 1.0]])
        loss, pred, lab = losses.sim_matrix_loss(out, label)
        assert float(loss) < 1e-10
        # positive entries weighted 10x: error on diagonal costs more
        label2 = jnp.asarray([[0.5, 0.0], [0.0, 0.5]])
        label3 = jnp.asarray([[1.0, 0.0], [0.5, 1.0]])
        l2, _, _ = losses.sim_matrix_loss(out, label2)
        l3, _, _ = losses.sim_matrix_loss(out, label3)
        assert float(l2) > float(l3)  # same |err| but pos-weighted

    def test_triplet_loss(self, rng):
        a = jnp.asarray(rng.standard_normal((3, 5)), jnp.float32)
        loss = losses.triplet_loss(a, a, -a, jnp.ones(3), jnp.zeros(3))
        # pos_pred=1, neg_pred=-1, margin=1 -> clip(-1-1+1)=0
        assert float(loss) == 0.0

    def test_aux_consistency(self, rng):
        a = jnp.asarray(rng.standard_normal((4, 6)), jnp.float32)
        b = jnp.asarray(rng.standard_normal((4, 6)), jnp.float32)
        an = a / jnp.linalg.norm(a, axis=1, keepdims=True)
        bn = b / jnp.linalg.norm(b, axis=1, keepdims=True)
        base = an @ bn.T
        assert float(losses.aux_consistency_loss(a, b, base)) < 1e-10

    def test_reconstruction_loss_perfect(self, rng):
        t = jnp.asarray(rng.standard_normal((4, 6)), jnp.float32)
        # perfect reconstruction: l2 term 0, cos term 1 -> loss = -1
        assert abs(float(losses.reconstruction_loss(t, t)) + 1.0) < 1e-5


class TestDecoderLosses:
    def test_make_mlm_target(self):
        y = jnp.asarray([[1, 5, 6, 7]])
        mask = jnp.ones((1, 4))
        masked, pred = losses.make_mlm_target(
            jax.random.PRNGKey(0), y, mask, 1.0, 4
        )
        np.testing.assert_array_equal(
            np.asarray(pred), [[False, True, True, True]]
        )
        np.testing.assert_array_equal(np.asarray(masked), [[1, 4, 4, 4]])

    def test_next_query_mlm_and_electra(self):
        V = 8
        y = jnp.asarray([[5, 6]])
        pred_target = jnp.asarray([[True, False]])
        logits = jax.nn.one_hot(y, V) * 50.0
        loss, output = losses.next_query_mlm_loss(logits, y, pred_target)
        assert float(loss) < 1e-3
        np.testing.assert_array_equal(np.asarray(output), np.asarray(y))
        logits2 = jax.nn.one_hot(jnp.asarray([[1, 1]]), 2) * 50.0
        el = losses.next_query_electra_loss(logits2, output, y, jnp.ones((1, 2)))
        assert float(el) < 1e-3
