"""Model zoo tests: shapes, masking invariants, hand-checked math for each
module (SURVEY.md §4's prescribed numerical tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sessionsimilaritysearch.config import tiny_test_config
from sessionsimilaritysearch.data.graph import batch_graphs, sequence_to_graph
from sessionsimilaritysearch.models import (
    MLP,
    BinarizeHead,
    CrossAttentionTransformer,
    DenseGATConv,
    DenseGatedGraphConv,
    HGT,
    HeteroGGNN,
    HeteroSAGE,
    NodeAsinEmbedding,
    NodeTextTransformer,
    TextEncoder,
    TransformerDecoderHead,
    build_graph_encoder,
    build_pretrain_encoder,
    build_text_session_encoder,
)
from sessionsimilaritysearch.models.pooling import (
    AttentionPooling,
    GraphPooling,
    PositionalAttentionPooling,
    SRGNNPooling,
    masked_max,
    masked_mean,
    masked_sum,
)
from sessionsimilaritysearch.models.transformer import causal_mask
from sessionsimilaritysearch.tokenizer import HashTokenizer


@pytest.fixture(scope="module")
def cfg():
    return tiny_test_config()


@pytest.fixture(scope="module")
def batch(cfg, gen, tokenizer):
    data = gen.dataset(4)
    graphs = [
        sequence_to_graph(i, s, t, tokenizer, cfg.dims)
        for i, (s, t) in enumerate(data)
    ]
    g = batch_graphs(graphs)
    return jax.tree.map(jnp.asarray, g)


class TestMaskedOps:
    def test_masked_mean(self):
        x = jnp.asarray([[[1.0], [3.0], [100.0]]])
        m = jnp.asarray([[1.0, 1.0, 0.0]])
        np.testing.assert_allclose(np.asarray(masked_mean(x, m)), [[2.0]])

    def test_masked_mean_empty(self):
        x = jnp.ones((1, 3, 2))
        m = jnp.zeros((1, 3))
        np.testing.assert_allclose(np.asarray(masked_mean(x, m)), np.zeros((1, 2)))

    def test_masked_max(self):
        x = jnp.asarray([[[1.0], [-3.0], [100.0]]])
        m = jnp.asarray([[1.0, 1.0, 0.0]])
        np.testing.assert_allclose(np.asarray(masked_max(x, m)), [[1.0]])


class TestGNNLayers:
    def test_gated_graph_conv_message_flow(self, rng):
        """A single directed edge 0->1: node 1's state must change with
        node 0's features; node 2 (isolated) runs GRU on zero message."""
        conv = DenseGatedGraphConv(8)
        x = jnp.asarray(rng.standard_normal((1, 3, 8)), jnp.float32)
        adj = jnp.zeros((1, 3, 3)).at[0, 0, 1].set(1.0)
        params = conv.init(jax.random.PRNGKey(0), x, adj)
        out1 = conv.apply(params, x, adj)
        x2 = x.at[0, 0].multiply(2.0)
        out2 = conv.apply(params, x2, adj)
        assert not np.allclose(out1[0, 1], out2[0, 1])  # receiver changed
        np.testing.assert_allclose(out1[0, 2], out2[0, 2])  # isolated same

    def test_gated_graph_conv_pads_input(self, rng):
        conv = DenseGatedGraphConv(16)
        x = jnp.asarray(rng.standard_normal((2, 3, 8)), jnp.float32)
        adj = jnp.zeros((2, 3, 3))
        params = conv.init(jax.random.PRNGKey(0), x, adj)
        assert conv.apply(params, x, adj).shape == (2, 3, 16)

    def test_gat_attention_normalized(self, rng):
        """With uniform dst and two src nodes, attention sums to 1 ->
        output is a convex combo of transformed src features."""
        conv = DenseGATConv(4)
        x_src = jnp.asarray(rng.standard_normal((1, 2, 6)), jnp.float32)
        x_dst = jnp.asarray(rng.standard_normal((1, 1, 3)), jnp.float32)
        adj = jnp.ones((1, 2, 1))
        params = conv.init(jax.random.PRNGKey(0), x_src, x_dst, adj)
        out = conv.apply(params, x_src, x_dst, adj)
        assert out.shape == (1, 1, 4)
        # isolated dst gets exactly the bias
        adj0 = jnp.zeros((1, 2, 1))
        out0 = conv.apply(params, x_src, x_dst, adj0)
        bias = params["params"]["bias"]
        np.testing.assert_allclose(np.asarray(out0[0, 0]), np.asarray(bias), atol=1e-6)

    def test_gat_multiplicity_weighting(self, rng):
        """Doubling an edge's count shifts attention toward that source --
        equivalent to the reference's repeated edge list."""
        conv = DenseGATConv(4)
        x_src = jnp.asarray(rng.standard_normal((1, 2, 4)), jnp.float32)
        x_dst = jnp.asarray(rng.standard_normal((1, 1, 4)), jnp.float32)
        p = conv.init(jax.random.PRNGKey(1), x_src, x_dst, jnp.ones((1, 2, 1)))
        out1 = conv.apply(p, x_src, x_dst, jnp.asarray([[[1.0], [1.0]]]))
        out2 = conv.apply(p, x_src, x_dst, jnp.asarray([[[2.0], [1.0]]]))
        assert not np.allclose(out1, out2)

    @pytest.mark.parametrize("Backbone,kw", [
        (HeteroGGNN, dict(hidden_channels=8, num_layers=2)),
        (HGT, dict(hidden_channels=8, num_heads=2, num_layers=2)),
    ])
    def test_backbone_jk_concat_width(self, Backbone, kw, batch, rng):
        gnn = Backbone(**kw)
        x = {
            "query": jnp.asarray(
                rng.standard_normal((4, batch.query_input_ids.shape[1], 8)),
                jnp.float32,
            ),
            "product": jnp.asarray(
                rng.standard_normal((4, batch.product_asin.shape[1], 8)),
                jnp.float32,
            ),
        }
        params = gnn.init(jax.random.PRNGKey(0), x, batch)
        out = gnn.apply(params, x, batch)
        # JK concat: input (8) + num_layers * hidden (8 each)
        assert out["query"].shape[-1] == 8 + 2 * 8
        assert out["product"].shape[-1] == 8 + 2 * 8
        out2 = gnn.apply(params, x, batch, add_input_feat=False)
        assert out2["query"].shape[-1] == 2 * 8

    def test_hetero_sage(self, batch, rng):
        gnn = HeteroSAGE(hidden_dim=8, out_dim=6)
        x = {
            "query": jnp.asarray(
                rng.standard_normal((4, batch.query_input_ids.shape[1], 5)),
                jnp.float32,
            ),
            "product": jnp.asarray(
                rng.standard_normal((4, batch.product_asin.shape[1], 7)),
                jnp.float32,
            ),
        }
        params = gnn.init(jax.random.PRNGKey(0), x, batch)
        out = gnn.apply(params, x, batch)
        assert out["query"].shape[-1] == 6
        assert out["product"].shape[-1] == 6


class TestPoolings:
    def _x(self, rng, n=6, d=10):
        x = jnp.asarray(rng.standard_normal((3, n, d)), jnp.float32)
        mask = jnp.ones((3, n)).at[:, n - 2 :].set(0.0)
        return x, mask

    @pytest.mark.parametrize("key", ["mean", "add", "max"])
    def test_graph_pooling(self, key, rng):
        x, mask = self._x(rng)
        pool = GraphPooling(key, 4)
        params = pool.init(jax.random.PRNGKey(0), x, mask)
        out = pool.apply(params, x, mask)
        assert out.shape == (3, 4)
        # padded nodes must not influence the result
        x2 = x.at[:, -1].set(99.0)
        np.testing.assert_allclose(
            np.asarray(pool.apply(params, x2, mask)), np.asarray(out), atol=1e-5
        )

    def test_attention_pooling_mask_invariance(self, rng):
        x, mask = self._x(rng)
        pool = AttentionPooling(4)
        params = pool.init(jax.random.PRNGKey(0), x, mask)
        out = pool.apply(params, x, mask)
        x2 = x.at[:, -1].set(77.0)
        np.testing.assert_allclose(
            np.asarray(pool.apply(params, x2, mask)), np.asarray(out), atol=1e-5
        )

    def test_srgnn_pooling(self, batch, rng):
        P = batch.product_asin.shape[1]
        x = jnp.asarray(rng.standard_normal((4, P, 8)), jnp.float32)
        pool = SRGNNPooling(5)
        params = pool.init(
            jax.random.PRNGKey(0), x, batch.product_node_mask, batch
        )
        out = pool.apply(params, x, batch.product_node_mask, batch)
        assert out.shape == (4, 5)

    def test_recency_srgnn_pooling(self, batch, rng):
        from sessionsimilaritysearch.models.pooling import (
            RecencySRGNNPooling,
        )

        P = batch.product_asin.shape[1]
        x = jnp.asarray(rng.standard_normal((4, P, 8)), jnp.float32)
        pool = RecencySRGNNPooling(5)
        params = pool.init(
            jax.random.PRNGKey(0), x, batch.product_node_mask, batch
        )
        out = pool.apply(params, x, batch.product_node_mask, batch)
        assert out.shape == (4, 5)
        assert np.isfinite(np.asarray(out)).all()
        # the decay length is a trainable scalar with a finite gradient
        def loss(p):
            return jnp.sum(pool.apply(p, x, batch.product_node_mask, batch))

        g = jax.grad(loss)(params)
        lam_g = float(g["params"]["raw_lambda"])
        assert np.isfinite(lam_g)
        # padded occurrence slots must not influence the result: corrupt a
        # node only reachable through masked occ rows via a masked product
        dead = np.where(np.asarray(batch.product_node_mask[0]) == 0)[0]
        if dead.size:
            x2 = x.at[0, int(dead[0])].set(1e3)
            np.testing.assert_allclose(
                np.asarray(pool.apply(params, x2,
                                      batch.product_node_mask, batch))[0],
                np.asarray(out)[0], atol=1e-4,
            )

    def test_recency_pooling_weights_track_lambda(self, batch, rng):
        """Small lambda concentrates the recency stream on the most recent
        occurrence: shrinking raw_lambda must move the rep toward the
        last-occurrence product state."""
        from sessionsimilaritysearch.models.pooling import (
            RecencySRGNNPooling,
        )

        P = batch.product_asin.shape[1]
        x = jnp.asarray(rng.standard_normal((4, P, 8)), jnp.float32)
        pool = RecencySRGNNPooling(5, init_lambda=0.05)
        params = pool.init(
            jax.random.PRNGKey(0), x, batch.product_node_mask, batch
        )
        # with a tiny decay length, weights collapse onto rev_pos == min
        occ_pos = np.asarray(batch.occ_pos[0])
        occ_mask = np.asarray(batch.occ_mask[0])
        valid = occ_mask > 0
        assert valid.any()
        rev = np.where(valid, occ_pos, 10**6)
        j = int(np.argmin(rev))
        w = np.exp(-(np.clip(occ_pos - 1.0, 0, None)) / 0.05) * occ_mask
        assert w.argmax() == j  # sanity of the construction

    def test_positional_attention_pooling(self, batch, cfg, rng):
        Q = batch.query_input_ids.shape[1]
        P = batch.product_asin.shape[1]
        q = jnp.asarray(rng.standard_normal((4, Q, 12)), jnp.float32)
        p = jnp.asarray(rng.standard_normal((4, P, 9)), jnp.float32)
        pool = PositionalAttentionPooling(64, cfg.max_seq_len)
        params = pool.init(jax.random.PRNGKey(0), q, p, batch)
        out = pool.apply(params, q, p, batch)
        assert out.shape == (4, 64)
        assert np.isfinite(np.asarray(out)).all()


class TestHeads:
    def test_mlp_shapes_and_jump(self, rng):
        x = jnp.asarray(rng.standard_normal((6, 10)), jnp.float32)
        mlp = MLP(n_output=4, n_hidden=8, n_hidden_layers=1, jump=True)
        params = mlp.init(jax.random.PRNGKey(0), x)
        out, _ = mlp.apply(
            params, x, deterministic=False, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(1)},
        )
        assert out.shape == (6, 4)
        assert np.abs(np.asarray(out)).max() <= 1.0  # tanh last_act

    def test_binarize_head_train_eval_asymmetry(self, rng):
        x = jnp.asarray(rng.standard_normal((5, 12)), jnp.float32)
        head = BinarizeHead(n_output=8)
        params = head.init(jax.random.PRNGKey(0), x, train=True)
        soft = head.apply(params, x, train=True)
        hard = head.apply(params, x, train=False)
        assert np.abs(np.asarray(soft)).max() < 1.0  # tanh interior
        np.testing.assert_array_equal(np.abs(np.asarray(hard)), np.ones((5, 8)))
        # straight-through: eval signs agree with train tanh signs
        np.testing.assert_array_equal(np.sign(np.asarray(soft)), np.asarray(hard))

    def test_binarize_head_gradient_flows_through_sign(self, rng):
        x = jnp.asarray(rng.standard_normal((3, 6)), jnp.float32)
        head = BinarizeHead(n_output=4)
        params = head.init(jax.random.PRNGKey(0), x, train=True)

        def loss(p):
            return jnp.sum(head.apply(p, x, train=False))

        g = jax.grad(loss)(params)
        total = sum(np.abs(np.asarray(v)).sum() for v in jax.tree.leaves(g))
        assert total > 0  # tanh surrogate gradient, not zero

    def test_decoder_head(self, rng):
        d = 8
        head = TransformerDecoderHead(ninp=d, nout=16, nhead=2, nhid=16, nlayers=1, dropout=0.0)
        tgt = jnp.asarray(rng.standard_normal((2, 5, d)), jnp.float32)
        mem = jnp.asarray(rng.standard_normal((2, 1, d)), jnp.float32)
        params = head.init(jax.random.PRNGKey(0), tgt, mem)
        out = head.apply(params, tgt, mem, tgt_mask=causal_mask(5))
        assert out.shape == (2, 5, 16)

    def test_cross_attention_latents_blocked(self, rng):
        """Latent tokens must not attend to text tokens: changing the text
        must not change what the latents contribute back to... the returned
        token embeddings DO change, but latent-only forward must be stable.
        We verify output shape + finite here and mask wiring via shapes."""
        cat = CrossAttentionTransformer(
            nlayers=1, node_emb_K=2, token_dim=8, nhead=2, nhid=16, dropout=0.0
        )
        node = jnp.asarray(rng.standard_normal((3, 10)), jnp.float32)
        tok = jnp.asarray(rng.standard_normal((3, 5, 8)), jnp.float32)
        mask = jnp.zeros((3, 5), dtype=bool)
        params = cat.init(jax.random.PRNGKey(0), node, tok, mask)
        out = cat.apply(params, node, tok, mask)
        assert out.shape == (3, 5, 8)


class TestTextEmbedders:
    def test_node_text_transformer(self, rng):
        m = NodeTextTransformer(ntoken=50, ninp=8, nhead=2, nhid=16, nlayers=1, dropout=0.0)
        ids = jnp.asarray(rng.integers(0, 50, (4, 6)), jnp.int32)
        att = jnp.ones((4, 6), jnp.int32)
        params = m.init(jax.random.PRNGKey(0), ids, att)
        out = m.apply(params, ids, att)
        assert out.shape == (4, 8)

    def test_text_encoder_freeze_stops_gradient(self, rng):
        m = TextEncoder(vocab_size=50, d_model=8, nhead=2, nhid=16, nlayers=1,
                        max_len=6, nout=4, freeze=True)
        ids = jnp.asarray(rng.integers(0, 50, (3, 6)), jnp.int32)
        typ = jnp.zeros_like(ids)
        att = jnp.ones_like(ids)
        params = m.init(jax.random.PRNGKey(0), ids, typ, att)

        def loss(p):
            return jnp.sum(m.apply(p, ids, typ, att) ** 2)

        g = jax.grad(loss)(params)
        # the trainable output Linear gets gradient...
        lin_g = sum(np.abs(np.asarray(v)).sum() for v in jax.tree.leaves(g["params"]["lin"]))
        assert lin_g > 0
        # ...the frozen backbone does not (reference .detach(), NodeEmbedding.py:115)
        enc_g = sum(np.abs(np.asarray(v)).sum() for v in jax.tree.leaves(g["params"]["encoder"]))
        assert enc_g == 0

    def test_text_encoder_token_output(self, rng):
        m = TextEncoder(vocab_size=50, d_model=8, nhead=2, nhid=16, nlayers=1, max_len=6)
        ids = jnp.asarray(rng.integers(0, 50, (3, 6)), jnp.int32)
        params = m.init(jax.random.PRNGKey(0), ids, jnp.zeros_like(ids), jnp.ones_like(ids))
        out, tok = m.apply(params, ids, jnp.zeros_like(ids), jnp.ones_like(ids), get_token=True)
        assert out.shape == (3, 8) and tok.shape == (3, 6, 8)

    def test_asin_embedding(self):
        m = NodeAsinEmbedding(nproducts=100, ninp=6)
        ids = jnp.asarray([[1, 2], [3, 99]], jnp.int32)
        params = m.init(jax.random.PRNGKey(0), ids)
        assert m.apply(params, ids).shape == (2, 2, 6)


class TestEncoders:
    def test_graph_level_encoder(self, cfg, batch):
        enc = build_graph_encoder(cfg)
        params = enc.init(jax.random.PRNGKey(0), batch)
        out = enc.apply(params, batch)
        assert out.shape == (4, cfg.session_emb_dim)
        assert np.isfinite(np.asarray(out)).all()

    def test_graph_level_encoder_recency_pooling(self, cfg, batch):
        enc = build_graph_encoder(cfg.replace(product_pooling="recency"))
        params = enc.init(jax.random.PRNGKey(0), batch)
        out = enc.apply(params, batch)
        assert out.shape == (4, cfg.session_emb_dim)
        assert np.isfinite(np.asarray(out)).all()
        flat = jax.tree_util.tree_leaves_with_path(params)
        assert any("raw_lambda" in str(p) for p, _ in flat)

    def test_graph_level_encoder_jits(self, cfg, batch):
        enc = build_graph_encoder(cfg)
        params = enc.init(jax.random.PRNGKey(0), batch)
        f = jax.jit(lambda p, g: enc.apply(p, g))
        out = f(params, batch)
        assert out.shape == (4, cfg.session_emb_dim)

    def test_unify_pooling_encoder(self, cfg, batch):
        enc = build_pretrain_encoder(cfg)
        # init must trace the token branch or its params won't exist
        params = enc.init(jax.random.PRNGKey(0), batch, get_token=True)
        out = enc.apply(params, batch)
        assert out.shape == (4, cfg.session_emb_dim)
        emb, node = enc.apply(params, batch, get_node=True)
        # use_id_embedding=False: product input is the 768-class text dim,
        # JK concat adds gnn_nlayers * gnn_nout (pretrain driver wiring)
        assert node["product"].shape[-1] == (
            cfg.text_encoder_dim + cfg.gnn_nlayers * cfg.gnn_nout
        )
        emb2, tokd = enc.apply(params, batch, get_token=True)
        assert tokd["query"].shape[-1] == cfg.text_encoder_dim

    def test_text_session_encoder(self, cfg, batch):
        enc = build_text_session_encoder(cfg)
        params = enc.init(jax.random.PRNGKey(0), batch)
        out = enc.apply(params, batch)
        assert out.shape == (4, cfg.n_out)

    def test_node_masking_changes_output(self, cfg, batch):
        enc = build_graph_encoder(cfg)
        params = enc.init(jax.random.PRNGKey(0), batch)
        out1 = enc.apply(params, batch)
        qmask = jnp.zeros_like(batch.query_node_mask)
        out2 = enc.apply(params, batch, query_node_mask=qmask)
        assert not np.allclose(np.asarray(out1), np.asarray(out2))

    def test_encoder_padding_invariance(self, cfg, batch):
        """Garbage in padded token rows must not change the embedding."""
        enc = build_graph_encoder(cfg)
        params = enc.init(jax.random.PRNGKey(0), batch)
        out1 = enc.apply(params, batch)
        # corrupt asin ids of padded product rows
        bad = batch._replace(
            product_asin=jnp.where(
                batch.product_node_mask > 0, batch.product_asin, 7
            )
        )
        out2 = enc.apply(params, bad)
        np.testing.assert_allclose(np.asarray(out1), np.asarray(out2), atol=1e-5)


class TestConvKeys:
    @pytest.mark.parametrize("key", ["SAGE", "GCN", "GAT"])
    def test_hetero_stack_conv_keys(self, key, batch, rng):
        gnn = HeteroSAGE(hidden_dim=8, out_dim=6, conv_key=key)
        x = {
            "query": jnp.asarray(
                rng.standard_normal((4, batch.query_input_ids.shape[1], 5)),
                jnp.float32,
            ),
            "product": jnp.asarray(
                rng.standard_normal((4, batch.product_asin.shape[1], 7)),
                jnp.float32,
            ),
        }
        params = gnn.init(jax.random.PRNGKey(0), x, batch)
        out = gnn.apply(params, x, batch)
        assert out["query"].shape[-1] == 6
        assert np.isfinite(np.asarray(out["product"])).all()

    def test_gcn_normalization(self, rng):
        from sessionsimilaritysearch.models import DenseGCNConv

        conv = DenseGCNConv(4)
        x_src = jnp.ones((1, 2, 3))
        x_dst = jnp.ones((1, 2, 3))
        adj = jnp.asarray([[[1.0, 0.0], [0.0, 1.0]]])  # 1-1 edges
        p = conv.init(jax.random.PRNGKey(0), x_src, x_dst, adj)
        out1 = conv.apply(p, x_src, x_dst, adj)
        # with identical src features, sym-normalized aggregation over a
        # fully connected bipartite graph (2 neighbors at weight 1/2 each)
        # equals the single-neighbor case at weight 1
        adj2 = jnp.ones((1, 2, 2))
        out2 = conv.apply(p, x_src, x_dst, adj2)
        np.testing.assert_allclose(
            np.asarray(out2), np.asarray(out1), rtol=1e-5
        )


class TestTitleTableCache:
    @pytest.fixture()
    def gen(self, tiny_cfg):
        # Shadows the session-scoped `gen`: these tests compare two compute
        # paths at tight float tolerance, and the tolerance margin is
        # data-dependent — a fresh seeded generator pins the draw so the
        # outcome cannot depend on how many sessions earlier tests consumed
        # from the shared stream (the conftest order-dependence rule).
        from sessionsimilaritysearch.data.synthetic import (
            SyntheticSessionGenerator,
        )

        return SyntheticSessionGenerator(asin_num=tiny_cfg.asin_num, seed=0)

    def test_cached_encode_matches_uncached(self, tiny_cfg, tokenizer, gen):
        """GraphLevelEncoder(title_table=...) must reproduce the uncached
        forward bit-for-bit (to float tolerance) for every session with at
        least one product interaction; the zero-product placeholder node
        (asin 0 carrying 'UNK' text) is the one documented divergence."""
        from sessionsimilaritysearch.data import build_graph_batch
        from sessionsimilaritysearch.evalharness.harness import (
            build_title_table,
            make_cached_encode_fn,
        )
        from sessionsimilaritysearch.models import build_graph_encoder

        data = gen.dataset(12)
        data = [d for d in data
                if any(a[1] != "s" for a in d[0])] or [gen.datum()]
        batch = build_graph_batch(
            data, tokenizer, tiny_cfg.dims,
            ignore_query=tiny_cfg.ignore_query,
        )
        enc = build_graph_encoder(tiny_cfg)
        params = enc.init(jax.random.PRNGKey(0), batch)
        plain = jax.jit(lambda g: enc.apply(params, g))
        table = build_title_table(
            tiny_cfg, tokenizer, gen.titles, enc, params, batch_size=64
        )
        assert table.shape == (tiny_cfg.asin_num, tiny_cfg.text_encoder_dim)
        cached = make_cached_encode_fn(enc, params, table)
        np.testing.assert_allclose(
            # rtol covers the large-magnitude outputs: the cached path
            # computes title embeddings at table-build batch shapes, and
            # XLA's different fusion there yields ~1e-6 input deltas that
            # three GNN layers can amplify past a bare 1e-4 atol
            np.asarray(cached(batch)), np.asarray(plain(batch)),
            rtol=1e-5, atol=1e-4,
        )

    def test_keyword_table_matches_uncached(self, tiny_cfg, tokenizer, gen):
        """The fully-cached forward (title_table + query_table) must match
        the uncached forward, with real (non-root) query nodes in play."""
        from sessionsimilaritysearch.data import build_graph_batch
        from sessionsimilaritysearch.evalharness.harness import (
            build_keyword_table,
            build_title_table,
            make_cached_encode_fn,
        )
        from sessionsimilaritysearch.models import build_graph_encoder

        cfg = tiny_cfg.replace(ignore_query=False)
        data = gen.dataset(10)
        data = [d for d in data
                if any(a[1] != "s" for a in d[0])] or [gen.datum()]
        batch = build_graph_batch(data, tokenizer, cfg.dims,
                                  ignore_query=False)
        enc = build_graph_encoder(cfg)
        params = enc.init(jax.random.PRNGKey(0), batch)
        plain = jax.jit(lambda g: enc.apply(params, g))
        table = build_title_table(cfg, tokenizer, gen.titles, enc, params,
                                  batch_size=64)
        kws = sorted({a[2] or "" for d in data for a in d[0]
                      if a[1] == "s"})
        qtable, lookup = build_keyword_table(cfg, tokenizer, kws, enc,
                                             params, batch_size=64)
        assert qtable.shape[0] == len(set(kws) | {""})
        cached = make_cached_encode_fn(enc, params, table,
                                       query_table=qtable, kw_lookup=lookup)
        np.testing.assert_allclose(
            # rtol covers the large-magnitude outputs: the cached path
            # computes title embeddings at table-build batch shapes, and
            # XLA's different fusion there yields ~1e-6 input deltas that
            # three GNN layers can amplify past a bare 1e-4 atol
            np.asarray(cached(batch)), np.asarray(plain(batch)),
            rtol=1e-5, atol=1e-4,
        )
        # at least one session must actually contain a search action, or
        # this test only exercises the root node
        assert any(a[1] == "s" for d in data for a in d[0])

    def test_keyword_table_oov_falls_back(self, tiny_cfg, tokenizer, gen):
        """A batch containing a keyword absent from the table must take the
        title-only path (exact output, no crash)."""
        from sessionsimilaritysearch.data import build_graph_batch
        from sessionsimilaritysearch.evalharness.harness import (
            build_keyword_table,
            build_title_table,
            keyword_ids,
            make_cached_encode_fn,
        )
        from sessionsimilaritysearch.models import build_graph_encoder

        cfg = tiny_cfg.replace(ignore_query=False)
        data = [d for d in gen.dataset(20)
                if any(a[1] == "s" for a in d[0])][:4]
        assert data, "generator produced no sessions with searches"
        batch = build_graph_batch(data, tokenizer, cfg.dims,
                                  ignore_query=False)
        enc = build_graph_encoder(cfg)
        params = enc.init(jax.random.PRNGKey(0), batch)
        plain = jax.jit(lambda g: enc.apply(params, g))
        table = build_title_table(cfg, tokenizer, gen.titles, enc, params,
                                  batch_size=64)
        # vocabulary deliberately MISSING the sessions' keywords
        qtable, lookup = build_keyword_table(
            cfg, tokenizer, ["zz-not-a-real-keyword"], enc, params,
            batch_size=64,
        )
        assert keyword_ids(lookup, np.asarray(batch.query_input_ids)) is None
        cached = make_cached_encode_fn(enc, params, table,
                                       query_table=qtable, kw_lookup=lookup)
        np.testing.assert_allclose(
            # rtol covers the large-magnitude outputs: the cached path
            # computes title embeddings at table-build batch shapes, and
            # XLA's different fusion there yields ~1e-6 input deltas that
            # three GNN layers can amplify past a bare 1e-4 atol
            np.asarray(cached(batch)), np.asarray(plain(batch)),
            rtol=1e-5, atol=1e-4,
        )
