"""Session/subsession/joint trainer tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sessionsimilaritysearch.config import tiny_test_config
from sessionsimilaritysearch.data.graph import (
    batch_graphs,
    sequence_to_graph,
    truncate_to_subsession,
)
from sessionsimilaritysearch.training.session_trainers import (
    create_joint_state,
    create_session_state,
    make_joint_train_step,
    make_session_train_step,
)


@pytest.fixture(scope="module")
def batches(gen, tokenizer):
    cfg = tiny_test_config(qh_nhead=2, qh_nhid=32)
    data = gen.dataset(8)
    rng = np.random.default_rng(0)
    session_graphs, subsession_graphs = [], []
    for i, (seq, tar) in enumerate(data):
        full = list(seq) + list(tar)
        session_graphs.append(
            sequence_to_graph(i, full, full, tokenizer, cfg.dims)
        )
        pre, fut = truncate_to_subsession((full, []), rng)
        subsession_graphs.append(
            sequence_to_graph(i, pre, fut, tokenizer, cfg.dims)
        )
    to_dev = lambda gs: jax.tree.map(jnp.asarray, batch_graphs(gs))
    return cfg, to_dev(session_graphs), to_dev(subsession_graphs)


class TestSessionTrainers:
    @pytest.mark.parametrize("mode", ["subsession", "session"])
    def test_step_runs_and_learns(self, batches, mode):
        cfg, session_b, subsession_b = batches
        graph = subsession_b if mode == "subsession" else session_b
        rng = jax.random.PRNGKey(0)
        model, state = create_session_state(cfg, rng, graph, mode=mode)
        step = make_session_train_step(model)
        first = None
        for i in range(6):
            rng, sub = jax.random.split(rng)
            state, m = step(state, graph, sub)
            if first is None:
                first = float(m["loss"])
        assert np.isfinite(float(m["loss"]))
        assert float(m["loss"]) < first

    def test_retrieval_metrics(self, batches):
        cfg, _, subsession_b = batches
        rng = jax.random.PRNGKey(1)
        model, state = create_session_state(cfg, rng, subsession_b)
        variables = {"params": state.params}
        if state.batch_stats is not None:
            variables["batch_stats"] = state.batch_stats
        p, r = model.apply(
            variables, subsession_b, 5, method=model.retrieval_metrics
        )
        assert 0.0 <= float(p) <= 1.0 and 0.0 <= float(r) <= 1.0

    def test_joint_trainer(self, batches):
        cfg, session_b, subsession_b = batches
        rng = jax.random.PRNGKey(2)
        model, state = create_joint_state(cfg, rng, session_b, subsession_b)
        step = make_joint_train_step(model)
        state, m = step(state, session_b, subsession_b, rng)
        for k in ("session_loss", "subsession_loss", "ctv_loss"):
            assert np.isfinite(float(m[k])), k

    def test_joint_trainer_flagship_towers(self, batches):
        """encoder_kind='flagship' joint towers expose the production
        GraphLevelEncoder param subtree per side — the extraction recipe
        examples/knn_pairings.py serves from."""
        from sessionsimilaritysearch.models.encoder import (
            build_graph_encoder,
        )

        cfg, session_b, subsession_b = batches
        rng = jax.random.PRNGKey(4)
        model, state = create_joint_state(
            cfg, rng, session_b, subsession_b, encoder_kind="flagship")
        step = make_joint_train_step(model)
        state, m = step(state, session_b, subsession_b, rng)
        assert np.isfinite(float(m["ctv_loss"]))
        enc = build_graph_encoder(cfg)
        for tower in ("session_model", "subsession_model"):
            emb = enc.apply(
                {"params": state.params[tower]["encoder"]}, subsession_b)
            assert emb.shape == (8, 2 * cfg.gnn_nout)

    def test_encode_method(self, batches):
        cfg, _, subsession_b = batches
        rng = jax.random.PRNGKey(3)
        model, state = create_session_state(cfg, rng, subsession_b)
        variables = {"params": state.params}
        if state.batch_stats is not None:
            variables["batch_stats"] = state.batch_stats
        emb = model.apply(variables, subsession_b, method=model.encode)
        assert emb.shape == (8, 2 * cfg.gnn_pooling_out)


class TestQueryLossStyles:
    def test_mlm_electra_style(self, batches):
        from sessionsimilaritysearch.training.session_trainers import (
            SessionEmbeddingModel,
        )
        from sessionsimilaritysearch.training.train_state import (
            adam_with_clip,
            create_train_state,
        )

        cfg, _, subsession_b = batches
        rng = jax.random.PRNGKey(4)
        model = SessionEmbeddingModel(
            cfg, mode="subsession", query_loss_style="mlm_electra"
        )
        state = create_train_state(
            model, rng, (subsession_b, rng), adam_with_clip(cfg.lr),
            init_kwargs={"deterministic": True},
        )
        step = make_session_train_step(model)
        state, m = step(state, subsession_b, rng)
        assert np.isfinite(float(m["query_loss"]))
        assert np.isfinite(float(m["loss"]))


class TestAugmentations:
    def test_random_exchange_order(self, gen):
        from sessionsimilaritysearch.data.augment import (
            random_drop_action,
            random_exchange_order,
            random_mask_product,
            random_perturb_product,
        )

        rng = np.random.default_rng(0)
        seq, tar = gen.datum()
        s2, t2 = random_exchange_order((seq, tar), rng)
        assert len(s2) == len(seq) and sorted(map(str, s2)) == sorted(map(str, seq))
        s3, _ = random_drop_action((seq, tar), rng)
        assert len(s3) == max(len(seq) - 1, 1)
        s4, _ = random_mask_product((seq, tar), rng)
        assert len(s4) == len(seq)
        s5, _ = random_perturb_product((seq, tar), rng, 100)
        assert len(s5) == len(seq)


class TestFlagshipEncoderKind:
    """encoder_kind='flagship' trains the production GraphLevelEncoder
    (TextEncoder backbone + HeteroGGNN + SRGNN pooling) inside the
    subsession trainer, so the SERVED encoder is the trained one and the
    catalog title cache applies (examples/flagship_serving.py)."""

    def test_train_encode_and_title_cache(self, batches, gen, tokenizer):
        from sessionsimilaritysearch.evalharness.harness import (
            build_title_table,
            make_cached_encode_fn,
        )
        from sessionsimilaritysearch.models.encoder import (
            build_graph_encoder,
        )

        cfg, _, sub = batches
        rng = jax.random.PRNGKey(0)
        model, state = create_session_state(
            cfg, rng, sub, mode="subsession", encoder_kind="flagship"
        )
        step = make_session_train_step(model)
        l0 = None
        for i in range(3):
            rng, k = jax.random.split(rng)
            state, m = step(state, sub, k)
            l0 = l0 if l0 is not None else float(m["loss"])
        assert np.isfinite(float(m["loss"]))
        # encode shape is the flagship 2*gnn_nout session embedding
        emb = model.apply(
            {"params": state.params}, sub, method="encode"
        )
        assert emb.shape == (sub.product_asin.shape[0], cfg.session_emb_dim)
        # trained encoder params drive the standalone encoder + title cache
        enc = build_graph_encoder(cfg)
        enc_vars = {"params": state.params["encoder"]}
        table = build_title_table(cfg, tokenizer, gen.titles, enc, enc_vars,
                                  batch_size=64)
        cached = make_cached_encode_fn(enc, enc_vars, table)
        plain = enc.apply(enc_vars, sub)
        np.testing.assert_allclose(
            np.asarray(cached(sub)), np.asarray(plain), atol=2e-4
        )
