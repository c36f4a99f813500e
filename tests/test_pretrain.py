"""Pretrain driver tests: one-step execution, loss decrease over steps,
retrieval metrics, data-parallel mesh execution (SURVEY.md §4: multi-chip
tests on a virtual CPU mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sessionsimilaritysearch.config import tiny_test_config
from sessionsimilaritysearch.data.graph import batch_graphs, sequence_to_graph
from sessionsimilaritysearch.parallel import create_mesh, shard_batch, shard_params
from sessionsimilaritysearch.training.pretrain import (
    create_pretrain_state,
    make_encode_fn,
    make_eval_step,
    make_train_step,
)


@pytest.fixture(scope="module")
def setup(tokenizer):
    from sessionsimilaritysearch.data.synthetic import (
        SyntheticSessionGenerator,
    )

    cfg = tiny_test_config()
    # own generator: the shared session-scoped ``gen`` is stateful, which
    # would make this module's data (and the loss trajectory asserted
    # below) depend on test execution order
    data = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=11).dataset(16)
    graphs = [
        sequence_to_graph(i, s, t, tokenizer, cfg.dims)
        for i, (s, t) in enumerate(data)
    ]
    batch = jax.tree.map(jnp.asarray, batch_graphs(graphs))
    rng = jax.random.PRNGKey(0)
    model, state = create_pretrain_state(cfg, rng, batch)
    return cfg, model, state, batch


class TestPretrainStep:
    def test_init_batch_size_invariant(self, setup):
        """Params from init are identical whatever batch the init traces
        with: the campaign inits from a sliced-to-8 sample to avoid
        multi-GB transient init memory at flagship dims
        (examples/flagship_campaign.py, r5) — restart determinism (same
        seed => same params => same cached-text tables) rests on this."""
        cfg, model, state, batch = setup
        small = jax.tree.map(lambda a: a[:4], batch)
        _, state_small = create_pretrain_state(
            cfg.replace(batch_size=4), jax.random.PRNGKey(0), small
        )
        same = jax.tree.map(
            lambda a, b: bool((a == b).all()), state.params, state_small.params
        )
        assert all(jax.tree.leaves(same))

    def test_single_step_runs(self, setup):
        cfg, model, state, batch = setup
        step = make_train_step(model, has_view=False)
        state2, metrics = step(state, batch, jax.random.PRNGKey(1))
        assert np.isfinite(float(metrics["loss"]))
        assert int(state2.step) == 1
        # params actually changed
        diff = jax.tree.map(
            lambda a, b: float(jnp.sum(jnp.abs(a - b))), state.params, state2.params
        )
        assert sum(jax.tree.leaves(diff)) > 0

    def test_loss_decreases(self, setup):
        cfg, model, state, batch = setup
        step = make_train_step(model, has_view=False)
        # fixed rng: the same sampled negatives each step make the
        # objective deterministic, so the decrease assertion is not at the
        # mercy of negative-sampling noise
        sub = jax.random.PRNGKey(2)
        first = None
        for i in range(8):
            state, metrics = step(state, batch, sub)
            if first is None:
                first = float(metrics["next_product_loss"])
        last = float(metrics["next_product_loss"])
        assert last < first, (first, last)

    def test_eval_step_deterministic(self, setup):
        cfg, model, state, batch = setup
        ev = make_eval_step(model)
        m1 = ev(state, batch, jax.random.PRNGKey(3))
        m2 = ev(state, batch, jax.random.PRNGKey(3))
        assert float(m1["loss"]) == float(m2["loss"])

    def test_encode_fn(self, setup):
        cfg, model, state, batch = setup
        enc = make_encode_fn(model)
        emb = enc(state, batch)
        assert emb.shape == (16, cfg.session_emb_dim)
        assert np.isfinite(np.asarray(emb)).all()

    def test_retrieval_metrics(self, setup):
        cfg, model, state, batch = setup
        variables = {"params": state.params}
        if state.batch_stats is not None:
            variables["batch_stats"] = state.batch_stats
        p, r = model.apply(variables, batch, 5, method=model.retrieval_metrics)
        assert 0.0 <= float(p) <= 1.0
        assert 0.0 <= float(r) <= 1.0

    def test_cached_text_tables_match_uncached(self, setup, tokenizer):
        """The cached-table training step (tables=) must reproduce the
        uncached step: the text backbone is frozen (stop_gradient, zero
        weight decay), so gathering its precomputed per-row outputs is
        mathematically the same forward. Gate for the campaign's cached
        mode (examples/flagship_campaign.py --cached-text)."""
        from sessionsimilaritysearch.data.synthetic import (
            SyntheticSessionGenerator,
        )
        from sessionsimilaritysearch.evalharness.harness import (
            build_keyword_table,
            build_title_table,
            keyword_ids,
        )
        from sessionsimilaritysearch.models.encoder import (
            build_pretrain_encoder,
        )

        cfg, model, state, batch = setup
        # the setup generator is seeded (11); rebuild for its catalog
        gen = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=11)
        data = gen.dataset(16)
        enc_mod = build_pretrain_encoder(cfg)
        enc_vars = {"params": state.params["encoder"]}
        title_table = build_title_table(
            cfg, tokenizer, gen.titles, enc_mod, enc_vars, batch_size=128
        )
        kws = sorted({a[2] or "" for d in data for a in d[0] + d[1]
                      if a[1] == "s"})
        qtable, kw_lookup = build_keyword_table(
            cfg, tokenizer, kws, enc_mod, enc_vars, batch_size=128
        )
        kw = keyword_ids(kw_lookup, np.asarray(batch.query_input_ids))
        assert kw is not None, "keyword table must cover the batch"

        step = make_train_step(model, has_view=False)
        rng = jax.random.PRNGKey(5)
        s_ref, m_ref = step(state, batch, rng)
        # title-only cache (query store still text-encoded)
        _, m_t = step(state, batch, rng, None,
                      {"title_table": title_table})
        np.testing.assert_allclose(
            float(m_ref["loss"]), float(m_t["loss"]), rtol=1e-5
        )
        # fully cached forward: both stores gathered
        s_c, m_c = step(state, batch, rng, None, {
            "title_table": title_table,
            "query_table": qtable,
            "query_kw": jnp.asarray(kw),
        })
        np.testing.assert_allclose(
            float(m_ref["loss"]), float(m_c["loss"]), rtol=1e-5
        )
        # the updated TRAINED params agree (text params get zero grads on
        # both paths; compare the active head + gnn + asin table)
        for key in ("next_product_head", "target_asin_embedding"):
            a = jax.tree.leaves(s_ref.params[key])
            b = jax.tree.leaves(s_c.params[key])
            for x, y in zip(a, b):
                np.testing.assert_allclose(
                    np.asarray(x), np.asarray(y), atol=2e-5
                )

    def test_contrastive_view_branch(self, gen, tokenizer):
        cfg = tiny_test_config(ctv_w=0.1)
        data = gen.dataset(8)
        graphs = [
            sequence_to_graph(i, s, t, tokenizer, cfg.dims)
            for i, (s, t) in enumerate(data)
        ]
        batch = jax.tree.map(jnp.asarray, batch_graphs(graphs))
        rng = jax.random.PRNGKey(0)
        from sessionsimilaritysearch.training.pretrain import PretrainModel
        from sessionsimilaritysearch.training.train_state import (
            adam_with_clip,
            create_train_state,
        )

        model = PretrainModel(cfg)
        state = create_train_state(
            model, rng, (batch, rng), adam_with_clip(cfg.lr),
            init_kwargs={"view_graph": batch, "deterministic": True},
        )
        step = make_train_step(model, has_view=True)
        state, metrics = step(state, batch, rng, batch)
        assert "ctv_loss" in metrics
        assert np.isfinite(float(metrics["ctv_loss"]))


class TestDataParallel:
    def test_sharded_step_matches_single(self, setup):
        """The same step over an 8-device data mesh must produce the same
        loss (GSPMD semantics-preserving)."""
        cfg, model, state, batch = setup
        mesh = create_mesh()
        assert mesh.shape["data"] == 8
        step = make_train_step(model, has_view=False)
        rng = jax.random.PRNGKey(5)
        _, m_single = step(state, batch, rng)

        sharded_batch = shard_batch(batch, mesh)
        sharded_state = state.replace(
            params=shard_params(state.params, mesh, min_rows=512)
        )
        _, m_shard = step(sharded_state, sharded_batch, rng)
        np.testing.assert_allclose(
            float(m_single["loss"]), float(m_shard["loss"]), rtol=2e-3
        )

    def test_asin_table_is_sharded(self, setup):
        cfg, model, state, batch = setup
        mesh = create_mesh()
        params = shard_params(state.params, mesh, min_rows=512)
        table = params["target_asin_embedding"]["embedding"]
        # 1000-row table over 8 devices: sharded row-wise
        assert len(table.sharding.device_set) == 8
