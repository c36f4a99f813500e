"""Integration tests: the reference's end-to-end call stacks (SURVEY.md §3)
reproduced on this stack, plus the NaN-sanitizer mode that
replaces the reference's assert storm (SURVEY.md §5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sessionsimilaritysearch.config import tiny_test_config
from sessionsimilaritysearch.data.graph import batch_graphs, sequence_to_graph
from sessionsimilaritysearch.data.loader import SessionGraphLoader
from sessionsimilaritysearch.data.similarity import get_ave_score, mine_triplets


class TestPretrainToServeStack:
    """SURVEY §3.1 + §3.3: pretrain -> embed corpus -> index -> query ->
    evaluate, all through public APIs."""

    def test_full_stack(self, gen, tokenizer):
        from sessionsimilaritysearch.engine import SessionSearchEngine
        from sessionsimilaritysearch.training.pretrain import (
            create_pretrain_state,
            make_encode_fn,
            make_train_step,
        )

        cfg = tiny_test_config(batch_size=8)
        data = gen.dataset(24)
        loader = SessionGraphLoader(
            data, tokenizer, cfg.dims, cfg.batch_size, seed=0, prefetch=0
        )
        rng = jax.random.PRNGKey(0)
        sample = jax.tree.map(jnp.asarray, next(iter(loader)))
        model, state = create_pretrain_state(cfg, rng, sample)
        step = make_train_step(model, has_view=False)
        for b in loader:
            rng, sub = jax.random.split(rng)
            state, m = step(state, jax.tree.map(jnp.asarray, b), sub)
        assert np.isfinite(float(m["loss"]))

        encode = make_encode_fn(model)
        eng = SessionSearchEngine(
            cfg, tokenizer, lambda g: encode(state, g),
            dim=cfg.session_emb_dim, capacity=64, batch_size=cfg.batch_size,
        )
        eng.add_sessions([(d[0], []) for d in data])
        D, I = eng.search(data[:6], k=5)
        assert I.shape == (6, 5)
        score = get_ave_score(
            I, data[:6], [d[0] for d in data], "all_product_type_score"
        )
        assert 0.0 <= score <= 1.0

    def test_finetune_hash_serve_stack(self, gen, tokenizer, rng):
        """SURVEY §3.2-3.3: frozen embeddings -> alternating hash fine-tune
        -> hard codes -> Hamming serve -> ground-truth report."""
        from sessionsimilaritysearch.evalharness.harness import (
            evaluate_binary,
        )
        from sessionsimilaritysearch.training.finetune import (
            build_triplet_batches,
            create_finetune_state,
            make_code_fns,
            make_finetune_step,
        )

        cfg = tiny_test_config(code_len=32)
        qdata, db = gen.dataset(20), gen.dataset(40)
        triplets = mine_triplets(qdata, db, "all_product_type_score", 8,
                                 pos_thresh=0.6, half_lo=0.1)
        if len(triplets) < 4:
            pytest.skip("synthetic data yielded too few triplets")
        emb_dim = 16
        W = rng.standard_normal((cfg.dims.max_product_nodes, emb_dim)).astype(
            np.float32
        )

        def embed_fn(items):
            # deterministic stand-in embedding from product-count histogram
            out = []
            for it in items:
                seq = (
                    list(it[0]) + list(it[1])
                    if isinstance(it, tuple)
                    else list(it)
                )
                h = np.zeros(cfg.dims.max_product_nodes, np.float32)
                for a in seq:
                    if a[1] != "s":
                        h[a[-1] % cfg.dims.max_product_nodes] += 1
                out.append(h @ W)
            return np.stack(out)

        model, state, tx = create_finetune_state(
            cfg, jax.random.PRNGKey(0), emb_dim=emb_dim
        )
        step_fn = make_finetune_step(model, tx, cfg)
        batches = build_triplet_batches(
            triplets, embed_fn, [(q, q) for q in qdata[:8]], 4,
            np.random.default_rng(1),
        )
        for _ in range(4):
            for b in batches():
                state, m = step_fn(state, b)
        db_fn, q_fn = make_code_fns(model)
        db_codes = np.asarray(db_fn(state, jnp.asarray(embed_fn(db))))
        q_codes = np.asarray(q_fn(state, jnp.asarray(embed_fn(qdata[:5]))))
        res = evaluate_binary(
            db_codes, q_codes, [d[0] for d in db], qdata[:5], k=5
        )
        assert res.I.shape == (5, 5)
        assert "ave_all_product_type_score" in res.report


class TestNaNSanitizer:
    """jax.debug_nans as the framework's replacement for the reference's
    per-stage NaN asserts (model/model.py:223-247 etc.)."""

    def test_pretrain_step_clean_under_debug_nans(self, gen, tokenizer):
        from sessionsimilaritysearch.training.pretrain import (
            create_pretrain_state,
            make_train_step,
        )

        cfg = tiny_test_config(batch_size=4)
        graphs = [
            sequence_to_graph(i, *d, tokenizer, cfg.dims)
            for i, d in enumerate(gen.dataset(4))
        ]
        batch = jax.tree.map(jnp.asarray, batch_graphs(graphs))
        rng = jax.random.PRNGKey(0)
        model, state = create_pretrain_state(cfg, rng, batch)
        step = make_train_step(model, has_view=False)
        with jax.debug_nans(True):
            state, m = step(state, batch, rng)  # raises on any NaN
        assert np.isfinite(float(m["loss"]))
