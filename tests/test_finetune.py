"""Fine-tuner tests: alternating two-tower optimization, side masking,
hash-code serving path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sessionsimilaritysearch.config import tiny_test_config
from sessionsimilaritysearch.training.finetune import (
    FinetuneState,
    TripletBatch,
    build_triplet_batches,
    create_finetune_state,
    make_code_fns,
    make_finetune_step,
    make_valid_fn,
)


def _mk_batch(rng, b=6, d=24):
    g = lambda *s: jnp.asarray(rng.standard_normal(s), jnp.float32)
    return TripletBatch(
        ori=g(b, d), pos=g(b, d), half=g(b, d), neg=g(b, d),
        pos_score=jnp.full((b,), 0.9), half_score=jnp.full((b,), 0.5),
        neg_score=jnp.full((b,), 0.1),
        aux_sub=g(b, d), aux=g(b, d),
    )


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    model, state, tx = create_finetune_state(cfg, jax.random.PRNGKey(0), emb_dim=24)
    return cfg, model, state, tx


class TestFinetune:
    def test_even_step_touches_db_side_only(self, setup, rng):
        cfg, model, state, tx = setup
        step = make_finetune_step(model, tx, cfg)
        batch = _mk_batch(rng)
        state2, metrics = step(state, batch)  # step 0 -> even -> db side
        for name in ("db_bin", "db_dec"):
            diff = jax.tree.map(
                lambda a, b: float(jnp.abs(a - b).sum()),
                state.params[name], state2.params[name],
            )
            assert sum(jax.tree.leaves(diff)) > 0, name
        for name in ("q_bin", "q_dec"):
            diff = jax.tree.map(
                lambda a, b: float(jnp.abs(a - b).sum()),
                state.params[name], state2.params[name],
            )
            assert sum(jax.tree.leaves(diff)) == 0, name

    def test_odd_step_touches_query_side(self, setup, rng):
        cfg, model, state, tx = setup
        step = make_finetune_step(model, tx, cfg)
        batch = _mk_batch(rng)
        s1, _ = step(state, batch)
        s2, _ = step(s1, batch)  # step 1 -> odd -> query side
        diff_q = jax.tree.map(
            lambda a, b: float(jnp.abs(a - b).sum()),
            s1.params["q_bin"], s2.params["q_bin"],
        )
        assert sum(jax.tree.leaves(diff_q)) > 0

    def test_loss_decreases(self, setup, rng):
        cfg, model, state, tx = setup
        step = make_finetune_step(model, tx, cfg)
        batch = _mk_batch(rng)
        first = None
        for i in range(20):
            state, metrics = step(state, batch)
            if first is None:
                first = float(metrics["loss"])
        assert float(metrics["loss"]) < first

    def test_valid_fn_breakdown(self, setup, rng):
        cfg, model, state, tx = setup
        run = make_valid_fn(model, cfg)
        out = run(state, _mk_batch(rng))
        for key in ("pos_loss", "neg_loss", "half_loss", "aux_loss",
                    "reg_loss", "rec_loss"):
            assert np.isfinite(float(out[key])), key

    def test_code_fns_emit_hard_codes(self, setup, rng):
        cfg, model, state, tx = setup
        db_codes, q_codes = make_code_fns(model)
        emb = jnp.asarray(rng.standard_normal((5, 24)), jnp.float32)
        c1 = np.asarray(db_codes(state, emb))
        c2 = np.asarray(q_codes(state, emb))
        assert c1.shape == (5, cfg.code_len)
        np.testing.assert_array_equal(np.abs(c1), np.ones_like(c1))
        np.testing.assert_array_equal(np.abs(c2), np.ones_like(c2))

    def test_build_triplet_batches(self, rng):
        cfg = tiny_test_config()
        triplets = [("a", "b", "c", "d", 0.9, 0.5, 0.1)] * 8
        aux_pairs = [("x", "y")] * 4
        embed_fn = lambda items: rng.standard_normal((len(items), 24)).astype(
            np.float32
        )
        batches = build_triplet_batches(
            triplets, embed_fn, aux_pairs, batch_size=4,
            rng=np.random.default_rng(0),
        )
        got = list(batches())
        assert len(got) == 2
        assert got[0].ori.shape == (4, 24)
        assert got[0].aux.shape == (4, 24)


class TestSharedInit:
    def test_tied_towers_emit_identical_codes(self, rng):
        """shared_init starts the hash at simhash quality: both towers are
        the SAME projection until training diverges them."""
        cfg = tiny_test_config(code_len=16)
        model, state, tx = create_finetune_state(
            cfg, jax.random.PRNGKey(1), emb_dim=12, shared_init=True
        )
        db_fn, q_fn = make_code_fns(model)
        emb = jnp.asarray(rng.standard_normal((7, 12)), jnp.float32)
        np.testing.assert_array_equal(
            np.asarray(db_fn(state, emb)), np.asarray(q_fn(state, emb))
        )

    def test_default_untied(self, rng):
        cfg = tiny_test_config(code_len=16)
        model, state, tx = create_finetune_state(
            cfg, jax.random.PRNGKey(1), emb_dim=12
        )
        db_fn, q_fn = make_code_fns(model)
        emb = jnp.asarray(rng.standard_normal((7, 12)), jnp.float32)
        assert (
            np.asarray(db_fn(state, emb)) != np.asarray(q_fn(state, emb))
        ).any()

    def test_ft_lr_used_for_head_training(self):
        """Config.ft_lr (default 3e-5) drives the fine-tune optimizer; the
        encoder lr (3e-4) overshoots the tiny heads."""
        cfg = tiny_test_config()
        assert cfg.ft_lr == pytest.approx(3e-5)
        assert (cfg.ft_lr or cfg.lr) != cfg.lr
