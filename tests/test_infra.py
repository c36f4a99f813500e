"""Infrastructure tests: loader, ETL round-trip, checkpoint/resume,
logging, profiling, training loop."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sessionsimilaritysearch.config import tiny_test_config
from sessionsimilaritysearch.data import etl
from sessionsimilaritysearch.data.loader import SessionGraphLoader, TupleLoader
from sessionsimilaritysearch.data.graph import sequence_to_graph
from sessionsimilaritysearch.utils.checkpoint import (
    CheckpointManager,
    state_to_tree,
    tree_to_state,
)
from sessionsimilaritysearch.utils.logging import (
    MetricLogger,
    RunDir,
    read_metrics,
)
from sessionsimilaritysearch.utils.profiling import PhaseTimer


class TestLoader:
    def test_batches_static_shape(self, gen, tokenizer, tiny_cfg):
        data = gen.dataset(10)
        loader = SessionGraphLoader(
            data, tokenizer, tiny_cfg.dims, batch_size=4
        )
        batches = list(loader)
        assert len(batches) == 3  # 10 -> 4,4,(2 padded to 4)
        for b in batches:
            assert b.query_input_ids.shape[0] == 4

    def test_drop_last(self, gen, tokenizer, tiny_cfg):
        loader = SessionGraphLoader(
            gen.dataset(10), tokenizer, tiny_cfg.dims, batch_size=4,
            drop_last=True,
        )
        assert len(list(loader)) == 2

    def test_shuffle_determinism(self, gen, tokenizer, tiny_cfg):
        data = gen.dataset(8)
        l1 = SessionGraphLoader(data, tokenizer, tiny_cfg.dims, 4, seed=7)
        l2 = SessionGraphLoader(data, tokenizer, tiny_cfg.dims, 4, seed=7)
        b1, b2 = next(iter(l1)), next(iter(l2))
        np.testing.assert_array_equal(b1.idx, b2.idx)

    def test_transform_applied(self, gen, tokenizer, tiny_cfg):
        data = gen.dataset(4)

        def swap(datum, rng):
            seq, tar = datum
            return list(reversed(seq)), tar

        loader = SessionGraphLoader(
            data, tokenizer, tiny_cfg.dims, 4, transform=swap, shuffle=False,
            prefetch=0,
        )
        plain = SessionGraphLoader(
            data, tokenizer, tiny_cfg.dims, 4, shuffle=False, prefetch=0
        )
        b_t, b_p = next(iter(loader)), next(iter(plain))
        assert not np.array_equal(b_t.query_pos, b_p.query_pos)

    def test_prefetch_propagates_errors(self, tokenizer, tiny_cfg):
        bad = [("not", "a", "session")]
        loader = SessionGraphLoader(
            bad, tokenizer, tiny_cfg.dims, 1, cache=False, prefetch=2
        )
        with pytest.raises(Exception):
            list(loader)

    def test_tuple_loader(self, gen, tokenizer, tiny_cfg):
        g = sequence_to_graph(0, *gen.datum(), tokenizer, tiny_cfg.dims)
        items = [(g, g, 0.5) for _ in range(6)]
        tl = TupleLoader(items, batch_size=3)
        batch = next(iter(tl))
        assert batch[0].query_input_ids.shape[0] == 3
        np.testing.assert_allclose(batch[2], [0.5] * 3)


class TestETL:
    def test_roundtrip(self, gen, tmp_path):
        sessions = [gen.session() for _ in range(5)]
        a, c = str(tmp_path / "actions.csv"), str(tmp_path / "asin.csv")
        etl.decompose_sessions(sessions, a, c)
        back, asin2id = etl.load_sessions_from_csv(a, c)
        assert len(back) == 5
        for orig, rec in zip(sessions, back):
            assert len(orig) == len(rec)
            for ao, ar in zip(orig, rec):
                assert ao.action_type == ar.action_type
                if ao.action_type != "s":
                    assert ao.title == ar.title
                    assert ao.product_type == ar.product_type
                else:
                    assert ao.keyword == ar.keyword
        assert len(asin2id) >= 1

    def test_split_prefix_future(self, gen):
        rng = np.random.default_rng(0)
        sessions = [gen.session() for _ in range(4)]
        pairs = etl.split_prefix_future(sessions, rng)
        for (pre, fut), orig in zip(pairs, sessions):
            assert len(pre) + len(fut) == len(orig)
            assert len(pre) >= 1


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        tree = {
            "a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "nested": {"b": np.asarray(3)},
        }
        cm = CheckpointManager(str(tmp_path / "ck"))
        cm.save("latest", tree)
        assert cm.has("latest")
        back = cm.restore("latest", tree)
        np.testing.assert_array_equal(back["a"], tree["a"])
        assert int(np.asarray(back["nested"]["b"])) == 3

    def test_npz_fallback_roundtrip(self, tmp_path):
        """Without orbax each tag is one .npz keyed by tree path; restore
        rebuilds the template's structure, or nested dicts without one."""
        tree = {
            "a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "nested": {"b": np.asarray(3), "c": jnp.ones((2,), jnp.bfloat16)},
        }
        cm = CheckpointManager(str(tmp_path / "ck"), use_orbax=False)
        cm.save("latest", tree)
        assert cm.has("latest")
        assert os.path.exists(str(tmp_path / "ck" / "latest.npz"))
        back = cm.restore("latest", tree)
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            assert np.asarray(x).dtype == np.asarray(y).dtype
        raw = cm.restore("latest")
        np.testing.assert_array_equal(raw["nested"]["b"], 3)
        assert cm.restore("missing") is None

    def test_train_state_npz_roundtrip(self, tmp_path, gen, tokenizer):
        """A trained TrainState (params, Adam state, step) survives the
        .npz fallback and keeps training."""
        from sessionsimilaritysearch.data.graph import batch_graphs
        from sessionsimilaritysearch.training.pretrain import (
            create_pretrain_state,
            make_train_step,
        )

        cfg = tiny_test_config()
        graphs = [
            sequence_to_graph(i, *d, tokenizer, cfg.dims)
            for i, d in enumerate(gen.dataset(4))
        ]
        batch = jax.tree.map(jnp.asarray, batch_graphs(graphs))
        rng = jax.random.PRNGKey(0)
        model, state = create_pretrain_state(cfg, rng, batch)
        step = make_train_step(model, has_view=False)
        state, _ = step(state, batch, rng)

        cm = CheckpointManager(str(tmp_path / "ck"), use_orbax=False)
        cm.save("latest", state_to_tree(state))
        _, fresh = create_pretrain_state(cfg, rng, batch)
        restored = tree_to_state(
            fresh, cm.restore("latest", state_to_tree(fresh))
        )
        assert int(restored.step) == 1
        for a, b in zip(jax.tree.leaves((state.params, state.opt_state)),
                        jax.tree.leaves((restored.params,
                                         restored.opt_state))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        _, m = step(restored, batch, rng)
        assert np.isfinite(float(m["loss"]))

    def test_train_state_is_a_pytree(self):
        """TrainState flattens to step, params, opt_state and batch_stats;
        apply_fn and tx are static, so jit takes it whole and returns it
        with the same static parts."""
        import optax

        from sessionsimilaritysearch.training.train_state import TrainState

        params = {"w": jnp.arange(3.0), "b": jnp.zeros(())}
        tx = optax.sgd(0.5)
        apply_fn = lambda p, x: p["w"] * x + p["b"]  # noqa: E731
        state = TrainState.create(apply_fn=apply_fn, params=params, tx=tx,
                                  batch_stats={"m": jnp.ones(2)})
        leaves, treedef = jax.tree.flatten(state)
        assert len(leaves) == 1 + 2 + len(jax.tree.leaves(tx.init(params))) + 1
        back = jax.tree.unflatten(treedef, leaves)
        assert back.apply_fn is apply_fn and back.tx is tx

        @jax.jit
        def train(s):
            g = jax.grad(lambda p: s.apply_fn(p, 2.0).sum())(s.params)
            return s.apply_gradients(grads=g)

        new = train(state)
        assert int(new.step) == 1 and new.tx is tx
        np.testing.assert_allclose(np.asarray(new.params["w"]),
                                   np.arange(3.0) - 1.0)
        np.testing.assert_allclose(float(new.params["b"]), -1.5)
        np.testing.assert_array_equal(np.asarray(new.batch_stats["m"]), 1.0)

    def test_train_state_roundtrip(self, tmp_path, gen, tokenizer):
        from sessionsimilaritysearch.data.graph import batch_graphs
        from sessionsimilaritysearch.training.pretrain import (
            create_pretrain_state,
            make_train_step,
        )

        cfg = tiny_test_config()
        graphs = [
            sequence_to_graph(i, *d, tokenizer, cfg.dims)
            for i, d in enumerate(gen.dataset(4))
        ]
        batch = jax.tree.map(jnp.asarray, batch_graphs(graphs))
        rng = jax.random.PRNGKey(0)
        model, state = create_pretrain_state(cfg, rng, batch)
        step = make_train_step(model, has_view=False)
        state, _ = step(state, batch, rng)

        cm = CheckpointManager(str(tmp_path / "ck"))
        cm.save("latest", state_to_tree(state))
        model2, state2 = create_pretrain_state(cfg, rng, batch)
        restored = tree_to_state(
            state2, cm.restore("latest", state_to_tree(state2))
        )
        assert int(restored.step) == 1
        a = jax.tree.leaves(state.params)[0]
        b = jax.tree.leaves(restored.params)[0]
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))
        # restored state can keep training
        restored, m = step(restored, batch, rng)
        assert np.isfinite(float(m["loss"]))


class TestLoggingProfiling:
    def test_metric_logger(self, tmp_path):
        p = str(tmp_path / "m.jsonl")
        ml = MetricLogger(p)
        ml.log(1, loss=0.5)
        ml.log(2, loss=0.25, recall=0.9)
        ml.close()
        rows = read_metrics(p)
        assert rows[0]["loss"] == 0.5 and rows[1]["recall"] == 0.9

    def test_rundir_snapshot(self, tmp_path, tiny_cfg):
        rd = RunDir(str(tmp_path / "run"), tiny_cfg)
        assert os.path.exists(rd.file("config.json"))
        with open(rd.file("config.json")) as f:
            assert json.load(f)["asin_num"] == tiny_cfg.asin_num

    def test_phase_timer(self):
        t = PhaseTimer()
        out = t.timed("op", lambda: jnp.ones(4) * 2)
        assert float(out[0]) == 2.0
        s = t.summary()
        assert s["op"]["count"] == 1 and s["op"]["total_s"] >= 0


class TestTrainingLoop:
    def test_loop_with_resume(self, tmp_path, gen, tokenizer):
        from sessionsimilaritysearch.training.loop import run_training
        from sessionsimilaritysearch.training.pretrain import (
            create_pretrain_state,
            make_eval_step,
            make_train_step,
        )
        from sessionsimilaritysearch.data.graph import batch_graphs

        cfg = tiny_test_config()
        data = gen.dataset(8)
        loader = SessionGraphLoader(
            data, tokenizer, cfg.dims, 4, seed=0, prefetch=0
        )
        rng = jax.random.PRNGKey(0)
        sample = jax.tree.map(
            jnp.asarray,
            batch_graphs([
                sequence_to_graph(i, *d, tokenizer, cfg.dims)
                for i, d in enumerate(data[:4])
            ]),
        )
        model, state = create_pretrain_state(cfg, rng, sample)
        ckpt = CheckpointManager(str(tmp_path / "ck"))
        rd = RunDir(str(tmp_path / "run"), cfg)
        state, best = run_training(
            state=state,
            step_fn=make_train_step(model, has_view=False),
            eval_fn=make_eval_step(model),
            train_loader=loader,
            valid_loader=loader,
            epochs=1,
            rng=rng,
            rundir=rd,
            ckpt=ckpt,
        )
        assert int(state.step) == 2
        assert np.isfinite(best)
        # resume continues from the saved step
        model2, fresh = create_pretrain_state(cfg, rng, sample)
        resumed, _ = run_training(
            state=fresh,
            step_fn=make_train_step(model2, has_view=False),
            train_loader=loader,
            epochs=1,
            rng=rng,
            ckpt=ckpt,
            resume=True,
        )
        assert int(resumed.step) == 4


class TestContrastiveViewLoader:
    def test_pairs(self, gen, tokenizer, tiny_cfg):
        from sessionsimilaritysearch.data.augment import (
            random_exchange_order,
        )
        from sessionsimilaritysearch.data.loader import (
            ContrastiveViewLoader,
            SessionGraphLoader,
        )

        from sessionsimilaritysearch.data.synthetic import (
            SyntheticSessionGenerator,
        )

        own = SyntheticSessionGenerator(asin_num=tiny_cfg.asin_num, seed=13)
        base = SessionGraphLoader(
            own.dataset(8), tokenizer, tiny_cfg.dims, 4, seed=1, prefetch=0
        )
        cv = ContrastiveViewLoader(base, random_exchange_order, seed=2)
        batch, view = next(iter(cv))
        np.testing.assert_array_equal(batch.idx, view.idx)  # same sessions
        assert batch.query_input_ids.shape == view.query_input_ids.shape
        # views differ structurally for at least one session
        assert not np.array_equal(batch.adj_pp, view.adj_pp) or not np.array_equal(
            batch.query_pos, view.query_pos
        )


class TestNanRecovery:
    def test_rollback_on_nan(self, tmp_path, gen, tokenizer):
        """A poisoned batch must not corrupt the state."""
        from sessionsimilaritysearch.training.loop import run_training
        from sessionsimilaritysearch.training.pretrain import (
            create_pretrain_state,
            make_train_step,
        )
        from sessionsimilaritysearch.data.graph import batch_graphs

        cfg = tiny_test_config()
        data = gen.dataset(4)
        graphs = [
            sequence_to_graph(i, *d, tokenizer, cfg.dims)
            for i, d in enumerate(data)
        ]
        good = jax.tree.map(jnp.asarray, batch_graphs(graphs))
        rng = jax.random.PRNGKey(0)
        model, state = create_pretrain_state(cfg, rng, good)
        base_step = make_train_step(model, has_view=False)

        calls = {"n": 0}

        def step(state, batch, rng):
            calls["n"] += 1
            if calls["n"] == 2:  # poison the second step
                s2, m = base_step(state, batch, rng)
                m = dict(m)
                m["loss"] = jnp.asarray(float("nan"))
                return s2, m
            return base_step(state, batch, rng)

        final, _ = run_training(
            state=state,
            step_fn=step,
            train_loader=[good, good, good],
            epochs=1,
            rng=rng,
        )
        # 3 batches, one rolled back -> step counter advanced by jitted
        # steps but parameters remain finite
        leaves = jax.tree.leaves(final.params)
        assert all(np.isfinite(np.asarray(l)).all() for l in leaves)


class TestSanitizers:
    """utils.sanitize: the SURVEY §5 replacements for the reference's
    in-module assert storm (model/model.py:223-247 NaN asserts,
    pretrain_filtered_amazon.py:344 detect_anomaly)."""

    def test_train_step_clean_under_debug_nans(self, gen, tokenizer):
        """The real pretrain step produces no NaNs with NaN trapping on."""
        from sessionsimilaritysearch.data.graph import batch_graphs
        from sessionsimilaritysearch.training.pretrain import (
            create_pretrain_state,
            make_train_step,
        )
        from sessionsimilaritysearch.utils.sanitize import debug_nans

        cfg = tiny_test_config()
        data = gen.dataset(4)
        batch = jax.tree.map(
            jnp.asarray,
            batch_graphs([
                sequence_to_graph(i, *d, tokenizer, cfg.dims)
                for i, d in enumerate(data)
            ]),
        )
        rng = jax.random.PRNGKey(0)
        model, state = create_pretrain_state(cfg, rng, batch)
        step = make_train_step(model, has_view=False)
        with debug_nans():
            state, m = step(state, batch, rng)
            jax.block_until_ready(m["loss"])
        assert np.isfinite(float(m["loss"]))

    def test_debug_nans_traps(self):
        from sessionsimilaritysearch.utils.sanitize import debug_nans

        @jax.jit
        def bad(x):
            return jnp.log(x)  # log(0) = -inf... log(-1) = nan

        with debug_nans():
            with pytest.raises(FloatingPointError):
                jax.block_until_ready(bad(jnp.asarray(-1.0)))
        # outside the scope the config is restored: no raise
        assert np.isnan(np.asarray(bad(jnp.asarray(-1.0))))

    def test_assert_pure_passes_and_catches(self):
        from sessionsimilaritysearch.utils.sanitize import assert_pure

        @jax.jit
        def pure(x):
            return x * 2.0 + 1.0

        assert_pure(pure, jnp.arange(4.0))

        counter = {"n": 0}

        def impure(x):
            counter["n"] += 1
            return np.asarray(x) * counter["n"]

        with pytest.raises(AssertionError):
            assert_pure(impure, jnp.arange(4.0))

    def test_train_step_is_pure(self, gen, tokenizer):
        """Two identical train-step calls produce bit-identical states --
        the functional-path race/impurity check."""
        from sessionsimilaritysearch.data.graph import batch_graphs
        from sessionsimilaritysearch.training.pretrain import (
            create_pretrain_state,
            make_train_step,
        )
        from sessionsimilaritysearch.utils.sanitize import assert_pure

        cfg = tiny_test_config()
        data = gen.dataset(4)
        batch = jax.tree.map(
            jnp.asarray,
            batch_graphs([
                sequence_to_graph(i, *d, tokenizer, cfg.dims)
                for i, d in enumerate(data)
            ]),
        )
        rng = jax.random.PRNGKey(0)
        model, state = create_pretrain_state(cfg, rng, batch)
        step = make_train_step(model, has_view=False)
        assert_pure(lambda: step(state, batch, rng)[1]["loss"])

    def test_assert_donates(self):
        from sessionsimilaritysearch.index.dense import _write_rows
        from sessionsimilaritysearch.utils.sanitize import (
            assert_donates,
        )

        buf = jnp.zeros((16, 4))
        rows = jnp.ones((2, 4))
        out = assert_donates(_write_rows, buf, rows, jnp.asarray(0, jnp.int32))
        assert np.asarray(out)[0, 0] == 1.0

        @jax.jit  # no donate_argnums: donation is "silently ignored"
        def no_donate(b, r):
            return b + 0.0

        with pytest.raises(AssertionError):
            assert_donates(no_donate, jnp.zeros((8, 4)), rows)


class TestYoochooseFormat:
    def test_item_sequences_roundtrip(self):
        from sessionsimilaritysearch.data import schema
        from sessionsimilaritysearch.data.etl import (
            sessions_from_item_sequences,
        )

        sessions = sessions_from_item_sequences([[3, 7, 3], [9]])
        assert schema.get_item(sessions[0]) == {3, 7}
        assert schema.get_item(sessions[1]) == {9}
        assert all(a.action_type == "c" for a in sessions[0])


class TestPrecision:
    def test_cast_floats(self):
        import jax.numpy as jnp

        from sessionsimilaritysearch.utils.precision import serving_params

        tree = {"w": jnp.ones((2, 2), jnp.float32), "ids": jnp.ones(3, jnp.int32)}
        out = serving_params(tree)
        assert out["w"].dtype == jnp.bfloat16
        assert out["ids"].dtype == jnp.int32

    def test_encoder_runs_with_bf16_params(self, gen, tokenizer, tiny_cfg):
        import jax
        import jax.numpy as jnp

        from sessionsimilaritysearch.data.graph import (
            batch_graphs,
            sequence_to_graph,
        )
        from sessionsimilaritysearch.models import build_graph_encoder
        from sessionsimilaritysearch.utils.precision import serving_params

        enc = build_graph_encoder(tiny_cfg)
        batch = jax.tree.map(
            jnp.asarray,
            batch_graphs([
                sequence_to_graph(i, *d, tokenizer, tiny_cfg.dims)
                for i, d in enumerate(gen.dataset(4))
            ]),
        )
        params = enc.init(jax.random.PRNGKey(0), batch)
        emb32 = enc.apply(params, batch)
        emb16 = enc.apply(serving_params(params), batch)
        assert np.isfinite(np.asarray(emb16)).all()
        # bf16 serving stays close to the f32 embedding direction
        a = np.asarray(emb32, np.float32)
        b = np.asarray(emb16, np.float32)
        cos = np.sum(a * b, 1) / (
            np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1) + 1e-9
        )
        assert cos.min() > 0.98


class TestWorkerLoader:
    def test_workers_match_serial(self, gen, tokenizer, tiny_cfg):
        data = gen.dataset(12)
        serial = SessionGraphLoader(
            data, tokenizer, tiny_cfg.dims, 4, shuffle=False, prefetch=0,
            cache=False,
        )
        parallel = SessionGraphLoader(
            data, tokenizer, tiny_cfg.dims, 4, shuffle=False, prefetch=0,
            cache=False, workers=2,
        )
        try:
            for b1, b2 in zip(serial, parallel):
                np.testing.assert_array_equal(b1.idx, b2.idx)
                np.testing.assert_array_equal(
                    b1.query_input_ids, b2.query_input_ids
                )
                np.testing.assert_array_equal(b1.adj_pp, b2.adj_pp)
        finally:
            parallel.close()

    def test_workers_disabled_with_transform(self, gen, tokenizer, tiny_cfg):
        loader = SessionGraphLoader(
            gen.dataset(4), tokenizer, tiny_cfg.dims, 4,
            transform=lambda d, r: d, workers=4, cache=False, prefetch=0,
        )
        assert loader.workers == 0


class TestShardedCheckpoint:
    def test_sharded_save_restore_no_gather(self, tmp_path):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from sessionsimilaritysearch.parallel import create_mesh
        from sessionsimilaritysearch.utils.checkpoint import (
            restore_sharded,
            save_sharded,
        )

        mesh = create_mesh()
        sh2 = NamedSharding(mesh, P("data", None))
        sh1 = NamedSharding(mesh, P("data"))
        tree = {
            "buf": jax.device_put(
                jnp.arange(16 * 4, dtype=jnp.float32).reshape(16, 4), sh2
            ),
            "ids": jax.device_put(jnp.arange(16, dtype=jnp.int32), sh1),
            "step": np.asarray(7),
            "replicated": jnp.ones((3,), jnp.float32),  # not sharded
        }
        d = str(tmp_path / "sck")
        save_sharded(d, tree)
        # template: same structure, zeros, same shardings
        template = {
            "buf": jax.device_put(jnp.zeros((16, 4), jnp.float32), sh2),
            "ids": jax.device_put(jnp.zeros((16,), jnp.int32), sh1),
            "step": np.asarray(0),
            "replicated": jnp.zeros((3,), jnp.float32),
        }
        out = restore_sharded(d, template)
        np.testing.assert_array_equal(np.asarray(out["buf"]),
                                      np.asarray(tree["buf"]))
        np.testing.assert_array_equal(np.asarray(out["ids"]),
                                      np.asarray(tree["ids"]))
        assert int(out["step"]) == 7
        np.testing.assert_array_equal(np.asarray(out["replicated"]),
                                      np.ones(3))
        # restored leaves carry the template's sharding (no host gather)
        assert out["buf"].sharding == sh2

        # mismatched shard boundaries are rejected, not silently wrong
        import pytest as _pytest

        bad_sh = NamedSharding(mesh, P())  # replicated: full-box per device
        bad = dict(template)
        bad["buf"] = jax.device_put(jnp.zeros((16, 4), jnp.float32), bad_sh)
        with _pytest.raises(AssertionError):
            restore_sharded(d, bad)

    def test_sharded_index_roundtrip_via_sharded_ckpt(self, tmp_path, rng):
        """ShardedDenseIndex state round-trips shard-by-shard: search
        results identical after restore."""
        import jax
        import jax.numpy as jnp

        from sessionsimilaritysearch.index.sharded import (
            ShardedDenseIndex,
        )
        from sessionsimilaritysearch.parallel import create_mesh
        from sessionsimilaritysearch.utils.checkpoint import (
            restore_sharded,
            save_sharded,
        )

        mesh = create_mesh()
        idx = ShardedDenseIndex(dim=16, capacity=64, mesh=mesh)
        emb = rng.standard_normal((32, 16)).astype(np.float32)
        idx.add(emb)
        idx.remove_ids([3, 17])  # diverge per-shard fills: the state the
        # old raw _buf/_ids poke silently lost
        d1, i1 = idx.search(emb[:5], 3)

        d = str(tmp_path / "ick")
        save_sharded(d, idx.state_dict())
        fresh = ShardedDenseIndex(dim=16, capacity=64, mesh=mesh)
        fresh.load_state(restore_sharded(d, fresh.state_dict()))
        d2, i2 = fresh.search(emb[:5], 3)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(d1, d2, atol=1e-6)
        # removal bookkeeping round-trips too: a follow-up remove works
        assert fresh.remove_ids([i1[4, 0]]) == 1
