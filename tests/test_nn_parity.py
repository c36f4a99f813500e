"""The in-repo module layer (sessionsimilaritysearch/nn.py) against Flax
linen, where Flax is installed: the same model source run under both must
give identical parameter trees (paths, shapes, initial values) and
identical forward outputs from the same parameters."""

import contextlib
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

_MODEL_MODULES = [
    "sessionsimilaritysearch.models.transformer",
    "sessionsimilaritysearch.models.embedding",
    "sessionsimilaritysearch.models.gnn",
    "sessionsimilaritysearch.models.pooling",
    "sessionsimilaritysearch.models.heads",
    "sessionsimilaritysearch.models.encoder",
    "sessionsimilaritysearch.training.pretrain",
    "sessionsimilaritysearch.training.session_trainers",
]


@contextlib.contextmanager
def flax_models():
    """Re-import the model modules with ``nn`` bound to flax.linen; yields
    {module name: flax-backed module} and restores the originals."""
    linen = pytest.importorskip("flax.linen")
    import sessionsimilaritysearch as pkg

    own_nn = sys.modules["sessionsimilaritysearch.nn"]
    for n in _MODEL_MODULES:
        importlib.import_module(n)
    saved = {n: sys.modules.pop(n) for n in _MODEL_MODULES}
    pkg.nn = linen
    sys.modules["sessionsimilaritysearch.nn"] = linen
    try:
        yield {n: importlib.import_module(n) for n in _MODEL_MODULES}
    finally:
        pkg.nn = own_nn
        sys.modules["sessionsimilaritysearch.nn"] = own_nn
        for n, mod in saved.items():
            sys.modules[n] = mod
            parent, _, attr = n.rpartition(".")
            setattr(sys.modules[parent], attr, mod)


def _paths(tree):
    return {
        jax.tree_util.keystr(p): (v.shape, v.dtype)
        for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _assert_same_tree(a, b):
    assert _paths(a) == _paths(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture(scope="module")
def graph_batch(tiny_cfg, tokenizer):
    from sessionsimilaritysearch.data import (
        SyntheticSessionGenerator,
        build_graph_batch,
    )

    data = SyntheticSessionGenerator(asin_num=tiny_cfg.asin_num,
                                     seed=2).dataset(6)
    return jax.tree.map(
        jnp.asarray, build_graph_batch(data, tokenizer, tiny_cfg.dims)
    )


def test_graph_encoder_matches_flax(tiny_cfg, graph_batch):
    from sessionsimilaritysearch.models import encoder as own

    key = jax.random.PRNGKey(3)
    own_model = own.build_graph_encoder(tiny_cfg)
    own_vars = own_model.init(key, graph_batch)
    with flax_models() as fm:
        ref_model = fm["sessionsimilaritysearch.models.encoder"] \
            .build_graph_encoder(tiny_cfg)
        ref_vars = ref_model.init(key, graph_batch)
        ref_out = ref_model.apply(ref_vars, graph_batch)
    _assert_same_tree(own_vars, ref_vars)
    np.testing.assert_array_equal(
        np.asarray(own_model.apply(ref_vars, graph_batch)),
        np.asarray(ref_out),
    )


def test_pretrain_model_matches_flax(tiny_cfg, graph_batch):
    from sessionsimilaritysearch.training import pretrain as own

    key = jax.random.PRNGKey(4)
    own_model = own.PretrainModel(tiny_cfg)
    own_vars = own_model.init(key, graph_batch, key, deterministic=True)
    with flax_models() as fm:
        ref_model = fm["sessionsimilaritysearch.training.pretrain"] \
            .PretrainModel(tiny_cfg)
        ref_vars = ref_model.init(key, graph_batch, key, deterministic=True)
        # training mode: dropout streams and BatchNorm statistics too
        (ref_loss, ref_m), ref_upd = ref_model.apply(
            ref_vars, graph_batch, key, deterministic=False,
            mutable=["batch_stats"], rngs={"dropout": key},
        )
        ref_emb = ref_model.apply(ref_vars, graph_batch, method="encode")
    _assert_same_tree(own_vars, ref_vars)
    (loss, m), upd = own_model.apply(
        ref_vars, graph_batch, key, deterministic=False,
        mutable=["batch_stats"], rngs={"dropout": key},
    )
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    _assert_same_tree(upd, ref_upd)
    np.testing.assert_array_equal(
        np.asarray(own_model.apply(ref_vars, graph_batch, method="encode")),
        np.asarray(ref_emb),
    )


def test_session_trainer_matches_flax(tiny_cfg, graph_batch):
    from sessionsimilaritysearch.training import session_trainers as own

    key = jax.random.PRNGKey(5)
    own_model = own.SessionEmbeddingModel(tiny_cfg, mode="session")
    own_vars = own_model.init(key, graph_batch, key, deterministic=True)
    with flax_models() as fm:
        ref_model = fm["sessionsimilaritysearch.training.session_trainers"] \
            .SessionEmbeddingModel(tiny_cfg, mode="session")
        ref_vars = ref_model.init(key, graph_batch, key, deterministic=True)
        ref_loss, _ = ref_model.apply(
            ref_vars, graph_batch, key, deterministic=False,
            mutable=["batch_stats"], rngs={"dropout": key},
        )[0]
    _assert_same_tree(own_vars, ref_vars)
    loss, _ = own_model.apply(
        ref_vars, graph_batch, key, deterministic=False,
        mutable=["batch_stats"], rngs={"dropout": key},
    )[0]
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
