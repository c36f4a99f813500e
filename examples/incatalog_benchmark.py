"""In-catalog retrieval quality benchmark: trained encoder vs sparse
baselines vs hybrid fusion.

In-catalog (shared product catalog between corpus and queries) is SKNN's
home turf: the synthetic type clusters correlate perfectly with item
overlap, which is the exact signal SKNN matches on
(reference: test_amazon_filterd.py:48-57). The hybrid mode
(evalharness.harness.evaluate_hybrid) fuses the learned embedding cosine
with that overlap cosine, so it dominates both single systems here AND
keeps the encoder's out-of-catalog generalization
(examples/generalization_benchmark.py).

Run: python examples/incatalog_benchmark.py [--epochs 30] [--platform cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from sessionsimilaritysearch.config import tiny_test_config
from sessionsimilaritysearch.data import SyntheticSessionGenerator
from sessionsimilaritysearch.data.augment import random_exchange_order
from sessionsimilaritysearch.data.loader import (
    ContrastiveViewLoader,
    SessionGraphLoader,
)
from sessionsimilaritysearch.data.similarity import get_ave_score
from sessionsimilaritysearch.evalharness.harness import (
    evaluate_hybrid,
    evaluate_sparse,
)
from sessionsimilaritysearch.index import build_index
from sessionsimilaritysearch.tokenizer import get_tokenizer
from sessionsimilaritysearch.training.pretrain import (
    PretrainModel,
    make_encode_fn,
    make_train_step,
)
from sessionsimilaritysearch.training.train_state import (
    adam_with_clip,
    create_train_state,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--corpus", type=int, default=2000)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    args = ap.parse_args()
    from sessionsimilaritysearch.runtime import (
        enable_compile_cache,
        force_platform,
    )

    if args.platform:
        force_platform(args.platform)
    enable_compile_cache()

    cfg = tiny_test_config(
        asin_num=1600, gnn_nout=64, gnn_nhid=64, emb_len=48,
        text_encoder_dim=64, batch_size=64, ctv_w=0.5,
    )
    gen = SyntheticSessionGenerator(asin_num=1600, n_types=10, seed=5)
    corpus_data = gen.dataset(args.corpus)
    test_data = gen.dataset(args.queries)

    tok = get_tokenizer(cfg.vocab_size)
    base = SessionGraphLoader(corpus_data, tok, cfg.dims, cfg.batch_size,
                              seed=0, prefetch=4)
    loader = ContrastiveViewLoader(base, random_exchange_order, seed=1)
    rng = jax.random.PRNGKey(0)
    b0, v0 = next(iter(loader))
    sample = jax.tree.map(jnp.asarray, b0)
    model = PretrainModel(cfg)
    state = create_train_state(
        model, rng, (sample, rng), adam_with_clip(cfg.lr),
        init_kwargs={"view_graph": sample, "deterministic": True},
    )
    step = make_train_step(model, has_view=True)
    encode = make_encode_fn(model)

    def embed_all(state, data):
        out = []
        ld = SessionGraphLoader(data, tok, cfg.dims, cfg.batch_size,
                                shuffle=False, prefetch=2, cache=False)
        for b in ld:
            out.append(np.asarray(encode(state, jax.tree.map(jnp.asarray, b))))
        return np.concatenate(out)[: len(data)]

    def dense_quality(state, tag, k=10):
        ce = embed_all(state, [(d[0], []) for d in corpus_data])
        qe = embed_all(state, test_data)
        idx = build_index(ce, metric="cos")
        _, I = idx.search(qe, k)
        s = get_ave_score(I, test_data, [d[0] for d in corpus_data],
                          "all_product_type_score")
        print(f"{tag}: ave type score@{k} = {s:.3f}")
        return s

    dense_quality(state, "encoder untrained")
    t0 = time.time()
    m = {}
    for epoch in range(args.epochs):
        for b, v in loader:
            rng, sub = jax.random.split(rng)
            state, m = step(state, jax.tree.map(jnp.asarray, b), sub,
                            jax.tree.map(jnp.asarray, v))
    print(f"trained {args.epochs} epochs in {time.time() - t0:.0f}s, "
          f"loss {float(m['loss']):.3f}")
    dense_quality(state, "encoder trained")

    for kind, name in (("binary", "SKNN"), ("stan", "STAN")):
        res = evaluate_sparse(cfg, [d[0] for d in corpus_data], test_data,
                              kind=kind, k=10)
        print(f"{name}: {res.report['ave_all_product_type_score']:.3f}")

    enc_fn = lambda g: encode(state, g)
    res = evaluate_hybrid(cfg, tok, enc_fn,
                          [(d[0], []) for d in corpus_data], test_data,
                          k=10, alpha=args.alpha, batch_size=cfg.batch_size)
    print(f"hybrid (alpha={args.alpha}): "
          f"{res.report['ave_all_product_type_score']:.3f}")


if __name__ == "__main__":
    main()
