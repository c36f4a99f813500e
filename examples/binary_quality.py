"""Trained binary-code quality: dense cosine vs 250-bit Hamming serving on
the SAME encoder embeddings.

The reference's hashing serve path (fine_tune_ours.py:748-897) fine-tunes
BinarizeHeads over frozen session embeddings, packs sign codes, and serves
with faiss.IndexBinaryFlat — reporting the ave similarity of the Hamming
top-k next to the dense top-k. This reproduces that comparison end-to-end
here: train an encoder, fine-tune 250-bit hash heads (alternating towers,
triplet + pair losses, training/finetune.py), then retrieve the same query
set three ways — dense cosine, UNTRAINED codes, TRAINED codes — and report
``ave_all_product_type_score``@k for each plus Hamming QPS.

Run (GPU): python examples/binary_quality.py
Smoke:     python examples/binary_quality.py --platform cpu --corpus 800 \
               --train 300 --queries 40 --epochs 2 --ft-epochs 2 --bits 32
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
from sessionsimilaritysearch.data.similarity import get_ave_score, mine_triplets
from sessionsimilaritysearch.evalharness.harness import (
    EmbeddingPipeline,
    evaluate_binary,
)
from sessionsimilaritysearch.index import build_index
from sessionsimilaritysearch.tokenizer import get_tokenizer
from sessionsimilaritysearch.training.finetune import (
    build_triplet_batches,
    create_finetune_state,
    make_code_fns,
    make_finetune_step,
)
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
    ap.add_argument("--corpus", type=int, default=20_000)
    ap.add_argument("--train", type=int, default=3000)
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--ft-epochs", type=int, default=20)
    ap.add_argument("--bits", type=int, default=250)
    ap.add_argument("--triplets", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--types", type=int, default=25)
    ap.add_argument("--asins", type=int, default=8000)
    ap.add_argument("--seed", type=int, default=0)
    # encoder width: session_emb_dim = 2*gnn_nout. The r2 study ran at
    # gnn_nout=64 => 128-d sessions, where 250-bit codes are an EXPANSION
    # and every code construction trivially preserves the geometry.
    # --flagship sets the reference's real operating point:
    # 800/768 => 1600-d sessions, a genuine 6.4:1 compression to 250 bits
    # (model/model.py:254 with config.py:4,16).
    ap.add_argument("--flagship", action="store_true")
    ap.add_argument("--gnn-nout", type=int, default=64)
    ap.add_argument("--gnn-nhid", type=int, default=64)
    ap.add_argument("--emb-len", type=int, default=48)
    ap.add_argument("--text-dim", type=int, default=64)
    ap.add_argument("--regime", default="clustered",
                    choices=["clustered", "adversarial"])
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    args = ap.parse_args()
    from sessionsimilaritysearch.runtime import (
        enable_compile_cache,
        force_platform,
    )

    if args.platform:
        force_platform(args.platform)
    enable_compile_cache()
    if args.flagship:
        args.gnn_nout = args.gnn_nhid = 800
        args.text_dim = 768
        args.emb_len = 200

    cfg = tiny_test_config(
        asin_num=args.asins, gnn_nout=args.gnn_nout, gnn_nhid=args.gnn_nhid,
        emb_len=args.emb_len, text_encoder_dim=args.text_dim,
        batch_size=64, ctv_w=0.5, code_len=args.bits,
    )
    if args.regime == "adversarial":
        from sessionsimilaritysearch.data import (
            AdversarialSessionGenerator,
        )

        gen = AdversarialSessionGenerator(asin_num=args.asins,
                                          seed=args.seed)
    else:
        gen = SyntheticSessionGenerator(asin_num=args.asins,
                                        n_types=args.types, seed=args.seed)
    corpus_data = gen.dataset(args.corpus)
    test_data = gen.dataset(args.queries)
    mine_data = gen.dataset(args.triplets * 2)
    corpus_sessions = [d[0] for d in corpus_data]
    tok = get_tokenizer(cfg.vocab_size)
    print(f"session_emb_dim={cfg.session_emb_dim} -> {args.bits} bits "
          f"(compression {cfg.session_emb_dim/args.bits:.1f}:1), "
          f"regime={args.regime}", flush=True)

    # --- 1. train the session encoder (contrastive pretrain objective)
    base = SessionGraphLoader(corpus_data[: args.train], tok, cfg.dims,
                              cfg.batch_size, seed=args.seed, prefetch=4)
    loader = ContrastiveViewLoader(base, random_exchange_order,
                                   seed=args.seed + 1)
    rng = jax.random.PRNGKey(args.seed)
    b0, _ = next(iter(loader))
    sample = jax.tree.map(jnp.asarray, b0)
    model = PretrainModel(cfg)
    state = create_train_state(
        model, rng, (sample, rng), adam_with_clip(cfg.lr),
        init_kwargs={"view_graph": sample, "deterministic": True},
    )
    step = make_train_step(model, has_view=True)
    encode = make_encode_fn(model)
    t0 = time.time()
    for _ in range(args.epochs):
        for b, v in loader:
            rng, sub = jax.random.split(rng)
            state, _ = step(state, jax.tree.map(jnp.asarray, b), sub,
                            jax.tree.map(jnp.asarray, v))
    print(f"encoder trained: {args.epochs} epochs, {time.time()-t0:.0f}s")

    pipe = EmbeddingPipeline(cfg, tok, lambda g: encode(state, g),
                             cfg.batch_size)
    ce = pipe([(s, []) for s in corpus_sessions])
    qe = pipe(test_data)

    # effective dimensionality of the embeddings (participation ratio of
    # the covariance spectrum): the honest context for any "X% retained at
    # B bits" claim -- random projections preserve a low-effective-rank
    # cloud far more easily than a full-rank one
    cen = ce - ce.mean(0, keepdims=True)
    sv = np.linalg.svd(cen[: min(len(cen), 8192)], compute_uv=False)
    lam = sv.astype(np.float64) ** 2
    pr = float(lam.sum() ** 2 / (lam**2).sum())
    top = lam / lam.sum()
    print(f"embedding spectrum: dim={ce.shape[1]} "
          f"participation_ratio={pr:.1f} "
          f"var_top10={top[:10].sum():.3f} var_top50={top[:50].sum():.3f} "
          f"var_top250={top[:250].sum():.4f}", flush=True)

    # --- 2. dense cosine baseline on the same embeddings
    idx = build_index(ce, metric="cos")
    _, I = idx.search(qe, args.k)
    dense_score = get_ave_score(I, test_data, corpus_sessions,
                                "all_product_type_score")

    # --- 3. fine-tune 250-bit hash heads over the frozen embeddings
    triplets = mine_triplets(mine_data, corpus_data[:2000],
                             "all_product_type_score", args.triplets,
                             pos_thresh=0.6, half_lo=0.1)
    print(f"mined {len(triplets)} triplets")
    ft_model, ft_state, tx = create_finetune_state(
        cfg, jax.random.PRNGKey(args.seed + 7), emb_dim=ce.shape[1],
        shared_init=True,  # start at LSH quality, train upward
    )
    db_fn, q_fn = make_code_fns(ft_model)
    code_db0 = np.asarray(db_fn(ft_state, jnp.asarray(ce)))
    code_q0 = np.asarray(q_fn(ft_state, jnp.asarray(qe)))

    step_fn = make_finetune_step(ft_model, tx, cfg)
    batches = build_triplet_batches(
        triplets, pipe, [(q[0], q[0]) for q in mine_data[:64]],
        min(32, max(4, len(triplets) // 4)), np.random.default_rng(args.seed),
    )
    t0 = time.time()
    m = {}
    for _ in range(args.ft_epochs):
        for b in batches():
            ft_state, m = step_fn(ft_state, b)
    print(f"hash heads trained: {args.ft_epochs} epochs, {time.time()-t0:.0f}s"
          f" (loss {float(m.get('loss', float('nan'))):.4f})")

    # --- 4. Hamming serving: untrained vs trained vs learned-projection
    # codes. 'binary ITQ' is the gradient-free learned construction
    # (ops.projection.fit_itq: center + PCA + balanced rotation fitted on
    # the CORPUS codes only — no labels, no triplets); on cone-collapsed
    # spectra it is the strongest code family because random hyperplanes
    # spend their bits on the shared mean direction.
    from sessionsimilaritysearch.ops.hamming import simhash_codes
    from sessionsimilaritysearch.ops.projection import fit_itq, itq_codes

    lsh_db = simhash_codes(ce, args.bits, seed=args.seed)
    lsh_q = simhash_codes(qe, args.bits, seed=args.seed)
    itq_bits = min(args.bits, ce.shape[1])
    itq_proj = fit_itq(ce, itq_bits, seed=args.seed)
    rows = [("dense cosine", dense_score, None)]
    for tag, db_c, q_c in (
        ("binary untrained", code_db0, code_q0),
        ("binary LSH (simhash)", lsh_db, lsh_q),
        (f"binary ITQ ({itq_bits}b)",
         itq_codes(ce, itq_proj), itq_codes(qe, itq_proj)),
        ("binary trained",
         np.asarray(db_fn(ft_state, jnp.asarray(ce))),
         np.asarray(q_fn(ft_state, jnp.asarray(qe)))),
    ):
        res = evaluate_binary(db_c, q_c, corpus_sessions, test_data,
                              k=args.k, mode="sign")
        rows.append((tag, res.report["ave_all_product_type_score"],
                     res.qps))
    print(f"\n=== ave type score@{args.k}, {args.corpus} corpus, "
          f"{args.bits}-bit codes ===")
    for tag, s, qps in rows:
        extra = f"  ({qps:,.0f} qps host-measured)" if qps else ""
        keep = f"  [{100*s/dense_score:.1f}% of dense]" if tag != rows[0][0] else ""
        print(f"{tag:>22}: {s:.4f}{keep}{extra}")


if __name__ == "__main__":
    main()
