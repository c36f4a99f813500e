"""Multi-seed retrieval-quality protocol: encoder vs sparse baselines vs
hybrid, with error bars (quality claims must survive a seed change).

The reference evaluates on filtered-Amazon/Yoochoose
(test_amazon_filterd.py:452-692); no public dump is reachable in this
environment (zero egress), so this is the hardened synthetic protocol:
a LARGE corpus (default 100k sessions) and N independent seeds, where each
seed draws a fresh product catalog, fresh corpus/query sessions, and a
fresh model init. Reported per system: mean +- std of
``ave_all_product_type_score``@10 across seeds (the reference's default
similarity labeler, config.py:61).

Run (GPU): python examples/quality_protocol.py
Smoke:     python examples/quality_protocol.py --platform cpu \
               --seeds 2 --corpus 2000 --train 500 --epochs 2
"""

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from sessionsimilaritysearch.config import tiny_test_config
from sessionsimilaritysearch.data import (
    AdversarialSessionGenerator,
    SyntheticSessionGenerator,
)
from sessionsimilaritysearch.data.augment import random_exchange_order
from sessionsimilaritysearch.data.loader import (
    ContrastiveViewLoader,
    SessionGraphLoader,
)
from sessionsimilaritysearch.data.similarity import get_ave_score
from sessionsimilaritysearch.evalharness import metrics
from sessionsimilaritysearch.evalharness.harness import evaluate_sparse
from sessionsimilaritysearch.index import build_index, sparse as sparse_index
from sessionsimilaritysearch.tokenizer import get_tokenizer
from sessionsimilaritysearch.training.loop import to_device
from sessionsimilaritysearch.training.pretrain import (
    PretrainModel,
    make_encode_fn,
    make_train_step,
)
from sessionsimilaritysearch.training.train_state import (
    adam_with_clip,
    create_train_state,
)


def _keep(d, lo, hi):
    """Session keeps only if every interacted product falls in [lo, hi)."""
    items = [a[-1] for a in (list(d[0]) + list(d[1])) if a[1] != "s"]
    return bool(items) and all(lo <= i < hi for i in items)


def _disjoint_datasets(gen, n_corpus, n_queries, asins):
    """Corpus sessions from catalog half [0, asins/2), query sessions from
    [asins/2, asins) — zero item overlap (the out-of-catalog regime of
    examples/generalization_benchmark.py), same type structure."""
    half = asins // 2
    corpus, queries = [], []
    while len(corpus) < n_corpus or len(queries) < n_queries:
        d = gen.datum()
        if len(corpus) < n_corpus and _keep(d, 0, half):
            corpus.append(d)
        elif len(queries) < n_queries and _keep(d, half, asins):
            queries.append(d)
    return corpus, queries


def run_seed(seed: int, args) -> dict:
    """One full independent trial: fresh catalog, data, and model init."""
    cfg = tiny_test_config(
        asin_num=args.asins, gnn_nout=args.gnn_nout, gnn_nhid=args.gnn_nhid,
        emb_len=args.emb_len, text_encoder_dim=args.text_dim,
        batch_size=64, ctv_w=0.5,
    )
    if args.regime == "adversarial":
        gen = AdversarialSessionGenerator(
            asin_num=args.asins, seed=1000 + seed
        )
    else:
        gen = SyntheticSessionGenerator(
            asin_num=args.asins, n_types=args.types, seed=1000 + seed
        )
    t0 = time.time()
    if args.disjoint:
        corpus_data, test_data = _disjoint_datasets(
            gen, args.corpus, args.queries, args.asins
        )
        c_items = {a[-1] for d in corpus_data
                   for a in list(d[0]) + list(d[1]) if a[1] != "s"}
        q_items = {a[-1] for d in test_data
                   for a in list(d[0]) + list(d[1]) if a[1] != "s"}
        assert not (c_items & q_items), "catalog halves overlap"
    else:
        corpus_data = gen.dataset(args.corpus)
        test_data = gen.dataset(args.queries)
    train_data = corpus_data[: args.train]
    corpus_sessions = [d[0] for d in corpus_data]

    if args.pooling != "srgnn":
        cfg = cfg.replace(product_pooling=args.pooling)
    tok = get_tokenizer(cfg.vocab_size)
    rng = jax.random.PRNGKey(seed)
    if args.encoder == "flagship":
        # the production two-pool encoder (build_graph_encoder) under the
        # subsession objective — the serving configuration of
        # examples/flagship_serving.py, protocol-grade here so pooling
        # variants (Config.product_pooling) get error bars
        from sessionsimilaritysearch.training.session_trainers import (
            create_session_state,
            make_session_train_step,
        )

        loader = SessionGraphLoader(train_data, tok, cfg.dims,
                                    cfg.batch_size, seed=seed, prefetch=4)
        b0 = next(iter(loader))
        sample = to_device(b0)
        model, state = create_session_state(
            cfg, rng, sample, mode="subsession", encoder_kind="flagship"
        )
        step = make_session_train_step(model)
        t_setup = time.time() - t0

        t0 = time.time()
        m = {}
        for _ in range(args.epochs):
            for b in loader:
                rng, sub = jax.random.split(rng)
                state, m = step(state, to_device(b), sub)
        t_train = time.time() - t0

        from sessionsimilaritysearch.models.encoder import (
            build_graph_encoder,
        )
        from sessionsimilaritysearch.utils.precision import (
            serving_params,
        )

        enc_mod = build_graph_encoder(cfg)
        enc_vars = {"params": serving_params(state.params)["encoder"]}
        enc_apply = jax.jit(lambda g: enc_mod.apply(enc_vars, g))

        def encode_batch(b):
            return enc_apply(to_device(b))
    else:
        base = SessionGraphLoader(train_data, tok, cfg.dims, cfg.batch_size,
                                  seed=seed, prefetch=4)
        loader = ContrastiveViewLoader(base, random_exchange_order,
                                       seed=seed + 1)
        b0, _ = next(iter(loader))
        sample = to_device(b0)
        model = PretrainModel(cfg)
        state = create_train_state(
            model, rng, (sample, rng), adam_with_clip(cfg.lr),
            init_kwargs={"view_graph": sample, "deterministic": True},
        )
        step = make_train_step(model, has_view=True)
        encode = make_encode_fn(model)
        t_setup = time.time() - t0

        t0 = time.time()
        m = {}
        for _ in range(args.epochs):
            for b, v in loader:
                rng, sub = jax.random.split(rng)
                state, m = step(state, to_device(b), sub,
                                to_device(v))
        t_train = time.time() - t0

        def encode_batch(b):
            return encode(state, to_device(b))

    def embed_all(data):
        out = []
        ld = SessionGraphLoader(data, tok, cfg.dims, cfg.batch_size,
                                shuffle=False, prefetch=2, cache=False)
        for b in ld:
            out.append(np.asarray(encode_batch(b)))
        return np.concatenate(out)[: len(data)]

    t0 = time.time()
    ce = embed_all([(s, []) for s in corpus_sessions])
    qe = embed_all(test_data)
    t_embed = time.time() - t0

    k = 10
    scores = {}
    # dense (trained encoder)
    idx = build_index(ce, metric="cos")
    _, I = idx.search(qe, k)
    scores["encoder"] = get_ave_score(I, test_data, corpus_sessions,
                                      "all_product_type_score")
    # sparse baselines (SKNN = binary overlap, STAN = time-decayed queries)
    for kind, name in (("binary", "SKNN"), ("stan", "STAN")):
        res = evaluate_sparse(cfg, corpus_sessions, test_data, kind=kind, k=k)
        scores[name] = res.report["ave_all_product_type_score"]
    # hybrid fusion, reusing the embeddings already computed (the harness's
    # evaluate_hybrid embeds internally; here we fuse in place to avoid a
    # second 100k-session embed pass per seed)
    cn = ce / np.clip(np.linalg.norm(ce, axis=1, keepdims=True), 1e-9, None)
    qn = qe / np.clip(np.linalg.norm(qe, axis=1, keepdims=True), 1e-9, None)
    sc = sparse_index.build_sparse_corpus(corpus_sessions, cfg.asin_num,
                                          kind="binary")
    sq = np.stack([
        sparse_index.sequence_to_binary_vec(t[0], cfg.asin_num)
        for t in test_data
    ])
    dense_sim = qn @ cn.T

    def topk_rows(mat):
        part = np.argpartition(-mat, k - 1, axis=1)[:, :k]
        vals = np.take_along_axis(mat, part, axis=1)
        return np.take_along_axis(
            part, np.argsort(-vals, axis=1, kind="stable"), axis=1
        )

    bin_sim = np.asarray(sc.dot(sq.T)).T
    fused = args.alpha * dense_sim + (1 - args.alpha) * bin_sim
    scores["hybrid"] = get_ave_score(topk_rows(fused), test_data,
                                     corpus_sessions,
                                     "all_product_type_score")
    # hybrid over the STAN (recency-decayed) overlap instead of binary --
    # on the overlap-hostile regime STAN is the stronger sparse signal
    # (recency concentrates on the session's current interest), so fuse
    # with the best sparse system rather than the weakest
    sc_stan = sparse_index.build_sparse_corpus(corpus_sessions,
                                               cfg.asin_num, kind="stan")
    sq_stan = np.stack([
        sparse_index.sequence_to_stan_vec(t[0], cfg.asin_num)
        for t in test_data
    ])
    # both sides are L2-normalized, so the fusion mixes two cosines on the
    # same scale (exactly like the binary hybrid)
    stan_sim = np.asarray(sc_stan.dot(sq_stan.T)).T
    fused2 = args.alpha * dense_sim + (1 - args.alpha) * stan_sim
    scores["hybrid_stan"] = get_ave_score(topk_rows(fused2), test_data,
                                          corpus_sessions,
                                          "all_product_type_score")
    # fusion-weight sweep: the similarity matrices are already in memory,
    # so extra alphas cost one argpartition each (r3 ran a=0.5 only; the
    # roadmap flagged the unswept alpha as a candidate for closing the
    # encoder-STAN gap on the adversarial regime)
    for a in args.alpha_sweep:
        for tag, sim in (("hybrid", bin_sim), ("hybrid_stan", stan_sim)):
            f = a * dense_sim + (1 - a) * sim
            scores[f"{tag}[a={a:g}]"] = get_ave_score(
                topk_rows(f), test_data, corpus_sessions,
                "all_product_type_score")
    # reciprocal-rank fusion (Cormack & Clarke'09): rank-based, so it is
    # immune to the two cosines living on different effective scales
    # (dense scores concentrate near 1 on cone-collapsed encoders while
    # overlap cosines spread over [0,1] — score averaging then lets one
    # side dominate regardless of alpha)

    def rrf(sim_a, sim_b, k0=60.0):
        ra = np.empty_like(sim_a, dtype=np.int32)
        rb = np.empty_like(sim_b, dtype=np.int32)
        oa = np.argsort(-sim_a, axis=1, kind="stable")
        ob = np.argsort(-sim_b, axis=1, kind="stable")
        rows = np.arange(sim_a.shape[0])[:, None]
        ra[rows, oa] = np.arange(sim_a.shape[1])[None, :]
        rb[rows, ob] = np.arange(sim_b.shape[1])[None, :]
        return 1.0 / (k0 + ra) + 1.0 / (k0 + rb)

    for tag, sim in (("rrf_sknn", bin_sim), ("rrf_stan", stan_sim)):
        scores[tag] = get_ave_score(
            topk_rows(rrf(dense_sim, sim)), test_data, corpus_sessions,
            "all_product_type_score")
    print(
        f"seed {seed}: "
        + "  ".join(f"{n}={v:.4f}" for n, v in scores.items())
        + f"   (setup {t_setup:.0f}s train {t_train:.0f}s loss "
        f"{float(m['loss']):.3f} embed {t_embed:.0f}s)",
        flush=True,
    )
    return scores


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--seed-base", type=int, default=0, help=(
        "offset added to every seed index: run big-budget seeds "
        "one per process and merge (host-OOM isolation)"))
    ap.add_argument("--corpus", type=int, default=100_000)
    ap.add_argument("--train", type=int, default=4000)
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--types", type=int, default=25)
    ap.add_argument("--asins", type=int, default=8000)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--encoder", default="pretrain",
                    choices=["pretrain", "flagship"],
                    help="'flagship' trains the production two-pool "
                         "encoder under the subsession objective instead "
                         "of the pretrain (UnifyPooling) model")
    ap.add_argument("--pooling", default="srgnn",
                    choices=["srgnn", "recency"],
                    help="flagship product readout "
                         "(Config.product_pooling); 'recency' adds the "
                         "learned STAN-style decay stream")
    ap.add_argument("--alpha-sweep", default="",
                    help="comma list of extra fusion weights to score "
                         "(reuses the in-memory similarity matrices)")
    ap.add_argument("--regime", default="clustered",
                    choices=["clustered", "adversarial"],
                    help="'adversarial' = overlap-hostile generator "
                         "(power-law popularity, cross-type trending head, "
                         "hierarchical taxonomy, title synonymy) where "
                         "SKNN is NOT near-oracle")
    # encoder width (session dim = 2*gnn_nout); defaults match the r2 runs,
    # raise for flagship-width evidence
    ap.add_argument("--gnn-nout", type=int, default=64)
    ap.add_argument("--gnn-nhid", type=int, default=64)
    ap.add_argument("--emb-len", type=int, default=48)
    ap.add_argument("--text-dim", type=int, default=64)
    ap.add_argument("--out", default=None, help="write per-seed JSON here")
    ap.add_argument("--disjoint", action="store_true",
                    help="out-of-catalog: corpus/queries from disjoint "
                         "catalog halves (use a smaller --corpus; sessions "
                         "are rejection-sampled)")
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    args = ap.parse_args()
    from sessionsimilaritysearch.runtime import (
        enable_compile_cache,
        force_platform,
    )

    if args.platform:
        force_platform(args.platform)
    enable_compile_cache()
    args.alpha_sweep = [
        float(a) for a in args.alpha_sweep.split(",") if a.strip()
    ]

    all_scores = []
    for s in range(args.seeds):
        all_scores.append(run_seed(args.seed_base + s, args))
        # long multi-seed runs at big train budgets OOM-killed the host
        # (130 GB RSS by seed 3): drop every jit cache + host garbage
        # between trials; for the biggest budgets run one seed per
        # process (--seed-base) and merge
        jax.clear_caches()
        gc.collect()
    systems = list(all_scores[0])
    print(
        f"\n=== ave type score@10, {args.seeds} seeds, "
        f"{args.corpus} corpus / {args.queries} queries per seed ==="
    )
    summary = {}
    for name in systems:
        vs = np.array([s[name] for s in all_scores])
        summary[name] = {
            "mean": float(vs.mean()), "std": float(vs.std(ddof=1)),
            "per_seed": [round(float(v), 4) for v in vs],
        }
        print(f"{name:>8}: {vs.mean():.4f} +- {vs.std(ddof=1):.4f}   {vs}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"args": vars(args), "systems": summary}, f, indent=1)


if __name__ == "__main__":
    main()
