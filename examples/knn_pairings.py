"""Three-pairing kNN next-item evaluation with TRAINED towers (the
measured-numbers half; the capability itself is
`harness.evaluate_knn_pairings` + `cli evaluate --mode knn --pairings`).

The reference's Yoochoose `main()` builds BOTH a session and a subsession
encoder, embeds the SAME train corpus through each, and logs next-item
recall@20 under three query/db pairings (test_amazon_filterd.py:87-205,
:189-201):

    subsession->session, subsession->subsession, session->session

This script reproduces that protocol on the synthetic regimes. The
reference's two encoders come from its JOINT trainer — session +
subsession objectives plus a contrastive loss aligning the two embedding
spaces (train_session_subsession_embedding.py:139-160,:296) — and that
alignment is what makes the CROSS pairing meaningful; `--towers joint`
(default) reproduces it via training.session_trainers.JointModel.
`--towers independent` trains the towers separately as an alignment
ablation: on the clustered regime the within-space pairings hold while
subsession->session collapses to below the popularity floor.
The adversarial regime is popularity-confounded for THIS protocol (its
trending head makes a static popularity-top-20 beat every kNN pairing)
— use clustered for alignment claims.

Run (GPU):  python examples/knn_pairings.py --out runs/knn_pairings_joint.json
Smoke:      python examples/knn_pairings.py --platform cpu --tiny
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def run_regime(regime: str, args) -> dict:
    import jax
    import jax.numpy as jnp

    from sessionsimilaritysearch.config import tiny_test_config
    from sessionsimilaritysearch.data import (
        AdversarialSessionGenerator,
        SyntheticSessionGenerator,
    )
    from sessionsimilaritysearch.data.loader import SessionGraphLoader
    from sessionsimilaritysearch.evalharness import harness
    from sessionsimilaritysearch.models.encoder import build_graph_encoder
    from sessionsimilaritysearch.tokenizer import get_tokenizer
    from sessionsimilaritysearch.training.loop import to_device
    from sessionsimilaritysearch.training.session_trainers import (
        create_session_state,
        make_session_train_step,
    )
    from sessionsimilaritysearch.utils.precision import serving_params

    cfg = tiny_test_config(
        asin_num=args.asins, gnn_nout=args.gnn_nout, gnn_nhid=args.gnn_nhid,
        emb_len=args.emb_len, text_encoder_dim=args.text_dim,
        batch_size=64, ctv_w=0.5,
    ).replace(product_pooling="recency")
    gen = (AdversarialSessionGenerator(asin_num=args.asins, seed=1000)
           if regime == "adversarial"
           else SyntheticSessionGenerator(asin_num=args.asins, seed=1000))
    corpus_data = gen.dataset(args.corpus)
    test_data = gen.dataset(args.queries)
    train_data = corpus_data[: args.train]
    tok = get_tokenizer(cfg.vocab_size)

    def train_tower(mode: str, seed: int):
        """One tower under the given objective; returns its encode fn."""
        rng = jax.random.PRNGKey(seed)
        loader = SessionGraphLoader(train_data, tok, cfg.dims,
                                    cfg.batch_size, seed=seed, prefetch=4)
        sample = to_device(next(iter(loader)))
        model, state = create_session_state(
            cfg, rng, sample, mode=mode, encoder_kind="flagship")
        step = make_session_train_step(model)
        t0 = time.time()
        m = {}
        for ep in range(args.epochs):
            for b in loader:
                rng, sub = jax.random.split(rng)
                state, m = step(state, to_device(b), sub)
            print(f"  [{mode} tower] epoch {ep+1}/{args.epochs} "
                  f"t={time.time()-t0:.0f}s", file=sys.stderr, flush=True)
        t_train = time.time() - t0
        enc_mod = build_graph_encoder(cfg)
        enc_vars = {"params": serving_params(state.params)["encoder"]}
        enc_apply = jax.jit(lambda g: enc_mod.apply(enc_vars, g))
        loss = float(m.get("loss", np.nan))
        return enc_apply, t_train, loss

    def train_joint_towers(seed: int):
        """BOTH towers from the reference's joint trainer: session +
        subsession objectives plus the contrastive alignment that puts the
        two embedding spaces in correspondence
        (train_session_subsession_embedding.py:139-160,:296). This is what
        makes the CROSS pairing (subsession query vs session corpus)
        meaningful — independently trained towers land in unrelated spaces
        and the cross row collapses (measured: the `independent` mode)."""
        from sessionsimilaritysearch.data.graph import (
            build_graph_batch,
            truncate_to_subsession,
        )
        from sessionsimilaritysearch.training.session_trainers import (
            create_joint_state,
            make_joint_train_step,
        )

        rng_np = np.random.default_rng(seed)
        rng = jax.random.PRNGKey(seed)
        full = [list(s) + list(t) for s, t in train_data]
        to_dev = to_device  # packed transport: one upload per dtype

        def make_batches(order):
            bs = cfg.batch_size
            for i in range(0, len(order) - bs + 1, bs):  # drop_last
                rows = [full[j] for j in order[i: i + bs]]
                sess = build_graph_batch(
                    [(r, r) for r in rows], tok, cfg.dims)
                sub = build_graph_batch(
                    [truncate_to_subsession((r, []), rng_np) for r in rows],
                    tok, cfg.dims)
                yield to_dev(sess), to_dev(sub)

        t0 = time.time()
        sb0, ssb0 = next(make_batches(np.arange(len(full))))
        print(f"  [joint towers] first batch built t={time.time()-t0:.1f}s",
              file=sys.stderr, flush=True)
        model, state = create_joint_state(
            cfg, rng, sb0, ssb0, encoder_kind="flagship")
        print(f"  [joint towers] state init t={time.time()-t0:.1f}s",
              file=sys.stderr, flush=True)
        step = make_joint_train_step(model)
        t0 = time.time()
        m = {}
        for ep in range(args.epochs):
            order = rng_np.permutation(len(full))
            for bi, (sb, ssb) in enumerate(make_batches(order)):
                rng, sub_rng = jax.random.split(rng)
                state, m = step(state, sb, ssb, sub_rng)
                if ep == 0 and bi in (0, 1, 4, 16, 64):
                    jax.block_until_ready(jax.tree.leaves(state.params)[0])
                    print(f"  [joint towers] batch {bi} t={time.time()-t0:.1f}s",
                          file=sys.stderr, flush=True)
            print(f"  [joint towers] epoch {ep+1}/{args.epochs} "
                  f"t={time.time()-t0:.0f}s loss={float(m['loss']):.4f}",
                  file=sys.stderr, flush=True)
        t_train = time.time() - t0
        enc_mod = build_graph_encoder(cfg)
        p = serving_params(state.params)
        mk = lambda tower: jax.jit(
            lambda g, _v={"params": p[tower]["encoder"]}: enc_mod.apply(_v, g)
        )
        return (mk("subsession_model"), mk("session_model"), t_train,
                float(m.get("loss", np.nan)),
                float(m.get("ctv_loss", np.nan)))

    if args.towers == "joint":
        sub_fn, ses_fn, t_joint, loss_joint, loss_ctv = train_joint_towers(
            seed=1)
        t_sub = t_ses = round(t_joint / 2, 1)
        loss_sub = loss_ses = loss_joint
    else:
        sub_fn, t_sub, loss_sub = train_tower("subsession", seed=1)
        ses_fn, t_ses, loss_ses = train_tower("session", seed=2)

    t0 = time.time()
    out = harness.evaluate_knn_pairings(
        cfg, tok, sub_fn, ses_fn, corpus_data, test_data,
        K=args.K, sample_size=args.sample_size, batch_size=cfg.batch_size,
    )
    t_eval = time.time() - t0
    out.update({
        "regime": regime, "towers": args.towers,
        "corpus": args.corpus, "train": args.train,
        "queries": args.queries, "epochs": args.epochs,
        "train_s_subsession": round(t_sub, 1),
        "train_s_session": round(t_ses, 1),
        "final_loss_subsession": round(loss_sub, 4),
        "final_loss_session": round(loss_ses, 4),
        "eval_s": round(t_eval, 1),
    })
    if args.towers == "joint":
        out["final_ctv_loss"] = round(loss_ctv, 4)
    print(json.dumps(out), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--regimes", default="clustered,adversarial")
    ap.add_argument("--towers", default="joint",
                    choices=["joint", "independent"],
                    help=("'joint' = the reference's contrastively aligned "
                          "pair (train_session_subsession_embedding.py); "
                          "'independent' = the alignment ablation"))
    ap.add_argument("--corpus", type=int, default=20_000)
    ap.add_argument("--train", type=int, default=8_000)
    ap.add_argument("--queries", type=int, default=500)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--K", type=int, default=20)
    ap.add_argument("--sample-size", type=int, default=500)
    ap.add_argument("--asins", type=int, default=8000)
    ap.add_argument("--gnn-nout", type=int, default=256)
    ap.add_argument("--gnn-nhid", type=int, default=256)
    ap.add_argument("--emb-len", type=int, default=128)
    ap.add_argument("--text-dim", type=int, default=256)
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    from sessionsimilaritysearch.runtime import (
        enable_compile_cache,
        force_platform,
    )

    if args.platform:
        force_platform(args.platform)
    enable_compile_cache()
    if args.tiny:
        args.corpus, args.train, args.queries = 512, 256, 32
        args.epochs, args.sample_size, args.asins = 2, 64, 1000
        args.gnn_nout = args.gnn_nhid = 32
        args.emb_len, args.text_dim = 16, 32

    results = {}
    for regime in args.regimes.split(","):
        results[regime] = run_regime(regime.strip(), args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
