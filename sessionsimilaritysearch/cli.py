"""Command-line entry points.

The reference has no CLI: every workflow is a script whose behavior is
changed by editing config.py (SURVEY.md §5). Here each workload is a
subcommand over the same dataclass config, with a JSON config snapshot per
run directory:

    python -m sessionsimilaritysearch.cli pretrain --steps 200
    python -m sessionsimilaritysearch.cli train-subsession --epochs 2
    python -m sessionsimilaritysearch.cli finetune
    python -m sessionsimilaritysearch.cli evaluate --mode model
    python -m sessionsimilaritysearch.cli etl --out data/
Synthetic data is generated when no dataset path is supplied (the
reference's Amazon pickles are not public).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _common(p: argparse.ArgumentParser):
    p.add_argument("--savedir", default="runs/cli")
    p.add_argument("--data", default=None, help="pickled session dataset")
    p.add_argument("--num-sessions", type=int, default=512)
    p.add_argument("--asin-num", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="use the small test config (CPU-friendly)")
    p.add_argument("--batch-size", type=int, default=None)


def _config(args):
    from sessionsimilaritysearch.config import Config, tiny_test_config

    cfg = tiny_test_config() if args.tiny else Config()
    cfg = cfg.replace(asin_num=args.asin_num, savedir=args.savedir,
                      seed=args.seed)
    if args.batch_size:
        cfg = cfg.replace(batch_size=args.batch_size)
    return cfg


def _dataset(args, cfg):
    from sessionsimilaritysearch.data.etl import load_sessions
    from sessionsimilaritysearch.data.synthetic import (
        SyntheticSessionGenerator,
    )

    if args.data:
        return load_sessions(args.data)
    gen = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=cfg.seed)
    return gen.dataset(args.num_sessions)


def cmd_pretrain(args):
    import jax

    from sessionsimilaritysearch.data.loader import SessionGraphLoader
    from sessionsimilaritysearch.tokenizer import get_tokenizer
    from sessionsimilaritysearch.training.loop import run_training, to_device
    from sessionsimilaritysearch.training.pretrain import (
        create_pretrain_state,
        make_eval_step,
        make_train_step,
    )
    from sessionsimilaritysearch.utils.checkpoint import CheckpointManager
    from sessionsimilaritysearch.utils.logging import RunDir

    cfg = _config(args)
    data = _dataset(args, cfg)
    n_valid = max(len(data) // 10, 1)
    tok = get_tokenizer(cfg.vocab_size)
    train_loader = SessionGraphLoader(
        data[n_valid:], tok, cfg.dims, cfg.batch_size,
        ignore_query=cfg.ignore_query, seed=cfg.seed,
    )
    valid_loader = SessionGraphLoader(
        data[:n_valid], tok, cfg.dims, cfg.batch_size, shuffle=False,
        ignore_query=cfg.ignore_query,
    )
    rng = jax.random.PRNGKey(cfg.seed)
    sample = to_device(next(iter(valid_loader)))
    use_view = cfg.ctv_w > 0 or args.contrastive
    if use_view and cfg.ctv_w == 0:
        cfg = cfg.replace(ctv_w=0.1)
    model, state = create_pretrain_state(cfg, rng, sample)
    step = make_train_step(model, has_view=use_view)
    if use_view:
        from sessionsimilaritysearch.data.augment import (
            random_exchange_order,
        )
        from sessionsimilaritysearch.data.loader import (
            ContrastiveViewLoader,
        )

        train_loader = ContrastiveViewLoader(
            train_loader, random_exchange_order, seed=cfg.seed
        )

        base_step = step

        def step(state, pair, rng):  # adapt (batch, view) tuples
            batch, view = pair
            return base_step(state, batch, rng, view)

    rundir = RunDir(cfg.savedir, cfg, "pretrain")
    ckpt = CheckpointManager(os.path.join(cfg.savedir, "ckpt"))
    state, best = run_training(
        state=state,
        step_fn=step,
        eval_fn=None if use_view else make_eval_step(model),
        train_loader=train_loader,
        valid_loader=None if use_view else valid_loader,
        epochs=args.epochs,
        rng=rng,
        rundir=rundir,
        ckpt=ckpt,
    )
    print(json.dumps({
        "best_valid_loss": best if best != float("inf") else None,
        "steps": int(state.step),
    }))


def cmd_train_session(args, mode: str):
    import jax

    from sessionsimilaritysearch.data.loader import SessionGraphLoader
    from sessionsimilaritysearch.tokenizer import get_tokenizer
    from sessionsimilaritysearch.training.loop import run_training, to_device
    from sessionsimilaritysearch.training.session_trainers import (
        create_session_state,
        make_session_train_step,
    )
    from sessionsimilaritysearch.utils.checkpoint import CheckpointManager
    from sessionsimilaritysearch.utils.logging import RunDir

    cfg = _config(args)
    data = _dataset(args, cfg)
    n_valid = max(len(data) // 10, 1)
    tok = get_tokenizer(cfg.vocab_size)
    train_loader = SessionGraphLoader(
        data[n_valid:], tok, cfg.dims, cfg.batch_size, seed=cfg.seed
    )
    valid_loader = SessionGraphLoader(
        data[:n_valid], tok, cfg.dims, cfg.batch_size, shuffle=False
    )
    rng = jax.random.PRNGKey(cfg.seed)
    sample = to_device(next(iter(valid_loader)))
    model, state = create_session_state(cfg, rng, sample, mode=mode)
    step = make_session_train_step(model)

    def eval_fn(state, batch, rng):
        variables = {"params": state.params}
        if state.batch_stats is not None:
            variables["batch_stats"] = state.batch_stats
        _, m = model.apply(variables, batch, rng, deterministic=True)
        return m

    rundir = RunDir(cfg.savedir, cfg, mode)
    ckpt = CheckpointManager(os.path.join(cfg.savedir, "ckpt"))
    state, best = run_training(
        state=state, step_fn=step, eval_fn=jax.jit(eval_fn),
        train_loader=train_loader, valid_loader=valid_loader,
        epochs=args.epochs, rng=rng, rundir=rundir, ckpt=ckpt,
    )
    print(json.dumps({
        "best_valid_loss": best if best != float("inf") else None,
        "steps": int(state.step),
    }))


def cmd_finetune(args):
    import jax
    import numpy as np

    from sessionsimilaritysearch.data.similarity import mine_triplets
    from sessionsimilaritysearch.evalharness.harness import EmbeddingPipeline
    from sessionsimilaritysearch.models import build_text_session_encoder
    from sessionsimilaritysearch.data.graph import batch_graphs, sequence_to_graph
    from sessionsimilaritysearch.tokenizer import get_tokenizer
    from sessionsimilaritysearch.training.finetune import (
        build_triplet_batches,
        create_finetune_state,
        make_finetune_step,
    )
    from sessionsimilaritysearch.utils.logging import RunDir

    cfg = _config(args)
    data = _dataset(args, cfg)
    half = len(data) // 2
    qdata, db = data[:half], data[half:]
    triplets = mine_triplets(qdata, db, cfg.sim_type, args.num_triplets)
    if not triplets:
        print(json.dumps({"error": "no triplets mined"}))
        return
    tok = get_tokenizer(cfg.vocab_size)

    if args.from_pretrain:
        # frozen encoder = the pretrained graph encoder (the fine_tune_ours
        # wiring: load_path checkpoint, fine_tune_ours.py:258-261)
        from sessionsimilaritysearch.data.loader import SessionGraphLoader
        from sessionsimilaritysearch.training.pretrain import (
            create_pretrain_state,
            make_encode_fn,
        )
        from sessionsimilaritysearch.utils.checkpoint import (
            CheckpointManager,
            state_to_tree,
            tree_to_state,
        )

        with open(os.path.join(args.from_pretrain, "config.json")) as f:
            from sessionsimilaritysearch.config import Config

            pcfg = Config.from_json(f.read())
        sample_loader = SessionGraphLoader(
            data[:pcfg.batch_size], tok, pcfg.dims, pcfg.batch_size,
            shuffle=False, prefetch=0,
        )
        import jax.numpy as jnp

        sample = jax.tree.map(jnp.asarray, next(iter(sample_loader)))
        pmodel, pstate = create_pretrain_state(
            pcfg, jax.random.PRNGKey(0), sample
        )
        cm = CheckpointManager(os.path.join(args.from_pretrain, "ckpt"))
        tag = "best" if cm.has("best") else "latest"
        pstate = tree_to_state(pstate, cm.restore(tag, state_to_tree(pstate)))
        encode = make_encode_fn(pmodel)
        encode_fn = lambda g: encode(pstate, g)
        emb_dim = pcfg.session_emb_dim
        pipe = EmbeddingPipeline(pcfg, tok, encode_fn,
                                 batch_size=pcfg.batch_size)
    else:
        # frozen encoder = text session encoder (the fine_tune_QAEA wiring)
        enc = build_text_session_encoder(cfg)
        sample = batch_graphs([
            sequence_to_graph(0, data[0][0], data[0][1], tok, cfg.dims)
        ])
        params = enc.init(jax.random.PRNGKey(cfg.seed), sample)
        encode_fn = jax.jit(lambda g: enc.apply(params, g))
        emb_dim = cfg.n_out
        pipe = EmbeddingPipeline(cfg, tok, encode_fn, batch_size=64)

    model, state, tx = create_finetune_state(
        cfg, jax.random.PRNGKey(cfg.seed), emb_dim=emb_dim
    )
    step = make_finetune_step(model, tx, cfg)
    batches = build_triplet_batches(
        triplets, pipe, [(q[0], list(q[0]) + list(q[1])) for q in qdata[:64]],
        min(cfg.ft_batch_size, len(triplets)), np.random.default_rng(cfg.seed),
    )
    rundir = RunDir(cfg.savedir, cfg, "finetune")
    last = {}
    for epoch in range(args.epochs):
        for b in batches():
            state, last = step(state, b)
        rundir.logger.info(f"epoch {epoch}: loss {float(last['loss']):.4f}")
    print(json.dumps({"final_loss": float(last["loss"]),
                      "triplets": len(triplets)}))


def cmd_evaluate(args):
    import jax

    from sessionsimilaritysearch.data.graph import batch_graphs, sequence_to_graph
    from sessionsimilaritysearch.evalharness import harness
    from sessionsimilaritysearch.models import build_text_session_encoder
    from sessionsimilaritysearch.tokenizer import get_tokenizer

    if args.mode == "load":
        # recompute the metric suite from a saved search run (the
        # reference's load-the-pickled-D/I flow, test_amazon_filterd.py)
        assert args.results, "--mode load requires --results PATH"
        rep = harness.evaluate_loaded(args.results)
        print(json.dumps({"mode": "load",
                          **{k: round(float(v), 4) for k, v in rep.items()}}))
        return

    cfg = _config(args)
    data = _dataset(args, cfg)
    n_test = max(len(data) // 10, 1)
    test_data, corpus_data = data[:n_test], data[n_test:]
    if args.mode in ("STAN", "SKNN"):
        res = harness.evaluate_sparse(
            cfg, [d[0] for d in corpus_data], test_data,
            kind="stan" if args.mode == "STAN" else "binary", k=args.k,
        )
    elif args.mode == "knn":
        from sessionsimilaritysearch.models import (
            build_text_session_encoder as _bts,
        )

        tok = get_tokenizer(cfg.vocab_size)
        enc = _bts(cfg)
        sample = batch_graphs([
            sequence_to_graph(0, data[0][0], data[0][1], tok, cfg.dims)
        ])
        params = enc.init(jax.random.PRNGKey(cfg.seed), sample)
        encode_fn = jax.jit(lambda g: enc.apply(params, g))
        if args.pairings:
            # the reference's three query/db pairing matrix
            # (test_amazon_filterd.py:189-201): a second, independently
            # initialized encoder stands in for the subsession tower
            # (trained pairings: examples/knn_pairings.py)
            enc2 = _bts(cfg)
            params2 = enc2.init(jax.random.PRNGKey(cfg.seed + 1), sample)
            sub_fn = jax.jit(lambda g: enc2.apply(params2, g))
            out = harness.evaluate_knn_pairings(
                cfg, tok, sub_fn, encode_fn, corpus_data, test_data,
                K=args.k, batch_size=64,
            )
        else:
            out = harness.evaluate_knn_recommendation(
                cfg, tok, encode_fn, corpus_data, test_data, K=args.k,
                batch_size=64,
            )
        print(json.dumps({"mode": "knn", **{k: round(float(v), 4)
                                            for k, v in out.items()}}))
        return
    else:
        tok = get_tokenizer(cfg.vocab_size)
        enc = build_text_session_encoder(cfg)
        sample = batch_graphs([
            sequence_to_graph(0, data[0][0], data[0][1], tok, cfg.dims)
        ])
        params = enc.init(jax.random.PRNGKey(cfg.seed), sample)
        encode_fn = jax.jit(lambda g: enc.apply(params, g))
        if args.mode == "hybrid":
            res = harness.evaluate_hybrid(
                cfg, tok, encode_fn, corpus_data, test_data, k=args.k,
                alpha=args.alpha, kind=args.hybrid_kind,
                fusion=args.fusion, batch_size=64,
            )
        else:
            res = harness.evaluate_encoder(
                cfg, tok, encode_fn, corpus_data, test_data, k=args.k,
                batch_size=64,
            )
    if args.save_results:
        harness.save_results(
            args.save_results, res.D, res.I, test_data,
            [d[0] for d in corpus_data],
        )
    out = {
        "mode": args.mode,
        "qps": round(res.qps, 2),
        "search_s": round(res.search_s, 4),
    }
    out.update({k: round(v, 4) for k, v in (res.report or {}).items()})
    print(json.dumps(out))


def cmd_etl(args):
    import numpy as np

    from sessionsimilaritysearch.data import etl
    from sessionsimilaritysearch.data.synthetic import (
        SyntheticSessionGenerator,
    )

    cfg = _config(args)
    os.makedirs(args.out, exist_ok=True)
    if args.data:
        sessions = etl.load_sessions(args.data)
    else:
        gen = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=cfg.seed)
        sessions = [gen.session() for _ in range(args.num_sessions)]
    etl.decompose_sessions(
        sessions,
        os.path.join(args.out, "actions.csv"),
        os.path.join(args.out, "asin.csv"),
    )
    back, asin2id = etl.load_sessions_from_csv(
        os.path.join(args.out, "actions.csv"),
        os.path.join(args.out, "asin.csv"),
    )
    print(json.dumps({
        "sessions": len(back),
        "distinct_asins": len(asin2id),
        "out": args.out,
    }))


def main(argv=None):
    from sessionsimilaritysearch.runtime import (
        PLATFORMS,
        enable_compile_cache,
        force_platform,
        require_platform,
    )

    parser = argparse.ArgumentParser(prog="sessionsimilaritysearch")
    parser.add_argument(
        "--platform", default=None, choices=PLATFORMS,
        help="force a JAX platform (overrides environment backends)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("pretrain", help="pretrain the flagship encoder")
    _common(p)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--contrastive", action="store_true",
                   help="add the contrastive view objective "
                        "(random_exchange_order augmentation)")

    for mode in ("session", "subsession"):
        p = sub.add_parser(f"train-{mode}", help=f"train the {mode} encoder")
        _common(p)
        p.add_argument("--epochs", type=int, default=1)

    p = sub.add_parser("finetune", help="similarity fine-tune (hash heads)")
    _common(p)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--num-triplets", type=int, default=64)
    p.add_argument("--from-pretrain", default=None,
                   help="savedir of a pretrain run: fine-tune on its frozen "
                        "graph-encoder embeddings (fine_tune_ours wiring)")

    p = sub.add_parser("evaluate", help="end-to-end retrieval evaluation")
    _common(p)
    p.add_argument("--mode", default="model",
                   choices=["model", "STAN", "SKNN", "knn", "load", "hybrid"])
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--alpha", type=float, default=0.5,
                   help="hybrid mode: weight of the dense term")
    p.add_argument("--hybrid-kind", default="overlap",
                   choices=["overlap", "stan"],
                   help="hybrid mode: sparse term (binary overlap or "
                        "recency-decayed STAN weights)")
    p.add_argument("--fusion", default="score", choices=["score", "rrf"],
                   help="hybrid mode: linear score fusion or "
                        "reciprocal-rank fusion (the measured-best "
                        "adversarial-regime system)")
    p.add_argument("--pairings", action="store_true",
                   help="knn mode: evaluate the reference's three "
                        "query/db pairings (subsession->session, "
                        "subsession->subsession, session->session; "
                        "test_amazon_filterd.py:189-201) instead of the "
                        "single pairing")
    p.add_argument("--save-results", default=None, metavar="PATH",
                   help="pickle D/I + sessions for later --mode load")
    p.add_argument("--results", default=None, metavar="PATH",
                   help="saved results file for --mode load")

    p = sub.add_parser("etl", help="sessions <-> CSV round trip")
    _common(p)
    p.add_argument("--out", default="data_out")

    args = parser.parse_args(argv)
    if args.platform:
        force_platform(args.platform)
    enable_compile_cache()
    require_platform()
    if args.cmd == "pretrain":
        cmd_pretrain(args)
    elif args.cmd == "train-session":
        cmd_train_session(args, "session")
    elif args.cmd == "train-subsession":
        cmd_train_session(args, "subsession")
    elif args.cmd == "finetune":
        cmd_finetune(args)
    elif args.cmd == "evaluate":
        cmd_evaluate(args)
    elif args.cmd == "etl":
        cmd_etl(args)


if __name__ == "__main__":
    main()
