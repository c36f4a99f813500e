"""End-to-end 100k-session index build + serve.

Generate 100k synthetic sessions, train the subsession encoder briefly,
embed the full corpus with bf16 serving params through the native
whole-batch graph builder, build the exact flat index, and answer 1,000
top-100 queries. The flow is the reference's build-then-serve pipeline
(test_amazon_filterd.py build_index + search) as one script.

Run: python examples/index_build_100k.py [--sessions 100000] [--platform cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from sessionsimilaritysearch.config import Config, tiny_test_config
from sessionsimilaritysearch.data import SyntheticSessionGenerator
from sessionsimilaritysearch.data.loader import SessionGraphLoader
from sessionsimilaritysearch.evalharness.harness import EmbeddingPipeline
from sessionsimilaritysearch.index.dense import DenseIndex
from sessionsimilaritysearch.tokenizer import get_tokenizer
from sessionsimilaritysearch.training.loop import to_device
from sessionsimilaritysearch.training.session_trainers import (
    create_session_state,
    make_session_train_step,
)
from sessionsimilaritysearch.utils.precision import serving_params


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=100_000)
    ap.add_argument("--train-sessions", type=int, default=10_000)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--embed-batch", type=int, default=2048)
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args()
    from sessionsimilaritysearch.runtime import (
        enable_compile_cache,
        force_platform,
    )

    if args.platform:
        force_platform(args.platform)
    enable_compile_cache()

    if args.tiny:
        cfg = tiny_test_config()
        args.sessions = min(args.sessions, 512)
        args.train_sessions = min(args.train_sessions, 128)
        args.queries = min(args.queries, 32)
        args.embed_batch = 64
    else:
        cfg = Config(
            asin_num=20_000, vocab_size=8192, text_encoder_dim=256,
            query_embedder_nhid=512, gnn_nhid=256, gnn_nout=256,
            emb_len=128, qh_nhead=4, batch_size=512,
        )
    tok = get_tokenizer(cfg.vocab_size)
    gen = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=0)

    t0 = time.perf_counter()
    data = gen.dataset(args.sessions)
    t_gen = time.perf_counter() - t0
    print(f"generate {args.sessions} sessions: {t_gen:.1f}s", flush=True)

    # --- train briefly (subsession objective)
    t0 = time.perf_counter()
    train_loader = SessionGraphLoader(
        data[: args.train_sessions], tok, cfg.dims,
        min(cfg.batch_size, args.train_sessions), seed=0,
    )
    rng = jax.random.PRNGKey(0)
    sample = to_device(next(iter(train_loader)))
    model, state = create_session_state(cfg, rng, sample, mode="subsession")
    step = make_session_train_step(model)
    m = {}
    for _ in range(args.epochs):
        for b in train_loader:
            rng, sub = jax.random.split(rng)
            state, m = step(state, to_device(b), sub)
    jax.block_until_ready(state.params)
    t_train = time.perf_counter() - t0
    print(f"train {args.epochs} epochs on {args.train_sessions}: "
          f"{t_train:.1f}s, loss {float(m['loss']):.3f}", flush=True)

    # --- embed the full corpus with bf16 serving params
    params = serving_params(state.params)
    variables = {"params": params}
    if state.batch_stats is not None:
        variables["batch_stats"] = state.batch_stats
    encode = jax.jit(lambda g: model.apply(variables, g, method="encode"))
    pipe = EmbeddingPipeline(cfg, tok, encode, batch_size=args.embed_batch)
    # split compile (one cold batch) from the
    # steady-state throughput the corpus build actually runs at
    t0 = time.perf_counter()
    pipe(data[: args.embed_batch])
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    emb = pipe([d[0] for d in data])
    t_embed = time.perf_counter() - t0
    print(f"embed {args.sessions}: {t_embed:.1f}s "
          f"({args.sessions / t_embed:.0f} sessions/s; "
          f"+{t_compile:.1f}s one-time compile)", flush=True)

    # --- index + serve
    t0 = time.perf_counter()
    index = DenseIndex(dim=emb.shape[1], capacity=args.sessions,
                       metric="cos")
    index.add(emb)
    jax.block_until_ready(index._buf)
    t_build = time.perf_counter() - t0
    q = emb[: args.queries]
    D, I = index.search(q, args.k)  # compile + warm
    t0 = time.perf_counter()
    D, I = index.search(q, args.k)
    np.asarray(D)
    t_search = time.perf_counter() - t0
    # briefly-trained encoders can be near-degenerate (candidates closer
    # than score precision), so report BOTH the set metric and the value
    # metric: top-1 score must be within rounding of the exact self-cosine
    # 1.0 whenever an equally-close tie displaces the query's own row
    self_top1 = float((np.asarray(I)[:, 0] == np.arange(len(q))).mean())
    top1_vals = np.asarray(D)[:, 0]
    top1_at_self = float((top1_vals >= 1.0 - 1e-4).mean())
    print(json.dumps({
        "sessions": args.sessions,
        "gen_s": round(t_gen, 1),
        "train_s": round(t_train, 1),
        "embed_s": round(t_embed, 1),
        "embed_compile_s": round(t_compile, 1),
        "embed_sessions_per_s": round(args.sessions / t_embed, 0),
        "index_build_s": round(t_build, 2),
        "search_s": round(t_search, 3),
        "qps": round(args.queries / t_search, 0),
        "self_recall_at_1": self_top1,
        "top1_score_at_self_cos": top1_at_self,
    }))


if __name__ == "__main__":
    main()
