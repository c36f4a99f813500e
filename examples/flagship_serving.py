"""Flagship end-to-end serving artifact.

One run ties the whole chain together at the reference's operating point —
the shape of ``test_amazon_filterd.main2('model', path)``
(test_amazon_filterd.py:452-692): train the flagship encoder (768/800 →
1600-d sessions) on synthetic sessions over the full 391,572-asin catalog,
build the catalog title-embedding cache, embed a ~1M-session corpus, and
serve the SAME embeddings through every production search mode — reporting
embed throughput, per-mode QPS, value-recall vs the f64 oracle, and
ground-truth retrieval quality (ave type score@10) from ONE corpus.

Run (GPU): python examples/flagship_serving.py
Smoke:     python examples/flagship_serving.py --platform cpu --tiny
"""

import argparse
import json
import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from sessionsimilaritysearch.config import Config, tiny_test_config
from sessionsimilaritysearch.data import (
    AdversarialSessionGenerator,
    SyntheticSessionGenerator,
)
from sessionsimilaritysearch.data.loader import SessionGraphLoader
from sessionsimilaritysearch.data.similarity import get_ave_score
from sessionsimilaritysearch.evalharness.harness import (
    EmbeddingPipeline,
    build_keyword_table,
    build_title_table,
    make_cached_encode_fn,
)
from sessionsimilaritysearch.index.dense import _quantize_rows_int8
from sessionsimilaritysearch.ops.hamming import (
    pack_bits_t,
    sign_topk,
    simhash_codes,
)
from sessionsimilaritysearch.ops.topk import (
    chunked_topk,
    l2_normalize,
    value_recall_at_k,
)
from sessionsimilaritysearch.tokenizer import get_tokenizer
from sessionsimilaritysearch.training.loop import to_device
from sessionsimilaritysearch.models.encoder import build_graph_encoder
from sessionsimilaritysearch.training.session_trainers import (
    create_session_state,
    make_session_train_step,
)
from sessionsimilaritysearch.utils.precision import serving_params


def _timed(fn, q0, iters, chain):
    """Median-free simple mean timing with chained data dependencies (the
    dev-chip runtime can return from block_until_ready early; chaining each
    iteration through the previous result and materializing the last one is
    the repo-wide timing convention, see bench.py)."""
    q = q0
    for _ in range(3):
        out = fn(q)
        q = chain(q, out)
    np.asarray(out[0])
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(q)
        q = chain(q, out)
    np.asarray(out[0])
    return (time.perf_counter() - t0) / iters, out


def _hamming_vr10(I, q_signs, c_signs, nq=64):
    """Tie-aware value-recall@10 vs the exact FULL-CORPUS Hamming oracle:
    a retrieved row counts when its TRUE Hamming distance reaches the
    oracle's 10th-best (integer distances tie heavily, so any
    equal-distance row is as good — the binary-tier quality gate). One
    numpy matmul for nq queries over the whole corpus."""
    q = np.asarray(q_signs, np.float32)[:nq]
    c = np.asarray(c_signs, np.float32)
    bits = q.shape[1]
    dist = (bits - q @ c.T) * 0.5
    bar = np.partition(dist, 9, axis=1)[:, 9:10]
    got = np.take_along_axis(
        dist, np.asarray(I[:nq, :10], np.int64), axis=1
    )
    return float((got <= bar + 1e-6).mean())


def _fullcorpus_vr10(I, qn, corpus, bars, nq=64, rel_tol=2 * 2.0**-8):
    """Value-recall@10 vs the FULL-CORPUS cosine oracle: a retrieved row
    counts when its TRUE cosine reaches the oracle's 10th-best (``bars``
    [nq, 1], precomputed on device in f32-HIGHEST from the f32 corpus
    before it is freed) within ``rel_tol``. The retrieved rows re-score
    against the bf16 ``corpus`` on device — its <=2^-8 relative rounding
    sits inside the bf16-tie ``rel_tol`` band this gate exists to absorb.
    For modes whose ranking spans the whole corpus but whose candidate
    generation cannot be replayed on a subcorpus slice
    (packed-stage-1 two-stage). Only [nq, 10] tiles cross to the host."""
    import jax

    rows = corpus[jnp.asarray(np.asarray(I[:nq, :10], np.int64))]
    got = jnp.einsum(
        "qd,qkd->qk", qn[:nq], rows.astype(jnp.float32),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    got = np.asarray(got, np.float64)
    bar = np.asarray(bars, np.float64)[:nq]
    return float((got >= bar - rel_tol * np.abs(bar)).mean())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=1 << 20)
    ap.add_argument("--train-sessions", type=int, default=12_800)
    ap.add_argument("--train-steps", type=int, default=400)
    ap.add_argument("--asin-num", type=int, default=391_572)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--quality-queries", type=int, default=200)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--bits", type=int, default=250)
    ap.add_argument("--embed-batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--regime", default="clustered",
                    choices=["clustered", "adversarial"])
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cache", default=None, help=(
        "path prefix for a stage checkpoint: the ~1h generate/train/embed "
        "pipeline saves its normalized embeddings + sessions here, and a "
        "rerun (same sessions/regime) resumes straight at the serving "
        "ladder — the long stages survive session interruptions"))
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
        args.sessions, args.train_sessions = 2048, 256
        args.train_steps, args.queries = 30, 64
        args.quality_queries, args.k = 32, 10
        args.embed_batch, args.iters, args.bits = 128, 2, 32
        args.asin_num = cfg.asin_num
    else:
        cfg = Config().replace(
            asin_num=args.asin_num, batch_size=256,  # 2x the b50 throughput
        )
    print(f"flagship serving artifact: {args.sessions} sessions, "
          f"session_emb_dim={cfg.session_emb_dim}, asin_num={cfg.asin_num}, "
          f"regime={args.regime}", flush=True)
    # --- 0. stage checkpoint: resume straight at the serving ladder when a
    # compatible cache exists (the generate/train/embed pipeline is ~1h at
    # 1M sessions and must survive session interruptions)
    meta = None
    if args.cache and os.path.exists(args.cache + ".npz"):
        z = np.load(args.cache + ".npz")
        cand = json.loads(bytes(z["meta"]).decode())
        if (cand["sessions"] == args.sessions
                and cand["regime"] == args.regime
                and cand["asin_num"] == cfg.asin_num
                and cand["queries"] == args.queries):
            meta, cn, qn = cand, z["cn"], z["qn"]
            with open(args.cache + ".sessions.pkl", "rb") as f:
                corpus_sessions, test_data = pickle.load(f)
            print(f"cache hit: {args.cache}.npz "
                  "(skipping generate/train/embed)", flush=True)
        else:
            print(f"cache mismatch ({cand} vs requested run); rebuilding",
                  flush=True)

    if meta is None:
        tok = get_tokenizer(cfg.vocab_size)
        if args.regime == "adversarial":
            gen = AdversarialSessionGenerator(asin_num=cfg.asin_num, seed=0)
        else:
            gen = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=0)

        t0 = time.perf_counter()
        data = gen.dataset(args.sessions)
        test_data = gen.dataset(args.queries)
        t_gen = time.perf_counter() - t0
        print(f"generate: {t_gen:.1f}s", flush=True)

        # --- 1. train the flagship encoder (subsession objective) briefly
        t0 = time.perf_counter()
        bs = min(cfg.batch_size, args.train_sessions)
        train_loader = SessionGraphLoader(
            data[: args.train_sessions], tok, cfg.dims, bs, seed=0,
        )
        rng = jax.random.PRNGKey(0)
        sample = to_device(next(iter(train_loader)))
        model, state = create_session_state(
            cfg, rng, sample, mode="subsession", encoder_kind="flagship")
        step = make_session_train_step(model)
        m, steps = {}, 0
        while steps < args.train_steps:
            for b in train_loader:
                rng, sub = jax.random.split(rng)
                state, m = step(state, to_device(b), sub)
                steps += 1
                if steps >= args.train_steps:
                    break
        jax.block_until_ready(state.params)
        t_train = time.perf_counter() - t0
        print(f"train {steps} steps: {t_train:.1f}s, "
              f"loss {float(m['loss']):.3f}", flush=True)

        # --- 2. catalog title cache + bf16 serving params
        params = serving_params(state.params)
        enc_mod = build_graph_encoder(cfg)
        enc_vars = {"params": params["encoder"]}
        t0 = time.perf_counter()
        table = build_title_table(cfg, tok, gen.titles, enc_mod, enc_vars,
                                  batch_size=args.embed_batch)
        t_table = time.perf_counter() - t0
        print(f"title table [{table.shape[0]} x {table.shape[1]}]: "
              f"{t_table:.1f}s", flush=True)
        # keyword table: with ignore_query the query store is just the padded
        # root-node grid, but the title-cached forward still ran the text
        # backbone over all [B, Q, T] padded rows -- the keyword gather
        # removes the text encoder from the serving forward entirely
        t0 = time.perf_counter()
        kws = sorted({a[2] or "" for d in data for a in d[0] if a[1] == "s"})
        qtable, kw_lookup = build_keyword_table(
            cfg, tok, kws, enc_mod, enc_vars, batch_size=args.embed_batch
        )
        t_kw_table = time.perf_counter() - t0
        print(f"keyword table [{qtable.shape[0]} x {qtable.shape[1]}]: "
              f"{t_kw_table:.1f}s", flush=True)
        encode = make_cached_encode_fn(enc_mod, enc_vars, table,
                                       query_table=qtable,
                                       kw_lookup=kw_lookup)
        pipe = EmbeddingPipeline(cfg, tok, encode,
                                 batch_size=args.embed_batch)

        # --- 3. embed the corpus DEVICE-RESIDENT (compile split from
        # steady state). The corpus never crosses the host link: encoder
        # output stays on-chip (EmbeddingPipeline out='device' — the
        # examples/embed_pipeline_probe.py measures it against per-batch
        # round trips)
        # and every serving form below derives from it on-device.
        corpus_sessions = [d[0] for d in data]
        t0 = time.perf_counter()
        pipe(data[: args.embed_batch], out="device")
        t_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        ce = pipe([(s, []) for s in corpus_sessions], out="device")
        norm = jax.jit(lambda x: l2_normalize(x.astype(jnp.float32)),
                       donate_argnums=0)
        cn = norm(ce)  # donated: the unnormalized buffer is freed
        del ce
        cn.block_until_ready()
        t_embed = time.perf_counter() - t0
        qn = norm(pipe(test_data, out="device"))
        embed_rate = args.sessions / t_embed
        print(f"embed {args.sessions}: {t_embed:.1f}s ({embed_rate:.0f}/s; "
              f"+{t_compile:.1f}s compile)", flush=True)
        meta = {
            "sessions": args.sessions, "regime": args.regime,
            "asin_num": cfg.asin_num, "queries": args.queries,
            "gen_s": round(t_gen, 1), "train_steps": steps,
            "train_s": round(t_train, 1), "title_table_s": round(t_table, 1),
            "kw_table_s": round(t_kw_table, 1),
            "embed_s": round(t_embed, 1),
            "embed_sessions_per_s": round(embed_rate, 0),
        }
        if args.cache:
            # the explicit resume checkpoint is the ONE sanctioned host
            # crossing of the corpus (opt-in)
            t0 = time.perf_counter()
            with open(args.cache + ".sessions.pkl", "wb") as f:
                pickle.dump((corpus_sessions, test_data), f,
                            protocol=pickle.HIGHEST_PROTOCOL)
            np.savez(args.cache + ".npz", cn=np.asarray(cn),
                     qn=np.asarray(qn),
                     meta=np.frombuffer(
                         json.dumps(meta).encode(), dtype=np.uint8))
            print(f"cache saved: {args.cache}.npz "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)

    # --- 4. the serving corpus in every production storage form, all
    # derived ON DEVICE from the f32 corpus; the f32 buffer is freed
    # before the timing ladder so the 1M x 1600 shape fits alongside
    # the scan workspace
    cn = jnp.asarray(cn)  # no-op on the embed path; upload on cache resume
    qn = jnp.asarray(qn)
    N, D = cn.shape
    corpus = cn.astype(jnp.bfloat16)
    queries = qn.astype(jnp.bfloat16)
    c8, c_scales = _quantize_rows_int8(cn)
    q8, q_scales = _quantize_rows_int8(qn)
    c_signs = simhash_codes(cn, args.bits).astype(jnp.bfloat16)
    q_signs = simhash_codes(qn, args.bits).astype(jnp.bfloat16)
    jax.block_until_ready((corpus, queries, c8, q8, c_signs, q_signs))

    K = args.k
    chunk = N
    oracle_n = min(N, 65536)
    oracle_q = min(args.queries, 64)
    # the ONLY host views: oracle slices for the quality gates
    # ([oracle_n, D] ~ 420 MB once, vs the full corpus every mode)
    sub = np.asarray(cn[:oracle_n])
    subq = np.asarray(qn[:oracle_q])

    # --- everything that needs the f32 corpus, fitted/derived now so the
    # 6.4 GB buffer can be freed before the timing ladder:
    # PCA low-rank form (round 3: trained-encoder spectra have
    # participation ratio 9-14, so a 64-d projection preserves the cosine
    # geometry; ops/projection.py — exactness is NOT assumed, the
    # explained-variance guardrail + value-recall vs the full-dim oracle
    # are reported with the row), the LEARNED ITQ binary prefilter
    # (random SimHash bits all point at the trained corpus's shared mean
    # direction — the measured r3 binary-prefilter null; ITQ centers and
    # rotates so the same sign-scan cost carries data-dependent signal),
    # its transposed-packed storage, and the full-corpus cosine oracle
    # bars for the packed gate. Fits sample-gather on device (fit_pca /
    # fit_itq pull only [65536, D]); codes/projections compute on device.
    from sessionsimilaritysearch.ops.projection import fit_itq, fit_pca

    pca_dim = min(64, D)
    proj = fit_pca(cn, pca_dim)
    cp = proj(cn).astype(jnp.bfloat16)
    qp = proj(qn).astype(jnp.bfloat16)

    t0 = time.perf_counter()
    itq_bits = min(args.bits, D)
    itq = fit_itq(cn, itq_bits)
    t_itq = time.perf_counter() - t0
    i_mean = jnp.asarray(itq.mean, jnp.float32)
    i_comp = jnp.asarray(itq.components, jnp.float32)

    @jax.jit
    def itq_signs(x):
        y = jnp.dot(x.astype(jnp.float32) - i_mean, i_comp.T,
                    preferred_element_type=jnp.float32)
        return jnp.where(y >= 0, 1.0, -1.0).astype(jnp.bfloat16)

    ci_signs = itq_signs(cn)
    qi_signs = itq_signs(qn)
    print(f"itq fit: {t_itq:.1f}s ({itq_bits} bits)", flush=True)

    # transposed-packed ITQ codes, packed ON DEVICE (ops.hamming
    # pack_bits_t; 1 bit/bit of memory — BinaryIndex(mode='packed') storage)
    bits_pad = -(-itq_bits // 128) * 128
    n_pack = -(-N // 16384) * 16384  # whole kernel groups
    ci_pad = jnp.zeros((n_pack, bits_pad), jnp.float32)
    ci_pad = ci_pad.at[:N, :itq_bits].set(ci_signs.astype(jnp.float32))
    ci_packed = pack_bits_t(ci_pad)
    del ci_pad
    qi_pad = jnp.pad(qi_signs, ((0, 0), (0, bits_pad - itq_bits)))
    nq_real = qi_pad.shape[0]
    q_rows = -(-nq_real // 256) * 256  # kernel query-block multiple
    if q_rows != nq_real:
        qi_pad = jnp.pad(qi_pad, ((0, q_rows - nq_real), (0, 0)))

    # full-corpus cosine oracle bars (10th-best true score per query) for
    # gates whose candidates cannot be replayed on a subcorpus slice
    oracle_bars = np.asarray(jax.lax.top_k(
        jnp.dot(qn[:oracle_q], cn.T, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST), 10,
    )[0][:, 9:10])

    jax.block_until_ready((cp, qp, ci_signs, qi_signs, ci_packed, qi_pad))
    del cn  # frees the f32 corpus; the ladder runs on the derived forms

    def chain_f(q, out):
        return q + (out[0][:, :1] > 1e30).astype(q.dtype)

    modes = {}

    def run_mode(name, fn, q0, idx_fn=None, rel_tol=0.0):
        dt, out = _timed(fn, q0, args.iters, chain_f)
        I = np.asarray(out[1])
        vr = None
        if idx_fn is not None:
            vi = np.asarray(idx_fn())
            vr = value_recall_at_k(vi, subq, sub, 10, rel_tol=rel_tol)
        modes[name] = {
            "ms_per_batch": round(dt * 1e3, 1),
            "qps": round(args.queries / dt, 0),
            "value_recall10": None if vr is None else round(vr, 4),
        }
        # ground-truth quality on the full corpus retrieval
        nq = args.quality_queries
        score = get_ave_score(I[:nq, :10], test_data[:nq], corpus_sessions,
                              "all_product_type_score")
        modes[name]["ave_type_score10"] = round(score, 4)
        print(f"{name:>18}: {dt*1e3:7.1f} ms  {args.queries/dt:9,.0f} qps  "
              f"vr10={'--' if vr is None else f'{vr:.4f}'}  "
              f"type@10={score:.4f}", flush=True)
        return I

    bf16 = jnp.bfloat16
    run_mode(
        "exact_bf16",
        lambda q: chunked_topk(q, corpus, K, chunk_size=chunk, mode="exact",
                               score_dtype=bf16),
        queries,
        idx_fn=lambda: chunked_topk(
            jnp.asarray(subq, bf16), corpus[:oracle_n], 10,
            chunk_size=oracle_n, score_dtype=bf16)[1],
        rel_tol=2 * 2.0**-8,
    )
    run_mode(
        "exact_cert_bf16",
        lambda q: chunked_topk(q, corpus, K, chunk_size=chunk,
                               mode="exact_cert", score_dtype=bf16),
        queries,
        idx_fn=lambda: chunked_topk(
            jnp.asarray(subq, bf16), corpus[:oracle_n], 10,
            chunk_size=oracle_n, mode="exact_cert", score_dtype=bf16)[1],
        rel_tol=2 * 2.0**-8,
    )
    run_mode(
        "int8x8_exact",
        lambda q: chunked_topk(q, c8, K, chunk_size=chunk, mode="exact",
                               score_dtype=bf16, corpus_scales=c_scales,
                               query_scales=q_scales),
        q8,
        idx_fn=lambda: chunked_topk(
            q8[:oracle_q], c8[:oracle_n], 10, chunk_size=oracle_n,
            score_dtype=bf16, corpus_scales=c_scales[:oracle_n],
            query_scales=q_scales[:oracle_q])[1],
        rel_tol=4 / 127,
    )
    run_mode(
        "int8x8_cert",
        lambda q: chunked_topk(q, c8, K, chunk_size=chunk, mode="exact_cert",
                               score_dtype=bf16, corpus_scales=c_scales,
                               query_scales=q_scales),
        q8,
        idx_fn=lambda: chunked_topk(
            q8[:oracle_q], c8[:oracle_n], 10, chunk_size=oracle_n,
            mode="exact_cert", score_dtype=bf16,
            corpus_scales=c_scales[:oracle_n],
            query_scales=q_scales[:oracle_q])[1],
        rel_tol=4 / 127,
    )
    run_mode(
        "int8x8_approx",
        lambda q: chunked_topk(q, c8, K, chunk_size=chunk, mode="approx",
                               recall_target=0.95, score_dtype=bf16,
                               corpus_scales=c_scales,
                               query_scales=q_scales),
        q8,
        idx_fn=lambda: chunked_topk(
            q8[:oracle_q], c8[:oracle_n], 10, chunk_size=oracle_n,
            mode="approx", recall_target=0.95, score_dtype=bf16,
            corpus_scales=c_scales[:oracle_n],
            query_scales=q_scales[:oracle_q])[1],
        rel_tol=4 / 127,
    )

    # --- PCA low-rank serving (forms derived in section 4)
    dt, out = _timed(
        lambda q: chunked_topk(q, cp, K, chunk_size=chunk, mode="exact",
                               score_dtype=bf16),
        qp, args.iters, chain_f,
    )
    I = np.asarray(out[1])
    # value recall vs the FULL-dimensional oracle: does 64-d serving
    # return rows as good as 1600-d exact search would?
    _, i_sub = chunked_topk(
        qp[:oracle_q], cp[:oracle_n], 10, chunk_size=oracle_n,
        score_dtype=bf16,
    )
    vr = value_recall_at_k(np.asarray(i_sub), subq, sub, 10,
                           rel_tol=2 * 2.0**-8)
    nq = args.quality_queries
    modes[f"pca{pca_dim}_exact"] = {
        "ms_per_batch": round(dt * 1e3, 1),
        "qps": round(args.queries / dt, 0),
        "value_recall10_vs_fulldim": round(vr, 4),
        "explained_variance": round(proj.explained, 4),
        "ave_type_score10": round(
            get_ave_score(I[:nq, :10], test_data[:nq], corpus_sessions,
                          "all_product_type_score"), 4),
    }
    print(f"{f'pca{pca_dim}_exact':>18}: {dt*1e3:7.1f} ms  "
          f"{args.queries/dt:9,.0f} qps  vr10(full-d)={vr:.4f}  "
          f"explained={proj.explained:.4f}  "
          f"type@10={modes[f'pca{pca_dim}_exact']['ave_type_score10']:.4f}",
          flush=True)

    def chain_b(q, out):
        return jnp.where(out[0][:, :1] < -1, -q, q)  # never flips

    dt, out = _timed(
        lambda q: sign_topk(q, c_signs, K, n_bits=args.bits),
        q_signs, args.iters, chain_b,
    )
    I = np.asarray(out[1])
    nq = args.quality_queries
    # binary rows carry the tie-aware Hamming-oracle gate (no ungated
    # quality number in this artifact): exact sign scan
    # should read 1.0; approx is the real gate
    vr_h = _hamming_vr10(I, q_signs, c_signs, nq=oracle_q)
    modes["binary_sign"] = {
        "ms_per_batch": round(dt * 1e3, 1),
        "qps": round(args.queries / dt, 0),
        "value_recall10": round(vr_h, 4),
        "value_recall10_oracle": "hamming",
        "ave_type_score10": round(
            get_ave_score(I[:nq, :10], test_data[:nq], corpus_sessions,
                          "all_product_type_score"), 4),
    }
    print(f"{'binary_sign':>18}: {dt*1e3:7.1f} ms  "
          f"{args.queries/dt:9,.0f} qps  vr10(hamming)={vr_h:.4f}  "
          f"type@10={modes['binary_sign']['ave_type_score10']:.4f}",
          flush=True)
    dt, out = _timed(
        lambda q: sign_topk(q, c_signs, K, n_bits=args.bits, mode="approx"),
        q_signs, args.iters, chain_b,
    )
    I = np.asarray(out[1])
    vr_h = _hamming_vr10(I, q_signs, c_signs, nq=oracle_q)
    modes["binary_approx"] = {
        "ms_per_batch": round(dt * 1e3, 1),
        "qps": round(args.queries / dt, 0),
        "value_recall10": round(vr_h, 4),
        "value_recall10_oracle": "hamming",
        "ave_type_score10": round(
            get_ave_score(I[:nq, :10], test_data[:nq], corpus_sessions,
                          "all_product_type_score"), 4),
    }
    print(f"{'binary_approx':>18}: {dt*1e3:7.1f} ms  "
          f"{args.queries/dt:9,.0f} qps  vr10(hamming)={vr_h:.4f}  "
          f"type@10={modes['binary_approx']['ave_type_score10']:.4f}",
          flush=True)

    # --- two-stage serving (index/twostage.py): the binary sign scan only
    # SHORTLISTS `pool` candidates; the returned ranking is the exact
    # full-dim one over the pool (ops.topk.rerank_topk, f32 scores). This
    # is the architectural route past the exact-selection floor: end-to-end
    # quality is governed by stage-1 pool recall alone.
    from sessionsimilaritysearch.ops.topk import rerank_topk

    def chain_ts(qs, out):
        return jnp.where(out[0][:, :1] > 1e30, -qs, qs)  # never flips

    for pool in (256, 512):
        def ts_search(qs, p=pool):
            _, cand = sign_topk(qs, c_signs, p, n_bits=args.bits,
                                mode="approx", recall_target=0.95)
            return rerank_topk(queries, corpus, cand, K,
                               score_dtype=jnp.float32)

        dt, out = _timed(ts_search, q_signs, args.iters, chain_ts)
        I = np.asarray(out[1])
        sub_pool = min(pool, oracle_n)
        _, cand_sub = sign_topk(
            q_signs[:oracle_q], c_signs[:oracle_n], sub_pool,
            n_bits=args.bits, mode="approx", recall_target=0.95,
        )
        _, i_sub = rerank_topk(
            jnp.asarray(subq, bf16), corpus[:oracle_n], cand_sub, 10,
            score_dtype=jnp.float32,
        )
        vr = value_recall_at_k(np.asarray(i_sub), subq, sub, 10,
                               rel_tol=2 * 2.0**-8)
        name = f"twostage_pool{pool}"
        modes[name] = {
            "ms_per_batch": round(dt * 1e3, 1),
            "qps": round(args.queries / dt, 0),
            "value_recall10": round(vr, 4),
            "ave_type_score10": round(
                get_ave_score(I[:nq, :10], test_data[:nq], corpus_sessions,
                              "all_product_type_score"), 4),
        }
        print(f"{name:>18}: {dt*1e3:7.1f} ms  {args.queries/dt:9,.0f} qps  "
              f"vr10={vr:.4f}  type@10={modes[name]['ave_type_score10']:.4f}",
              flush=True)

    # --- LEARNED binary prefilter (ITQ; fitted in section 4). Same exact
    # full-dim re-rank over the pool.
    for pool in (128, 256):
        def itq_search(qs, p=pool):
            _, cand = sign_topk(qs, ci_signs, p, n_bits=itq_bits,
                                mode="approx", recall_target=0.95)
            return rerank_topk(queries, corpus, cand, K,
                               score_dtype=jnp.float32)

        dt, out = _timed(itq_search, qi_signs, args.iters, chain_ts)
        I = np.asarray(out[1])
        sub_pool = min(pool, oracle_n)
        _, cand_sub = sign_topk(
            qi_signs[:oracle_q], ci_signs[:oracle_n], sub_pool,
            n_bits=itq_bits, mode="approx", recall_target=0.95,
        )
        _, i_sub = rerank_topk(
            jnp.asarray(subq, bf16), corpus[:oracle_n], cand_sub, 10,
            score_dtype=jnp.float32,
        )
        vr = value_recall_at_k(np.asarray(i_sub), subq, sub, 10,
                               rel_tol=2 * 2.0**-8)
        name = f"twostage_itq_pool{pool}"
        modes[name] = {
            "ms_per_batch": round(dt * 1e3, 1),
            "qps": round(args.queries / dt, 0),
            "value_recall10": round(vr, 4),
            "ave_type_score10": round(
                get_ave_score(I[:nq, :10], test_data[:nq], corpus_sessions,
                              "all_product_type_score"), 4),
        }
        print(f"{name:>18}: {dt*1e3:7.1f} ms  {args.queries/dt:9,.0f} qps  "
              f"vr10={vr:.4f}  type@10={modes[name]['ave_type_score10']:.4f}",
              flush=True)

    # --- packed capacity tier on TRAINED embeddings: the ITQ codes stored
    # transposed-packed at 1 bit/bit of device memory and scanned by the
    # unpack+matmul scan (BinaryIndex(mode='packed') /
    # TwoStageIndex(stage1='packed') production path). Two rows: the standalone packed code
    # scan (exact Hamming ranking == binary sign at 1/16th the memory) and
    # the packed-stage-1 two-stage (exact top-pool + full-dim re-rank).
    from sessionsimilaritysearch.ops.hamming import packed_t_topk

    vc = jnp.asarray(N, jnp.int32)
    dt, out = _timed(
        lambda q: packed_t_topk(
            q, ci_packed, K, n_bits=itq_bits, valid_count=vc,
        ),
        qi_pad, args.iters, chain_b,
    )
    I = np.asarray(out[1])[:nq_real]
    vr_h = _hamming_vr10(I, qi_signs, ci_signs, nq=oracle_q)
    modes["binary_packed_itq"] = {
        "ms_per_batch": round(dt * 1e3, 1),
        "qps": round(args.queries / dt, 0),
        "value_recall10": round(vr_h, 4),
        "value_recall10_oracle": "hamming",
        "device_bytes_per_row": bits_pad // 8,
        "ave_type_score10": round(
            get_ave_score(I[:nq, :10], test_data[:nq], corpus_sessions,
                          "all_product_type_score"), 4),
    }
    print(f"{'binary_packed_itq':>18}: {dt*1e3:7.1f} ms  "
          f"{args.queries/dt:9,.0f} qps  vr10(hamming)={vr_h:.4f}  "
          f"type@10={modes['binary_packed_itq']['ave_type_score10']:.4f}"
          f"  ({bits_pad // 8} B/row)", flush=True)

    pool = 128

    def packed_ts(qs, p=pool):
        _, cand = packed_t_topk(
            qs, ci_packed, p, n_bits=itq_bits, valid_count=vc,
        )
        return rerank_topk(queries, corpus, cand[:nq_real], K,
                           score_dtype=jnp.float32)

    def chain_packed_ts(qs, out):
        # scalar flag: out rows (nq_real) != padded query rows
        return jnp.where(out[0][:1, :1] > 1e30, -qs, qs)  # never flips

    dt, out = _timed(packed_ts, qi_pad, args.iters, chain_packed_ts)
    I = np.asarray(out[1])
    name = f"twostage_packeditq_pool{pool}"
    # packed stage-1 candidates can't be replayed on a subcorpus slice
    # (the pack layout is whole-buffer), so the gate runs against the
    # FULL-corpus cosine oracle bars (precomputed in section 4 from
    # the f32 corpus) for the first oracle_q queries
    vr_f = _fullcorpus_vr10(I, qn, corpus, oracle_bars, nq=oracle_q)
    modes[name] = {
        "ms_per_batch": round(dt * 1e3, 1),
        "qps": round(args.queries / dt, 0),
        "value_recall10": round(vr_f, 4),
        "ave_type_score10": round(
            get_ave_score(I[:nq, :10], test_data[:nq], corpus_sessions,
                          "all_product_type_score"), 4),
    }
    print(f"{name:>18}: {dt*1e3:7.1f} ms  {args.queries/dt:9,.0f} qps  "
          f"vr10={vr_f:.4f}  "
          f"type@10={modes[name]['ave_type_score10']:.4f}",
          flush=True)
    del ci_packed

    result = {
        "sessions": N,
        "dim": D,
        "asin_num": cfg.asin_num,
        "regime": args.regime,
        "k": K,
        "query_batch": args.queries,
        "gen_s": meta["gen_s"],
        "train_steps": meta["train_steps"],
        "train_s": meta["train_s"],
        "title_table_s": meta["title_table_s"],
        "kw_table_s": meta.get("kw_table_s"),
        "itq_fit_s": round(t_itq, 1),
        "embed_s": meta["embed_s"],
        "embed_sessions_per_s": meta["embed_sessions_per_s"],
        "modes": modes,
    }
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
