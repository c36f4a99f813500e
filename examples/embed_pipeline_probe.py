"""Embed-path host/transfer probe.

The native graph builder runs the whole host transform as one C call per
batch; the other host cost is the per-batch device->host transfer.
`EmbeddingPipeline`'s default ('np') blocks on `np.asarray(encode(batch))`
every batch, so the [B, 1600] f32 result crosses to the host INSIDE the
timed loop and serializes with compute; `out='device'` keeps every batch
on-device and the host only blocks once, at the final concatenate — an
index build then consumes the corpus with zero host round-trips.

Measures, at flagship dims (title+keyword cached bf16 encoder) over a
100k-session corpus:
  A: pipeline out='np'                  (status quo)
  B: pipeline out='device'              (async dispatch, on-device concat)
  C: B + DenseIndex.add from the device array (end-to-end build)

Run (GPU): python examples/embed_pipeline_probe.py
Smoke:     python examples/embed_pipeline_probe.py --platform cpu --tiny
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=100_000)
    ap.add_argument("--asin-num", type=int, default=50_000)
    ap.add_argument("--embed-batch", type=int, default=1024)
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
    import jax.numpy as jnp

    from sessionsimilaritysearch.config import Config, tiny_test_config
    from sessionsimilaritysearch.data import AdversarialSessionGenerator
    from sessionsimilaritysearch.data.loader import SessionGraphLoader
    from sessionsimilaritysearch.evalharness.harness import (
        EmbeddingPipeline,
        build_keyword_table,
        build_title_table,
        make_cached_encode_fn,
    )
    from sessionsimilaritysearch.index.dense import DenseIndex
    from sessionsimilaritysearch.models.encoder import build_graph_encoder
    from sessionsimilaritysearch.tokenizer import get_tokenizer
    from sessionsimilaritysearch.training.loop import to_device
    from sessionsimilaritysearch.training.session_trainers import (
        create_session_state,
    )
    from sessionsimilaritysearch.utils.precision import serving_params

    if args.tiny:
        cfg = tiny_test_config()
        args.sessions, args.embed_batch = 1024, 128
    else:
        cfg = Config().replace(asin_num=args.asin_num, batch_size=256)

    gen = AdversarialSessionGenerator(asin_num=cfg.asin_num, seed=11)
    data = [d[0] for d in gen.dataset(args.sessions)]
    tok = get_tokenizer(cfg.vocab_size)

    # flagship serving encoder at init (bf16, cached tables) — the
    # serving_soak/flagship recipe; quality is irrelevant to this probe
    warm_loader = SessionGraphLoader(
        [(d, []) for d in data[:args.embed_batch]], tok, cfg.dims,
        min(cfg.batch_size, args.embed_batch), seed=0)
    sample = to_device(next(iter(warm_loader)))
    warm_loader.close()
    rng = jax.random.PRNGKey(0)
    _, state = create_session_state(
        cfg, rng, sample, mode="subsession", encoder_kind="flagship")
    params = serving_params(state.params)
    enc_mod = build_graph_encoder(cfg)
    enc_vars = {"params": params["encoder"]}
    table = build_title_table(cfg, tok, gen.titles, enc_mod, enc_vars,
                              batch_size=args.embed_batch)
    kws = sorted({a[2] or "" for d in data for a in d if a[1] == "s"})
    qtable, kw_lookup = build_keyword_table(
        cfg, tok, kws, enc_mod, enc_vars, batch_size=args.embed_batch)
    encode = make_cached_encode_fn(enc_mod, enc_vars, table,
                                   query_table=qtable, kw_lookup=kw_lookup)
    pipe = EmbeddingPipeline(cfg, tok, encode, batch_size=args.embed_batch)

    # warm both program caches outside the timed region
    _ = np.asarray(pipe(data[: args.embed_batch]))
    _ = pipe(data[: args.embed_batch], out="device").block_until_ready()

    report = {"sessions": len(data), "embed_batch": args.embed_batch,
              "dim": cfg.session_emb_dim,
              "platform": jax.devices()[0].platform}

    # A: status quo — per-batch blocking np.asarray
    t0 = time.perf_counter()
    emb_np = pipe(data)
    a_s = time.perf_counter() - t0
    report["A_np_s"] = round(a_s, 2)
    report["A_np_sessions_per_s"] = round(len(data) / a_s, 0)

    # B: device-resident — materialize via a data-dependent scalar
    t0 = time.perf_counter()
    emb_dev = pipe(data, out="device")
    checksum = float(jnp.sum(emb_dev))
    b_s = time.perf_counter() - t0
    report["B_device_s"] = round(b_s, 2)
    report["B_device_sessions_per_s"] = round(len(data) / b_s, 0)
    report["B_speedup_vs_A"] = round(a_s / b_s, 2)
    assert np.isfinite(checksum)

    # parity: same rows (bf16 encode is deterministic across both paths)
    head = np.asarray(emb_dev[:256])
    report["parity_max_abs_diff"] = float(np.max(np.abs(
        head - emb_np[:256])))

    # C: end-to-end index build from the device array (zero host crossings
    # of the corpus) vs from the host array
    idx = DenseIndex(dim=cfg.session_emb_dim, capacity=len(data),
                     metric="cos", dtype=jnp.bfloat16)
    t0 = time.perf_counter()
    idx.add(emb_dev)
    jax.block_until_ready(idx._buf)
    report["C_add_device_s"] = round(time.perf_counter() - t0, 2)
    idx2 = DenseIndex(dim=cfg.session_emb_dim, capacity=len(data),
                      metric="cos", dtype=jnp.bfloat16)
    t0 = time.perf_counter()
    idx2.add(emb_np)
    jax.block_until_ready(idx2._buf)
    report["C_add_np_s"] = round(time.perf_counter() - t0, 2)

    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
