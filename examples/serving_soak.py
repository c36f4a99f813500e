"""Mixed-workload serving soak.

One sustained SessionSearchEngine run at >=1M rows that interleaves every
maintenance verb the serving layer exposes — ingest / search /
remove_sessions / expire / snapshot+restore — and reports what a production
operator actually watches: sustained mixed-workload QPS, per-batch search
latency p50/p99, ingest throughput, maintenance-op cost, **jit-cache size
pinned flat** (the zero-retrace claim under realistic interleaving, not a
synthetic unit test), and device-memory stability.

The reference has no serving loop at all — its indexes are built once and
queried once (test_amazon_filterd.py:207-223); this artifact is the
evidence that the engine's streaming redesign holds up under a sustained
realistic mix, not just under per-verb unit tests.

The encoder is the flagship two-pool model at init (serving_params bf16,
title+keyword cached forward) — the soak measures serving-path stability
and cost, not retrieval quality, so training is skipped; quality evidence
lives in examples/flagship_serving.py and the quality protocol.

Run (GPU):  python examples/serving_soak.py --out runs/serving_soak.json
Smoke:      python examples/serving_soak.py --platform cpu --tiny
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from sessionsimilaritysearch.config import Config, tiny_test_config
from sessionsimilaritysearch.data import AdversarialSessionGenerator
from sessionsimilaritysearch.engine import SessionSearchEngine
from sessionsimilaritysearch.evalharness.harness import (
    build_keyword_table,
    build_title_table,
    make_cached_encode_fn,
)
from sessionsimilaritysearch.models.encoder import build_graph_encoder
from sessionsimilaritysearch.tokenizer import get_tokenizer
from sessionsimilaritysearch.training.loop import to_device
from sessionsimilaritysearch.training.session_trainers import (
    create_session_state,
)
from sessionsimilaritysearch.utils.precision import serving_params


def _jit_cache_sizes() -> dict:
    """Cache sizes of every jitted entry point the exact serving path can
    touch. A flat total across the soak IS the zero-retrace contract."""
    from sessionsimilaritysearch.ops import topk
    from sessionsimilaritysearch.parallel import collectives

    out = {}
    for name in ("chunked_topk", "rerank_topk"):
        fn = getattr(topk, name, None)
        size = getattr(fn, "_cache_size", None)
        if size is not None:
            out[name] = size()
    # the sharded serving path compiles through the collectives cache
    out["collectives"] = len(collectives._FN_CACHE)
    return out


def _pct(lat_s, q):
    a = np.asarray(lat_s, dtype=np.float64) * 1e3
    return {
        "p50_ms": round(float(np.percentile(a, 50)), 3),
        "p99_ms": round(float(np.percentile(a, 99)), 3),
        "mean_ms": round(float(a.mean()), 3),
        "batches": len(a),
        "qps": round(q * len(a) / float(np.sum(a) / 1e3), 1),
    }


def run_soak(args) -> dict:
    if args.tiny:
        cfg = tiny_test_config()
        args.rows = min(args.rows, 1024)
        args.fill_chunk, args.batches = 256, 8
        args.qbatch = args.ibatch = 64
        args.remove_every, args.expire_every = 3, 4
        args.embed_batch = 64
    elif args.tiny_model:
        # tiny DIMS, caller-chosen rows/batches: the CPU-mesh soak
        # artifact wants realistic row counts and the full verb mix
        # without a 1600-d text-encoder table build on CPU.
        cfg = tiny_test_config()
    else:
        cfg = Config().replace(asin_num=args.asin_num, batch_size=256)
    gen = AdversarialSessionGenerator(asin_num=cfg.asin_num, seed=7)
    tok = get_tokenizer(cfg.vocab_size)

    # --- encoder at init, bf16 serving params, cached tables (the
    # flagship_serving.py recipe minus training)
    t0 = time.perf_counter()
    warm = gen.dataset(args.embed_batch)
    from sessionsimilaritysearch.data.loader import SessionGraphLoader

    loader = SessionGraphLoader(
        warm, tok, cfg.dims, min(cfg.batch_size, len(warm)), seed=0)
    sample = to_device(next(iter(loader)))
    rng = jax.random.PRNGKey(0)
    _, state = create_session_state(
        cfg, rng, sample, mode="subsession", encoder_kind="flagship")
    params = serving_params(state.params)
    enc_mod = build_graph_encoder(cfg)
    enc_vars = {"params": params["encoder"]}
    table = build_title_table(cfg, tok, gen.titles, enc_mod, enc_vars,
                              batch_size=args.embed_batch)
    kws = sorted({a[2] or "" for d in warm for a in d[0] if a[1] == "s"})
    qtable, kw_lookup = build_keyword_table(
        cfg, tok, kws, enc_mod, enc_vars, batch_size=args.embed_batch)
    encode = make_cached_encode_fn(enc_mod, enc_vars, table,
                                   query_table=qtable, kw_lookup=kw_lookup)
    t_setup = time.perf_counter() - t0
    dim = cfg.session_emb_dim
    print(f"setup (init encoder + tables, dim={dim}): {t_setup:.1f}s",
          flush=True)

    # stream headroom: the mixed phase net-adds ibatch rows per iteration
    capacity = args.rows + args.batches * args.ibatch + 4 * args.ibatch
    mesh = None
    if getattr(args, "mesh", 0):
        # sharded-engine soak: the same mixed verb
        # load against ShardedDenseIndex over a device mesh — stable gids,
        # tombstoned metadata, collective search, lock-held fallback save
        from sessionsimilaritysearch.parallel import create_mesh

        mesh = create_mesh(devices=jax.devices()[: args.mesh])
    # bf16 corpus storage: the benched production dtype (value-recall
    # gated at 2 ulps) — at 1M x 1600 the f32 default costs 6.8 GB/buffer
    # and leaves no headroom for snapshot-restore on a 16 GB chip
    eng = SessionSearchEngine(
        cfg, tok, encode, dim=dim, capacity=capacity, mesh=mesh,
        batch_size=args.embed_batch, dtype=jnp.bfloat16,
    )

    # --- phase FILL: bulk ingest to args.rows (unstamped -> never expires;
    # the expire verb acts on the streamed tail, remove_sessions exercises
    # compaction over the whole id space)
    t0 = time.perf_counter()
    n_fill = 0
    gen_s = 0.0
    while n_fill < args.rows:
        m = min(args.fill_chunk, args.rows - n_fill)
        tg = time.perf_counter()
        chunk = gen.dataset(m)
        gen_s += time.perf_counter() - tg
        eng.add_sessions([d[0] for d in chunk])
        n_fill += m
        if n_fill % (args.fill_chunk * 16) == 0:
            print(f"  fill {n_fill}/{args.rows}", flush=True)
    fill_s = time.perf_counter() - t0
    ingest_rate = args.rows / max(fill_s - gen_s, 1e-9)
    print(f"fill {args.rows} rows: {fill_s:.1f}s "
          f"({ingest_rate:.0f} sessions/s ingest, {gen_s:.1f}s generate)",
          flush=True)

    # --- query pool + streamed-session pool for the mixed phase
    qpool = gen.dataset(max(4 * args.qbatch, 512))
    stream = gen.dataset(args.batches * args.ibatch)
    # parity-check batch matches the serving (shape, k) exactly, so the
    # snapshot check reuses the warm search program
    fixed_q = [d for d in qpool[: args.qbatch]]

    dev = jax.local_devices()[0]

    def hbm():
        try:
            return int(dev.memory_stats()["bytes_in_use"])
        except Exception:
            # backends without memory_stats: fall back to
            # the process's live device arrays (an upper bound on what WE
            # hold — exactly the leak signal the stability claim needs)
            try:
                return int(sum(
                    x.nbytes for x in jax.live_arrays()
                    if dev in getattr(x, "devices", lambda: set())()
                ))
            except Exception:
                return None

    # --- warmup: touch every verb once so all jit caches are populated
    # BEFORE the flat-cache window opens
    eng.search(qpool[: args.qbatch], k=args.k)
    victims = [stream[i][0] for i in range(min(8, len(stream)))]
    eng.add_sessions(victims, stamp=-1.0)
    eng.remove_sessions(data=victims)
    eng.expire(before=-0.5)
    cache0 = _jit_cache_sizes()
    hbm0 = hbm()
    print(f"warmup done; jit caches {cache0}, hbm={hbm0}", flush=True)

    # --- phase MIXED: sustained interleaving
    lat, lat_during_save, events = [], [], []
    removed_total = expired_total = 0
    snap = None
    save_handle = None
    save_t0 = save_s = None
    snap_ref = None
    t_mix = time.perf_counter()
    for i in range(args.batches):
        q0 = (i * args.qbatch) % (len(qpool) - args.qbatch + 1)
        save_in_flight = save_handle is not None and not save_handle.done()
        t0 = time.perf_counter()
        D, I = eng.search(qpool[q0: q0 + args.qbatch], k=args.k)
        # chain a data dependency: materialize scores on host
        float(np.asarray(D)[:, 0].sum())
        (lat_during_save if save_in_flight else lat).append(
            time.perf_counter() - t0)
        if save_handle is not None and save_s is None \
                and save_handle.done():
            save_s = time.perf_counter() - save_t0

        batch = [d[0] for d in stream[i * args.ibatch:(i + 1) * args.ibatch]]
        t0 = time.perf_counter()
        eng.add_sessions(batch, stamp=float(i))
        events.append(("ingest", time.perf_counter() - t0))

        if args.remove_every and (i + 1) % args.remove_every == 0:
            # content-keyed removal of a random slice of the bulk corpus
            rs = np.random.default_rng(i)
            idx = rs.choice(len(eng.sessions), size=args.ibatch,
                            replace=False)
            vict = [eng.sessions[j] for j in idx]
            t0 = time.perf_counter()
            removed_total += eng.remove_sessions(data=vict)
            events.append(("remove", time.perf_counter() - t0))
        if args.expire_every and (i + 1) % args.expire_every == 0:
            # TTL: drop streamed rows older than a sliding window
            t0 = time.perf_counter()
            expired_total += eng.expire(before=float(i - args.expire_every))
            events.append(("expire", time.perf_counter() - t0))
        if i == args.batches // 2:
            # NON-BLOCKING snapshot mid-run: capture + kick off the
            # background write, then KEEP SERVING — the during-save search
            # latencies land in lat_during_save (p99 during save must
            # stay <=2x steady-state). Restore + parity
            # check happen after the mixed phase so the restore (which
            # rolls the corpus back to the capture point by design)
            # doesn't perturb the sustained-QPS window.
            prefix = os.path.join(args.workdir, "soak_snap")
            # same (shape, k) as the serving searches: the parity check
            # must not itself be a new jit program
            Db, Ib = eng.search(fixed_q, k=args.k)
            snap_ref = (np.asarray(Db), np.asarray(Ib))
            save_t0 = time.perf_counter()
            eng_capture_ntotal = eng.index.ntotal
            save_handle = eng.save_async(prefix)
            events.append(("snapshot_capture",
                           time.perf_counter() - save_t0))
            print(f"  snapshot@{i}: capture+dispatch "
                  f"{time.perf_counter() - save_t0:.2f}s (write streams in "
                  "the background; serving continues)", flush=True)
    mix_s = time.perf_counter() - t_mix
    ntotal_end = eng.index.ntotal
    if save_handle is not None:
        save_handle.join()
        if save_s is None:  # write outlived the mixed phase
            save_s = time.perf_counter() - save_t0
        t0 = time.perf_counter()
        eng.restore(os.path.join(args.workdir, "soak_snap"))
        t_restore = time.perf_counter() - t0
        Da, Ia = eng.search(fixed_q, k=args.k)
        same = bool(np.array_equal(snap_ref[1], np.asarray(Ia)))
        snap = {"save_s": round(save_s, 2),
                "restore_s": round(t_restore, 2),
                "search_identical_after_restore": same,
                "search_batches_during_save": len(lat_during_save),
                "ntotal": eng_capture_ntotal}
        print(f"  snapshot: save {save_s:.1f}s (non-blocking, "
              f"{len(lat_during_save)} search batches served during it) "
              f"restore {t_restore:.1f}s identical={same}", flush=True)
    cache1 = _jit_cache_sizes()
    hbm1 = hbm()

    ev = {}
    for kind, dt in events:
        ev.setdefault(kind, []).append(dt * 1e3)
    search = _pct(lat, args.qbatch)
    search_during_save = (_pct(lat_during_save, args.qbatch)
                          if lat_during_save else None)
    report = {
        "rows": args.rows,
        "dim": dim,
        "capacity": capacity,
        "mesh_devices": getattr(args, "mesh", 0) or None,
        "ntotal_end": ntotal_end,
        "platform": jax.default_backend(),
        "setup_s": round(t_setup, 1),
        "fill_s": round(fill_s, 1),
        "ingest_sessions_per_s": round(ingest_rate, 0),
        "mixed_batches": args.batches,
        "mixed_wall_s": round(mix_s, 1),
        "sustained_mixed_qps": round(args.batches * args.qbatch / mix_s, 1),
        "search": search,
        "search_during_save": search_during_save,
        "ops_ms": {
            k: {"mean": round(float(np.mean(v)), 1),
                "max": round(float(np.max(v)), 1), "n": len(v)}
            for k, v in sorted(ev.items())
        },
        "removed_rows": removed_total,
        "expired_rows": expired_total,
        "snapshot": snap,
        "jit_cache_after_warmup": cache0,
        "jit_cache_end": cache1,
        "jit_cache_flat": cache0 == cache1,
        "hbm_bytes_after_warmup": hbm0,
        "hbm_bytes_end": hbm1,
        "engine_stats": {k: v for k, v in eng.stats().items()
                         if k in ("ntotal", "pending")},
    }
    return report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--asin-num", type=int, default=50_000)
    ap.add_argument("--fill-chunk", type=int, default=8192)
    ap.add_argument("--batches", type=int, default=80,
                    help="mixed-phase iterations")
    ap.add_argument("--qbatch", type=int, default=256)
    ap.add_argument("--ibatch", type=int, default=256)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--embed-batch", type=int, default=1024)
    ap.add_argument("--remove-every", type=int, default=10)
    ap.add_argument("--expire-every", type=int, default=20)
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard the engine over this many devices "
                         "(0 = single-chip)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--tiny-model", action="store_true", help=(
        "tiny encoder dims but caller-chosen rows/batches "
        "(CPU-mesh artifact mode)"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from sessionsimilaritysearch.runtime import (
        enable_compile_cache,
        force_platform,
    )

    if args.platform:
        force_platform(args.platform)
    enable_compile_cache()
    if args.workdir is None:
        args.workdir = tempfile.mkdtemp(prefix="soak_")
    report = run_soak(args)
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}")
    if not report["jit_cache_flat"]:
        print("WARNING: jit cache grew during the mixed phase "
              f"({report['jit_cache_after_warmup']} -> "
              f"{report['jit_cache_end']})", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
