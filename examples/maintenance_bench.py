"""Measure the FAISS-maintenance surface at the bench shape: for a
serving framework the maintenance APIs' latency is a headline number.

At 1M x 1600 (bf16 corpus, 'cos') on one GPU:

1. range_search QPS across radii, from easy (one compiled depth) to
   HOSTILE (a radius containing most of the corpus, driving the adaptive
   depth to capacity) — reporting the top-k depths each radius compiled
   (the O(log size) program count is the design claim, docs/PARITY.md).
2. filtered search (row_mask) overhead vs the unmasked exact scan.
3. bulk remove_ids wall time + search throughput immediately after — the
   fixed-capacity zero-retrace contract says post-remove latency must
   match pre-remove (scan cost ∝ capacity): single-chip positional
   compaction AND the sharded stable-gid compaction (1-device mesh).
4. merge_from wall time (shard consolidation).

Run (GPU): python examples/maintenance_bench.py
Smoke:     python examples/maintenance_bench.py --platform cpu --tiny

Reference anchors: faiss.Index.range_search / remove_ids / merge_from and
IDSelector filtering; the reference itself only ever timed
index.search (fine_tune_ours.py:875-879).
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
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default="runs/maintenance_bench.json")
    ap.add_argument("--iters", type=int, default=10)
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

    from sessionsimilaritysearch.index.dense import DenseIndex
    from sessionsimilaritysearch.ops.topk import l2_normalize

    if args.tiny:
        N, D, K, Q = 1 << 14, 128, 100, 256
        RQ = 16  # range-search query batch
        merge_n = 1 << 12
        remove_n = 1 << 12
    else:
        N, D, K, Q = 1 << 20, 1600, 100, 1024
        RQ = 64
        merge_n = 1 << 18
        remove_n = 100_000

    rec = {"N": N, "D": D, "K": K, "query_batch": Q}
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    # corpus stays ON DEVICE end-to-end (zero host crossings) AND in bf16
    # with chunk-wise f32 normalize (an f32 corpus plus whole-corpus
    # normalize temps plus the index buffer is ~21 GB transient;
    # bench.py's bf16 recipe is the proven budget at this shape).
    CH = min(N, 1 << 17)
    corpus = jax.random.normal(k1, (N, D), jnp.bfloat16)
    corpus = jnp.concatenate([
        l2_normalize(corpus[i: i + CH].astype(jnp.float32)).astype(
            jnp.bfloat16)
        for i in range(0, N, CH)
    ])
    corpus.block_until_ready()
    # queries stay DEVICE-RESIDENT for timing: each host->device query
    # batch is ~6.5 MB; the device-resident number is the honest scan
    # cost.
    queries = l2_normalize(jax.random.normal(k2, (Q, D), jnp.float32))
    queries.block_until_ready()

    # capacity leaves room for two merge sources (cold + warm merge below);
    # the streaming contract scans CAPACITY, so every search number here is
    # the honest serving cost at this capacity (1.5x bench.py's 1M scan)
    cap = N + 2 * merge_n
    rec["capacity"] = cap
    idx = DenseIndex(dim=D, capacity=cap, metric="cos",
                     dtype=jnp.bfloat16, chunk_size=cap,
                     score_dtype=jnp.bfloat16)
    for i in range(0, N, CH):  # chunked adds bound the normalize temps
        idx.add(corpus[i: i + CH])
    del corpus  # 3.4 GB: free it before timing (memory headroom)

    def timed_search(label, n_iter=None, row_mask=None, index=None):
        # bench.py's protocol: chain iterations through a data dependency
        # and materialize ONCE — per-iteration np.asarray would add a
        # [q,k] host transfer to every batch.
        ix = index if index is not None else idx
        n_iter = n_iter or args.iters
        q = queries
        for _ in range(2):
            D_, I_ = ix.search(q, K, row_mask=row_mask, out="device")
            q = queries + (D_[:, :1] * 1e-12).astype(queries.dtype)
        np.asarray(D_)
        t0 = time.perf_counter()
        for _ in range(n_iter):
            D_, I_ = ix.search(q, K, row_mask=row_mask, out="device")
            q = queries + (D_[:, :1] * 1e-12).astype(queries.dtype)
        np.asarray(D_)
        dt = (time.perf_counter() - t0) / n_iter
        rec[label] = {"ms_per_batch": round(dt * 1e3, 1),
                      "qps": round(Q / dt, 1)}
        print(f"{label:>28}: {dt*1e3:8.1f} ms  {Q/dt:10,.1f} qps",
              flush=True)
        return D_, I_

    # --- baseline: the unmasked exact scan (the bench.py headline path)
    timed_search("search_unmasked")

    # --- 2. filtered search: 50% random gid mask (IDSelector counterpart),
    # device-resident at capacity length (a host mask costs a ~1.3 MB
    # upload per call)
    mask = np.zeros(idx.capacity, bool)
    mask[:N] = np.random.default_rng(0).random(N) < 0.5
    mask_dev = jnp.asarray(mask)
    mask_dev.block_until_ready()
    timed_search("search_row_mask_50pct", row_mask=mask_dev)

    # --- 1. range_search across radii. On unit-norm iid Gaussian rows at
    # this dimension, cosines concentrate near 0 with sd ~ 1/sqrt(D), so
    # the radii sweep hit-set sizes from ~0 to ~half the corpus (hostile).
    sd = 1.0 / np.sqrt(D)
    radii = [
        ("easy", 5.0 * sd),      # ~0 hits: one compiled depth
        ("moderate", 3.0 * sd),  # ~0.1% of the corpus per query
        ("hostile", 0.0),        # ~50% of the corpus: depth -> capacity
    ]
    rq = queries[:RQ]
    for name, radius in radii:
        depths = []
        orig_search = idx.search

        def counting_search(q, k, _o=orig_search, _d=depths, **kw):
            _d.append(k)
            return _o(q, k, **kw)

        idx.search = counting_search
        try:
            t0 = time.perf_counter()
            lims, Dr, Ir = idx.range_search(rq, radius)
            dt = time.perf_counter() - t0
            # second call: every depth program is now cached — the
            # steady-state serving number
            depths2 = []
            depths.clear()
            t0 = time.perf_counter()
            lims, Dr, Ir = idx.range_search(rq, radius)
            dt_warm = time.perf_counter() - t0
            depths2 = list(depths)
        finally:
            idx.search = orig_search
        hits = float(np.diff(lims).mean())
        rec[f"range_{name}"] = {
            "radius": round(float(radius), 5),
            "mean_hits_per_query": round(hits, 1),
            "depths": depths2,
            "cold_s": round(dt, 2),
            "warm_s": round(dt_warm, 2),
            "warm_qps": round(RQ / dt_warm, 1),
        }
        print(f"{'range_' + name:>28}: radius={radius:.4f} "
              f"hits/q={hits:10,.1f} depths={depths2} "
              f"cold={dt:.2f}s warm={dt_warm:.2f}s "
              f"({RQ / dt_warm:,.1f} qps)", flush=True)

    def _settle():
        # force completion of donated device writes with a tiny
        # data-dependent host read
        np.asarray(idx._buf[0, :8].astype(jnp.float32))

    # --- 4. merge_from: consolidate a merge_n-row index into this one.
    # merge retraces per distinct SOURCE size (maintenance op, not a
    # serving path) — measure cold (compile included) and warm (a second
    # same-sized merge: the steady shard-consolidation cost).
    src = DenseIndex(dim=D, capacity=merge_n, metric="cos",
                     dtype=jnp.bfloat16, chunk_size=merge_n)
    k3 = jax.random.PRNGKey(7)
    src.add(l2_normalize(
        jax.random.normal(k3, (merge_n, D), jnp.float32)
    ).astype(jnp.bfloat16))
    merge_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        added = idx.merge_from(src)
        _settle()
        merge_s.append(time.perf_counter() - t0)
    del src
    rec["merge_from"] = {
        "rows": added, "cold_s": round(merge_s[0], 2),
        "warm_s": round(merge_s[1], 3),
        "warm_rows_per_s": round(added / merge_s[1], 1),
    }
    print(f"{'merge_from':>28}: {added} rows cold={merge_s[0]:.2f}s "
          f"warm={merge_s[1]:.3f}s ({added/merge_s[1]:,.0f} rows/s warm)",
          flush=True)
    timed_search("search_after_merge")

    # --- 3. bulk remove_ids + post-remove throughput (single-chip
    # positional compaction); cold (compile) + warm, disjoint victim sets
    rng = np.random.default_rng(1)
    # draw from the ORIGINAL N rows so the same victim set is valid for
    # the sharded index below (which never saw the merge)
    victims = rng.choice(N, size=2 * remove_n, replace=False)
    remove_s = []
    for half in (victims[:remove_n], victims[remove_n:]):
        t0 = time.perf_counter()
        removed = idx.remove_ids(half)
        _settle()
        remove_s.append(time.perf_counter() - t0)
    rec["remove_ids"] = {
        "rows": removed, "cold_s": round(remove_s[0], 2),
        "warm_s": round(remove_s[1], 3),
        "warm_rows_per_s": round(removed / remove_s[1], 1),
    }
    print(f"{'remove_ids':>28}: {removed} rows cold={remove_s[0]:.2f}s "
          f"warm={remove_s[1]:.3f}s "
          f"({removed/remove_s[1]:,.0f} rows/s warm)", flush=True)
    timed_search("search_after_remove")
    del idx

    # --- sharded stable-gid compaction on a 1-device mesh (the engine's
    # scale-out id semantics: gids never renumber)
    from jax.sharding import Mesh

    from sessionsimilaritysearch.index.sharded import ShardedDenseIndex

    mesh1 = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    sidx = ShardedDenseIndex(dim=D, capacity=N, mesh=mesh1,
                             dtype=jnp.bfloat16, chunk_size=N,
                             score_dtype=jnp.bfloat16)
    # fresh unit-norm rows, generated per chunk (the dense corpus was
    # freed above for memory headroom; row identity is irrelevant to cost)
    for i in range(0, N, CH):  # chunked adds bound the normalize temps
        ck = jax.random.normal(jax.random.fold_in(k1, i), (min(CH, N - i), D))
        sidx.add(l2_normalize(ck).astype(jnp.bfloat16))
        del ck

    timed_search("sharded_search_before_remove", index=sidx)
    s_remove_s = []
    for half in (victims[:remove_n], victims[remove_n:]):
        t0 = time.perf_counter()
        removed = sidx.remove_ids(half)
        np.asarray(sidx._buf[0, :8].astype(jnp.float32))
        s_remove_s.append(time.perf_counter() - t0)
    rec["sharded_remove_ids"] = {
        "rows": removed, "cold_s": round(s_remove_s[0], 2),
        "warm_s": round(s_remove_s[1], 3),
        "warm_rows_per_s": round(removed / s_remove_s[1], 1),
    }
    print(f"{'sharded_remove_ids':>28}: {removed} rows "
          f"cold={s_remove_s[0]:.2f}s warm={s_remove_s[1]:.3f}s "
          f"({removed/s_remove_s[1]:,.0f} rows/s warm)", flush=True)
    timed_search("sharded_search_after_remove", index=sidx)

    rec["platform"] = jax.devices()[0].platform
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: v for k, v in rec.items()
                      if not isinstance(v, dict)}))


if __name__ == "__main__":
    main()
