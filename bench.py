"""Benchmark: exact top-K session-similarity search throughput on one GPU.

Headline metric (BASELINE.md): queries/sec/chip for exact cosine top-100
over a ~1M-session embedding shard at the reference's dimensions
(d=1600 = the GraphLevelEncoder output, K=100 = test_amazon_filterd.py:460),
with recall@10 vs a brute-force oracle verified on a subcorpus.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"} where
vs_baseline is value / 10_000 (the >=10k QPS/chip target from BASELINE.json).
The same line carries the binary (Hamming) serving path as extra keys
("binary_sign_qps_250b": the +-1 matmul scan over 250-bit codes, the
reference's timed hashing path, fine_tune_ours.py:871-879) so the driver's
single-line parse stays intact while the binary number is recorded.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from sessionsimilaritysearch.ops.topk import (
        chunked_topk,
        l2_normalize,
        oracle_topk_np,
        recall_at_k,
        value_recall_at_k,
    )

    from sessionsimilaritysearch.runtime import (
        enable_compile_cache,
        require_platform,
    )

    enable_compile_cache()
    if require_platform() == "gpu":
        N, D, K, Q = 1 << 20, 1600, 100, 1024  # ~1.05M sessions
        chunk = N  # single pass: the 1M x 1024 score buffer fits the card
        oracle_n, oracle_q = 65536, 64
        iters = 20
    else:  # the caller forced the CPU: toy shapes that check the contract
        N, D, K, Q = 1 << 15, 256, 100, 256
        chunk = 1 << 13
        oracle_n, oracle_q = 4096, 16
        iters = 3

    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    # build the corpus on device in bf16 (half the memory of f32)
    corpus = jax.random.normal(k1, (N, D), dtype=jnp.bfloat16)
    corpus = l2_normalize(corpus.astype(jnp.float32)).astype(jnp.bfloat16)
    queries = jax.random.normal(k2, (Q, D), dtype=jnp.float32)
    queries = l2_normalize(queries).astype(jnp.bfloat16)
    jax.block_until_ready((corpus, queries))

    # --- correctness gate for the bf16-scored scan: value-aware recall@10
    # vs the f64 numpy oracle on a subcorpus, scored EXACTLY like the timed
    # path. Index-set recall under-reads when candidates sit closer than the
    # score dtype resolves (ties churn, every retrieved row equally good);
    # value recall credits a hit when the retrieved row's TRUE score reaches
    # the oracle's 10th score within 2 bf16 ulps (ops.topk.value_recall_at_k).
    score_dtype = jnp.bfloat16
    sub = np.asarray(corpus[:oracle_n], np.float32)
    subq = np.asarray(queries[:oracle_q], np.float32)
    d_dev, i_dev = chunked_topk(
        jnp.asarray(subq, jnp.bfloat16), corpus[:oracle_n], 10,
        chunk_size=chunk, score_dtype=score_dtype,
    )
    _, i_oracle = oracle_topk_np(subq, sub, 10)
    set_recall10 = recall_at_k(np.asarray(i_dev), i_oracle)
    recall10 = value_recall_at_k(
        np.asarray(i_dev), subq, sub, 10, rel_tol=2 * 2.0**-8
    )
    if recall10 < 0.999:  # guard failed: fall back to strictly-f32 scores
        score_dtype = jnp.float32
        _, i_dev = chunked_topk(
            jnp.asarray(subq, jnp.bfloat16), corpus[:oracle_n], 10,
            chunk_size=chunk, score_dtype=score_dtype,
        )
        set_recall10 = recall_at_k(np.asarray(i_dev), i_oracle)
        recall10 = value_recall_at_k(
            np.asarray(i_dev), subq, sub, 10, rel_tol=0.0
        )

    # --- throughput: timed exact top-K over the full shard. NOTE: corpus
    # must be a traced argument, not a closure capture -- capturing bakes
    # the multi-GB array into the lowered program as a constant.
    def search(q):
        return chunked_topk(q, corpus, K, chunk_size=chunk, mode="exact",
                            bucket=128, score_dtype=score_dtype)

    # compile + warm: several chained materialized iterations, so no prior
    # async work (corpus normalize, oracle pass) overlaps the timed region
    q = queries
    for _ in range(3):
        vals, _ = search(q)
        q = q + (vals[:, :1] * 1e-12).astype(q.dtype)
    np.asarray(vals)
    t0 = time.perf_counter()
    for _ in range(iters):
        vals, idx = search(q)
        # chain iterations through a data dependency so a lazily-dispatching
        # runtime cannot overlap or defer them past the timer
        q = q + (vals[:, :1] * 1e-12).astype(q.dtype)
    np.asarray(vals)
    dt = (time.perf_counter() - t0) / iters
    qps = Q / dt

    # --- binary (Hamming) serving path: exact top-K over 250-bit sign
    # codes via the single-pass +-1 bf16 matmul scan (lossless: +-1 dots
    # are integers <= 250, below bf16's 256 exact-integer limit). Ranking
    # pinned identical to XOR+popcount by tests/test_topk_index.py.
    from sessionsimilaritysearch.ops.hamming import sign_topk

    bits = 250 if N >= (1 << 20) else 64  # the reference's code width
    kb1, kb2 = jax.random.split(jax.random.PRNGKey(1))
    c_signs = jnp.where(
        jax.random.bernoulli(kb1, 0.5, (N, bits)), 1.0, -1.0
    ).astype(jnp.bfloat16)
    q_signs = jnp.where(
        jax.random.bernoulli(kb2, 0.5, (Q, bits)), 1.0, -1.0
    ).astype(jnp.bfloat16)
    jax.block_until_ready((c_signs, q_signs))
    qb = q_signs
    for _ in range(3):
        bd, _ = sign_topk(qb, c_signs, K, n_bits=bits)
        qb = jnp.where(bd[:, :1] < -1, -qb, qb)  # data dep; never flips
    np.asarray(bd)
    t0 = time.perf_counter()
    for _ in range(iters):
        bd, bi = sign_topk(qb, c_signs, K, n_bits=bits)
        qb = jnp.where(bd[:, :1] < -1, -qb, qb)
    np.asarray(bd)
    b_dt = (time.perf_counter() - t0) / iters
    binary_qps = Q / b_dt

    # --- binary + approx selection (lax.approx_max_k; backends without a
    # native partial reduction lower it to an exact selection). Quality
    # gate: every returned slot's TRUE Hamming distance must meet the
    # exact k-th bar (tie-aware -- integer distances tie heavily).
    bd_e = bd  # exact distances from the timed loop above (sorted asc)
    qb2 = qb
    for _ in range(3):
        bda, _ = sign_topk(qb2, c_signs, K, n_bits=bits, mode="approx")
        qb2 = jnp.where(bda[:, :1] < -1, -qb2, qb2)
    np.asarray(bda)
    t0 = time.perf_counter()
    for _ in range(iters):
        bda, bia = sign_topk(qb2, c_signs, K, n_bits=bits, mode="approx")
        qb2 = jnp.where(bda[:, :1] < -1, -qb2, qb2)
    np.asarray(bda)
    binary_approx_qps = Q / ((time.perf_counter() - t0) / iters)
    binary_approx_recall = float(
        (np.sort(np.asarray(bda), 1) <= np.asarray(bd_e)[:, -1:]).mean()
    )

    # --- sharded binary serving on ONE chip (index/sharded_binary.py on a
    # 1-device mesh): the shard_map + integer-merge path of
    # ShardedBinaryIndex, measured against the raw sign scan above so the
    # scale-out machinery's single-chip overhead is a recorded number.
    # Timed device-resident like every other row; a separate host-serving
    # number records the numpy-in / numpy-out cost for callers that live
    # on the host.
    from jax.sharding import Mesh
    from sessionsimilaritysearch.index.sharded_binary import (
        ShardedBinaryIndex,
    )

    mesh1 = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    sb = ShardedBinaryIndex(n_bits=bits, capacity=N, mesh=mesh1)
    sb.add(c_signs)
    qs = q_signs  # device-resident, same array the raw sign row scans
    for _ in range(3):
        sbd, _ = sb.search(qs, K, out="device")
        qs = jnp.where(sbd[:, :1] < -1, -qs, qs)  # data dep; never flips
    np.asarray(sbd)
    t0 = time.perf_counter()
    for _ in range(iters):
        sbd, _ = sb.search(qs, K, out="device")
        qs = jnp.where(sbd[:, :1] < -1, -qs, qs)
    np.asarray(sbd)
    sharded_binary_qps = Q / ((time.perf_counter() - t0) / iters)
    sharded_binary_exact = bool(
        (np.sort(np.asarray(sbd), 1) == np.sort(np.asarray(bd_e), 1)).all()
    )
    # host-serving form: numpy queries in, (D, I) materialized out —
    # includes the host<->device link per call by construction
    qs_host = np.asarray(q_signs.astype(jnp.float32))
    for _ in range(2):
        sbdh, _ = sb.search(qs_host, K)
    t0 = time.perf_counter()
    for _ in range(iters):
        sbdh, _ = sb.search(qs_host, K)
    sharded_binary_host_qps = Q / ((time.perf_counter() - t0) / iters)
    del sb, mesh1

    # --- packed capacity tier (BinaryIndex(mode='packed')): codes stored
    # transposed-packed at 1 bit/bit of device memory (32 MB here vs
    # 500 MB for the sign rows), scanned by the unpack+matmul scan
    # (ops.hamming.packed_t_topk). Distances are exact, so the quality
    # gate is distance-set equality.
    from sessionsimilaritysearch.ops.hamming import (
        pack_bits_t_np,
        packed_t_topk,
    )

    bits_pad = -(-bits // 128) * 128
    signs_host = np.asarray(c_signs.astype(jnp.float32))
    packed_t = jnp.asarray(
        pack_bits_t_np(
            np.pad(signs_host, ((0, 0), (0, bits_pad - bits)))
        )
    )
    del signs_host
    qp_pad = jnp.pad(q_signs, ((0, 0), (0, bits_pad - bits)))
    jax.block_until_ready((packed_t, qp_pad))
    qb3 = qp_pad
    for _ in range(3):
        bdp, _ = packed_t_topk(qb3, packed_t, K, n_bits=bits)
        qb3 = jnp.where(bdp[:, :1] < -1, -qb3, qb3)
    np.asarray(bdp)
    t0 = time.perf_counter()
    for _ in range(iters):
        bdp, _ = packed_t_topk(qb3, packed_t, K, n_bits=bits)
        qb3 = jnp.where(bdp[:, :1] < -1, -qb3, qb3)
    np.asarray(bdp)
    binary_packed_qps = Q / ((time.perf_counter() - t0) / iters)
    binary_packed_exact = bool(
        (np.sort(np.asarray(bdp), 1) == np.sort(np.asarray(bd_e), 1)).all()
    )
    del packed_t

    # --- int8 x int8 scan (DenseIndex(quantize='int8x8')): both sides
    # quantized per-row to int8 so the matmul runs int8 x int8 -> int32
    # and the corpus is HALF the memory of bf16. Retrieval quality is gated
    # the same way as bf16 but at the two-sided quantization tolerance
    # (4/127).
    from sessionsimilaritysearch.index.dense import _quantize_rows_int8

    c8, c_scales = _quantize_rows_int8(corpus.astype(jnp.float32))
    q8, q_scales = _quantize_rows_int8(queries.astype(jnp.float32))
    jax.block_until_ready((c8, c_scales, q8, q_scales))
    d8, i8 = chunked_topk(
        q8[:oracle_q], c8[:oracle_n], 10, chunk_size=oracle_n,
        corpus_scales=c_scales[:oracle_n], query_scales=q_scales[:oracle_q],
        score_dtype=jnp.bfloat16,
    )
    int8_recall10 = value_recall_at_k(
        np.asarray(i8), subq, sub, 10, rel_tol=4 / 127
    )

    def search_int8(q):
        return chunked_topk(q, c8, K, chunk_size=chunk, mode="exact",
                            bucket=128, score_dtype=jnp.bfloat16,
                            corpus_scales=c_scales, query_scales=q_scales)

    qi = q8
    for _ in range(3):
        iv, _ = search_int8(qi)
        qi = qi + (iv[:, :1] > 1e30).astype(qi.dtype)  # data dep; adds 0
    np.asarray(iv)
    t0 = time.perf_counter()
    for _ in range(iters):
        iv, _ = search_int8(qi)
        qi = qi + (iv[:, :1] > 1e30).astype(qi.dtype)
    np.asarray(iv)
    int8_qps = Q / ((time.perf_counter() - t0) / iters)

    # --- int8x8 matmul + approx_max_k selection, gated by value-recall@10
    # at the int8 tolerance.
    d8a, i8a = chunked_topk(
        q8[:oracle_q], c8[:oracle_n], 10, chunk_size=oracle_n,
        mode="approx", recall_target=0.95,
        corpus_scales=c_scales[:oracle_n], query_scales=q_scales[:oracle_q],
        score_dtype=jnp.bfloat16,
    )
    int8_approx_recall10 = value_recall_at_k(
        np.asarray(i8a), subq, sub, 10, rel_tol=4 / 127
    )

    def search_int8_approx(q):
        return chunked_topk(q, c8, K, chunk_size=chunk, mode="approx",
                            recall_target=0.95, score_dtype=jnp.bfloat16,
                            corpus_scales=c_scales, query_scales=q_scales)

    qi = q8
    for _ in range(3):
        iv, _ = search_int8_approx(qi)
        qi = qi + (iv[:, :1] > 1e30).astype(qi.dtype)
    np.asarray(iv)
    t0 = time.perf_counter()
    for _ in range(iters):
        iv, _ = search_int8_approx(qi)
        qi = qi + (iv[:, :1] > 1e30).astype(qi.dtype)
    np.asarray(iv)
    int8_approx_qps = Q / ((time.perf_counter() - t0) / iters)

    # --- two-stage serving (index/twostage.py semantics): the int8x8
    # approx scan nominates a 128-row candidate pool per query, then
    # stage 2 gathers ONLY those rows and re-ranks them exactly at full
    # dimension (ops.topk.rerank_topk); gated against the device-exact
    # top-10.
    from sessionsimilaritysearch.ops.topk import rerank_topk

    def make_search_twostage(pool):
        def search_twostage(q):
            tq8, tqs = _quantize_rows_int8(q.astype(jnp.float32))
            _, cand = chunked_topk(
                tq8, c8, pool, chunk_size=chunk, mode="approx",
                recall_target=0.95, score_dtype=jnp.bfloat16,
                corpus_scales=c_scales, query_scales=tqs,
            )
            return rerank_topk(q, corpus, cand, K, score_dtype=jnp.bfloat16)

        return search_twostage

    # exact reference on the ORIGINAL (unperturbed) queries, same scoring
    # contract as the timed exact path
    _, ref_full = chunked_topk(
        queries, corpus, 10, chunk_size=chunk, mode="exact",
        bucket=128, score_dtype=score_dtype,
    )
    ref_i = np.asarray(ref_full)

    # quality GATE: two-stage quality is stage-1 pool
    # recall, so the containment must clear a bar like every other tier's
    # recall gate — auto-widen the pool until exact-top10 set containment
    # >= 0.95 (each doubling trades QPS for pool recall; the timed row is
    # whatever pool passed)
    pool = 128
    while True:
        search_twostage = make_search_twostage(pool)
        ts_d, ts_i = search_twostage(queries)
        got = np.asarray(ts_i)[:, :10]
        twostage_containment = float(
            sum(len(set(g.tolist()) & set(r.tolist()))
                for g, r in zip(got, ref_i)) / ref_i.size
        )
        if twostage_containment >= 0.95 or pool >= 1024:
            break
        pool *= 2
    twostage_gate = "pass" if twostage_containment >= 0.95 else "FAIL"
    qt = queries
    for _ in range(3):
        tv, _ = search_twostage(qt)
        qt = qt + (tv[:, :1] * 1e-12).astype(qt.dtype)
    np.asarray(tv)
    t0 = time.perf_counter()
    for _ in range(iters):
        tv, _ = search_twostage(qt)
        qt = qt + (tv[:, :1] * 1e-12).astype(qt.dtype)
    np.asarray(tv)
    twostage_qps = Q / ((time.perf_counter() - t0) / iters)

    result = {
        "metric": f"exact_top{K}_qps_per_chip_{N>>20}M_x{D}d"
        + ("_bf16score" if score_dtype == jnp.bfloat16 else "")
        + (f"_recall10_{recall10:.3f}" if recall10 < 0.999 else ""),
        "value": round(qps, 1),
        "unit": "queries/sec",
        "vs_baseline": round(qps / 10_000, 3),
        f"binary_sign_qps_{bits}b": round(binary_qps, 1),
        f"binary_approx_qps_{bits}b": round(binary_approx_qps, 1),
        f"binary_approx_value_recall{K}": round(binary_approx_recall, 4),
        f"binary_packed_qps_{bits}b": round(binary_packed_qps, 1),
        "binary_packed_distances_exact": binary_packed_exact,
        "int8x8_qps": round(int8_qps, 1),
        "int8x8_value_recall10": round(int8_recall10, 4),
        "int8x8_approx_qps": round(int8_approx_qps, 1),
        "int8x8_approx_value_recall10": round(int8_approx_recall10, 4),
        f"twostage_int8_pool{pool}_qps": round(twostage_qps, 1),
        "twostage_exact_top10_containment": round(twostage_containment, 4),
        "twostage_containment_gate": twostage_gate,
        f"sharded_binary_sign_qps_{bits}b": round(sharded_binary_qps, 1),
        f"sharded_binary_sign_host_qps_{bits}b": round(
            sharded_binary_host_qps, 1
        ),
        "sharded_binary_distances_exact": sharded_binary_exact,
    }
    print(json.dumps(result))
    print(
        f"# value recall@10 vs oracle on {oracle_n} rows: {recall10:.4f} "
        f"(index-set recall {set_recall10:.4f}); score_dtype="
        f"{jnp.dtype(score_dtype).name}, batch={Q}, {dt*1e3:.1f} ms/batch, "
        f"device={jax.devices()[0].platform}/"
        f"{jax.devices()[0].device_kind} x{len(jax.devices())}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
