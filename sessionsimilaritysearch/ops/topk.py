"""Exact MIPS / cosine / L2 top-k over a dense embedding corpus.

This replaces the reference's FAISS flat indexes and numpy argsort loops
(reference: test_amazon_filterd.py:207-223 ``build_index``,
:403-412 ``find_K_sparse_dense``; fine_tune_ours.py:844-849, 880-882) with
accelerator-shaped compute:

- the corpus scan is a sequence of [q_tile, d] x [d, chunk] matmuls (bf16
  inputs, f32 accumulation; float32 operands run at full float32
  precision, see :func:`_precision`);
- a running top-k of size K is carried through a ``lax.scan`` over corpus
  chunks, so only O(q*K) state lives between chunks and the full [q, N]
  score matrix is never materialized in device memory;
- chunk top-k + carry merge uses ``jax.lax.top_k`` on [q, 2K], which XLA
  lowers efficiently for the small K (<=100) this workload uses.

The host path ``oracle_topk_np`` is the correctness oracle.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def l2_normalize(x: jnp.ndarray, eps: float = 1e-6) -> jnp.ndarray:
    """Row L2-normalize with the reference's clipped-norm semantics
    (util_amazon_filtered.py:28-31: divide by sqrt(clip(sum_sq, 1e-6)))."""
    sq = jnp.sum(x * x, axis=-1, keepdims=True)
    return x / jnp.sqrt(jnp.clip(sq, eps, None))


def merge_topk(
    vals_a: jnp.ndarray,
    idx_a: jnp.ndarray,
    vals_b: jnp.ndarray,
    idx_b: jnp.ndarray,
    k: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Merge two (values, indices) top-k candidate sets into the overall
    top-k. Also the per-shard merge step of the distributed search
    (SURVEY.md §2.11: per-shard top-k then re-rank)."""
    vals = jnp.concatenate([vals_a, vals_b], axis=-1)
    idx = jnp.concatenate([idx_a, idx_b], axis=-1)
    top_vals, top_pos = jax.lax.top_k(vals, k)
    top_idx = jnp.take_along_axis(idx, top_pos, axis=-1)
    return top_vals, top_idx


def exact_topk(
    queries: jnp.ndarray,
    corpus: jnp.ndarray,
    k: int,
    metric: str = "ip",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Single-shot top-k: full [q, n] score matrix then ``lax.top_k``.

    Right for small corpora (fits device memory); use :func:`chunked_topk` at scale.
    """
    scores = _scores(queries, corpus, metric)
    return jax.lax.top_k(scores, k)


def _precision(*operands):
    """Matmul precision for a scoring product: HIGHEST when any operand is
    float32, so a float32 score is a float32 product on every backend (GPU
    tensor cores otherwise round float32 operands to TF32); the backend
    default for bf16/int8 operands, whose products are exact in f32
    accumulation anyway."""
    if any(x.dtype == jnp.float32 for x in operands):
        return jax.lax.Precision.HIGHEST
    return None


def _scores(queries, corpus, metric: str):
    prec = _precision(queries, corpus)
    if metric == "l2":
        # rank by negative squared distance: -(|q|^2 - 2 q.c + |c|^2)
        qq = jnp.sum(queries * queries, axis=-1, keepdims=True)
        cc = jnp.sum(corpus * corpus, axis=-1)
        qc = jnp.dot(queries, corpus.T, precision=prec,
                     preferred_element_type=jnp.float32)
        return 2.0 * qc - qq - cc[None, :]
    if metric in ("ip", "cos"):
        return jnp.dot(queries, corpus.T, precision=prec,
                       preferred_element_type=jnp.float32)
    raise ValueError(f"unknown metric {metric}")


def _chunk_topk_sort(scores, k):
    """Plain per-chunk top-k (XLA TopK / full row sort)."""
    return jax.lax.top_k(scores, k)


def _chunk_topk_cert(scores, k, bucket: int, recall_target: float,
                     overfetch: int):
    """Exact-with-certificate per-chunk top-k.

    The exact bucketed selection's wide ``lax.top_k`` over the bucket maxes
    is pure selection overhead; ``lax.approx_max_k`` can be faster on
    backends with a native partial reduction, but can miss buckets. This
    path takes the fast route and PROVES the result exact: select ``k + overfetch`` candidate
    buckets approximately, re-rank their contents exactly, then check the
    certificate -- every bucket whose max EXCEEDS the k-th found score was
    among the examined buckets. If so, no unexamined row can displace the
    found top-k (up to ties at the bar, which are value-interchangeable --
    the repo-wide exactness convention, see value_recall_at_k). On
    violation (rare: the approx selection must miss one of the top-k
    buckets), fall back to the exact bucketed pass for the whole batch
    inside ``lax.cond`` -- expected cost stays near the approx path's.
    """
    q, ch = scores.shape
    nb = ch // bucket
    sb = scores.reshape(q, nb, bucket)
    bmax = jnp.max(sb, axis=-1)                      # [q, nb]
    kb = min(nb, k + overfetch)
    _, b_idx = jax.lax.approx_max_k(
        bmax, kb, recall_target=recall_target
    )
    cand = jnp.take_along_axis(sb, b_idx[..., None], axis=1)
    cand = cand.reshape(q, kb * bucket)
    c_vals, c_pos = jax.lax.top_k(cand, k)
    bar = c_vals[:, -1:]                             # k-th best found
    examined = jnp.zeros((q, nb), jnp.bool_)
    examined = examined.at[jnp.arange(q)[:, None], b_idx].set(True)
    violated = jnp.any((bmax > bar) & ~examined)

    def fallback(_):
        return _chunk_topk_bucketed(scores, k, bucket)

    def certified(_):
        sel_bucket = jnp.take_along_axis(b_idx, c_pos // bucket, axis=1)
        col = sel_bucket * bucket + c_pos % bucket
        return c_vals, col

    return jax.lax.cond(violated, fallback, certified, None)


def _chunk_topk_bucketed(scores, k, bucket: int):
    """EXACT per-chunk top-k by two-pass bucketed selection.

    Pass 1: max over buckets of ``bucket`` adjacent columns; top-k over the
    bucket maxes. Any bucket containing a global top-k element has a bucket
    max >= the k-th score, hence ranks within the top-k buckets (up to ties
    at the boundary, which are interchangeable by value) -- so gathering the
    top-k buckets' contents and re-ranking exactly (pass 2) returns the
    exact top-k at a fraction of a full-width TopK's cost: the wide TopK
    shrinks from ``chunk`` columns to ``chunk/bucket``, and pass 2 ranks
    only ``k * bucket`` candidates.
    """
    q, ch = scores.shape
    nb = ch // bucket
    sb = scores.reshape(q, nb, bucket)
    bmax = jnp.max(sb, axis=-1)                      # [q, nb]
    _, b_idx = jax.lax.top_k(bmax, k)                # [q, k]
    cand = jnp.take_along_axis(sb, b_idx[..., None], axis=1)  # [q, k, bucket]
    cand = cand.reshape(q, k * bucket)
    c_vals, c_pos = jax.lax.top_k(cand, k)
    # reconstruct column index inside the chunk
    sel_bucket = jnp.take_along_axis(b_idx, c_pos // bucket, axis=1)
    col = sel_bucket * bucket + c_pos % bucket
    return c_vals, col


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "chunk_size", "metric", "valid_count_static", "mode", "bucket",
        "recall_target", "score_dtype",
    ),
)
def chunked_topk(
    queries: jnp.ndarray,
    corpus: jnp.ndarray,
    k: int,
    chunk_size: int = 262144,
    metric: str = "ip",
    valid_count: Optional[jnp.ndarray] = None,
    valid_count_static: Optional[int] = None,
    mode: str = "exact",
    bucket: int = 128,
    recall_target: float = 0.95,
    score_dtype=jnp.float32,
    corpus_scales: Optional[jnp.ndarray] = None,
    query_scales: Optional[jnp.ndarray] = None,
    row_mask: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Streaming top-k over corpus chunks.

    Args:
      queries: [q, d] (pre-normalized by the caller for cosine).
      corpus: [n, d]; rows at index >= valid_count are ignored (ring-buffer
        support for streaming inserts).
      k: retrieval depth.
      chunk_size: corpus rows per scan step; each step is one matmul of
        shape [q, d] x [d, chunk_size]. Bigger chunks amortize selection
        cost at the price of a [q, chunk] score buffer in device memory.
      metric: 'ip' | 'cos' (caller normalizes) | 'l2'.
      valid_count: dynamic number of valid corpus rows (defaults to n).
      mode: per-chunk selection strategy --
        'exact'  bucketed two-pass selection (exact, the default);
        'sort'   plain lax.top_k (exact, slow for wide chunks);
        'approx' lax.approx_max_k (recall_target tunes the per-chunk
                 recall; backends without a native partial reduction,
                 the GPU among them, lower it to an exact sort-based
                 selection, far slower there than 'exact');
        'exact_cert' approx bucket selection + bucket-max certificate,
                 falling back to 'exact' inside lax.cond only when the
                 certificate is violated -- exact results (up to value
                 ties at the k-th bar) at near-approx selection cost
                 (see _chunk_topk_cert).
      bucket: bucket width for 'exact' mode.
      score_dtype: score-matrix dtype. float32 (default) = strictly exact
        ranking; bfloat16 halves the score-buffer memory traffic --
        ranking is exact at bf16 precision (the matmul still accumulates
        in f32).
      corpus_scales: optional [n] per-row dequantization scales for an
        int8-quantized corpus (DenseIndex(quantize='int8')): the corpus
        holds ``round(row / scale)`` int8 codes and true scores are
        recovered as ``(q . code) * scale``. 'ip'/'cos' only.
      query_scales: optional [q] per-query dequantization scales; with
        BOTH sides int8 (DenseIndex(quantize='int8x8')) the matmul runs
        int8 x int8 -> int32 and scores dequantize as ``(qcode . ccode) * qscale * cscale``.
        Requires corpus_scales; 'ip'/'cos' only.
      row_mask: optional [n] bool — filtered search: rows where False are
        excluded from ranking (scored -inf), on top of the valid_count
        masking. A dynamic operand: passing a fresh mask per call never
        retraces (one extra program vs the unmasked path, keyed on
        presence only). The scan still touches every row — cost is the
        unfiltered scan's, not proportional to the filter's selectivity.

    Returns:
      (values [q, k], indices [q, k]) sorted descending by score. Invalid
      slots (k > valid rows) carry -inf / index -1, matching FAISS's
      missing-result convention.

    NOTE on shapes: this is a ``jax.jit`` function, so every distinct
    (q, n, k, d) combination compiles its own program (cached after). Serving callers with variable batch sizes
    should pad queries to a fixed set of batch shapes before calling --
    DenseIndex.search buckets query batches to powers of two for exactly
    this reason; ad-hoc callers that stream odd-sized batches will eat
    silent recompiles. ``valid_count`` exists so GROWING a corpus does NOT
    retrace (allocate capacity once, mask the tail) -- pass it instead of
    slicing the corpus to size.
    """
    q, d = queries.shape
    n = corpus.shape[0]
    chunk_size = min(chunk_size, max(n, 1))
    if valid_count is None:
        valid_count = jnp.asarray(
            n if valid_count_static is None else valid_count_static, jnp.int32
        )

    n_chunks = -(-n // chunk_size)
    n_pad = n_chunks * chunk_size
    if n_pad != n:
        corpus = jnp.pad(corpus, ((0, n_pad - n), (0, 0)))
        if corpus_scales is not None:
            corpus_scales = jnp.pad(corpus_scales, (0, n_pad - n))
        if row_mask is not None:
            row_mask = jnp.pad(row_mask, (0, n_pad - n))
    # [n_chunks, chunk, d] so scan slices are contiguous
    corpus_chunks = corpus.reshape(n_chunks, chunk_size, d)
    if corpus_scales is not None:
        assert metric != "l2", "quantized corpus supports 'ip'/'cos' only"
        scale_chunks = corpus_scales.reshape(n_chunks, chunk_size)
    if row_mask is not None:
        mask_chunks = row_mask.astype(jnp.bool_).reshape(
            n_chunks, chunk_size
        )
    if query_scales is not None:
        assert corpus_scales is not None, (
            "query_scales (int8 x int8 mode) requires corpus_scales"
        )

    kk = min(k, chunk_size)
    bucketable = (
        chunk_size % bucket == 0
        and kk <= chunk_size // bucket
        and chunk_size // bucket >= 2
    )
    use_bucketed = mode == "exact" and bucketable
    use_cert = mode == "exact_cert" and bucketable
    if mode == "exact_cert" and not bucketable:
        mode = "sort"  # tiny chunks: plain exact selection

    if metric == "l2":
        qq = jnp.sum(queries * queries, axis=-1, keepdims=True)

    col = jax.lax.broadcasted_iota(jnp.int32, (1, chunk_size), 1)

    def step(carry, inp):
        best_vals, best_idx = carry
        it = iter(inp)
        chunk_i, chunk = next(it), next(it)
        scales = next(it) if corpus_scales is not None else None
        mask = next(it) if row_mask is not None else None
        base = chunk_i * chunk_size
        if metric == "l2":
            cc = jnp.sum(chunk * chunk, axis=-1)
            qc = jnp.dot(queries, chunk.T, precision=_precision(queries, chunk),
                         preferred_element_type=score_dtype)
            scores = (2.0 * qc - qq - cc[None, :]).astype(score_dtype)
        else:
            both_int8 = (
                queries.dtype == jnp.int8 and chunk.dtype == jnp.int8
            )
            if both_int8:
                # int8 x int8 -> int32; dequantize afterwards
                qc = jnp.dot(
                    queries, chunk.T, preferred_element_type=jnp.int32
                )
                deq = query_scales[:, None] * scales[None, :]
                scores = (qc.astype(jnp.float32) * deq).astype(score_dtype)
            else:
                if not jnp.issubdtype(chunk.dtype, jnp.floating):
                    chunk = chunk.astype(queries.dtype)  # int8 -> compute
                scores = jnp.dot(
                    queries, chunk.T, precision=_precision(queries, chunk),
                    preferred_element_type=score_dtype,
                )
                if corpus_scales is not None:
                    scores = (
                        scores.astype(jnp.float32) * scales[None, :]
                    ).astype(score_dtype)
        gidx = base + col  # [1, chunk]
        valid = gidx < valid_count
        if mask is not None:
            valid = valid & mask[None, :]
        scores = jnp.where(valid, scores, -jnp.inf)
        if mode == "approx":
            c_vals, c_pos = jax.lax.approx_max_k(
                scores, kk, recall_target=recall_target
            )
        elif use_cert:
            c_vals, c_pos = _chunk_topk_cert(
                scores, kk, bucket, recall_target, overfetch=2 * kk
            )
        elif use_bucketed:
            c_vals, c_pos = _chunk_topk_bucketed(scores, kk, bucket)
        else:
            c_vals, c_pos = _chunk_topk_sort(scores, kk)
        c_vals = c_vals.astype(jnp.float32)  # merge carry stays f32
        c_idx = base + c_pos
        c_idx = jnp.where(jnp.isfinite(c_vals), c_idx, -1)
        return merge_topk(best_vals, best_idx, c_vals, c_idx, k), None

    init = (
        jnp.full((q, k), -jnp.inf, dtype=jnp.float32),
        jnp.full((q, k), -1, dtype=jnp.int32),
    )
    xs = (jnp.arange(n_chunks, dtype=jnp.int32), corpus_chunks)
    if corpus_scales is not None:
        xs = xs + (scale_chunks,)
    if row_mask is not None:
        xs = xs + (mask_chunks,)
    (vals, idx), _ = jax.lax.scan(step, init, xs)
    return vals, idx


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "score_dtype", "q_chunk"),
)
def rerank_topk(
    queries: jnp.ndarray,
    corpus: jnp.ndarray,
    cand_idx: jnp.ndarray,
    k: int,
    metric: str = "ip",
    score_dtype=jnp.float32,
    corpus_scales: Optional[jnp.ndarray] = None,
    q_chunk: int = 128,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact re-scoring of per-query candidate pools (two-stage serving).

    Stage 2 of the prefilter + re-rank architecture: a cheap stage-1 scan
    (binary Hamming, int8 approx, or a PCA low-rank scan) nominates
    ``pool`` candidate rows per query; this op gathers ONLY those rows
    from the full-precision corpus and ranks them exactly. The final
    ranking is exact over the pool, so end-to-end quality is governed
    purely by stage-1 pool recall — at pool sizes of a few hundred the
    prefilter misses essentially nothing while the full-dim work drops
    from O(n) rows to O(pool) rows per query.

    The reference has no counterpart (FAISS flat scans are always
    single-stage, test_amazon_filterd.py:207-223); this is the
    accelerator answer to its exact-search latency.

    Args:
      queries: [q, d] (pre-normalized for cosine).
      corpus: [n, d] full-precision rows (or int8 codes with
        ``corpus_scales``).
      cand_idx: [q, pool] int32 stage-1 candidates; -1 marks missing
        slots (masked to -inf / idx -1 in the output).
      k: final retrieval depth (k <= pool).
      metric: 'ip' | 'cos' (caller normalizes) | 'l2'.
      score_dtype: score dtype of the re-rank (f32 = strictly exact;
        bf16 matches the exact_bf16 scan's tie semantics).
      corpus_scales: [n] per-row dequant scales for an int8 corpus.
      q_chunk: queries per scan step — bounds the gathered candidate
        tile to [q_chunk, pool, d] so device memory stays flat in q.

    Returns:
      (values [q, k] descending f32, indices [q, k]; missing slots are
      (-inf, -1)), same conventions as :func:`chunked_topk`.
    """
    q, d = queries.shape
    pool = cand_idx.shape[1]
    kk = min(k, pool)
    q_chunk = min(q_chunk, max(q, 1))
    n_tiles = -(-q // q_chunk)
    q_pad = n_tiles * q_chunk
    if q_pad != q:
        queries = jnp.pad(queries, ((0, q_pad - q), (0, 0)))
        cand_idx = jnp.pad(
            cand_idx, ((0, q_pad - q), (0, 0)), constant_values=-1
        )
    q_tiles = queries.reshape(n_tiles, q_chunk, d)
    c_tiles = cand_idx.reshape(n_tiles, q_chunk, pool)

    if metric == "l2":
        assert corpus_scales is None, (
            "int8 re-rank supports 'ip'/'cos' only"
        )

    def step(_, inp):
        q_t, c_t = inp
        safe = jnp.maximum(c_t, 0)
        rows = jnp.take(corpus, safe, axis=0)  # [qc, pool, d]
        if corpus_scales is not None:
            rows = rows.astype(jnp.float32) * jnp.take(
                corpus_scales, safe, axis=0
            )[..., None]
        prec = _precision(q_t, rows.astype(q_t.dtype))
        if metric == "l2":
            qq = jnp.sum(q_t * q_t, axis=-1, keepdims=True)
            cc = jnp.sum(
                rows.astype(jnp.float32) * rows.astype(jnp.float32), axis=-1
            )
            qc = jnp.einsum(
                "qd,qpd->qp", q_t, rows.astype(q_t.dtype), precision=prec,
                preferred_element_type=jnp.float32,
            )
            scores = (2.0 * qc - qq - cc).astype(score_dtype)
        else:
            scores = jnp.einsum(
                "qd,qpd->qp", q_t, rows.astype(q_t.dtype), precision=prec,
                preferred_element_type=score_dtype,
            ).astype(score_dtype)
        scores = jnp.where(c_t >= 0, scores, -jnp.inf)
        vals, pos = jax.lax.top_k(scores, kk)
        idx = jnp.take_along_axis(c_t, pos, axis=-1)
        vals = vals.astype(jnp.float32)
        idx = jnp.where(jnp.isfinite(vals), idx, -1)
        return None, (vals, idx)

    _, (vals, idx) = jax.lax.scan(step, None, (q_tiles, c_tiles))
    vals = vals.reshape(q_pad, kk)[:q]
    idx = idx.reshape(q_pad, kk)[:q]
    if kk < k:
        vals = jnp.pad(vals, ((0, 0), (0, k - kk)),
                       constant_values=-jnp.inf)
        idx = jnp.pad(idx, ((0, 0), (0, k - kk)), constant_values=-1)
    return vals, idx


def oracle_topk_np(
    queries: np.ndarray, corpus: np.ndarray, k: int, metric: str = "ip"
) -> Tuple[np.ndarray, np.ndarray]:
    """Brute-force numpy oracle (the pure-CPU exact search the reference
    implements at test_amazon_filterd.py:403-412). Used in tests to assert
    device search recall == 1.0."""
    queries = np.asarray(queries, np.float64)
    corpus = np.asarray(corpus, np.float64)
    if metric == "l2":
        scores = (
            2.0 * queries @ corpus.T
            - (queries**2).sum(-1, keepdims=True)
            - (corpus**2).sum(-1)[None, :]
        )
    else:
        scores = queries @ corpus.T
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(scores, idx, axis=1)
    return vals.astype(np.float32), idx.astype(np.int32)


def recall_at_k(found_idx: np.ndarray, true_idx: np.ndarray) -> float:
    """Fraction of oracle top-k recovered (order-insensitive)."""
    found_idx, true_idx = np.asarray(found_idx), np.asarray(true_idx)
    hits = 0
    for f, t in zip(found_idx, true_idx):
        hits += len(set(f.tolist()) & set(t.tolist()))
    return hits / true_idx.size


def value_recall_at_k(
    found_idx: np.ndarray,
    queries: np.ndarray,
    corpus: np.ndarray,
    k: int,
    metric: str = "ip",
    rel_tol: float = 0.0,
) -> float:
    """Tie/precision-aware recall: greedy one-to-one matching of the
    retrieved rows' TRUE (f64) scores against the oracle's top-k score
    multiset, within ``rel_tol`` (relative to the per-query score scale).

    Index-set recall (``recall_at_k``) under-reads exact engines whenever
    candidates are separated by less than the score dtype's resolution —
    duplicate corpus rows, near-degenerate embeddings, or
    bf16-scored scans: the retrieved set differs from the oracle's while
    every retrieved row is as close to the query. Comparing score multisets
    instead of id sets measures what retrieval quality actually is, and the
    one-to-one matching keeps the guard adversarially sound: a dropped
    true neighbor costs its slot even when deeper ties abound, and a duplicated row can only fill one slot. With
    ``rel_tol=0`` this equals set recall when all scores are distinct but
    also credits exact ties.
    """
    found_idx = np.asarray(found_idx)
    queries = np.asarray(queries, np.float64)
    corpus = np.asarray(corpus, np.float64)
    assert found_idx.shape[1] >= k
    found_idx = found_idx[:, :k]
    if metric == "l2":
        scores = (
            2.0 * queries @ corpus.T
            - (queries**2).sum(-1, keepdims=True)
            - (corpus**2).sum(-1)[None, :]
        )
    else:
        scores = queries @ corpus.T
    oracle = -np.sort(-scores, axis=1)[:, :k]  # descending top-k bars
    scale = np.maximum(np.abs(scores).max(axis=1), 1e-30)
    got = np.take_along_axis(
        scores, np.maximum(found_idx, 0).astype(np.int64), axis=1
    )
    got = np.where(found_idx >= 0, got, -np.inf)
    return value_recall_from_scores(got, oracle, rel_tol * scale)


def value_recall_from_scores(
    got: np.ndarray, oracle: np.ndarray, tol
) -> float:
    """The :func:`value_recall_at_k` matching from precomputed scores —
    for corpora that never visit the host (device-resident serving): the
    caller computes ``got`` [q, k] (true scores of the retrieved rows;
    -inf for missing slots) and ``oracle`` [q, k] (the true top-k score
    bars) on device, pulls only those [q, k] tiles, and gates here.
    ``tol`` is the ABSOLUTE per-query tolerance (rel_tol * score scale).
    """
    got = -np.sort(-np.asarray(got, np.float64), axis=1)  # descending
    oracle = -np.sort(-np.asarray(oracle, np.float64), axis=1)
    tol = np.broadcast_to(np.asarray(tol, np.float64), (got.shape[0],))
    q, k = oracle.shape
    assert got.shape[1] >= k, (got.shape, oracle.shape)
    matched = 0
    for r in range(q):
        j = 0
        for i in range(k):  # bars descend; each retrieved row used once
            if j < k and got[r, j] >= oracle[r, i] - tol[r]:
                matched += 1
                j += 1
    return matched / (k * max(q, 1))
