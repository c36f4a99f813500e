"""End-to-end benchmark harness (reference: test_amazon_filterd.py:452-692
``main2`` and the ``test()`` serve paths of fine_tune_ours.py:748-897).

Pipeline: embed corpus -> build index -> embed queries -> timed exact top-K
search -> quality report. Modes mirror the reference's:

- 'model':  a session encoder (graph or text) + cosine DenseIndex
- 'binary': fine-tuned hash codes + BinaryIndex (Hamming)
- 'STAN' / 'SKNN': sparse CPU baselines via scipy

Timings separate embed / build / search, like the reference's
``time.perf_counter`` brackets (:577-579), and report queries/sec.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sessionsimilaritysearch.config import Config
from sessionsimilaritysearch.data.graph import batch_graphs, sequence_to_graph
from sessionsimilaritysearch.evalharness import metrics
from sessionsimilaritysearch.index import BinaryIndex, DenseIndex, build_index
from sessionsimilaritysearch.index import sparse as sparse_index


@dataclasses.dataclass
class SearchResult:
    D: np.ndarray
    I: np.ndarray
    embed_corpus_s: float
    build_s: float
    embed_query_s: float
    search_s: float
    qps: float
    report: Optional[dict] = None


class EmbeddingPipeline:
    """Host-side embed loop: sessions -> padded graphs -> batched jitted
    encoder forward -> stacked [N, d] matrix (the corpus-embed loop of
    fine_tune_ours.py:821-832 as one XLA program per batch).

    Graph building runs through SessionGraphLoader, so it overlaps device
    compute (prefetch thread) and scales with host cores (``workers``)."""

    def __init__(self, cfg: Config, tokenizer, encode_fn: Callable,
                 batch_size: int = 256, workers: int = 0, prefetch: int = 2):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.encode_fn = encode_fn
        self.batch_size = batch_size
        self.workers = workers
        self.prefetch = prefetch

    def __call__(self, data: Sequence, out: str = "np"):
        """``data``: list of (prefix, future) pairs or bare sessions.

        ``out``: 'np' returns a host array (one blocking device->host
        transfer per batch, which serializes with compute); 'device'
        keeps every batch
        on-device and concatenates there, so an index build consumes the
        embeddings with ZERO host round-trips of the corpus (the batches
        queue behind each other via async dispatch and the host only
        blocks once, at the concatenate)."""
        from sessionsimilaritysearch.data.loader import SessionGraphLoader

        assert out in ("np", "device")
        if len(data) == 0:
            z = np.zeros((0, 0), dtype=np.float32)
            return jnp.asarray(z) if out == "device" else z
        norm = [
            d if isinstance(d, tuple) and len(d) == 2 else (d, [])
            for d in data
        ]
        loader = SessionGraphLoader(
            norm, self.tokenizer, self.cfg.dims, self.batch_size,
            shuffle=False, ignore_query=self.cfg.ignore_query, cache=False,
            prefetch=self.prefetch, workers=self.workers,
        )
        from sessionsimilaritysearch.training.loop import to_device

        try:
            # packed transport: one upload per dtype per batch instead of
            # ~30 per-leaf uploads (see training.loop.to_device)
            if out == "device":
                parts = [self.encode_fn(to_device(b)) for b in loader]
                return jnp.concatenate(parts, axis=0)[: len(norm)]
            res = [np.asarray(self.encode_fn(to_device(b))) for b in loader]
        finally:
            loader.close()
        # the loader wrap-pads the final batch; rows stay in input order
        return np.concatenate(res, axis=0)[: len(norm)]


def run_dense_search(
    corpus_emb: np.ndarray,
    query_emb: np.ndarray,
    k: int,
    metric: str = "cos",
    chunk_size: int = 65536,
) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """Build + timed search; returns (D, I, build_s, search_s)."""
    t0 = time.perf_counter()
    index = build_index(corpus_emb, metric=metric, chunk_size=chunk_size)
    jax.block_until_ready(index._buf)
    t1 = time.perf_counter()
    D, I = index.search(query_emb, k)  # includes compile on first call
    t2 = time.perf_counter()
    return D, I, t1 - t0, t2 - t1


def evaluate_encoder(
    cfg: Config,
    tokenizer,
    encode_fn: Callable,
    corpus_data: Sequence,
    test_data: Sequence,
    k: int = 100,
    with_report: bool = True,
    batch_size: int = 256,
) -> SearchResult:
    """The 'model' mode of main2: embed corpus+queries with an encoder,
    cosine flat search, full quality report."""
    pipe = EmbeddingPipeline(cfg, tokenizer, encode_fn, batch_size)
    t0 = time.perf_counter()
    corpus_emb = pipe([d[0] if isinstance(d, tuple) else d for d in corpus_data])
    t1 = time.perf_counter()
    query_emb = pipe(test_data)
    t2 = time.perf_counter()
    D, I, build_s, search_s = run_dense_search(corpus_emb, query_emb, k)
    qps = len(test_data) / search_s if search_s > 0 else float("inf")
    report = None
    if with_report:
        corpus_sessions = [
            d[0] if isinstance(d, tuple) else d for d in corpus_data
        ]
        report = metrics.full_report(D, I, test_data, corpus_sessions)
    return SearchResult(D, I, t1 - t0, build_s, t2 - t1, search_s, qps, report)


def evaluate_binary(
    db_codes: np.ndarray,
    query_codes: np.ndarray,
    corpus_sessions: Sequence,
    test_data: Sequence,
    k: int = 100,
    mode: str = "sign",
    with_report: bool = True,
    selection: str = "exact",
    recall_target: float = 0.95,
) -> SearchResult:
    """The code_len>0 serve path of fine_tune_ours.test() (:839-879):
    Hamming search over BinarizeHead codes. ``selection='approx'`` (sign
    mode) selects with ``lax.approx_max_k`` (ops.hamming.sign_topk)."""
    n_bits = db_codes.shape[1]
    t0 = time.perf_counter()
    index = BinaryIndex(n_bits=n_bits, capacity=db_codes.shape[0], mode=mode,
                        selection=selection, recall_target=recall_target)
    index.add(db_codes)
    t1 = time.perf_counter()
    D, I = index.search(query_codes, k)
    t2 = time.perf_counter()
    search_s = t2 - t1
    report = None
    if with_report:
        report = metrics.full_report(D, I, test_data, corpus_sessions)
    return SearchResult(
        D, I, 0.0, t1 - t0, 0.0, search_s,
        len(test_data) / search_s if search_s > 0 else float("inf"), report,
    )


def evaluate_knn_recommendation(
    cfg: Config,
    tokenizer,
    encode_fn: Callable,
    corpus_data: Sequence,
    test_data: Sequence,
    K: int = 20,
    sample_size: int = 500,
    batch_size: int = 256,
) -> dict:
    """Next-item recommendation via session kNN -- the Yoochoose evaluation
    flow (test_amazon_filterd.py:87-205): retrieve similar sessions, pool
    their items weighted by similarity, report recall@K of the pooled
    ranking against the session's future items."""
    from sessionsimilaritysearch.evalharness.knn import (
        knn_recommendation_recall,
    )

    pipe = EmbeddingPipeline(cfg, tokenizer, encode_fn, batch_size)
    corpus_sessions = [
        d[0] if isinstance(d, tuple) else d for d in corpus_data
    ]
    corpus_emb = pipe(corpus_sessions)
    query_emb = pipe([t[0] for t in test_data])
    k_search = min(sample_size, corpus_emb.shape[0])
    D, I, _, search_s = run_dense_search(corpus_emb, query_emb, k_search)
    recall = knn_recommendation_recall(
        D, I, test_data, corpus_sessions, K=K, sample_size=sample_size
    )
    return {
        "recall_at_k": recall,
        "K": K,
        "search_s": search_s,
        "qps": len(test_data) / search_s if search_s > 0 else float("inf"),
    }


def evaluate_knn_pairings(
    cfg: Config,
    tokenizer,
    subsession_encode_fn: Callable,
    session_encode_fn: Callable,
    corpus_data: Sequence,
    test_data: Sequence,
    K: int = 20,
    sample_size: int = 500,
    batch_size: int = 256,
) -> dict:
    """The reference's FULL Yoochoose pairing matrix
    (test_amazon_filterd.py:87-205): TWO encoders — subsession (prefix
    objective) and session (whole-session objective) — embed the SAME
    train corpus into two indexes, test prefixes embed through each
    encoder, and kNN next-item recall@K is reported for all three
    query/db pairings the reference logs (:189-201):

    - ``subsession_session``   (Q: subsession emb, D: session corpus)
    - ``subsession_subsession`` (Q: subsession emb, D: subsession corpus)
    - ``session_session``      (Q: session emb, D: session corpus)

    ``evaluate_knn_recommendation`` above is the single-pairing
    (prefix-query vs one corpus) form; this is the three-way protocol
    ."""
    pipe_sub = EmbeddingPipeline(cfg, tokenizer, subsession_encode_fn,
                                 batch_size)
    pipe_ses = EmbeddingPipeline(cfg, tokenizer, session_encode_fn,
                                 batch_size)
    corpus_sessions = [
        d[0] if isinstance(d, tuple) else d for d in corpus_data
    ]
    db_session = pipe_ses(corpus_sessions)
    db_subsession = pipe_sub(corpus_sessions)
    queries = [t[0] for t in test_data]
    q_subsession = pipe_sub(queries)
    q_session = pipe_ses(queries)
    from sessionsimilaritysearch.evalharness.knn import (
        knn_recommendation_recall,
    )

    out = {"K": K}
    for name, q, db in (
        ("subsession_session", q_subsession, db_session),
        ("subsession_subsession", q_subsession, db_subsession),
        ("session_session", q_session, db_session),
    ):
        k_search = min(sample_size, db.shape[0])
        D, I, _, search_s = run_dense_search(db, q, k_search)
        out[f"recall_{name}"] = knn_recommendation_recall(
            D, I, test_data, corpus_sessions, K=K, sample_size=sample_size
        )
    return out


def evaluate_sparse(
    cfg: Config,
    corpus_sessions: Sequence,
    test_data: Sequence,
    kind: str = "binary",
    k: int = 100,
    lammy: float = 1.04,
    with_report: bool = True,
) -> SearchResult:
    """The 'STAN'/'SKNN' modes of main2 (:582-602): sparse CPU brute force.

    NOTE per the reference, the CORPUS is always binary item-indicator
    vectors; only the queries change vectorizer (STAN mode applies the
    exponential time decay to the query side, test_amazon_filterd.py:
    589-605)."""
    t0 = time.perf_counter()
    corpus = sparse_index.build_sparse_corpus(
        corpus_sessions, cfg.asin_num, kind="binary"
    )
    t1 = time.perf_counter()
    vec_fn = (
        sparse_index.sequence_to_binary_vec
        if kind == "binary"
        else lambda s, n: sparse_index.sequence_to_stan_vec(s, n, lammy)
    )
    queries = np.stack([vec_fn(t[0], cfg.asin_num) for t in test_data])
    t2 = time.perf_counter()
    D, I = sparse_index.find_K_sparse_dense(corpus, queries, k)
    t3 = time.perf_counter()
    report = None
    if with_report:
        report = metrics.full_report(D, I, test_data, corpus_sessions)
    search_s = t3 - t2
    return SearchResult(
        D, I, 0.0, t1 - t0, t2 - t1, search_s,
        len(test_data) / search_s if search_s > 0 else float("inf"), report,
    )


# ---------------------------------------------------------------------------
# Precomputed-results round trip: the reference's 'load' evaluation mode
# (test_amazon_filterd.py main2 loads pickled D/I produced by an earlier
# search run and recomputes the metric suite without re-searching).
# ---------------------------------------------------------------------------

def save_results(path: str, D, I, test_data: Sequence,
                 corpus_sessions: Sequence) -> None:
    """Persist a search run: retrieved scores/ids plus the sessions the
    metric suite needs to recompute ground truth later."""
    import pickle

    with open(path, "wb") as f:
        pickle.dump(
            {
                "D": None if D is None else np.asarray(D),
                "I": np.asarray(I),
                "test_data": list(test_data),
                "corpus_sessions": list(corpus_sessions),
            },
            f,
        )


def load_results(path: str) -> dict:
    import pickle

    with open(path, "rb") as f:
        blob = pickle.load(f)
    for key in ("I", "test_data", "corpus_sessions"):
        assert key in blob, f"results file missing '{key}'"
    return blob


def evaluate_loaded(path: str) -> dict:
    """The 'load' mode: full metric report from a saved search run."""
    blob = load_results(path)
    return metrics.full_report(
        blob.get("D"), blob["I"], blob["test_data"], blob["corpus_sessions"]
    )


# ---------------------------------------------------------------------------
# Catalog title-embedding cache: titles repeat across sessions, so corpus
# builds can encode each distinct catalog title ONCE and gather by asin id
# (GraphLevelEncoder(title_table=...)). The reference re-encodes the title
# text of every product node of every session (model/model.py:192-260 via
# NodeEmbedding); at 3M sessions x ~20 product nodes that is ~150x redundant
# text-encoder work for a 391k-item catalog.
# ---------------------------------------------------------------------------

def build_title_table(
    cfg: Config,
    tokenizer,
    titles: Sequence[str],
    encoder,
    params,
    batch_size: int = 1024,
) -> jnp.ndarray:
    """[len(titles), d_text] device table: ``titles[i]`` embedded with the
    encoder's text backbone, for ``GraphLevelEncoder.__call__(title_table=)``.
    ``titles`` must be the CANONICAL catalog titles keyed by asin id — the
    same strings the graph transform tokenizes. Caveat: the no-product
    placeholder node (asin 0, 'UNK' text, data/graph.py:161-162) gathers
    asin 0's real title under the cache; only degenerate sessions with zero
    product interactions are affected."""
    import jax.numpy as _jnp

    fwd = jax.jit(
        lambda ids, typ, att, p: encoder.apply(
            p, ids, typ, att, method="embed_texts"
        )
    )
    fwd = functools.partial(fwd, p=params)  # traced arg, not a constant
    out = []
    n = len(titles)
    for s in range(0, n, batch_size):
        chunk = [t if t is not None else "" for t in titles[s : s + batch_size]]
        pad = batch_size - len(chunk)
        if pad:
            chunk = chunk + [""] * pad
        tok = tokenizer(chunk, max_length=cfg.dims.token_len)
        emb = fwd(
            _jnp.asarray(tok["input_ids"]),
            _jnp.asarray(tok["token_type_ids"]),
            _jnp.asarray(tok["attention_mask"]),
        )
        out.append(np.asarray(emb)[: len(chunk) - pad if pad else None])
    return _jnp.asarray(np.concatenate(out, axis=0))


def build_keyword_table(
    cfg: Config,
    tokenizer,
    keywords: Sequence[str],
    encoder,
    params,
    batch_size: int = 1024,
) -> Tuple[jnp.ndarray, dict]:
    """The query-store twin of :func:`build_title_table`: embed each
    DISTINCT search keyword once and serve query nodes by gather.

    Returns ``(table [n, d_text], lookup)`` where ``lookup`` maps the
    *padded token row bytes* of a keyword (exactly what
    ``sequence_to_graph`` writes into ``query_input_ids``,
    data/graph.py:134-145) to its table row. Keying by token bytes rather
    than strings means the batch-time lookup needs no access to the raw
    session — `make_cached_encode_fn` reads ids straight off the host
    SessionGraph. The root query node's ``""`` keyword is always included
    (row for it exists even if absent from ``keywords``); all-zero padding
    rows map to row 0 (their output is masked by ``query_node_mask``)."""
    import jax.numpy as _jnp

    kws = [""] + [k for k in dict.fromkeys(keywords) if k != ""]
    table = build_title_table(cfg, tokenizer, kws, encoder, params,
                              batch_size=batch_size)
    T = cfg.dims.token_len
    lookup: dict = {}
    for s in range(0, len(kws), batch_size):
        chunk = kws[s : s + batch_size]
        tok = tokenizer(chunk, max_length=T)
        ids = np.zeros((len(chunk), T), dtype=np.int32)
        m = tok["input_ids"].shape[1]
        ids[:, : min(m, T)] = tok["input_ids"][:, :T]
        for j in range(len(chunk)):
            lookup.setdefault(ids[j].tobytes(), s + j)
    lookup.setdefault(np.zeros(T, dtype=np.int32).tobytes(), 0)
    return _jnp.asarray(table), lookup


def keyword_ids(lookup: dict, query_input_ids: np.ndarray) -> Optional[np.ndarray]:
    """[B, Q, T] host token grid -> [B, Q] table ids via ``lookup``.
    Returns None if ANY row is absent (caller should fall back to the
    uncached query path for that batch).

    Cost is O(distinct rows) Python + one C-speed ``np.unique`` over a
    void view — an ignore_query corpus batch has exactly two distinct rows
    (root + padding), so this is microseconds, not B*Q dict lookups."""
    ids = np.ascontiguousarray(query_input_ids, dtype=np.int32)
    B, Q, T = ids.shape
    flat = ids.reshape(B * Q, T)
    rows = flat.view(np.dtype((np.void, T * 4))).ravel()
    uniq, inv = np.unique(rows, return_inverse=True)
    mapped = np.empty(len(uniq), dtype=np.int32)
    for j, u in enumerate(uniq):
        v = lookup.get(u.tobytes())
        if v is None:
            return None
        mapped[j] = v
    return mapped[inv].reshape(B, Q)


def make_cached_encode_fn(
    encoder, params, title_table, query_table=None, kw_lookup=None
) -> Callable:
    """Jitted ``graph -> [B, d]`` closure-safe encode fn: the table AND the
    params ride as traced arguments. A closure capture bakes them into the
    lowered program as constants — at flagship size (93M params) that
    bloats the executable and its compile time.

    With ``query_table`` + ``kw_lookup`` (from :func:`build_keyword_table`)
    the query store is ALSO served by gather — the forward contains no
    text-encoder FLOPs at all. Batches containing a keyword outside the
    table fall back to the title-only path (still exact, just slower)."""
    jitted = jax.jit(
        lambda g, tbl, p: encoder.apply(p, g, title_table=tbl)
    )
    if query_table is None:
        return lambda g: jitted(g, title_table, params)
    assert kw_lookup is not None, "query_table requires its kw_lookup"
    jitted_q = jax.jit(
        lambda g, tbl, qtbl, kw, p: encoder.apply(
            p, g, title_table=tbl, query_table=qtbl, query_kw=kw
        )
    )

    def fn(g):
        kw = keyword_ids(kw_lookup, np.asarray(g.query_input_ids))
        if kw is None:  # out-of-vocabulary keyword: uncached query path
            return jitted(g, title_table, params)
        return jitted_q(g, title_table, query_table, kw, params)

    return fn


def evaluate_hybrid(
    cfg: Config,
    tokenizer,
    encode_fn: Callable,
    corpus_data: Sequence,
    test_data: Sequence,
    k: int = 100,
    alpha: float = 0.5,
    kind: str = "overlap",
    fusion: str = "score",
    lammy: float = 1.04,
    with_report: bool = True,
    batch_size: int = 256,
) -> SearchResult:
    """Hybrid retrieval: fuse the learned session-embedding cosine with a
    sparse item cosine per (query, corpus) pair.

    ``kind``: the sparse term — 'overlap' (binary-indicator item cosine,
    SKNN's signal, test_amazon_filterd.py:48-57) or 'stan' (recency-decayed
    STAN weights on the QUERY side only; the corpus stays binary, the
    reference's STAN convention — test_amazon_filterd.py:589-605, same as
    :func:`evaluate_sparse`).

    ``fusion``: 'score' fuses the two cosines linearly
    (``alpha * dense + (1-alpha) * sparse``; both are cosines of
    L2-normalized vectors, so raw fusion is well-scaled) and 'rrf' fuses
    reciprocal ranks (``1/(60+r_dense) + 1/(60+r_sparse)``) — scale-immune,
    and the measured-best system on the adversarial regime
    (rrf+stan beat STAN on 3/3 seeds of the adversarial protocol). Same
    semantics as ``SessionSearchEngine.search(hybrid_kind=,
    hybrid_fusion=)`` but over the full corpus rather than an overfetched
    candidate pool. In-catalog the sparse term supplies the item-match
    signal; out-of-catalog it collapses to ~0 and the dense term carries
    retrieval — so the hybrid dominates both single systems across regimes
    . The reference evaluates its modes separately and
    never fuses; this is a serving capability it lacks."""
    assert kind in ("overlap", "stan")
    assert fusion in ("score", "rrf")
    corpus_sessions = [d[0] if isinstance(d, tuple) else d for d in corpus_data]
    pipe = EmbeddingPipeline(cfg, tokenizer, encode_fn, batch_size)
    t0 = time.perf_counter()
    ce = pipe(corpus_sessions)
    qe = pipe(test_data)
    t1 = time.perf_counter()
    ce = ce / np.clip(np.linalg.norm(ce, axis=1, keepdims=True), 1e-9, None)
    qe = qe / np.clip(np.linalg.norm(qe, axis=1, keepdims=True), 1e-9, None)
    sc = sparse_index.build_sparse_corpus(
        corpus_sessions, cfg.asin_num, kind="binary"
    )
    if kind == "overlap":
        sq = np.stack([
            sparse_index.sequence_to_binary_vec(t[0], cfg.asin_num)
            for t in test_data
        ])
    else:
        sq = np.stack([
            sparse_index.sequence_to_stan_vec(t[0], cfg.asin_num, lammy)
            for t in test_data
        ])
    t2 = time.perf_counter()
    dense = qe @ ce.T                       # [nq, n] cosine
    overlap = np.asarray(sc.dot(sq.T)).T    # [nq, n] cosine
    if fusion == "rrf":
        nq, n = dense.shape
        rows = np.repeat(np.arange(nq, dtype=np.int64), n)
        # dense ranks (0 = best; stable order for exact ties)
        d_order = np.argsort(-dense, axis=1, kind="stable")
        r_dense = np.empty((nq, n), np.int64)
        np.put_along_axis(
            r_dense, d_order, np.arange(n, dtype=np.int64)[None, :], axis=1
        )
        # sparse ranks, dense rank as the tiebreak (engine._hybrid_rerank
        # semantics: rows the sparse term cannot distinguish keep their
        # dense preference)
        s_order = np.lexsort(
            (r_dense.ravel(), -overlap.ravel(), rows)
        ).reshape(nq, n) % n
        r_sparse = np.empty((nq, n), np.int64)
        np.put_along_axis(
            r_sparse, s_order, np.arange(n, dtype=np.int64)[None, :], axis=1
        )
        fused = (
            1.0 / (60.0 + r_dense) + 1.0 / (60.0 + r_sparse)
        ).astype(np.float32)
    else:
        fused = alpha * dense + (1.0 - alpha) * overlap
    kk = min(k, fused.shape[1])
    part = np.argpartition(-fused, kk - 1, axis=1)[:, :kk]
    vals = np.take_along_axis(fused, part, axis=1)
    order = np.argsort(-vals, axis=1, kind="stable")
    I = np.full((fused.shape[0], k), -1, dtype=np.int32)
    D = np.full((fused.shape[0], k), -np.inf, dtype=np.float32)
    I[:, :kk] = np.take_along_axis(part, order, axis=1)
    D[:, :kk] = np.take_along_axis(vals, order, axis=1)
    t3 = time.perf_counter()
    report = None
    if with_report:
        report = metrics.full_report(None, I, list(test_data), corpus_sessions)
    search_s = t3 - t2
    return SearchResult(
        D, I, t1 - t0, t2 - t1, 0.0, search_s,
        len(test_data) / search_s if search_s > 0 else float("inf"), report,
    )
