"""Retrieval-quality metric suite.

Host-side reimplementation of the evaluation functions in
test_amazon_filterd.py:226-450: MAP variants (linearly-decaying score AP),
Jaccard/recall variants over item sets, STAN overlap score, fuzzy query-match
metrics, and threshold recall. Conventions:

- ``test_data``: list of (prefix, future) session pairs;
- ``corpus``: list of sessions (each retrieved entry is scored as
  (session, []));
- ``I``: [num_queries, K] retrieved corpus indices.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from sessionsimilaritysearch.data import levenshtein, schema, similarity


def average_precision(y_true: np.ndarray) -> float:
    """AP for a ranked 0/1 relevance list (the reference feeds
    sklearn.average_precision_score with linearly decreasing scores, which
    reduces to rank-order AP -- test_amazon_filterd.py:239-240)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    n_pos = y_true.sum()
    if n_pos == 0:
        return 0.0
    cum = np.cumsum(y_true)
    ranks = np.arange(1, len(y_true) + 1)
    return float(np.sum((cum / ranks) * y_true) / n_pos)


def _map_over(I, relevant_sets, corpus_item_sets):
    maps = []
    K = I.shape[1]
    for i in range(I.shape[0]):
        rel = relevant_sets[i]
        y = np.array(
            [
                I[i, j] >= 0 and len(corpus_item_sets[I[i, j]] & rel) > 0
                for j in range(K)
            ],
            dtype=np.float64,
        )
        maps.append(average_precision(y))
    return float(np.mean(maps)) if maps else 0.0


def _corpus_item_sets(corpus):
    return [schema.get_item(s) for s in corpus]


def get_future_map(I, test_data, corpus, corpus_sets=None):
    """MAP where a hit = corpus session sharing an item with the FUTURE
    (test_amazon_filterd.py:226-244)."""
    sets = corpus_sets or _corpus_item_sets(corpus)
    rel = [schema.get_item(t[1]) for t in test_data]
    return _map_over(np.asarray(I), rel, sets)


def get_all_map(I, test_data, corpus, corpus_sets=None):
    sets = corpus_sets or _corpus_item_sets(corpus)
    rel = [schema.get_item(list(t[0]) + list(t[1])) for t in test_data]
    return _map_over(np.asarray(I), rel, sets)


def get_cur_map(I, test_data, corpus, corpus_sets=None):
    sets = corpus_sets or _corpus_item_sets(corpus)
    rel = [schema.get_item(t[0]) for t in test_data]
    return _map_over(np.asarray(I), rel, sets)


def _jaccard_over(I, query_sets, corpus_sets, denom: str):
    vals = []
    I = np.asarray(I)
    K = I.shape[1]
    for i in range(I.shape[0]):
        q = query_sets[i]
        if len(q) == 0:
            continue
        for j in range(K):
            if I[i, j] < 0:  # missing-result slot
                continue
            s = corpus_sets[I[i, j]]
            if denom == "union":
                d = len(s | q)
                vals.append(len(s & q) / d if d else 0.0)
            else:  # recall: normalized by the query set
                vals.append(len(s & q) / len(q))
    return float(np.mean(vals)) if vals else 0.0


def get_cur_jaccard(I, test_data, corpus):
    sets = _corpus_item_sets(corpus)
    return _jaccard_over(I, [schema.get_item(t[0]) for t in test_data], sets, "union")


def get_future_jaccard(I, test_data, corpus):
    sets = _corpus_item_sets(corpus)
    return _jaccard_over(I, [schema.get_item(t[1]) for t in test_data], sets, "union")


def get_all_jaccard(I, test_data, corpus):
    """Mean all_jaccard get_score of every retrieved pair
    (test_amazon_filterd.py:299-312)."""
    return similarity.get_ave_score(I, test_data, corpus, "all_jaccard")


def get_all_jaccard_mse(D, I, test_data, corpus):
    """|retrieval score - true all_jaccard| (test_amazon_filterd.py:314-329)."""
    D, I = np.asarray(D), np.asarray(I)
    truths = []
    for i in range(I.shape[0]):
        for j in range(I.shape[1]):
            truths.append(
                similarity.get_score(
                    test_data[i], (corpus[I[i, j]], []), "all_jaccard"
                )
                if I[i, j] >= 0
                else 0.0
            )
    return float(np.mean(np.abs(D.flatten() - np.asarray(truths))))


def get_cur_recall(I, test_data, corpus, corpus_sets=None):
    sets = corpus_sets or _corpus_item_sets(corpus)
    return _jaccard_over(I, [schema.get_item(t[0]) for t in test_data], sets, "query")


def get_all_recall(I, test_data, corpus, corpus_sets=None):
    sets = corpus_sets or _corpus_item_sets(corpus)
    rel = [schema.get_item(list(t[0]) + list(t[1])) for t in test_data]
    return _jaccard_over(I, rel, sets, "query")


def get_future_recall(I, test_data, corpus, corpus_sets=None):
    sets = corpus_sets or _corpus_item_sets(corpus)
    return _jaccard_over(I, [schema.get_item(t[1]) for t in test_data], sets, "query")


def get_query_metric(I, test_data, corpus, mode: str, metric: str):
    """Fuzzy query-list match score/recall (test_amazon_filterd.py:416-441):
    Levenshtein ratio > 0.9 counts as a match."""
    I = np.asarray(I)
    K = I.shape[1]
    vals = []
    for i in range(I.shape[0]):
        t = test_data[i]
        if mode == "all":
            query = schema.get_query(list(t[0]) + list(t[1]), False)
        elif mode == "cur":
            query = schema.get_query(t[0], False)
        elif mode == "future":
            query = schema.get_query(t[1], False)
        else:
            raise ValueError(f"unrecognized mode {mode}")
        if len(query) == 0:
            continue
        for j in range(K):
            if I[i, j] < 0:
                continue
            session_q = schema.get_query(corpus[I[i, j]], False)
            q_cnt, s_cnt = levenshtein.get_string_match(query, session_q)
            if metric == "score":
                total = len(query) + len(session_q)
                vals.append((q_cnt + s_cnt) / total if total else 0.0)
            elif metric == "recall":
                vals.append(q_cnt / len(query))
            else:
                raise ValueError(f"unrecognized metric {metric}")
    return float(np.mean(vals)) if vals else 0.0


def get_recall_above_threshold(test_data, corpus, I, sim_type: str, thres: float):
    """Fraction of retrieved top-K whose ground-truth score exceeds
    ``thres`` (test_amazon_filterd.py:443-450)."""
    I = np.asarray(I)
    gt = np.zeros_like(I, dtype=np.float32)
    for i, t in enumerate(test_data):
        for j in range(I.shape[1]):
            if I[i, j] < 0:
                continue
            gt[i, j] = similarity.get_score(t, (corpus[I[i, j]], []), sim_type)
    return float(np.mean(np.sum(gt > thres, axis=1)) / I.shape[1])


def full_report(D, I, test_data, corpus) -> dict:
    """Every sim-type mean + the four metric families in one dict (the
    print block of test_amazon_filterd.py:669-673 and
    fine_tune_ours.py:889-897). Pass ``D=None`` when retrieval scores are
    not cosine-comparable (e.g. Hamming distances); when given, D feeds the
    |score - jaccard| diagnostic (test_amazon_filterd.py:314-329)."""
    out = {}
    sets = _corpus_item_sets(corpus)  # shared across the set-based metrics
    for st in similarity.SIM_TYPES:
        out[f"ave_{st}"] = similarity.get_ave_score(I, test_data, corpus, st)
    out["future_map"] = get_future_map(I, test_data, corpus, sets)
    out["all_map"] = get_all_map(I, test_data, corpus, sets)
    out["cur_map"] = get_cur_map(I, test_data, corpus, sets)
    out["future_recall"] = get_future_recall(I, test_data, corpus, sets)
    out["all_recall"] = get_all_recall(I, test_data, corpus, sets)
    out["frac_above_0.5"] = get_recall_above_threshold(
        test_data, corpus, I, "all_product_type_score", 0.5
    )
    if D is not None:
        out["all_jaccard_mse"] = get_all_jaccard_mse(D, I, test_data, corpus)
    return out
