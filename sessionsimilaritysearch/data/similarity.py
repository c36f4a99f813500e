"""Ground-truth session similarity labelers.

Reimplements the four similarity types used for fine-tuning and evaluation
(reference: fine_tune_ours.py:42-88, duplicated in fine_tune_QAEA.py:39-85)
plus the retrieved-list average scorer (fine_tune_ours.py:90-97). These run
host-side over raw sessions; they are label generators, not model math.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from sessionsimilaritysearch.data import levenshtein, schema

SIM_TYPES = (
    "all_jaccard",
    "cur_jaccard",
    "all_query_score",
    "all_product_title_score",
    "all_product_type_score",
)


def get_score(data_a, data_b, sim_type: str) -> float:
    """Similarity of two (prefix, future) session pairs under ``sim_type``.

    Matches fine_tune_ours.py:42-88 exactly in semantics:
    - all_jaccard / cur_jaccard: item-set Jaccard over full / prefix session
    - all_query_score: Levenshtein.seqratio of query keyword lists
    - all_product_title_score: seqratio of per-interaction title lists
    - all_product_type_score: cosine of product-type count vectors (the
      default, config.py:61)
    """
    if sim_type == "all_jaccard":
        a_item = schema.get_item(list(data_a[0]) + list(data_a[1]))
        b_item = schema.get_item(list(data_b[0]) + list(data_b[1]))
        union = len(a_item | b_item)
        return len(a_item & b_item) / union if union else 0.0
    if sim_type == "cur_jaccard":
        a_item = schema.get_item(data_a[0])
        b_item = schema.get_item(data_b[0])
        union = len(a_item | b_item)
        return len(a_item & b_item) / union if union else 0.0
    if sim_type == "all_query_score":
        a_query = schema.get_query(list(data_a[0]) + list(data_a[1]), pad=False)
        b_query = schema.get_query(list(data_b[0]) + list(data_b[1]), pad=False)
        if not a_query or not b_query:
            return 0.0
        return levenshtein.seqratio(a_query, b_query)
    if sim_type == "all_product_title_score":
        a_t = schema.get_session_item_title(list(data_a[0]) + list(data_a[1]))
        b_t = schema.get_session_item_title(list(data_b[0]) + list(data_b[1]))
        return levenshtein.seqratio(a_t, b_t)
    if sim_type == "all_product_type_score":
        a_type = schema.get_item_type(list(data_a[0]) + list(data_a[1]))
        b_type = schema.get_item_type(list(data_b[0]) + list(data_b[1]))
        type_to_id = {}
        vec_len = len(set(a_type + b_type))
        if vec_len == 0:
            return 0.0
        a_vec = np.zeros(vec_len)
        b_vec = np.zeros(vec_len)
        for t in a_type:
            if t not in type_to_id:
                type_to_id[t] = len(type_to_id)
            a_vec[type_to_id[t]] += 1
        if a_type:
            a_vec = a_vec / np.linalg.norm(a_vec)
        for t in b_type:
            if t not in type_to_id:
                type_to_id[t] = len(type_to_id)
            b_vec[type_to_id[t]] += 1
        if b_type:
            b_vec = b_vec / np.linalg.norm(b_vec)
        return float(np.sum(a_vec * b_vec))
    raise ValueError(f"unrecognized sim type: {sim_type}")


def get_ave_score(I, test_data, train_data, sim_type: str) -> float:
    """Mean ground-truth score of retrieved top-K lists
    (reference: fine_tune_ours.py:90-97). ``I`` is [num_queries, K] indices
    into ``train_data``; corpus entries are scored as (session, []) pairs."""
    I = np.asarray(I)
    gt = np.zeros_like(I, dtype=np.float32)
    for i, t in enumerate(test_data):
        for j, d in enumerate(I[i, :]):
            if d < 0:  # FAISS-style missing-result slot (k > corpus size)
                continue
            r = train_data[int(d)]
            gt[i, j] = get_score(t, (r, []), sim_type)
    return float(np.mean(gt))


def score_matrix(data: Sequence, sim_type: str) -> np.ndarray:
    """Pairwise label matrix for a batch of (prefix, future) pairs
    (the inner double loop of fine_tune_ours.py:114-116)."""
    n = len(data)
    out = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        for j in range(n):
            out[i, j] = get_score(data[i], data[j], sim_type)
    return out


def mine_triplets(
    query_data,
    db_data,
    sim_type: str,
    num: int,
    pos_thresh: float = 0.8,
    half_lo: float = 0.2,
):
    """Triplet mining: for each query session scan the db for a positive
    (score >= 0.8), a half-positive ([0.2, 0.8)) and a negative (< 0.2)
    (reference recipe: fine_tune_ours.py:185-256).

    Returns a list of 7-tuples
    (ori, pos, half, neg, pos_score, half_score, neg_score) over raw data.
    """
    out = []
    for ori in query_data:
        if len(out) >= num:
            break
        pos = half = neg = None
        pos_s = half_s = neg_s = 0.0
        for cand in db_data:
            s = get_score(ori, cand, sim_type)
            if s >= pos_thresh and pos is None:
                pos, pos_s = cand, s
            elif half_lo <= s < pos_thresh and half is None:
                half, half_s = cand, s
            elif s < half_lo and neg is None:
                neg, neg_s = cand, s
            if pos is not None and half is not None and neg is not None:
                break
        if pos is not None and half is not None and neg is not None:
            out.append((ori, pos, half, neg, pos_s, half_s, neg_s))
    return out
