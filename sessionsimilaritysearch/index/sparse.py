"""Sparse session-vector baselines: STAN and SKNN.

CPU reimplementation of the reference's sparse paths
(test_amazon_filterd.py:37-57 vectorizers, :403-412 exact sparse-dense
search, :385-400 STAN score). These are quality baselines and oracles; they
are deliberately NOT on the accelerator -- scattered 400k-dim one-hot
vectors are the wrong shape for dense matmul units, and the reference runs
them on CPU too.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from scipy.sparse import csr_matrix


def sequence_to_stan_vec(seq, asin_num: int, lammy: float = 1.04) -> np.ndarray:
    """Exponentially time-decayed item vector, L2-normalized
    (test_amazon_filterd.py:37-46)."""
    vec = np.zeros(asin_num)
    item_seq = [a for a in seq if a[1] != "s"]
    if not item_seq:
        return vec
    for i, a in enumerate(item_seq):
        w = np.exp((i - len(item_seq)) / lammy)
        vec[a[-1]] += w
    return vec / np.sqrt(np.sum(vec**2))


def sequence_to_binary_vec(seq, asin_num: int) -> np.ndarray:
    """Binary item-indicator vector, L2-normalized
    (test_amazon_filterd.py:48-57)."""
    vec = np.zeros(asin_num)
    item_seq = [a for a in seq if a[1] != "s"]
    if not item_seq:
        return vec
    for a in item_seq:
        vec[a[-1]] = 1
    return vec / np.sqrt(np.sum(vec**2))


def build_sparse_corpus(
    sessions: Sequence, asin_num: int, kind: str = "binary", lammy: float = 1.04
) -> csr_matrix:
    fn = (
        sequence_to_binary_vec
        if kind == "binary"
        else lambda s, n: sequence_to_stan_vec(s, n, lammy)
    )
    rows = [fn(s, asin_num) for s in sessions]
    return csr_matrix(np.stack(rows))


def find_K_sparse_dense(sparse_data: csr_matrix, dense_query: np.ndarray, K: int):
    """Brute-force top-K of dense queries against a CSR corpus
    (test_amazon_filterd.py:403-412) -- the exact-search loop the device
    engine replaces; kept as the CPU oracle. Missing slots (K > corpus
    size) fill with (-inf, -1), matching the device indexes."""
    nq = dense_query.shape[0]
    n = sparse_data.shape[0]
    kk = min(K, n)
    I = np.full((nq, K), -1, dtype=np.int32)
    D = np.full((nq, K), -np.inf)
    for i in range(nq):
        val = np.squeeze(np.asarray(sparse_data.dot(dense_query[i, :])))
        val = np.atleast_1d(val)
        order = np.argsort(val)[-kk:][::-1]
        I[i, :kk] = order
        D[i, :kk] = val[order]
    return D, I


def get_STAN_score(I, test_data, corpus, asin_num: int, lammy: float = 1.04):
    """Mean STAN-weighted overlap of retrieved sessions
    (test_amazon_filterd.py:385-400)."""
    I = np.asarray(I)
    scores = []
    for i in range(I.shape[0]):
        prefix = test_data[i][0]
        if len(prefix) == 0:
            continue
        q = sequence_to_stan_vec(prefix, asin_num, lammy) / np.sqrt(len(prefix))
        for j in range(I.shape[1]):
            if I[i, j] < 0:  # missing-result slot
                continue
            s = sequence_to_binary_vec(corpus[I[i, j]], asin_num)
            s = s / np.sqrt(np.sum(s**2) + 1e-6)
            scores.append(float(q @ s))
    return float(np.mean(scores)) if scores else 0.0
