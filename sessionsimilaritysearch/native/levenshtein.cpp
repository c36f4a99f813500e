// Native host-side kernels for label generation and verification.
//
// The reference leans on two C extensions for its host loops: the
// `python-Levenshtein` C library for ground-truth similarity labels
// (reference: util_amazon_filtered.py:246, fine_tune_ours.py:61-65) and
// FAISS's C++ flat index for exact search. This build replaces FAISS
// on-device (ops/topk.py); this library covers the remaining native
// surface: edit-distance label generation, the batch all-pairs scorer used
// by triplet mining, the hashing tokenizer hot loop, and an OpenMP exact
// top-k CPU oracle for verification at scale.
//
// Exposed via a C ABI and loaded with ctypes (no pybind11 in this image).
//
// Build: make -C sessionsimilaritysearch/native

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <vector>

#include "tokenize_inl.h"

extern "C" {

// ---------------------------------------------------------------------------
// Levenshtein: python-Levenshtein-compatible ratio / seqratio
// ---------------------------------------------------------------------------

// indel distance = |a| + |b| - 2 * LCS(a, b)  (substitution cost 2)
static int64_t indel_distance(const char* a, size_t la, const char* b,
                              size_t lb) {
  if (la == 0 || lb == 0) return (int64_t)(la + lb);
  std::vector<int32_t> prev(lb + 1, 0), cur(lb + 1, 0);
  for (size_t i = 1; i <= la; ++i) {
    char ai = a[i - 1];
    cur[0] = 0;
    for (size_t j = 1; j <= lb; ++j) {
      if (ai == b[j - 1]) {
        cur[j] = prev[j - 1] + 1;
      } else {
        cur[j] = cur[j - 1] >= prev[j] ? cur[j - 1] : prev[j];
      }
    }
    std::swap(prev, cur);
  }
  int64_t lcs = prev[lb];
  return (int64_t)(la + lb) - 2 * lcs;
}

double lev_ratio(const char* a, size_t la, const char* b, size_t lb) {
  size_t lensum = la + lb;
  if (lensum == 0) return 1.0;
  return (double)((int64_t)lensum - indel_distance(a, la, b, lb)) /
         (double)lensum;
}

// seqratio: generalized edit distance over string sequences with element
// substitution cost 2 * (1 - ratio(x, y)) (matches data/levenshtein.py).
double lev_seqratio(const char** a, const size_t* a_lens, size_t na,
                    const char** b, const size_t* b_lens, size_t nb) {
  size_t lensum = na + nb;
  if (lensum == 0) return 1.0;
  if (na == 0 || nb == 0) return 0.0;
  std::vector<double> prev(nb + 1), cur(nb + 1);
  for (size_t j = 0; j <= nb; ++j) prev[j] = (double)j;
  for (size_t i = 1; i <= na; ++i) {
    cur[0] = (double)i;
    for (size_t j = 1; j <= nb; ++j) {
      double sub = prev[j - 1] + 2.0 * (1.0 - lev_ratio(a[i - 1], a_lens[i - 1],
                                                        b[j - 1], b_lens[j - 1]));
      double del = prev[j] + 1.0;
      double ins = cur[j - 1] + 1.0;
      cur[j] = std::min(sub, std::min(del, ins));
    }
    std::swap(prev, cur);
  }
  return ((double)lensum - prev[nb]) / (double)lensum;
}

// Fuzzy set-match counts with ratio > 0.9
// (reference: util_amazon_filtered.py:239-249).
void lev_string_match(const char** a, const size_t* a_lens, size_t na,
                      const char** b, const size_t* b_lens, size_t nb,
                      int64_t* a_match_out, int64_t* b_match_out) {
  std::vector<int> am(na, 0), bm(nb, 0);
  for (size_t i = 0; i < na; ++i)
    for (size_t j = 0; j < nb; ++j)
      if (lev_ratio(a[i], a_lens[i], b[j], b_lens[j]) > 0.9) {
        am[i] = 1;
        bm[j] = 1;
      }
  int64_t asum = 0, bsum = 0;
  for (int v : am) asum += v;
  for (int v : bm) bsum += v;
  *a_match_out = asum;
  *b_match_out = bsum;
}

// ---------------------------------------------------------------------------
// Hashing tokenizer hot loop (mirrors tokenizer.HashTokenizer exactly)
// ---------------------------------------------------------------------------

// Tokenize n texts into out[n * max_len] int32 ids (pad 0, cls 2, sep 3;
// word ids in [5, vocab)). Word split: [a-z0-9]+ over lowercased input.
// Inner loop shared with the graph builder (tokenize_inl.h).
void tokenize_batch(const char** texts, const size_t* lens, size_t n,
                    int32_t max_len, int32_t vocab_size, int32_t* out) {
  for (size_t t = 0; t < n; ++t)
    sss::tokenize_row(texts[t], lens[t], max_len, vocab_size,
                      out + (size_t)t * max_len);
}

// ---------------------------------------------------------------------------
// CPU exact top-k oracle (OpenMP): verification at corpus scale
// ---------------------------------------------------------------------------

void topk_f32(const float* corpus, int64_t n, int64_t d, const float* queries,
              int64_t nq, int32_t k, int32_t* out_idx, float* out_val) {
#pragma omp parallel for schedule(dynamic)
  for (int64_t qi = 0; qi < nq; ++qi) {
    const float* q = queries + qi * d;
    // min-heap of (score, idx)
    std::priority_queue<std::pair<float, int32_t>,
                        std::vector<std::pair<float, int32_t>>,
                        std::greater<>>
        heap;
    for (int64_t r = 0; r < n; ++r) {
      const float* c = corpus + r * d;
      float s = 0.f;
      for (int64_t j = 0; j < d; ++j) s += q[j] * c[j];
      if ((int32_t)heap.size() < k) {
        heap.emplace(s, (int32_t)r);
      } else if (s > heap.top().first) {
        heap.pop();
        heap.emplace(s, (int32_t)r);
      }
    }
    int32_t m = (int32_t)heap.size();
    for (int32_t j = m - 1; j >= 0; --j) {
      out_val[qi * k + j] = heap.top().first;
      out_idx[qi * k + j] = heap.top().second;
      heap.pop();
    }
    for (int32_t j = m; j < k; ++j) {
      out_val[qi * k + j] = -1e30f;
      out_idx[qi * k + j] = -1;
    }
  }
}

}  // extern "C"
