"""Cross-shard retrieval collectives.

The scaling axis of this system is CORPUS SIZE (SURVEY.md §5): the embedding
corpus shards row-wise over the mesh's ``data`` axis, each chip scans its
shard with the blocked MIPS kernel, and the per-shard top-k candidates (a
[q, k] sliver each) are all-gathered over the interconnect and re-ranked -- the
"per-shard top-k + all-gather merge" plan of SURVEY.md §2.11. The heavy
traffic (the corpus scan) never crosses chips; only O(q * k * ndev) floats
do.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


# Compiled-collective cache. A fresh ``jax.shard_map`` over a fresh closure
# re-traces and re-lowers on EVERY call, which at serving shapes costs far
# more than the sharded scan itself.
# Each collective below builds its mapped function ONCE per static
# configuration, wraps it in jit, and reuses it; the jit layer then caches
# per input shape/dtype as usual, so serving calls are pure dispatch.
_FN_CACHE: dict = {}


def _cached_fn(key, build):
    fn = _FN_CACHE.get(key)
    if fn is None:
        fn = _FN_CACHE[key] = jax.jit(build())
    return fn


def sharded_topk(
    queries: jnp.ndarray,
    corpus: jnp.ndarray,
    k: int,
    mesh: Mesh,
    axis: str = "data",
    shard_ids: Optional[jnp.ndarray] = None,
    valid_per_shard: Optional[jnp.ndarray] = None,
    chunk_size: int = 262144,
    mode: str = "exact",
    bucket: int = 128,
    corpus_scales: Optional[jnp.ndarray] = None,
    query_scales: Optional[jnp.ndarray] = None,
    score_dtype=jnp.float32,
    row_mask: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact top-k over a row-sharded corpus.

    Args:
      queries: [q, d], replicated.
      corpus: [n, d] with rows sharded over ``axis`` (n divisible by the
        axis size).
      shard_ids: optional [n] int32 of global ids per row (same sharding);
        defaults to the row's global position.
      valid_per_shard: optional scalar count of valid rows per shard (ring
        buffers); defaults to the full shard.
      corpus_scales: optional [n] per-row int8 dequantization scales (same
        sharding as the corpus rows); see ``ops.topk.chunked_topk``.
      query_scales: optional [q] per-query int8 scales, replicated (the
        int8 x int8 mode; requires corpus_scales).
      row_mask: optional [n] bool (same sharding as the corpus rows) —
        filtered search; False rows never rank (ops.topk.chunked_topk
        semantics, applied per shard before the cross-shard merge).

    Returns replicated (values [q, k], ids [q, k]).
    """
    from sessionsimilaritysearch.ops.topk import chunked_topk, merge_topk

    ndev = mesh.shape[axis]
    n = corpus.shape[0]
    assert n % ndev == 0, f"corpus rows {n} not divisible by mesh axis {ndev}"
    shard_rows = n // ndev
    has_cs = corpus_scales is not None
    has_qs = query_scales is not None
    has_mask = row_mask is not None
    chunk_size = min(chunk_size, shard_rows)
    score_dtype = jnp.dtype(score_dtype)  # canonical: stable cache keys

    def local_search(q, c_local, ids_local, valid, *extra):
        it = iter(extra)
        cs = next(it) if has_cs else None
        qs = next(it) if has_qs else None
        rm = next(it) if has_mask else None
        vals, idx = chunked_topk(
            q, c_local, k,
            chunk_size=chunk_size,
            valid_count=valid[0],
            mode=mode, bucket=bucket,
            corpus_scales=cs, query_scales=qs,
            score_dtype=score_dtype, row_mask=rm,
        )
        safe = jnp.clip(idx, 0, shard_rows - 1)
        gids = jnp.where(idx >= 0, ids_local[safe], -1)
        # [ndev, q, k] -> [q, ndev * k] -> final exact top-k
        av = jax.lax.all_gather(vals, axis)
        ai = jax.lax.all_gather(gids, axis)
        av = jnp.moveaxis(av, 0, 1).reshape(q.shape[0], -1)
        ai = jnp.moveaxis(ai, 0, 1).reshape(q.shape[0], -1)
        top_vals, top_pos = jax.lax.top_k(av, k)
        top_ids = jnp.take_along_axis(ai, top_pos, axis=-1)
        return top_vals, top_ids

    if shard_ids is None:
        shard_ids = jnp.arange(n, dtype=jnp.int32)
    if valid_per_shard is None:
        valid_per_shard = jnp.full((ndev,), shard_rows, dtype=jnp.int32)

    extra_args, extra_specs = [], []
    if has_cs:
        extra_args.append(corpus_scales)
        extra_specs.append(P(axis))
    if has_qs:
        extra_args.append(query_scales)
        extra_specs.append(P())
    if has_mask:
        extra_args.append(row_mask)
        extra_specs.append(P(axis))

    fn = _cached_fn(
        ("topk", mesh, axis, k, chunk_size, mode, bucket, score_dtype,
         shard_rows, has_cs, has_qs, has_mask),
        lambda: jax.shard_map(
            local_search,
            mesh=mesh,
            in_specs=(P(), P(axis, None), P(axis), P(axis), *extra_specs),
            out_specs=(P(), P()),
            # the scan carry inside chunked_topk starts replicated and
            # becomes shard-varying after the first chunk; skip the static
            # VMA check
            check_vma=False,
        ),
    )
    return fn(queries, corpus, shard_ids, valid_per_shard, *extra_args)


def sharded_twostage_topk(
    queries: jnp.ndarray,
    q_signs: jnp.ndarray,
    corpus: jnp.ndarray,
    codes: jnp.ndarray,
    k: int,
    mesh: Mesh,
    axis: str = "data",
    shard_ids: Optional[jnp.ndarray] = None,
    valid_per_shard: Optional[jnp.ndarray] = None,
    pool: int = 512,
    recall_target: float = 0.95,
    score_dtype=jnp.float32,
    code_scales: Optional[jnp.ndarray] = None,
    q_code_scales: Optional[jnp.ndarray] = None,
    row_mask: Optional[jnp.ndarray] = None,
    packed_bits: Optional[int] = None,
    packed_block_rows: int = 2048,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Two-stage top-k over a row-sharded corpus: per-shard cheap-code
    prefilter + per-shard exact full-dim re-rank + cross-shard merge.

    The multi-chip form of ``index.twostage.TwoStageIndex``: each chip
    scans only its own slice of the sign codes (the cheap stage-1
    representation), nominates ``pool`` local candidates per query,
    gathers just those rows from its full-precision shard and ranks them
    exactly (``ops.topk.rerank_topk``), and the per-shard [q, k] slivers
    merge by all-gather — the same O(q * k * ndev) wire cost as
    :func:`sharded_topk`, but with the heavy local scan running at code
    width instead of full dimension. The global result is the exact
    full-dim ranking over the union of the per-shard pools, so quality is
    governed purely by stage-1 pool recall (raise ``pool`` toward the
    shard size to force it to 1). The reference's FAISS serving is
    single-host and single-stage (fine_tune_ours.py:839-849); this is its
    scale-out replacement.

    Args:
      queries: [q, d] full-precision queries, replicated (pre-normalized
        for cosine).
      q_signs: [q, w] stage-1 query codes, replicated: +-1 bf16 sign codes
        (SimHash/ITQ, same projection as the corpus codes), a bf16 low-rank
        projection (PCA prefilter), or int8 rows (with ``q_code_scales``).
      corpus: [n, d] full-precision rows, row-sharded over ``axis``.
      codes: [n, w] stage-1 corpus codes in the same representation as
        ``q_signs``, sharded identically to the corpus.
      code_scales: optional [n] per-row int8 dequantization scales (same
        sharding as the codes) — the int8x8 prefilter.
      q_code_scales: optional [q] per-query int8 scales, replicated
        (requires ``code_scales``).
      shard_ids: optional [n] int32 global ids (same sharding); defaults
        to global row position.
      valid_per_shard: optional per-shard valid-row counts (ring
        buffers); defaults to full shards.
      pool: stage-1 candidates PER SHARD per query (the union across the
        mesh is the effective global pool).
      recall_target: stage-1 ``approx_max_k`` recall target.
      score_dtype: stage-2 re-rank score dtype (f32 = strictly exact).
      row_mask: optional [n] bool (same sharding as the corpus rows) —
        filtered search; the mask applies inside each shard's stage-1
        scan so the per-shard pool is spent entirely on allowed rows.
      packed_bits: when set, ``codes`` is a TRANSPOSED-PACKED int32 code
        buffer ([n/32, bits_pad] in ops.hamming.pack_bits_t_np layout,
        packed per ``packed_block_rows``-slot blocks within each shard)
        and this is the true code width: each chip scans its packed slice
        with the unpack+matmul scan (ops.hamming.packed_t_topk) — 1 bit/bit
        of stage-1 memory per device and an EXACT Hamming top-pool. ``q_signs``
        must carry ZERO pad columns past packed_bits.

    Returns replicated (values [q, k] descending, global ids [q, k]);
    missing slots are (-inf, -1).
    """
    from sessionsimilaritysearch.ops.topk import chunked_topk, rerank_topk

    ndev = mesh.shape[axis]
    n = corpus.shape[0]
    assert n % ndev == 0, f"corpus rows {n} not divisible by mesh axis {ndev}"
    shard_rows = n // ndev
    local_pool = min(pool, shard_rows)
    has_cs = code_scales is not None
    has_qs = q_code_scales is not None
    has_mask = row_mask is not None
    if packed_bits is None:
        assert codes.shape[0] == n
    else:
        assert codes.shape[0] * 32 == n, (codes.shape, n)
        assert not has_cs and not has_qs, "packed stage 1 scans sign codes"
        assert shard_rows % packed_block_rows == 0, (
            f"shard rows {shard_rows} must be whole "
            f"{packed_block_rows}-slot pack blocks"
        )

    def local_search(q, qs, c_local, code_local, ids_local, valid, *extra):
        it = iter(extra)
        cs = next(it) if has_cs else None
        qcs = next(it) if has_qs else None
        rm = next(it) if has_mask else None
        if packed_bits is not None:
            # stage 1, packed: exact Hamming top-pool over this shard's
            # 1 bit/bit transposed-packed codes
            from sessionsimilaritysearch.ops.hamming import packed_t_topk

            _, cand = packed_t_topk(
                qs, code_local, local_pool, n_bits=packed_bits,
                block_rows=packed_block_rows,
                valid_count=valid[0], row_mask=rm,
            )
        else:
            # stage 1: approx-selected matmul scan over this shard's codes
            # (+-1 sign dot ordering == ascending Hamming, ops/hamming.py;
            # int8x8 when scales are passed; plain ip for low-rank
            # projections)
            _, cand = chunked_topk(
                qs, code_local, local_pool,
                chunk_size=shard_rows, metric="ip", mode="approx",
                recall_target=recall_target, score_dtype=jnp.bfloat16,
                valid_count=valid[0], corpus_scales=cs, query_scales=qcs,
                row_mask=rm,
            )
        # stage 2: exact full-dim re-rank of the local pool
        vals, idx = rerank_topk(
            q, c_local, cand, k, metric="ip", score_dtype=score_dtype,
        )
        safe = jnp.clip(idx, 0, shard_rows - 1)
        gids = jnp.where(idx >= 0, ids_local[safe], -1)
        av = jax.lax.all_gather(vals, axis)
        ai = jax.lax.all_gather(gids, axis)
        av = jnp.moveaxis(av, 0, 1).reshape(q.shape[0], -1)
        ai = jnp.moveaxis(ai, 0, 1).reshape(q.shape[0], -1)
        top_vals, top_pos = jax.lax.top_k(av, k)  # -inf slots sort last
        top_ids = jnp.take_along_axis(ai, top_pos, axis=-1)
        return top_vals, top_ids

    if shard_ids is None:
        shard_ids = jnp.arange(n, dtype=jnp.int32)
    if valid_per_shard is None:
        valid_per_shard = jnp.full((ndev,), shard_rows, dtype=jnp.int32)

    extra_args, extra_specs = [], []
    if has_cs:
        extra_args.append(code_scales)
        extra_specs.append(P(axis))
    if has_qs:
        extra_args.append(q_code_scales)
        extra_specs.append(P())
    if has_mask:
        extra_args.append(row_mask)
        extra_specs.append(P(axis))

    fn = _cached_fn(
        ("twostage", mesh, axis, k, local_pool, recall_target,
         jnp.dtype(score_dtype), shard_rows, has_cs, has_qs, has_mask,
         packed_bits, packed_block_rows),
        lambda: jax.shard_map(
            local_search,
            mesh=mesh,
            in_specs=(P(), P(), P(axis, None), P(axis, None), P(axis),
                      P(axis), *extra_specs),
            out_specs=(P(), P()),
            check_vma=False,  # same scan-carry VMA caveat as sharded_topk
        ),
    )
    return fn(queries, q_signs, corpus, codes, shard_ids, valid_per_shard,
              *extra_args)


def sharded_hamming_topk(
    q_signs: jnp.ndarray,
    codes: jnp.ndarray,
    k: int,
    mesh: Mesh,
    n_bits: int,
    axis: str = "data",
    shard_ids: Optional[jnp.ndarray] = None,
    valid_per_shard: Optional[jnp.ndarray] = None,
    selection: str = "exact",
    recall_target: float = 0.95,
    row_mask: Optional[jnp.ndarray] = None,
    packed_bits: Optional[int] = None,
    packed_block_rows: int = 2048,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Hamming top-k over a row-sharded binary-code corpus.

    The scale-out form of the reference's ``faiss.IndexBinaryFlat`` serve
    path (fine_tune_ours.py:839-879): each chip ranks its own slice of the
    codes by Hamming distance — sign matmul for ``packed_bits=None``
    (±1 bf16 rows, the 'sign' speed tier; ``selection='approx'`` swaps in
    ``lax.approx_max_k``) or the unpack+matmul scan over transposed-packed
    storage (the 1 bit/bit capacity tier, ops.hamming.packed_t_topk) — and
    the per-shard [q, k] slivers merge by all-gather, exactly like
    :func:`sharded_topk`. The merge runs
    on negated integer distances, so it is tie-class exact.

    Args:
      q_signs: [q, n_bits] ±1 queries, replicated (packed mode: padded to
        the code buffer's lane width with ZERO pad columns).
      codes: sign mode — [n, n_bits] ±1 bf16, rows sharded over ``axis``;
        packed mode — [n/32, bits_pad] int32 transposed-packed words
        (ops.hamming.pack_bits_t_np layout per shard), sharded over
        ``axis``.
      shard_ids: optional [n] int32 global ids (same sharding); defaults
        to global slot position.
      valid_per_shard: optional per-shard valid-slot counts.
      row_mask: optional bool, sharded over ``axis`` — [n] slots in sign
        mode, [n_phys_slots] in packed mode; False slots never rank.

    Returns replicated (hamming distances ascending [q, k] int32, global
    ids [q, k]); missing slots carry (INT32_MAX, -1).
    """
    from sessionsimilaritysearch.ops import hamming

    ndev = mesh.shape[axis]
    if packed_bits is None:
        n = codes.shape[0]
    else:
        n = codes.shape[0] * 32
    assert n % ndev == 0, f"code slots {n} not divisible by mesh axis {ndev}"
    shard_rows = n // ndev
    k_local = min(k, shard_rows)
    has_mask = row_mask is not None
    if packed_bits is not None:
        assert shard_rows % packed_block_rows == 0, (
            f"shard slots {shard_rows} must be whole "
            f"{packed_block_rows}-slot pack blocks"
        )

    def local_search(qs, code_local, ids_local, valid, *extra):
        rm = extra[0] if has_mask else None
        if packed_bits is not None:
            dist, idx = hamming.packed_t_topk(
                qs, code_local, k_local, n_bits=packed_bits,
                block_rows=packed_block_rows,
                valid_count=valid[0], row_mask=rm,
            )
        else:
            dist, idx = hamming.sign_topk(
                qs, code_local, k_local, n_bits=n_bits,
                chunk_size=shard_rows, mode=selection,
                recall_target=recall_target,
                valid_count=valid[0], row_mask=rm,
            )
        safe = jnp.clip(idx, 0, shard_rows - 1)
        gids = jnp.where(idx >= 0, ids_local[safe], -1)
        # merge on NEGATED int32 distances (missing slots -> -INT32_MAX,
        # which sorts last): integer-exact, no float tie churn
        neg = jnp.where(
            idx < 0, -jnp.iinfo(jnp.int32).max, -dist.astype(jnp.int32)
        )
        av = jax.lax.all_gather(neg, axis)
        ai = jax.lax.all_gather(gids, axis)
        av = jnp.moveaxis(av, 0, 1).reshape(qs.shape[0], -1)
        ai = jnp.moveaxis(ai, 0, 1).reshape(qs.shape[0], -1)
        kk = min(k, av.shape[-1])
        top_neg, top_pos = jax.lax.top_k(av, kk)
        top_ids = jnp.take_along_axis(ai, top_pos, axis=-1)
        if kk < k:
            pad = ((0, 0), (0, k - kk))
            top_neg = jnp.pad(
                top_neg, pad, constant_values=-jnp.iinfo(jnp.int32).max
            )
            top_ids = jnp.pad(top_ids, pad, constant_values=-1)
        top_dist = jnp.where(
            top_ids < 0, jnp.iinfo(jnp.int32).max, -top_neg
        )
        return top_dist, top_ids

    if shard_ids is None:
        shard_ids = jnp.arange(n, dtype=jnp.int32)
    if valid_per_shard is None:
        valid_per_shard = jnp.full((ndev,), shard_rows, dtype=jnp.int32)

    extra_args, extra_specs = [], []
    if has_mask:
        extra_args.append(row_mask)
        extra_specs.append(P(axis))

    fn = _cached_fn(
        ("hamming", mesh, axis, k, k_local, n_bits, selection,
         recall_target, shard_rows, has_mask, packed_bits,
         packed_block_rows),
        lambda: jax.shard_map(
            local_search,
            mesh=mesh,
            in_specs=(P(), P(axis, None), P(axis), P(axis), *extra_specs),
            out_specs=(P(), P()),
            check_vma=False,  # same scan-carry VMA caveat as sharded_topk
        ),
    )
    return fn(q_signs, codes, shard_ids, valid_per_shard, *extra_args)


def shard_corpus(corpus, mesh: Mesh, axis: str = "data"):
    """Place a [n, d] corpus row-sharded over the mesh."""
    return jax.device_put(corpus, NamedSharding(mesh, P(axis, None)))
