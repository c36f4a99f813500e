"""Binary-code (Hamming) search.

Replaces FAISS ``IndexBinaryFlat`` (reference: fine_tune_ours.py:839-843,
871-879: ``np.packbits`` then Hamming top-k over 250-bit codes produced by
the BinarizeHead). Two formulations:

1. ``hamming_topk`` -- codes packed 32 bits/int32; XOR +
   ``lax.population_count`` + sum. Memory-optimal (1 bit/bit).
2. ``sign_topk`` -- codes held as +-1 bf16; for +-1 vectors,
   ``dot(a, b) = n_bits - 2 * hamming(a, b)``, so ranking by inner product
   is exactly ranking by ascending Hamming distance. This turns the search
   into the same blocked MIPS matmul as the float path, which runs on the
   accelerator's matrix units instead of its vector units.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def pack_bits_np(signs: np.ndarray) -> np.ndarray:
    """Pack a [n, bits] array of {+1,-1} (or {1,0}) into [n, ceil(bits/32)]
    int32 words (bit j of word w = bit 32*w + j)."""
    signs = np.asarray(signs)
    bits = (signs > 0).astype(np.uint32)
    n, d = bits.shape
    w = -(-d // 32)
    padded = np.zeros((n, w * 32), dtype=np.uint32)
    padded[:, :d] = bits
    padded = padded.reshape(n, w, 32)
    shifts = np.arange(32, dtype=np.uint32)
    words = (padded << shifts[None, None, :]).sum(axis=2, dtype=np.uint32)
    return words.view(np.int32)


def pack_bits(signs: jnp.ndarray) -> jnp.ndarray:
    """Device-side packing of {+1,-1} sign codes into int32 words."""
    bits = (signs > 0).astype(jnp.uint32)
    n, d = bits.shape
    w = -(-d // 32)
    bits = jnp.pad(bits, ((0, 0), (0, w * 32 - d))).reshape(n, w, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    words = jnp.sum(bits << shifts[None, None, :], axis=2, dtype=jnp.uint32)
    return words.astype(jnp.int32)


def unpack_bits_np(words: np.ndarray, n_bits: int) -> np.ndarray:
    """Inverse of :func:`pack_bits_np`: [n, w] int32 -> [n, n_bits] +-1
    float32 (bit 1 -> +1, bit 0 -> -1)."""
    words = np.asarray(words).view(np.uint32)
    n, w = words.shape
    shifts = np.arange(32, dtype=np.uint32)
    bits = (words[:, :, None] >> shifts[None, None, :]) & np.uint32(1)
    bits = bits.reshape(n, w * 32)[:, :n_bits]
    return np.where(bits > 0, 1.0, -1.0).astype(np.float32)


# ---------------------------------------------------------------------------
# Transposed packing: codes unpack to +-1 bf16 with 32 STATIC shifts and a
# concat along the row axis, so a block of packed words turns into a block
# of matmul operand rows without any per-element gather.
#
# Layout: original rows are grouped in blocks of ``block_rows`` (a pack-time
# constant, the unpack's block). Within a block,
# original row ii = j * (block_rows//32) + s is stored as bit j of packed
# row s; packed shape is [n/32, n_bits]. The unpack
# ``concat([(cb >> j) & 1 for j in range(32)], axis=0)`` then reproduces the
# block's rows in ORIGINAL order.
# ---------------------------------------------------------------------------

TBLOCK = 2048  # default pack-time row-block


def pack_bits_t_np(signs: np.ndarray, block_rows: int = TBLOCK) -> np.ndarray:
    """Transposed packing of [n, bits] {+1,-1} (or {0,1}) sign codes into
    [n//32, bits] int32 (layout above). ``n % block_rows == 0`` (pad the
    row count first; zero rows unpack to all -1 codes)."""
    signs = np.asarray(signs)
    n, bits = signs.shape
    assert n % block_rows == 0 and block_rows % 32 == 0, (n, block_rows)
    s_rows = block_rows // 32
    b01 = (signs > 0).astype(np.uint32)
    g = b01.reshape(n // block_rows, 32, s_rows, bits)  # [G, j, s, b]
    out = np.zeros((n // block_rows, s_rows, bits), dtype=np.uint32)
    for j in range(32):
        out |= g[:, j, :, :] << np.uint32(j)
    return out.reshape(n // 32, bits).view(np.int32)


def pack_bits_t(signs: jnp.ndarray, block_rows: int = TBLOCK) -> jnp.ndarray:
    """Device-side :func:`pack_bits_t_np`: [n, bits] {+1,-1} sign codes ->
    [n//32, bits] int32 in the transposed layout, computed ON DEVICE — a
    device-resident corpus packs without the [n, bits] host round trip.
    Bit-exact with the host packer (pinned by tests)."""
    n, bits = signs.shape
    assert n % block_rows == 0 and block_rows % 32 == 0, (n, block_rows)
    s_rows = block_rows // 32
    b01 = (signs > 0).astype(jnp.uint32)
    g = b01.reshape(n // block_rows, 32, s_rows, bits)
    shifts = jnp.arange(32, dtype=jnp.uint32).reshape(1, 32, 1, 1)
    # bit positions are disjoint across j, so sum == bitwise OR
    out = (g << shifts).sum(axis=1, dtype=jnp.uint32)
    return jax.lax.bitcast_convert_type(
        out.reshape(n // 32, bits), jnp.int32
    )


def unpack_bits_t(
    packed_t: jnp.ndarray, block_rows: int = TBLOCK
) -> jnp.ndarray:
    """Device-side inverse of :func:`pack_bits_t_np`: [n/32, bits] int32 ->
    [n, bits] +-1 bf16 rows in original order (the per-chunk unpack of
    :func:`packed_t_topk`)."""
    ns, bits = packed_t.shape
    s_rows = block_rows // 32
    assert ns % s_rows == 0, (ns, block_rows)
    g = packed_t.reshape(ns // s_rows, 1, s_rows, bits)
    shifts = jnp.arange(32, dtype=jnp.int32).reshape(1, 32, 1, 1)
    bits01 = (g >> shifts) & jnp.int32(1)  # [G, j, s, b]
    flat = bits01.reshape(ns * 32, bits)
    return (2 * flat - 1).astype(jnp.float32).astype(jnp.bfloat16)


def unpack_bits_t_np(packed_t: np.ndarray, block_rows: int = TBLOCK) -> np.ndarray:
    """Host-side inverse of :func:`pack_bits_t_np`: [n/32, bits] int32 ->
    [n, bits] +-1 float32 rows in original order (snapshot migration /
    re-striping)."""
    packed_t = np.asarray(packed_t).view(np.uint32)
    ns, bits = packed_t.shape
    s_rows = block_rows // 32
    assert ns % s_rows == 0, (ns, block_rows)
    g = packed_t.reshape(ns // s_rows, 1, s_rows, bits)
    shifts = np.arange(32, dtype=np.uint32).reshape(1, 32, 1, 1)
    b01 = (g >> shifts) & np.uint32(1)
    flat = b01.reshape(ns * 32, bits)
    return np.where(flat > 0, 1.0, -1.0).astype(np.float32)


def t_slot_coords(slots, block_rows: int = TBLOCK):
    """Map original-row slot ids to their transposed-layout coordinates:
    (packed row p, bit j). Works for numpy or jnp inputs."""
    s_rows = block_rows // 32
    gi, ii = slots // block_rows, slots % block_rows
    return gi * s_rows + ii % s_rows, ii // s_rows


@functools.partial(
    jax.jit, static_argnames=("k", "n_bits", "block_rows", "chunk_size")
)
def packed_t_topk(
    q_signs: jnp.ndarray,
    c_packed_t: jnp.ndarray,
    k: int,
    n_bits: int,
    block_rows: int = TBLOCK,
    chunk_size: int = 1 << 16,
    valid_count=None,
    row_mask=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact Hamming top-k over transposed-packed codes (the 1 bit/bit
    capacity tier): lax.scan over row chunks, each chunk unpacked to +-1
    bf16 (:func:`unpack_bits_t`) and ranked by sign matmul.
    Identical ranking to :func:`sign_topk` mode='exact' over the unpacked
    codes (exact: +-1 dots are integers, f32-accumulated). Returns
    (hamming distances ascending, indices); same valid_count / row_mask /
    missing-slot conventions as :func:`hamming_topk`.

    ``q_signs``: [q, bits_pad] +-1 (columns past n_bits must be ZERO so
    padded corpus bits contribute nothing)."""
    q, bits = q_signs.shape
    ns = c_packed_t.shape[0]
    n = ns * 32
    if valid_count is None:
        valid_count = jnp.asarray(n, jnp.int32)
    # chunks must tile n exactly (lax.scan) in whole pack blocks: largest
    # block count <= the target that divides the corpus
    n_blocks = n // block_rows
    assert n_blocks * block_rows == n, (n, block_rows)
    nb = max(1, min(chunk_size // block_rows, n_blocks))
    while n_blocks % nb:
        nb -= 1
    chunk_size = nb * block_rows
    n_chunks = n // chunk_size
    qb = q_signs.astype(jnp.bfloat16)
    chunks = c_packed_t.reshape(n_chunks, chunk_size // 32, bits)
    if row_mask is not None:
        mask_chunks = row_mask.astype(jnp.bool_).reshape(
            n_chunks, chunk_size
        )
    col = jax.lax.broadcasted_iota(jnp.int32, (1, chunk_size), 1)
    neg_inf = jnp.float32(-jnp.inf)

    def step(carry, inp):
        best_val, best_idx = carry
        it = iter(inp)
        chunk_i, chunk = next(it), next(it)
        mask = next(it) if row_mask is not None else None
        base = chunk_i * chunk_size
        rows = unpack_bits_t(chunk, block_rows)  # [chunk, bits] +-1 bf16
        dots = jax.lax.dot_general(
            qb, rows,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )  # [q, chunk]
        live = (base + col) < valid_count
        if mask is not None:
            live = live & mask[None, :]
        dots = jnp.where(live, dots, neg_inf)
        c_vals, c_pos = jax.lax.top_k(dots, min(k, chunk_size))
        c_idx = jnp.where(jnp.isfinite(c_vals), base + c_pos, -1)
        vals = jnp.concatenate([best_val, c_vals], axis=-1)
        idx = jnp.concatenate([best_idx, c_idx], axis=-1)
        t_vals, t_pos = jax.lax.top_k(vals, k)
        t_idx = jnp.take_along_axis(idx, t_pos, axis=-1)
        return (t_vals, t_idx), None

    init = (
        jnp.full((q, k), -jnp.inf, dtype=jnp.float32),
        jnp.full((q, k), -1, dtype=jnp.int32),
    )
    xs = (jnp.arange(n_chunks, dtype=jnp.int32), chunks)
    if row_mask is not None:
        xs = xs + (mask_chunks,)
    (dots, idx), _ = jax.lax.scan(step, init, xs)
    dist = jnp.where(
        idx < 0,
        jnp.iinfo(jnp.int32).max,
        ((n_bits - dots) * 0.5).astype(jnp.int32),
    )
    return dist, idx


@functools.partial(jax.jit, static_argnames=("k", "chunk_size"))
def hamming_topk(
    q_codes: jnp.ndarray,
    c_codes: jnp.ndarray,
    k: int,
    chunk_size: int = 65536,
    valid_count=None,
    row_mask=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact Hamming top-k over packed int32 codes.

    Returns (distances [q, k] ascending, indices [q, k]); distances follow
    FAISS IndexBinaryFlat convention (smaller = closer).

    ``valid_count``: dynamic number of valid corpus rows (default n). Pass
    it instead of slicing the corpus so streaming inserts into a fixed
    buffer never retrace (same contract as ops.topk.chunked_topk).

    ``row_mask``: optional [n] bool — filtered search (the FAISS
    IDSelector counterpart): rows where False never rank, on top of the
    valid_count masking. Dynamic operand: fresh masks never retrace.
    """
    q, w = q_codes.shape
    n = c_codes.shape[0]
    if valid_count is None:
        valid_count = jnp.asarray(n, jnp.int32)
    chunk_size = min(chunk_size, max(n, 1))
    n_chunks = -(-n // chunk_size)
    n_pad = n_chunks * chunk_size
    if n_pad != n:
        c_codes = jnp.pad(c_codes, ((0, n_pad - n), (0, 0)))
        if row_mask is not None:
            row_mask = jnp.pad(row_mask, (0, n_pad - n))
    chunks = c_codes.reshape(n_chunks, chunk_size, w)
    if row_mask is not None:
        mask_chunks = row_mask.astype(jnp.bool_).reshape(
            n_chunks, chunk_size
        )
    qc = q_codes.astype(jnp.uint32)
    col = jax.lax.broadcasted_iota(jnp.int32, (1, chunk_size), 1)

    def step(carry, inp):
        best_neg, best_idx = carry
        it = iter(inp)
        chunk_i, chunk = next(it), next(it)
        mask = next(it) if row_mask is not None else None
        base = chunk_i * chunk_size
        x = jnp.bitwise_xor(qc[:, None, :], chunk.astype(jnp.uint32)[None, :, :])
        dist = jnp.sum(
            jax.lax.population_count(x).astype(jnp.int32), axis=-1
        )  # [q, chunk]
        gidx = base + col
        live = gidx < valid_count
        if mask is not None:
            live = live & mask[None, :]
        neg = jnp.where(live, -dist, jnp.iinfo(jnp.int32).min)
        c_vals, c_pos = jax.lax.top_k(neg, min(k, chunk_size))
        # masked/invalid slots carry idx -1 so a sentinel value can never
        # surface with a live-looking row id
        c_idx = jnp.where(
            c_vals > jnp.iinfo(jnp.int32).min, base + c_pos, -1
        )
        vals = jnp.concatenate([best_neg, c_vals], axis=-1)
        idx = jnp.concatenate([best_idx, c_idx], axis=-1)
        t_vals, t_pos = jax.lax.top_k(vals, k)
        t_idx = jnp.take_along_axis(idx, t_pos, axis=-1)
        return (t_vals, t_idx), None

    init = (
        jnp.full((q, k), jnp.iinfo(jnp.int32).min, dtype=jnp.int32),
        jnp.full((q, k), -1, dtype=jnp.int32),
    )
    xs = (jnp.arange(n_chunks, dtype=jnp.int32), chunks)
    if row_mask is not None:
        xs = xs + (mask_chunks,)
    (neg, idx), _ = jax.lax.scan(step, init, xs)
    # missing slots carry the INT32_MIN sentinel; negating would overflow
    # back to "closest possible" -- report a huge distance instead, matching
    # FAISS's missing-result convention
    dist = jnp.where(idx < 0, jnp.iinfo(jnp.int32).max, -neg)
    return dist, idx


@functools.partial(
    jax.jit,
    static_argnames=("k", "chunk_size", "n_bits", "mode", "recall_target"),
)
def sign_topk(
    q_signs: jnp.ndarray,
    c_signs: jnp.ndarray,
    k: int,
    n_bits: int,
    chunk_size: int = 1 << 20,
    mode: str = "exact",
    recall_target: float = 0.95,
    valid_count=None,
    row_mask=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Hamming top-k via +-1 matmul.

    ``q_signs``/``c_signs`` are +-1 in bf16 (or f32), shape [*, n_bits].
    Returns (hamming distances ascending, indices); with ``mode='exact'``
    (default) the ranking is identical to :func:`hamming_topk`.

    Scores are +-1 dot products, i.e. integers with |dot| <= n_bits; bf16
    represents every integer of magnitude <= 256 exactly, so for codes up
    to 256 bits the bf16-scored scan is LOSSLESS and halves the score
    buffer of f32. Wider codes fall back to f32 scores.

    ``mode='approx'`` swaps the per-chunk selection for
    ``lax.approx_max_k`` at ``recall_target`` (backends without a native
    partial reduction, the GPU among them, lower it to an exact
    selection). Hamming scores are small integers with heavy ties, so
    tie-aware recall is the right quality measure (any returned code at
    the k-th distance is as good).

    ``row_mask``: optional [n] bool — filtered search, same contract as
    ``ops.topk.chunked_topk`` (False rows never rank; dynamic operand,
    fresh masks never retrace).
    """
    from sessionsimilaritysearch.ops.topk import chunked_topk

    ip, idx = chunked_topk(
        q_signs.astype(jnp.bfloat16),
        c_signs.astype(jnp.bfloat16),
        k,
        chunk_size=chunk_size,
        metric="ip",
        mode=mode,
        recall_target=recall_target,
        score_dtype=jnp.bfloat16 if n_bits <= 256 else jnp.float32,
        valid_count=valid_count,
        row_mask=row_mask,
    )
    # dot = bits - 2*hamming  =>  hamming = (bits - dot) / 2. Missing slots
    # carry ip=-inf; float->int conversion of inf is implementation-defined,
    # so set them to the explicit INT32_MAX sentinel hamming_topk uses.
    dist = jnp.where(
        idx < 0,
        jnp.iinfo(jnp.int32).max,
        ((n_bits - ip) * 0.5).astype(jnp.int32),
    )
    return dist, idx


def simhash_codes(emb, n_bits: int, seed: int = 0) -> np.ndarray:
    """Training-free cosine LSH (SimHash): ``sign(emb @ R)`` with ONE
    shared Gaussian projection R [d, n_bits] for both query and db sides,
    so expected Hamming distance is proportional to the angle between
    embeddings (Charikar'02). The zero-setup binary serving mode: feeds
    ``BinaryIndex``/``evaluate_binary`` directly and retains most of the
    dense cosine ranking at 250 bits (examples/binary_quality.py), where
    the reference's serve path requires a fine-tuned BinarizeHead
    (fine_tune_ours.py:839-879) before binary search is usable at all.

    Returns [n, n_bits] float32 in {+1, -1} (zero dots break ties as +1).
    Type-preserving: a jax-array input hashes ON DEVICE (full-precision
    matmul) and returns a device array — a device-resident corpus never
    crosses the host link to be coded.
    """
    R = np.random.default_rng(seed).standard_normal(
        (emb.shape[1], n_bits)
    ).astype(np.float32)
    if isinstance(emb, jnp.ndarray) and not isinstance(emb, np.ndarray):
        y = jnp.dot(emb.astype(jnp.float32), jnp.asarray(R),
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
        return jnp.where(y >= 0, 1.0, -1.0).astype(jnp.float32)
    emb = np.asarray(emb, np.float32)
    return np.where(emb @ R >= 0, 1.0, -1.0).astype(np.float32)


def oracle_hamming_np(q_signs, c_signs, k):
    """Numpy Hamming oracle over +-1 sign arrays."""
    qb = (np.asarray(q_signs) > 0).astype(np.int32)
    cb = (np.asarray(c_signs) > 0).astype(np.int32)
    dist = (qb[:, None, :] != cb[None, :, :]).sum(-1)
    idx = np.argsort(dist, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(dist, idx, axis=1)
    return vals, idx.astype(np.int32)
