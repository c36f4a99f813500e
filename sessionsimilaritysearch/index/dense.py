"""The dense session-embedding index.

In the reference the "index" is a FAISS flat structure built once from the
full corpus (reference: test_amazon_filterd.py:207-223 ``build_index``;
fine_tune_ours.py:844-849). Here the index IS the corpus: a device-resident
[capacity, d] array (optionally sharded over a mesh -- see
``parallel/collectives.py``) scanned by blocked MIPS matmuls. No
pointer-chasing ANN structures: a flat matmul scan matches the reference's
exact-search semantics and the hardware's strengths.

Streaming inserts append into the preallocated buffer
(``jax.lax.dynamic_update_slice`` under jit); searches mask rows beyond the
current fill count, so add/search interleave without recompilation.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sessionsimilaritysearch.ops import topk as topk_ops


@functools.partial(jax.jit, donate_argnums=(0,))
def _write_rows(buf: jnp.ndarray, rows: jnp.ndarray, start: jnp.ndarray):
    return jax.lax.dynamic_update_slice(buf, rows, (start, 0))


@functools.partial(jax.jit, donate_argnums=(0,))
def _move_rows(buf: jnp.ndarray, src: jnp.ndarray, dst: jnp.ndarray):
    """Compaction scatter ``buf[dst] = buf[src]`` (rank-generic). Padded
    identity moves (src == dst == a row past the surviving range) write a
    slot its own value, so duplicate pad targets stay deterministic."""
    return buf.at[dst].set(buf[src])


def to_host_chunked(a, max_bytes: int = 4 << 20) -> np.ndarray:
    """Device->host transfer in row blocks of ~``max_bytes`` so concurrent
    small materializations (serving searches) never wait behind a
    monolithic multi-GB copy — each block is its own transfer, bounding
    any queued request's wait to one block. Serving-path building block
    for background snapshot writers (engine.save_async)."""
    if a.ndim == 0 or a.nbytes <= max_bytes:
        return np.asarray(a)
    rows = max(1, int(max_bytes // max(a.nbytes // a.shape[0], 1)))
    first = np.asarray(a[:rows])
    out = np.empty(a.shape, dtype=first.dtype)
    out[:rows] = first
    for s in range(rows, a.shape[0], rows):
        out[s : s + rows] = np.asarray(a[s : s + rows])
    return out


def compaction_plan(size: int, ids) -> Tuple[np.ndarray, np.ndarray, int]:
    """Swap-with-last removal plan over a [0, size) row range.

    Removing ``ids`` compacts the survivors into [0, new_size) by moving
    each surviving tail row (>= new_size) into a removed slot below
    new_size — O(#removed) moves, no full-buffer rewrite, and row order
    outside the moved set is untouched. Returns (src, dst, new_size):
    equal-length int32 arrays such that after ``buf[dst] = buf[src]`` the
    first new_size rows are exactly the survivors. This is the counterpart
    of FAISS ``remove_ids`` renumbering semantics (the reference's flat
    indexes, fine_tune_ours.py:844-849): surviving rows move ids.
    """
    ids = np.unique(np.asarray(ids, np.int64).reshape(-1))
    if ids.size == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32), size
    if ids[0] < 0 or ids[-1] >= size:
        raise ValueError(
            f"remove ids must lie in [0, {size}); got range "
            f"[{ids[0]}, {ids[-1]}]"
        )
    new_size = size - ids.size
    holes = ids[ids < new_size]
    tail_survivors = np.setdiff1d(
        np.arange(new_size, size, dtype=np.int64), ids, assume_unique=True
    )
    return (
        tail_survivors.astype(np.int32),
        holes.astype(np.int32),
        int(new_size),
    )


def _padded_moves(
    src: np.ndarray, dst: np.ndarray, pad_row: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pad a move list to the next power of two (min 8) with identity
    moves of ``pad_row`` so variable-size removals compile O(log capacity)
    scatter programs instead of one per distinct count. ``pad_row`` must
    never be a real destination (real dsts are < new_size <= pad_row)."""
    p = max(8, 1 << (int(src.size) - 1).bit_length())
    s = np.full(p, pad_row, np.int32)
    d = np.full(p, pad_row, np.int32)
    s[: src.size], d[: dst.size] = src, dst
    return jnp.asarray(s), jnp.asarray(d)


def _range_from_search(
    search_fn, nq: int, radius: float, *, descending: bool,
    total: int, k0: int = 128,
):
    """Exact range search built on adaptive-depth top-k.

    Accelerator formulation of ``faiss.Index.range_search``: rather than a
    variable-length scatter on device (dynamic shapes don't jit), run the
    existing fixed-shape top-k scan and DOUBLE the depth until every
    query's k-th result falls outside the radius (or depth reaches the
    corpus). Depths are powers of two, so a stream of range queries
    compiles O(log size) scan programs total, all cached. Returns FAISS's
    CSR convention ``(lims [nq+1], D, I)`` with each query's slice
    ``D[lims[i]:lims[i+1]]`` sorted best-first (FAISS leaves slices
    unordered; sorted is strictly stronger).
    """
    if total == 0 or nq == 0:
        return (
            np.zeros(nq + 1, np.int64),
            np.zeros(0, np.float32),
            np.zeros(0, np.int64),
        )
    k = min(max(8, k0), total)
    while True:
        d, i = search_fn(k)
        ok = (i >= 0) & (d >= radius if descending else d <= radius)
        # a fully-within-radius result row means the radius set may extend
        # past this depth -- double and rescan (exactness over latency)
        if k >= total or not ok.all(axis=1).any():
            break
        k = min(k * 2, total)
    lims = np.zeros(nq + 1, np.int64)
    np.cumsum(ok.sum(axis=1), out=lims[1:])
    return lims, d[ok], i[ok].astype(np.int64)


@jax.jit
def _quantize_rows_int8(emb: jnp.ndarray):
    """Per-row symmetric int8: code = round(row / s), s = max|row| / 127.
    Scores dequantize as (q . code) * s (ops.topk.chunked_topk
    corpus_scales)."""
    s = jnp.max(jnp.abs(emb), axis=1) / 127.0
    s = jnp.maximum(s, 1e-30)
    codes = jnp.clip(jnp.round(emb / s[:, None]), -127, 127).astype(jnp.int8)
    return codes, s.astype(jnp.float32)


class DenseIndex:
    """Flat exact index over a dense embedding corpus.

    metric:
      'cos' -- rows L2-normalized on add, queries normalized on search
               (reference build_index 'cos', test_amazon_filterd.py:211-214)
      'ip'  -- raw inner product
      'l2'  -- ascending squared L2 distance

    center ('cos' only): rank by CENTERED cosine -- subtract a corpus
    mean direction from every normalized row/query and re-unit-norm
    before scoring. Measured motivation (1M flagship artifact,
    examples/flagship_serving.py): session encoders early in training emit embeddings
    concentrated in a narrow cone, raw cosine saturates into one giant
    tie-class, and exact top-k degenerates to arbitrary tie-breaking;
    removing the common component lifted ground-truth type@10 7x at the
    1M x 1600 operating point. Pass an explicit [d] mean (fit it on a
    representative sample), or 'auto' to fit from the first added batch
    (frozen thereafter -- rows are stored in centered form).
    """

    def __init__(
        self,
        dim: int,
        capacity: int,
        metric: str = "cos",
        dtype=jnp.float32,
        chunk_size: int = 65536,
        mode: str = "exact",
        score_dtype=jnp.float32,
        quantize: Optional[str] = None,
        center=None,
    ):
        assert metric in ("cos", "ip", "l2")
        assert center is None or metric == "cos", (
            "center= is defined for the 'cos' metric only"
        )
        # 'int8': corpus int8, queries bf16 (capacity: half the memory of
        # bf16). 'int8x8': BOTH sides int8 so the scan runs
        # int8 x int8 -> int32 matmuls; queries
        # are quantized per-row at search time and scores dequantized.
        assert quantize in (None, "int8", "int8x8")
        assert quantize is None or metric != "l2", (
            "int8 corpus supports 'ip'/'cos' only"
        )
        self.dim = dim
        self.capacity = capacity
        self.metric = metric
        self.quantize = quantize
        self.dtype = jnp.dtype(jnp.int8 if quantize else dtype)
        self.chunk_size = chunk_size
        self.mode = mode
        # canonicalize: jnp.float32 (the class) and np.dtype('float32') hash
        # DIFFERENTLY as jit static args, so a loaded index would otherwise
        # recompile every search program a fresh index already owns
        # (serving_soak caught this after snapshot-restore)
        self.score_dtype = jnp.dtype(score_dtype)
        self._buf = jnp.zeros((capacity, dim), dtype=self.dtype)
        # per-row dequantization scales (int8 mode): true_row ~= code * scale.
        # Quarters the corpus memory vs f32 (halves vs bf16) for single-device
        # capacity headroom (1M x 1600 f32 = 6.4 GB -> 1.6 GB); ranking
        # error is bounded by the per-row quantization step and gated in
        # tests by value_recall_at_k.
        self._scales = (
            jnp.zeros((capacity,), jnp.float32) if quantize else None
        )
        self.center_mode = (
            None if center is None
            else ("auto" if isinstance(center, str) else "fixed")
        )
        if self.center_mode == "auto":
            assert center == "auto", f"unknown center mode {center!r}"
            self._center = None  # fitted from the first add
        else:
            self._center = (
                None if center is None
                else jnp.asarray(center, jnp.float32).reshape(dim)
            )
        self.size = 0

    def _centered(self, emb: jnp.ndarray) -> jnp.ndarray:
        """Centered-cosine transform of already-unit-norm rows:
        normalize(x_n - mean)."""
        return topk_ops.l2_normalize(emb - self._center)

    @property
    def ntotal(self) -> int:  # FAISS-compatible name
        return self.size

    def add(self, emb) -> None:
        """Append embeddings [m, d]; normalizes rows first under 'cos'."""
        emb = jnp.asarray(
            emb, jnp.float32 if self.quantize else self.dtype
        )
        assert emb.ndim == 2 and emb.shape[1] == self.dim
        m = emb.shape[0]
        if self.size + m > self.capacity:
            raise ValueError(
                f"index full: {self.size}+{m} > capacity {self.capacity}"
            )
        if self.metric == "cos":
            emb = topk_ops.l2_normalize(emb)
            if self.center_mode == "auto" and self._center is None:
                self._center = jnp.mean(emb, axis=0)
            if self._center is not None:
                emb = self._centered(emb)
        if self.quantize:
            emb, scales = _quantize_rows_int8(emb)
            self._scales = jax.lax.dynamic_update_slice(
                self._scales, scales, (self.size,)
            )
        else:
            emb = emb.astype(self.dtype)
        self._buf = _write_rows(self._buf, emb, jnp.asarray(self.size, jnp.int32))
        self.size += m

    def remove_ids(self, ids) -> int:
        """Remove rows by index (``faiss.Index.remove_ids`` counterpart;
        the reference's flat indexes expose exactly this maintenance op —
        session corpora need expiry/erasure, fine_tune_ours.py:844-849).

        Surviving tail rows compact into the freed slots (swap-with-last),
        so REMAINING ROW IDS CHANGE exactly as in FAISS: callers holding
        external row-aligned metadata must apply the same ``compaction_plan``
        moves (SessionSearchEngine.remove_sessions does). O(#removed) device
        work; freed capacity is immediately reusable by :meth:`add`; the
        search program never retraces (fixed buffer + valid_count). Returns
        the number of rows removed."""
        src, dst, new_size = compaction_plan(self.size, ids)
        if src.size:
            s, d = _padded_moves(src, dst, self.capacity - 1)
            self._buf = _move_rows(self._buf, s, d)
            if self.quantize:
                self._scales = _move_rows(self._scales, s, d)
        removed = self.size - new_size
        self.size = new_size
        return removed

    def reconstruct_batch(self, ids) -> np.ndarray:
        """Return stored rows by position (``faiss.Index.reconstruct_batch``
        counterpart): [m, d] float32, each row exactly as the index scores
        it — unit-normalized under 'cos', centered if ``center=`` is on,
        and the DEQUANTIZED approximation (code × scale) under int8 modes
        (FAISS likewise reconstructs the decoded vector, not the original).
        Ids are positional (this index renumbers on :meth:`remove_ids`)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.size):
            raise IndexError(
                f"reconstruct ids must lie in [0, {self.size})"
            )
        rows = jnp.take(self._buf, jnp.asarray(ids), axis=0)
        rows = rows.astype(jnp.float32)
        if self.quantize:
            scales = jnp.take(self._scales, jnp.asarray(ids))
            rows = rows * scales[:, None]
        return np.asarray(rows)

    def reconstruct(self, i: int) -> np.ndarray:
        """Single-row form (``faiss.Index.reconstruct``): [d] float32."""
        return self.reconstruct_batch([int(i)])[0]

    def search(self, queries, k: int,
               row_mask=None, out: str = "np",
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k. Returns (D [q,k], I [q,k]) like ``faiss.Index.search``:
        scores descending for 'cos'/'ip', squared distances ascending for
        'l2'; missing slots are (-inf/+inf, -1).

        ``out``: 'np' (default) materializes FAISS-style numpy results;
        'device' returns jax arrays WITHOUT forcing a host transfer — the
        device-resident convention (EmbeddingPipeline(out='device')): a
        downstream device consumer never pays the device->host transfer.

        ``row_mask``: optional bool array over the current rows (length
        ``size``, or ``capacity``) — filtered search: rows where False
        never rank (the FAISS IDSelector counterpart). A dynamic operand:
        fresh masks never retrace. NOTE after :meth:`remove_ids` row ids
        renumber — rebuild positional masks after removal.

        Query batches are padded up to the next power of two (min 8) so a
        variable-batch serving caller compiles O(log max_q) programs
        instead of one per distinct batch size; the corpus side never
        retraces (fixed capacity + valid_count masking)."""
        qdtype = jnp.bfloat16 if self.quantize else self.dtype
        queries = jnp.asarray(queries, qdtype)
        nq = queries.shape[0]
        q_pad = max(8, 1 << (max(nq - 1, 1)).bit_length())
        if q_pad != nq:
            queries = jnp.pad(queries, ((0, q_pad - nq), (0, 0)))
        if self.metric == "cos":
            if self._center is not None:
                queries = self._centered(
                    topk_ops.l2_normalize(queries.astype(jnp.float32))
                ).astype(qdtype)
            else:
                queries = topk_ops.l2_normalize(queries).astype(qdtype)
        query_scales = None
        if self.quantize == "int8x8":
            queries, query_scales = _quantize_rows_int8(
                queries.astype(jnp.float32)
            )
        metric = "ip" if self.metric == "cos" else self.metric
        if row_mask is not None and not (
            isinstance(row_mask, jax.Array)
            and row_mask.dtype == jnp.bool_
            and row_mask.shape[0] == self.capacity
        ):  # a device-resident capacity-length bool mask passes through
            row_mask = np.asarray(row_mask, bool)
            assert row_mask.shape[0] in (self.size, self.capacity), (
                f"row_mask length {row_mask.shape[0]} matches neither "
                f"size {self.size} nor capacity {self.capacity}"
            )
            if row_mask.shape[0] < self.capacity:
                row_mask = np.pad(
                    row_mask, (0, self.capacity - row_mask.shape[0])
                )
            row_mask = jnp.asarray(row_mask)
        vals, idx = topk_ops.chunked_topk(
            queries,
            self._buf,
            k,
            chunk_size=self.chunk_size,
            metric=metric,
            valid_count=jnp.asarray(self.size, jnp.int32),
            mode=self.mode,
            score_dtype=self.score_dtype,
            corpus_scales=self._scales,
            query_scales=query_scales,
            row_mask=row_mask,
        )
        if out == "np":
            vals, idx = np.asarray(vals)[:nq], np.asarray(idx)[:nq]
        else:
            assert out == "device", f"out must be 'np'|'device', got {out!r}"
            vals, idx = vals[:nq], idx[:nq]
        if self.metric == "l2":
            vals = -vals  # back to ascending squared distance
        return vals, idx

    def range_search(
        self, queries, radius: float, k0: int = 128, row_mask=None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All rows within ``radius`` of each query
        (``faiss.Index.range_search`` counterpart; the reference's flat
        indexes expose it, fine_tune_ours.py:844-849). Returns FAISS's CSR
        triple ``(lims [q+1] int64, D, I)``: query ``i``'s neighbors are
        ``I[lims[i]:lims[i+1]]``, sorted best-first.

        Radius semantics follow the metric: 'cos'/'ip' keep rows with
        score >= radius; 'l2' keeps squared distance <= radius. Exact:
        implemented as an adaptive-depth top-k (depth doubles from ``k0``
        until each query's deepest hit falls outside the radius), so it
        reuses the zero-retrace fixed-capacity scan and compiles at most
        O(log size) programs. ``row_mask`` composes as in :meth:`search`.
        Prefer :meth:`search` on latency-critical paths when a depth
        bound is known."""
        if self.mode == "approx":
            raise ValueError(
                "range_search needs an exact selection mode: approx "
                "top-k can silently drop in-radius rows"
            )
        if not hasattr(queries, "shape"):  # keep device queries on-device
            queries = np.asarray(queries)
        return _range_from_search(
            lambda k: self.search(queries, k, row_mask=row_mask),
            queries.shape[0], radius,
            descending=self.metric != "l2", total=self.size, k0=k0,
        )

    def merge_from(self, other: "DenseIndex") -> int:
        """Append ``other``'s stored rows (``faiss.Index.merge_from``
        counterpart — shard-consolidation maintenance). ``other``'s row
        ids shift by ``self.ntotal`` exactly as in FAISS; unlike FAISS,
        ``other`` is left intact. Requires identical dim/metric/quantize
        and an identical center transform (rows are stored
        post-transform, so differing transforms cannot share a buffer);
        an unfitted ``center='auto'`` index adopts ``other``'s fitted
        mean. One donated device write; retraces per distinct source size
        (maintenance op, not a serving path). Returns the row count
        appended."""
        assert isinstance(other, DenseIndex)
        if (self.dim, self.metric, self.quantize) != (
            other.dim, other.metric, other.quantize
        ):
            raise ValueError(
                "merge_from requires identical dim/metric/quantize: "
                f"({self.dim},{self.metric},{self.quantize}) vs "
                f"({other.dim},{other.metric},{other.quantize})"
            )
        if self.size + other.size > self.capacity:
            raise ValueError(
                f"index full: {self.size}+{other.size} > {self.capacity}"
            )
        if self._center is None and other._center is not None:
            if self.center_mode == "auto" and self.size == 0:
                self._center = other._center
            else:
                raise ValueError("center transform mismatch")
        elif (self._center is None) != (other._center is None) or (
            self._center is not None
            and not np.allclose(
                np.asarray(self._center), np.asarray(other._center)
            )
        ):
            raise ValueError("center transform mismatch")
        if other.size == 0:
            return 0
        rows = other._buf[: other.size].astype(self.dtype)
        self._buf = _write_rows(
            self._buf, rows, jnp.asarray(self.size, jnp.int32)
        )
        if self.quantize:
            self._scales = jax.lax.dynamic_update_slice(
                self._scales, other._scales[: other.size], (self.size,)
            )
        self.size += other.size
        return other.size

    # --- persistence (reference: faiss.write_index/read_index,
    #     test_amazon_filterd.py:96-97,159,176 -- commented out upstream,
    #     first-class here)
    def snapshot(self) -> dict:
        """Phase 1 of a two-phase save: capture a consistent point-in-time
        copy of the serving state as DEVICE arrays (slices dispatch fresh
        buffers, so later adds/removes — which donate ``_buf`` — cannot
        touch the capture) plus host scalars. Cheap: on-device copies run
        at device memory bandwidth, no host transfer. Pair with
        :meth:`write_snapshot` off-thread so a snapshot never blocks
        serving."""
        snap = {
            "buf": self._buf[: self.size],
            "dtype": jnp.dtype(self.dtype).name,
            "metric": self.metric,
            "dim": self.dim,
            "capacity": self.capacity,
            # serving configuration: a tuned engine must restore tuned
            # (snapshots used to silently reset to exact/f32 defaults)
            "mode": self.mode,
            "score_dtype": jnp.dtype(self.score_dtype).name,
            "chunk_size": self.chunk_size,
        }
        if self.quantize:
            snap["scales"] = self._scales[: self.size]
            snap["quantize"] = self.quantize
        if self._center is not None:
            snap["center"] = np.asarray(self._center, np.float32)
        if self.center_mode is not None:
            snap["center_mode"] = self.center_mode
        return snap

    @staticmethod
    def write_snapshot(snap: dict, path: str) -> None:
        """Phase 2: download the captured device arrays and write the npz.
        Safe to run on a background thread while the live index keeps
        mutating. bf16 corpora persist as raw uint16 bit patterns
        (``buf_u16``) — half the transfer and disk of the old
        f32 widening, bit-exact round trip. The download streams in
        ~4 MB row blocks: a monolithic multi-GB device->host transfer
        occupies the link in one piece, and any concurrent search's tiny
        result materialization queues behind ALL of it (a one-piece
        multi-GB save stalls a concurrent search for the whole transfer;
        chunking bounds the wait to one block)."""
        snap = dict(snap)
        buf = snap.pop("buf")
        if buf.dtype == jnp.bfloat16:
            snap["buf_u16"] = to_host_chunked(buf).view(np.uint16)
        else:
            snap["buf"] = to_host_chunked(buf)
        if "scales" in snap:
            snap["scales"] = np.asarray(snap["scales"])
        np.savez(path, **snap)

    def save(self, path: str) -> None:
        self.write_snapshot(self.snapshot(), path)

    @classmethod
    def load(cls, path: str, capacity: Optional[int] = None, **kw) -> "DenseIndex":
        """Restore a snapshot, including its serving configuration
        (mode/score_dtype/chunk_size/quantize). Keyword overrides win over
        the stored values; ``quantize`` cannot be overridden (the stored
        rows are already in code form)."""
        z = np.load(path if path.endswith(".npz") else path + ".npz", allow_pickle=True)
        if "buf_u16" in z.files:  # bf16 corpus stored as raw bit patterns
            import ml_dtypes

            buf = z["buf_u16"].view(ml_dtypes.bfloat16)
        else:
            buf = z["buf"]
        quantize = str(z["quantize"]) if "quantize" in z else None
        if "quantize" in kw and kw.pop("quantize") != quantize:
            raise ValueError(
                f"snapshot was saved with quantize={quantize!r}; stored rows "
                "are already in that storage form and cannot be re-quantized"
            )
        kw.setdefault("mode", str(z["mode"]) if "mode" in z else "exact")
        kw.setdefault(
            "score_dtype",
            jnp.dtype(str(z["score_dtype"])) if "score_dtype" in z
            else jnp.float32,
        )
        kw.setdefault(
            "chunk_size", int(z["chunk_size"]) if "chunk_size" in z else 65536
        )
        if "dtype" in z and not quantize:
            kw.setdefault("dtype", jnp.dtype(str(z["dtype"])))
        if "center" in z:
            # rows are stored already centered; restore the transform for
            # queries (and keep the fitted mean frozen under 'auto')
            kw.setdefault("center", np.asarray(z["center"], np.float32))
        idx = cls(
            dim=int(z["dim"]),
            capacity=capacity or int(z["capacity"]),
            metric=str(z["metric"]),
            quantize=quantize,
            **kw,
        )
        if "center_mode" in z:
            idx.center_mode = str(z["center_mode"])
        if buf.shape[0]:
            # rows were already normalized on the original add under 'cos'
            # (and quantized in int8 mode -- codes round-trip bit-exactly)
            idx._buf = _write_rows(
                idx._buf, jnp.asarray(buf, idx.dtype), jnp.asarray(0, jnp.int32)
            )
            if quantize:
                idx._scales = jax.lax.dynamic_update_slice(
                    idx._scales, jnp.asarray(z["scales"], jnp.float32), (0,)
                )
            idx.size = buf.shape[0]
        return idx


def build_index(
    emb,
    metric: str = "cos",
    chunk_size: int = 65536,
    quantize: Optional[str] = None,
    center=None,
) -> DenseIndex:
    """One-shot construction from a full corpus
    (reference: test_amazon_filterd.py:207-223). ``center='auto'`` fits
    the centered-cosine mean from the whole corpus (here the first add IS
    the corpus, so 'auto' is exact)."""
    emb = np.asarray(emb)
    index = DenseIndex(
        dim=emb.shape[1],
        capacity=emb.shape[0],
        metric=metric,
        chunk_size=chunk_size,
        quantize=quantize,
        center=center,
    )
    index.add(emb)
    return index
