"""SessionSearchEngine: the serving facade.

Ties the whole pipeline into one object — the role played in the reference
by the ad-hoc script bodies of fine_tune_ours.test() (:748-897) and
test_amazon_filterd.main2() (:452-692): encode sessions with a trained
encoder, keep the embedding corpus as a (optionally mesh-sharded) flat
index, stream-insert new sessions, answer top-k queries, and report
latency/QPS counters.
"""

from __future__ import annotations

import pickle
import queue as queue_mod
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import numpy as np

from sessionsimilaritysearch.config import Config
from sessionsimilaritysearch.evalharness import metrics as metrics_mod
from sessionsimilaritysearch.index.dense import DenseIndex
from sessionsimilaritysearch.utils.profiling import PhaseTimer


def _item_set(sess) -> frozenset:
    """Distinct product ids of a session (schema.get_item)."""
    return frozenset(a[-1] for a in sess if a[1] != "s")


def _overlap_cos(a: frozenset, b: frozenset) -> float:
    """Cosine of the L2-normalized binary item-indicator vectors, computed
    set-wise: |A∩B| / sqrt(|A||B|) (test_amazon_filterd.py:48-57 without
    ever materializing asin_num-dim vectors)."""
    if not a or not b:
        return 0.0
    return len(a & b) / ((len(a) * len(b)) ** 0.5)


def _item_stan_weights(sess, lammy: float = 1.04) -> dict:
    """Per-distinct-item L2-normalized recency weights — STAN semantics
    (index/sparse.py sequence_to_stan_vec; test_amazon_filterd.py:37-46)
    without materializing the asin_num-dim vector. The dot of two such
    dicts over shared keys IS the STAN cosine."""
    import math

    item_seq = [a for a in sess if a[1] != "s"]
    L = len(item_seq)
    acc: dict = {}
    for i, a in enumerate(item_seq):
        acc[a[-1]] = acc.get(a[-1], 0.0) + math.exp((i - L) / lammy)
    norm = math.sqrt(sum(w * w for w in acc.values()))
    if norm <= 0:
        return {}
    return {k: w / norm for k, w in acc.items()}


def _session_key(sess) -> tuple:
    """Hashable content digest of a session: (type, asin, text) per action —
    exactly the fields the graph transform reads, so two sessions with equal
    keys embed identically."""
    return tuple(
        (a[1], 0, a[2]) if a[1] == "s" else (a[1], int(a[-1]), a[-2])
        for a in sess
    )


class _GrowArr:
    """Append-only numpy array with amortized-doubling growth.

    Replaces the Python-list metadata mirrors so that (a) `_np_meta`
    snapshots are O(1) views instead of O(total) list->array conversions
    and (b) removal compacts with one vectorized gather instead of an
    O(corpus) Python rebuild (`_rebuild_meta` takes seconds per 256-row
    removal on a 1M-row corpus).

    Lock-free reader contract (same as the lists it replaces): writers
    hold the ingest lock; readers call ``view()``/``len()`` without it.
    ``_n`` is published AFTER the data is written, so ``view(len(self))``
    is always a fully-written prefix. Growth swaps in a new backing array;
    readers holding the old one still see a consistent snapshot.
    """

    __slots__ = ("_a", "_n")

    def __init__(self, dtype, data=None):
        if data is not None:
            self._a = np.ascontiguousarray(data, dtype=dtype)
            self._n = len(self._a)
        else:
            self._a = np.empty(1024, dtype=dtype)
            self._n = 0

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        return self._a[: self._n][i]

    def __setitem__(self, i, v) -> None:
        self._a[: self._n][i] = v

    def view(self, n: int = None) -> np.ndarray:
        a = self._a  # snapshot the reference once (growth may swap it)
        if n is None:
            n = self._n
        return a[: min(n, len(a))]

    def append(self, v) -> None:
        self.extend((v,))

    def extend(self, vals) -> None:
        vals = np.asarray(list(vals) if not isinstance(vals, np.ndarray)
                          else vals, dtype=self._a.dtype)
        need = self._n + len(vals)
        if need > len(self._a):
            new = np.empty(max(need, 2 * len(self._a)), dtype=self._a.dtype)
            new[: self._n] = self._a[: self._n]
            self._a = new
        self._a[self._n: need] = vals
        self._n = need  # publish last: seals the write for lock-free reads


class SaveHandle:
    """Handle for an in-flight :meth:`SessionSearchEngine.save_async`.
    ``join()`` blocks until the snapshot is fully on disk and re-raises
    any writer error; ``done()`` polls without blocking."""

    def __init__(self, work: Callable):
        self._err: List[BaseException] = []

        def runner():
            try:
                work()
            except BaseException as e:  # surfaced on join()
                self._err.append(e)

        self._thread = threading.Thread(target=runner, daemon=True)

    def done(self) -> bool:
        return not self._thread.is_alive()

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)
        if self._err:
            raise self._err.pop(0)


class SessionSearchEngine:
    """Encode-then-exact-search session similarity serving.

    Args:
      cfg: config (graph dims, ignore_query, retrieval defaults).
      tokenizer: host tokenizer.
      encode_fn: jitted ``batch_graphs -> [B, d]`` embedding function of the
        trained encoder.
      dim: embedding dimension.
      capacity: max corpus size.
      mesh: optional ``jax.sharding.Mesh`` -- shards the corpus row-wise and
        searches with the cross-shard collective.
      batch_size: encoder batch (static shape; short batches pad).
      quantize: None | 'int8' | 'int8x8' -- int8-code corpus storage
        (2-4x capacity/device; 'int8x8' also runs the scan as an
        int8 x int8 -> int32 matmul). Same-tolerance retrieval quality
        gates as the raw indexes.
      prefilter: None | 'binary' | 'itq' | 'int8x8' | 'pca' -- two-stage
        serving (index.twostage.TwoStageIndex): a cheap stage-1 scan over
        codes nominates ``pool`` candidates per query and only those rows
        are ranked exactly at full dimension. Exact final ranking over the
        pool; 'itq' is the learned binary prefilter for trained
        (cone-collapsed) embeddings where random SimHash is signal-free.
      pool: stage-1 candidates per query (two-stage mode).
      projector: fitted ``ops.projection.PCAProjector`` for
        ``prefilter='pca'``/'itq' (fit offline with ``fit_pca``/``fit_itq``
        on a corpus sample; ``index.twostage.build_twostage_index`` shows
        the recipe).
      center: centered-cosine serving (dense single-chip path): a [dim]
        mean, or 'auto' to fit from the first ingested batch. The
        measured fix for cone-collapsed encoder embeddings where raw
        cosine saturates.
      stage1: two-stage code-scan engine for the 'binary'/'itq'
        prefilters, single-chip AND sharded — 'matmul' (sign matmul) or
        'packed' (unpack+matmul scan over int32-packed codes,
        16x smaller stage-1 buffers, per chip in sharded mode;
        index.twostage.TwoStageIndex docs).
      dtype: corpus storage dtype for the dense (non-quantized) paths;
        None keeps each index class's default (f32 dense; bf16 two-stage
        store). Production serving at 1M x 1600 should pass
        ``jnp.bfloat16``: halves corpus memory and is the benched default,
        value-recall gated at 2 bf16 ulps (bench.py).
    """

    def __init__(
        self,
        cfg: Config,
        tokenizer,
        encode_fn: Callable,
        dim: int,
        capacity: int,
        metric: str = "cos",
        mesh=None,
        batch_size: int = 256,
        mode: str = "exact",
        quantize=None,
        prefilter: Optional[str] = None,
        pool: int = 512,
        projector=None,
        center=None,
        stage1: str = "matmul",
        dtype=None,
    ):
        from sessionsimilaritysearch.evalharness.harness import (
            EmbeddingPipeline,
        )

        self.cfg = cfg
        self.tokenizer = tokenizer
        self.encode_fn = encode_fn
        self.batch_size = batch_size
        self.timer = PhaseTimer()
        self.sessions: List = []  # retained for metric reports
        self._pipe = EmbeddingPipeline(cfg, tokenizer, encode_fn, batch_size)
        # (item, stamp) pairs waiting until a full stripe is available
        # (sharded mode buffers whole multiples of the shard count)
        self._pending: List = []
        # background ingest (add_sessions_async / flush)
        self._ingest_q: Optional[queue_mod.Queue] = None
        self._ingest_thread: Optional[threading.Thread] = None
        self._ingest_err: List[BaseException] = []
        # reentrant: expire() computes matching rows and calls
        # remove_sessions under one critical section
        self._ingest_lock = threading.RLock()
        # canonical key per inserted session, for query-time dedup
        self._canon: List = []
        # distinct item-id set per inserted session, for hybrid re-ranking
        self._items: List[frozenset] = []
        # numpy mirrors of the above for the vectorized query paths.
        # Append ORDER matters for lock-free snapshots: _canon_ids and
        # _item_flat are written BEFORE _item_lens for each row, so reading
        # n = len(_item_lens) first yields a consistent prefix of all three
        # even while a background ingest thread is appending.
        self._key_to_id: dict = {}
        self._canon_ids = _GrowArr(np.int64)
        self._item_flat = _GrowArr(np.int64)
        self._item_wstan = _GrowArr(np.float64)  # STAN w per _item_flat row
        self._item_lens = _GrowArr(np.int64)
        self._meta_cache: Optional[tuple] = None
        # gids dropped via remove_sessions in sharded mode (stable-id
        # indexes keep tombstoned metadata rows; single-chip compacts)
        self._removed: set = set()
        # optional caller-supplied ingest stamp per row (TTL expiry);
        # NaN = unstamped. A float array, not a Python list: expire()
        # scans it every call and a 1M-row Python loop costs ~seconds
        # while the vectorized compare is ~ms
        self._stamps = _GrowArr(np.float64)
        if mesh is not None:
            from sessionsimilaritysearch.index.sharded import (
                ShardedDenseIndex,
            )

            ndev = mesh.shape["data"]
            capacity = -(-capacity // ndev) * ndev
            if prefilter is not None and stage1 == "packed":
                # packed stage-1 shards must hold whole pack blocks
                from sessionsimilaritysearch.ops.hamming import TBLOCK

                unit = ndev * TBLOCK
                capacity = -(-capacity // unit) * unit
            if prefilter is not None:
                from sessionsimilaritysearch.index.twostage import (
                    ShardedTwoStageIndex,
                )

                assert prefilter in ("binary", "itq", "int8x8", "pca"), (
                    f"unknown prefilter {prefilter!r}"
                )
                assert quantize is None, (
                    "two-stage mode stores its own code buffers; drop "
                    "quantize"
                )
                self.index = ShardedTwoStageIndex(
                    dim=dim, capacity=capacity, mesh=mesh, metric=metric,
                    prefilter=prefilter, pool=pool, projector=projector,
                    stage1=stage1,
                    **({} if dtype is None else {"store_dtype": dtype}),
                )
            else:
                self.index = ShardedDenseIndex(
                    dim=dim, capacity=capacity, mesh=mesh, metric=metric,
                    mode=mode, quantize=quantize,
                    **({} if dtype is None else {"dtype": dtype}),
                )
            self._pad_to = ndev
        elif prefilter is not None:
            from sessionsimilaritysearch.index.twostage import (
                TwoStageIndex,
            )

            assert quantize is None, (
                "two-stage mode stores its own code buffers; drop quantize"
            )
            self.index = TwoStageIndex(
                dim=dim, capacity=capacity, metric=metric,
                prefilter=prefilter, pool=pool, projector=projector,
                stage1=stage1,
                **({} if dtype is None else {"store_dtype": dtype}),
            )
            self._pad_to = 1
        else:
            self.index = DenseIndex(
                dim=dim, capacity=capacity, metric=metric,
                quantize=quantize, center=center,
                **({} if dtype is None else {"dtype": dtype}),
            )
            self._pad_to = 1

    # ------------------------------------------------------------------
    def embed(self, data: Sequence, out: str = "np"):
        """Embed raw sessions / (prefix, future) pairs.

        ``out='device'`` skips the per-batch device->host transfer — the
        ingest path uses it so corpus embeddings go encoder -> index with
        zero host crossings (a per-batch round trip serializes with
        compute)."""
        t0 = time.perf_counter()
        res = self._pipe(data, out=out)
        self.timer.totals["encode"] += time.perf_counter() - t0
        self.timer.counts["encode"] += 1
        return res

    def add_sessions(self, data: Sequence,
                     stamp: Optional[float] = None) -> None:
        """Encode + stream-insert sessions into the corpus.

        In sharded mode inserts stripe across shards, so only whole
        multiples of the shard count go in immediately; the remainder is
        buffered until the next add (``pending`` in :meth:`stats`). No
        duplicate rows are ever inserted -- duplicates would occupy top-k
        slots and double-count in reports.

        ``stamp``: optional caller-supplied ingest timestamp (any
        monotonic float — epoch seconds, a step counter) recorded per row
        for TTL eviction via :meth:`expire`. Unstamped rows never expire.
        """
        with self._ingest_lock:
            self._add_locked(data, stamp)

    def _add_locked(self, data: Sequence,
                    stamp: Optional[float] = None) -> None:
        self._pending.extend((d, stamp) for d in data)
        m = (len(self._pending) // self._pad_to) * self._pad_to
        if m == 0:
            return
        pairs, self._pending = self._pending[:m], self._pending[m:]
        batch = [d for d, _ in pairs]
        emb = self.embed(batch, out="device")
        with self.timer("insert"):
            self.index.add(emb)
            jax.block_until_ready(self.index._buf)  # time the device work
        for d, ts in pairs:
            sess = d[0] if isinstance(d, tuple) and len(d) == 2 else d
            self._stamps.append(np.nan if ts is None else float(ts))
            self.sessions.append(sess)
            key = _session_key(sess)
            items = _item_set(sess)
            sw = _item_stan_weights(sess)
            self._canon.append(key)
            self._items.append(items)
            self._canon_ids.append(
                self._key_to_id.setdefault(key, len(self._key_to_id))
            )
            ids = list(items)
            self._item_flat.extend(ids)
            self._item_wstan.extend(sw.get(i, 0.0) for i in ids)
            self._item_lens.append(len(ids))  # last: seals the row

    def _np_meta(self):
        """Consistent numpy snapshot of per-row metadata: (n, canon_ids,
        item_offsets[n+1], item_flat, item_wstan). Lock-free:
        ``_item_lens`` is appended last per row (see __init__), so its
        length bounds a fully-written prefix. Cached until new rows
        arrive."""
        n = len(self._item_lens)
        cache = self._meta_cache
        if cache is not None and cache[0] == n:
            return cache
        lens = self._item_lens.view(n)
        n = len(lens)  # re-bound: a concurrent shrink may have raced us
        off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens[:n], out=off[1:])
        flat = self._item_flat.view(int(off[-1]))
        wstan = self._item_wstan.view(int(off[-1]))
        canon = self._canon_ids.view(n)
        self._meta_cache = (n, canon, off, flat, wstan)
        return self._meta_cache

    # ------------------------------------------------------------------
    # Background ingest: encode+insert off the caller's thread so serving
    # threads keep answering queries while new sessions stream in (the
    # reference has no streaming path at all -- its index is built once,
    # test_amazon_filterd.py:207-223).
    def add_sessions_async(self, data: Sequence,
                           stamp: Optional[float] = None) -> None:
        """Queue sessions for background encode+insert. Failures surface on
        the next :meth:`flush` (or :meth:`close`)."""
        if self._ingest_thread is None:
            self._ingest_q = queue_mod.Queue()
            self._ingest_thread = threading.Thread(
                target=self._ingest_loop, daemon=True
            )
            self._ingest_thread.start()
        self._ingest_q.put((list(data), stamp))

    def _ingest_loop(self) -> None:
        while True:
            item = self._ingest_q.get()
            try:
                if item is None:
                    return
                data, stamp = item
                with self._ingest_lock:
                    self._add_locked(data, stamp)
            except BaseException as e:
                self._ingest_err.append(e)
            finally:
                self._ingest_q.task_done()

    def flush(self) -> None:
        """Block until all queued background inserts are in the index; the
        stripe remainder (sharded mode) stays pending as for add_sessions."""
        if self._ingest_q is not None:
            self._ingest_q.join()
        if self._ingest_err:
            raise self._ingest_err.pop(0)

    def close(self) -> None:
        if self._ingest_thread is not None:
            self.flush()
            self._ingest_q.put(None)
            self._ingest_thread.join()
            self._ingest_thread = None
            self._ingest_q = None

    # ------------------------------------------------------------------
    def _rebuild_meta(self) -> None:
        """Recompute every per-row metadata structure from
        ``self.sessions`` (used by restore and by single-chip removal)."""
        self._canon = [_session_key(s) for s in self.sessions]
        self._items = [_item_set(s) for s in self.sessions]
        self._key_to_id = {}
        canon_ids = [
            self._key_to_id.setdefault(key, len(self._key_to_id))
            for key in self._canon
        ]
        flat: List[int] = []
        wstan: List[float] = []
        lens: List[int] = []
        for sess, items in zip(self.sessions, self._items):
            sw = _item_stan_weights(sess)
            ids = list(items)
            flat.extend(ids)
            wstan.extend(sw.get(i, 0.0) for i in ids)
            lens.append(len(ids))
        # lens seals LAST on append; on shrink assign it FIRST so a racing
        # _np_meta never computes offsets past the (shorter) new arrays
        self._item_lens = _GrowArr(np.int64, lens)
        self._canon_ids = _GrowArr(np.int64, canon_ids)
        self._item_flat = _GrowArr(np.int64, flat)
        self._item_wstan = _GrowArr(np.float64, wstan)
        self._meta_cache = None

    def _compact_meta(self, src: np.ndarray, dst: np.ndarray,
                      new_size: int) -> None:
        """Mirror the index's swap-with-last compaction on every per-row
        metadata structure in O(moved + items) instead of re-deriving all
        of it from ``self.sessions`` (O(corpus) Python — seconds per
        256-row removal on a 1M-row corpus; this path is ~ms). ``src``/``dst``/``new_size``
        must be the SAME ``compaction_plan`` applied to the index."""
        for s, d in zip(src.tolist(), dst.tolist()):
            self.sessions[d] = self.sessions[s]
            self._canon[d] = self._canon[s]
            self._items[d] = self._items[s]
        del self.sessions[new_size:]
        del self._canon[new_size:]
        del self._items[new_size:]
        st = self._stamps.view(len(self._stamps)).copy()
        st[dst] = st[src]
        self._stamps = _GrowArr(np.float64, st[:new_size])
        # stale keys may linger in _key_to_id; canonical ids only need
        # EQUALITY semantics (dedup groups rows with the same content), so
        # ids need not stay dense — restore() rebuilds the dense form.
        n_old = len(self._item_lens)
        lens = self._item_lens.view(n_old).copy()
        canon = self._canon_ids.view(n_old).copy()
        off = np.zeros(n_old + 1, dtype=np.int64)
        np.cumsum(lens, out=off[1:])
        flat = self._item_flat.view(int(off[-1]))
        wstan = self._item_wstan.view(int(off[-1]))
        perm = np.arange(new_size, dtype=np.int64)
        keep = dst < new_size
        perm[dst[keep]] = src[keep]
        counts = lens[perm]
        new_off = np.zeros(new_size + 1, dtype=np.int64)
        np.cumsum(counts, out=new_off[1:])
        gather = (np.repeat(off[perm] - new_off[:-1], counts)
                  + np.arange(int(new_off[-1]), dtype=np.int64))
        # shrink order (see _rebuild_meta): lens first, then the arrays
        self._item_lens = _GrowArr(np.int64, counts)
        self._canon_ids = _GrowArr(np.int64, canon[perm])
        self._item_flat = _GrowArr(np.int64, flat[gather])
        self._item_wstan = _GrowArr(np.float64, wstan[gather])
        self._meta_cache = None

    def remove_sessions(self, data: Optional[Sequence] = None,
                        ids: Optional[Sequence] = None) -> int:
        """Delete sessions from the serving corpus (the engine counterpart
        of ``faiss.Index.remove_ids`` — expiry/erasure for streaming
        corpora; the reference's build-once indexes have no delete path).

        Pass EITHER ``data`` (raw sessions or (prefix, future) tuples —
        every stored row with the same canonical content is removed, plus
        matching not-yet-inserted pending rows) OR ``ids`` (row ids as
        returned by :meth:`search`).

        Id semantics follow the underlying index: sharded corpora keep
        STABLE global ids (removed ids are never reused or returned), while
        single-chip indexes compact positionally exactly like FAISS
        ``remove_ids`` — ids already handed out renumber, so resolve
        content -> id -> remove without interleaved inserts/removals.
        This is a maintenance operation: it takes the ingest lock (safe
        against concurrent ``add_sessions_async``), but queries running
        concurrently with a single-chip removal may transiently read
        renumbered hybrid/dedup metadata. Returns rows removed."""
        assert (data is None) != (ids is None), (
            "pass exactly one of data= or ids="
        )
        with self._ingest_lock:
            if data is not None:
                keys = {
                    _session_key(
                        d[0] if isinstance(d, tuple) and len(d) == 2 else d
                    )
                    for d in data
                }
                # drop matching rows still waiting in the stripe buffer
                self._pending = [
                    (d, ts) for d, ts in self._pending
                    if _session_key(
                        d[0] if isinstance(d, tuple) and len(d) == 2 else d
                    ) not in keys
                ]
                # vectorized content->rows: canonical ids group identical
                # content, so membership is one np.isin over the id
                # mirror instead of an O(corpus) Python key scan (that
                # scan was the bulk of a remove at 1M rows)
                kids = np.fromiter(
                    (self._key_to_id[k] for k in keys
                     if k in self._key_to_id),
                    np.int64,
                )
                mask = np.isin(self._canon_ids.view(len(self._canon)),
                               kids)
                if self._removed:
                    mask[np.fromiter(self._removed, np.int64,
                                     len(self._removed))] = False
                rows = np.flatnonzero(mask).tolist()
            else:
                rows = [int(i) for i in ids if int(i) >= 0]
            if not rows:
                return 0
            from sessionsimilaritysearch.index.dense import (
                compaction_plan,
            )
            from sessionsimilaritysearch.index.sharded import (
                ShardedDenseIndex,
            )
            from sessionsimilaritysearch.index.twostage import (
                ShardedTwoStageIndex,
            )

            if isinstance(self.index,
                          (ShardedDenseIndex, ShardedTwoStageIndex)):
                removed = self.index.remove_ids(rows)
                self._removed.update(rows)
                return removed
            src, dst, new_size = compaction_plan(self.index.ntotal, rows)
            removed = self.index.remove_ids(rows)
            # mirror the index's swap-with-last compaction on every
            # row-aligned metadata structure (incremental, not a rebuild)
            self._compact_meta(src, dst, new_size)
            return removed

    def expire(self, before: float) -> int:
        """TTL eviction: remove every row (and pending entry) whose ingest
        ``stamp`` (see :meth:`add_sessions`) is older than ``before``.
        Rows added without a stamp never expire. The standard session-store
        retention pattern, built on :meth:`remove_sessions`; same id
        semantics and concurrency contract. Returns indexed rows removed
        (dropped pending entries are not counted)."""
        with self._ingest_lock:
            self._pending = [
                (d, ts) for d, ts in self._pending
                if ts is None or ts >= before
            ]
            st = self._stamps.view()
            mask = st < before  # NaN (unstamped) compares False
            if self._removed:
                mask[np.fromiter(self._removed, np.int64,
                                 len(self._removed))] = False
            ids = np.flatnonzero(mask)
            if ids.size == 0:
                return 0
            return self.remove_sessions(ids=ids)

    # ------------------------------------------------------------------
    def search(self, data: Sequence, k: Optional[int] = None,
               dedup: bool = False, hybrid_alpha: Optional[float] = None,
               overfetch: int = 4, hybrid_kind: str = "overlap",
               hybrid_fusion: str = "score",
               where: Optional[Callable] = None):
        """Full query path: sessions -> embed -> exact top-k.
        Returns (D, I). With ``dedup=True``, hits whose stored session
        duplicates an earlier hit's (same actions, e.g. inserted twice by a
        re-played stream) are dropped and backfilled from deeper ranks.

        ``hybrid_alpha``: re-rank the dense top-(overfetch*k) candidates by
        ``alpha * dense_cos + (1 - alpha) * sparse_cos`` (the fusion
        of evalharness.harness.evaluate_hybrid, restricted to the dense
        candidate set so the sparse term costs O(session length) per
        candidate instead of an asin_num-dim matmul). Raise ``overfetch``
        to trade latency for fusion fidelity.

        ``hybrid_kind``: the sparse term -- 'overlap' (binary
        item-indicator cosine, test_amazon_filterd.py:48-57) or 'stan'
        (recency-decayed STAN cosine, :37-46). On overlap-hostile data the
        recency weighting is the stronger sparse signal by a wide margin
        (adversarial protocol, examples/quality_protocol.py).

        ``hybrid_fusion``: 'score' fuses the two cosines linearly with
        ``hybrid_alpha``; 'rrf' uses reciprocal-rank fusion
        ``1/(60+rank_dense) + 1/(60+rank_sparse)`` over the candidate set
        (Cormack & Clarke'09) — rank-based, so it is immune to the scale
        mismatch that makes score fusion land BELOW the better parent on
        cone-collapsed encoders (measured: adversarial alpha sweep;
        rrf_stan >= max(parents) per seed). ``hybrid_alpha``
        still gates the hybrid path on (its value is ignored for 'rrf').

        ``where``: optional predicate ``session -> bool`` — filtered
        search (the FAISS IDSelector counterpart): only stored sessions
        the predicate accepts can rank (e.g. purchase sessions, a
        category slice). Evaluated over the whole stored corpus per call
        (O(n) host work — cache at the call site for hot filters);
        composes with dedup and hybrid re-ranking. Supported on every
        engine index (dense, two-stage, sharded forms of both); two-stage
        engines apply the mask inside stage 1 so the candidate pool is
        spent entirely on allowed rows."""
        k = k or self.cfg.retrieval_k
        assert hybrid_kind in ("overlap", "stan")
        assert hybrid_fusion in ("score", "rrf")
        if hybrid_alpha is not None and self.index.metric != "cos":
            raise ValueError(
                "hybrid_alpha fuses a cosine with an overlap cosine; "
                f"metric={self.index.metric!r} scores are unbounded and the "
                "alpha weighting would be meaningless (use metric='cos')"
            )
        # device-resident: query embeddings go encoder -> index without a
        # host round trip
        emb = self.embed(data, out="device")
        t0 = time.perf_counter()
        if hybrid_alpha is None:
            D, I = self.search_embeddings(emb, k, dedup=dedup, where=where)
        else:
            m = min(max(overfetch * k, k), max(self.index.ntotal, 1))
            D2, I2 = self.search_embeddings(emb, m, dedup=dedup,
                                            where=where)
            D2 = np.asarray(D2, dtype=np.float32)
            gid = np.asarray(I2, dtype=np.int64)
            sessions = [
                d[0] if isinstance(d, tuple) and len(d) == 2 else d
                for d in data
            ]
            if hybrid_kind == "stan":
                q_w = [_item_stan_weights(s) for s in sessions]
            else:
                q_w = []
                for s in sessions:
                    items = _item_set(s)
                    w = 1.0 / (len(items) ** 0.5) if items else 0.0
                    q_w.append({i: w for i in items})
            D, I = self._hybrid_rerank(
                D2, gid, q_w, k, float(hybrid_alpha), hybrid_kind,
                fusion=hybrid_fusion,
            )
        self.timer.totals["search"] += time.perf_counter() - t0
        self.timer.counts["search"] += 1
        return D, I

    def _hybrid_rerank(self, D2, gid, q_weights, k: int, alpha: float,
                       kind: str = "overlap", fusion: str = "score"):
        """Vectorized fusion re-rank: ``alpha * dense + (1-alpha) * sparse``
        over the [q, m] candidate matrix, one numpy pass for the whole batch
        (no per-candidate Python). ``q_weights`` is one
        {item: weight} dict per query with L2-normalized weights, so the
        sparse term is a cosine for both kinds: 'overlap' uses uniform
        1/sqrt(n) weights (binary-indicator cosine) and 'stan' uses
        recency-decayed weights. Candidates inserted so recently that their
        metadata isn't sealed yet (concurrent add_sessions_async) score 0
        instead of racing on ``self._items``."""
        q, m = D2.shape
        if q_weights and not isinstance(q_weights[0], dict):
            # item sets -> uniform binary-indicator weights
            q_weights = [
                {i: 1.0 / (len(s) ** 0.5) for i in s} if s else {}
                for s in q_weights
            ]
        n_meta, _, off, flat, wstan = self._np_meta()
        present = gid >= 0
        known = present & (gid < n_meta)
        g = np.where(known, gid, 0).ravel()
        starts = off[g]
        lens = np.where(known.ravel(), off[g + 1] - starts, 0)
        # gather every candidate's item ids into one flat stream
        total = int(lens.sum())
        ends = np.cumsum(lens)
        seg0 = ends - lens
        gather_ix = np.arange(total) + np.repeat(starts - seg0, lens)
        cand_items = flat[gather_ix]
        if kind == "stan":
            cand_w = wstan[gather_ix]
        else:
            # binary-indicator weights: 1/sqrt(#items of that candidate)
            inv = np.zeros(lens.shape, np.float64)
            np.divide(1.0, np.sqrt(lens.astype(np.float64)), out=inv,
                      where=lens > 0)
            cand_w = np.repeat(inv, lens)
        # membership of (query row, item) pairs, encoded as single ints and
        # resolved by binary search in the (small, sorted) query-key set --
        # np.isin would sort the multi-million-candidate stream instead
        q_lens = np.asarray([len(s) for s in q_weights], dtype=np.int64)
        q_items = np.asarray(
            [i for s in q_weights for i in s], dtype=np.int64
        )
        q_w = np.asarray(
            [w for s in q_weights for w in s.values()], dtype=np.float64
        )
        big = int(max(flat.max(initial=0), q_items.max(initial=0))) + 1
        qkeys = np.repeat(np.arange(q), q_lens) * big + q_items
        korder = np.argsort(qkeys)
        qkeys, q_w = qkeys[korder], q_w[korder]
        row_of_cand = np.repeat(
            np.arange(q, dtype=np.int64), lens.reshape(q, m).sum(axis=1)
        )
        ckeys = row_of_cand * big + cand_items
        if qkeys.size:
            p = np.searchsorted(qkeys, ckeys)
            pc = np.minimum(p, qkeys.size - 1)
            member = (p < qkeys.size) & (qkeys[pc] == ckeys)
            contrib = np.where(member, cand_w * q_w[pc], 0.0)
        else:
            contrib = np.zeros(total, dtype=np.float64)
        # per-candidate weighted intersections: segment sums via one cumsum
        cm = np.zeros(total + 1, dtype=np.float64)
        np.cumsum(contrib, out=cm[1:])
        ov = (cm[ends] - cm[seg0]).reshape(q, m).astype(np.float32)
        if fusion == "rrf":
            # reciprocal-rank fusion over the candidate set: rank each
            # system independently (dense rank = column order, since D2
            # arrives descending; sparse rank by ov with the dense order
            # as the tiebreak so candidates the sparse term cannot
            # distinguish keep their dense preference)
            rr = np.repeat(np.arange(q, dtype=np.int64), m)
            cc = np.tile(np.arange(m, dtype=np.int64), q)
            # missing slots sort last so real candidates get contiguous
            # sparse ranks; ties keep the dense (column) order
            ovr = np.where(present, ov, -np.inf)
            sp_order = np.lexsort((cc, -ovr.ravel(), rr)).reshape(q, m) % m
            cols = cc.reshape(q, m)
            sp_rank = np.empty((q, m), np.int64)
            np.put_along_axis(sp_rank, sp_order, cols, axis=1)
            fused = (
                1.0 / (60.0 + cols) + 1.0 / (60.0 + sp_rank)
            ).astype(np.float32)
        else:
            fused = alpha * D2 + np.float32(1.0 - alpha) * ov
        fused[~present] = -np.inf
        # top-k per row; ties keep the dense rank order (column tiebreak)
        rowsf = np.repeat(np.arange(q), m)
        colsf = np.tile(np.arange(m), q)
        order = np.lexsort((colsf, -fused.ravel(), rowsf)).reshape(q, m)
        top = (order % m)[:, : min(k, m)]
        D = np.full((q, k), -np.inf, dtype=np.float32)
        I = np.full((q, k), -1, dtype=np.int64)
        D[:, : top.shape[1]] = np.take_along_axis(fused, top, axis=1)
        I[:, : top.shape[1]] = np.take_along_axis(gid, top, axis=1)
        I[~np.isfinite(D)] = -1
        return D, I

    def search_embeddings(self, emb, k: Optional[int] = None,
                          dedup: bool = False,
                          where: Optional[Callable] = None):
        k = k or self.cfg.retrieval_k
        kw = {}
        if where is not None:
            kw["row_mask"] = self._where_mask(where)
        if not dedup:
            return self.index.search(emb, k, **kw)
        # over-fetch so dropped duplicates can be backfilled
        k2 = min(max(2 * k, k + 8), max(self.index.ntotal, 1))
        D2, I2 = self.index.search(emb, k2, **kw)
        return self._dedup_topk(D2, I2, k)

    def range_search(self, data: Sequence, radius: float,
                     k0: int = 128, where: Optional[Callable] = None):
        """All stored sessions within ``radius`` of each query session
        (cosine score floor under the default 'cos' metric) — the
        ``faiss.Index.range_search`` counterpart at the serving layer;
        the natural API for near-duplicate detection and dedup sweeps.
        Returns the CSR triple ``(lims [q+1], D, I)``: query ``i``'s
        neighbors are ``I[lims[i]:lims[i+1]]`` (row ids in this engine's
        id space — positional single-chip, stable gids sharded), sorted
        best-first. ``where`` filters as in :meth:`search`. Exact; the
        engine's index must be an exact-mode dense/sharded-dense (the
        two-stage pool bound has no radius semantics — build the engine
        without ``prefilter=`` for radius workloads)."""
        if not hasattr(self.index, "range_search"):
            raise ValueError(
                "range_search needs an exact full-corpus index; this "
                f"engine serves a {type(self.index).__name__} (two-stage "
                "pools have no radius semantics)"
            )
        emb = self.embed(data, out="device")
        mask = self._where_mask(where) if where is not None else None
        t0 = time.perf_counter()
        out = self.index.range_search(emb, radius, k0=k0, row_mask=mask)
        # radius queries count in the same serving stats as search()
        # (they were invisible in engine.stats())
        self.timer.totals["search"] += time.perf_counter() - t0
        self.timer.counts["search"] += 1
        return out

    def _where_mask(self, where: Callable) -> np.ndarray:
        """Evaluate a session predicate into the index's row mask:
        positional for the single-chip indexes, gid-keyed for the sharded
        ones (ids are stable there, so the session list IS the gid space,
        tombstones included). Two-stage indexes apply the mask inside
        stage 1, so the candidate pool is spent entirely on allowed
        rows."""
        return np.fromiter(
            (bool(where(s)) for s in self.sessions),
            dtype=bool, count=len(self.sessions),
        )

    def _dedup_topk(self, D2, I2, k: int):
        """Drop candidates whose session duplicates a better-ranked hit
        (same canonical key), backfilling from deeper ranks."""
        D2 = np.asarray(D2)
        gid = np.asarray(I2, dtype=np.int64)
        q, m = gid.shape
        n_meta, canon, _, _, _ = self._np_meta()
        valid = gid >= 0
        # canonical id per candidate; rows whose metadata isn't sealed yet
        # (concurrent ingest) fall back to a unique per-gid key, offset past
        # the canon-id range so it can't collide
        g = np.where(valid, gid, 0)
        key = np.where(
            g < n_meta,
            canon[np.minimum(g, max(n_meta - 1, 0))] if n_meta else g,
            g + (np.int64(1) << 40),
        )
        # group by (row, key), keep each group's best-ranked column, then
        # restore rank order and take the first k per row -- one numpy pass
        # for the whole batch
        rowsf = np.repeat(np.arange(q), m)
        colsf = np.tile(np.arange(m), q)
        order = np.lexsort((colsf, key.ravel(), rowsf))
        rs, ks = rowsf[order], key.ravel()[order]
        first = np.ones(q * m, dtype=bool)
        first[1:] = (rs[1:] != rs[:-1]) | (ks[1:] != ks[:-1])
        keep = first & valid.ravel()[order]
        kr, kc = rs[keep], colsf[order][keep]
        o2 = np.lexsort((kc, kr))
        kr, kc = kr[o2], kc[o2]
        pos = np.arange(len(kr)) - np.searchsorted(kr, np.arange(q))[kr]
        sel = pos < k
        kr, kc, pos = kr[sel], kc[sel], pos[sel]
        D = np.full((q, k), -np.inf, dtype=D2.dtype)
        I = np.full((q, k), -1, dtype=np.asarray(I2).dtype)
        D[kr, pos] = D2[kr, kc]
        I[kr, pos] = gid[kr, kc]
        return D, I

    # ------------------------------------------------------------------
    def report(self, test_data: Sequence, I, D=None) -> dict:
        """Ground-truth quality report for retrieved results. Pass the
        cosine D matrix to include the |score - jaccard| diagnostic."""
        return metrics_mod.full_report(D, I, list(test_data), self.sessions)

    def reconstruct(self, ids) -> np.ndarray:
        """Stored embedding rows for result ids, [m, d] float32
        (``faiss.Index.reconstruct_batch`` counterpart): the row exactly
        as the index scores it (normalized / centered / dequantized per
        the index's storage). Id semantics are the index's own — STABLE
        global ids on sharded engines, positional (renumbered by
        remove_sessions) single-chip; ids straight from :meth:`search`
        results are always valid until the row is removed."""
        return self.index.reconstruct_batch(ids)

    def stats(self) -> dict:
        s = self.timer.summary()
        s["ntotal"] = self.index.ntotal
        s["pending"] = len(self._pending)
        return s

    # ------------------------------------------------------------------
    # Snapshot / restore (reference: faiss.write_index/read_index plus the
    # pickled session lists the metric suite reads; here one prefix carries
    # both halves of the serving state)
    def save(self, prefix: str) -> None:
        """Snapshot corpus + sessions to ``prefix + '.index.npz'`` and
        ``prefix + '.sessions.pkl'``. Queued background inserts are flushed
        first; the stripe remainder is persisted and re-buffered on restore.
        Blocking form of :meth:`save_async`."""
        self.save_async(prefix).join()

    def save_async(self, prefix: str) -> "SaveHandle":
        """Non-blocking snapshot: capture a consistent point-in-time copy
        of the serving state under the ingest lock (fast — index buffers
        copy ON DEVICE via ``index.snapshot()``, metadata copies are
        shallow), then download + write on a background thread while
        searches AND ingest continue. A blocking ``save()`` stalls
        serving for the whole device->host stream of the corpus, which
        has no business sitting on the query path (``faiss.write_index``
        is offline; a serving engine must do better).

        Returns a :class:`SaveHandle`; call ``.join()`` before restoring
        from ``prefix`` or exiting. Snapshot consistency: the capture
        point is strictly ordered against adds/removes (they take the same
        lock), and captured device buffers are fresh copies, so later
        donation-based updates cannot touch them. Indexes without a
        ``snapshot()`` method (sharded forms) fall back to writing under
        the ingest lock on the worker thread: searches still continue,
        ingest/maintenance block for the write's duration."""
        self.flush()
        with self._ingest_lock:
            snap = (self.index.snapshot()
                    if hasattr(self.index, "snapshot") else None)
            meta = {
                "sessions": list(self.sessions),
                # float array, NaN = unstamped (restore also accepts the
                # legacy list-of-Optional[float] form)
                "stamps": self._stamps.view(len(self._stamps)).copy(),
                "pending": [d for d, _ in self._pending],
                "pending_stamps": [ts for _, ts in self._pending],
            }
        writer = type(self.index).write_snapshot if snap is not None \
            else None

        def work():
            if snap is not None:
                writer(snap, prefix + ".index")
            else:
                with self._ingest_lock:
                    self.index.save(prefix + ".index")
            with open(prefix + ".sessions.pkl", "wb") as f:
                pickle.dump(meta, f)

        handle = SaveHandle(work)
        handle._thread.start()
        return handle

    def restore(self, prefix: str) -> None:
        """Load a snapshot into this engine (same mesh/metric setup). The
        encoder is not part of the snapshot — pair with the training
        checkpoints (utils/checkpoint.py) for full state."""
        from sessionsimilaritysearch.index.sharded import (
            ShardedDenseIndex,
        )

        with self._ingest_lock:
            # the snapshot carries the full serving configuration
            # (mode/score_dtype/chunk_size/quantize) -- restore it verbatim
            # rather than re-imposing this engine's construction defaults
            from sessionsimilaritysearch.index.twostage import (
                ShardedTwoStageIndex,
                TwoStageIndex,
            )

            # Free the CURRENT index's device buffers BEFORE the snapshot
            # uploads: load() materializes a full capacity-sized corpus,
            # and holding both would need 2x the corpus memory, which can
            # run a device out of memory mid-restore exactly when restore
            # is most needed. On load failure the
            # engine is left index-less (unusable) rather than silently
            # serving the pre-restore corpus.
            old = self.index
            kind = type(old)
            mesh = getattr(old, "mesh", None)
            cap = old.capacity
            self.index = None
            del old

            if issubclass(kind, ShardedTwoStageIndex):
                self.index = ShardedTwoStageIndex.load(
                    prefix + ".index", mesh=mesh
                )
            elif issubclass(kind, ShardedDenseIndex):
                self.index = ShardedDenseIndex.load(
                    prefix + ".index", mesh=mesh
                )
            elif issubclass(kind, TwoStageIndex):
                self.index = TwoStageIndex.load(
                    prefix + ".index", capacity=cap
                )
            else:
                self.index = DenseIndex.load(
                    prefix + ".index", capacity=cap
                )
            with open(prefix + ".sessions.pkl", "rb") as f:
                blob = pickle.load(f)
            self.sessions = list(blob["sessions"])
            raw = blob.get("stamps")
            if raw is None:
                arr = np.full(len(self.sessions), np.nan)
            elif isinstance(raw, np.ndarray):
                arr = raw.astype(np.float64)
            else:  # legacy list-of-Optional[float] snapshots
                arr = np.asarray(
                    [np.nan if t is None else float(t) for t in raw],
                    np.float64,
                )
            self._stamps = _GrowArr(np.float64, arr)
            pend = list(blob["pending"])
            pend_ts = list(blob.get("pending_stamps", [None] * len(pend)))
            self._pending = list(zip(pend, pend_ts))
            self._rebuild_meta()
            # stable-id (sharded) indexes keep tombstoned metadata rows
            # for removed gids: rebuild the removed set from the index's
            # surviving ids so content-keyed removal stays consistent
            self._removed = set()
            host_ids = getattr(self.index, "_host_ids", None)
            if host_ids is not None:
                present = set(host_ids[host_ids >= 0].tolist())
                self._removed = {
                    gid for gid in range(self.index._next_id)
                    if gid not in present
                }
