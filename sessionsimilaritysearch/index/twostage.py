"""Two-stage serving index: cheap prefilter + exact full-dim re-rank.

At 1M x 1600 the exact dense scan pays a full-dimension matmul and an
exact selection over every row; approx/binary modes are cheaper but their
final *ranking* is not exact. This index takes the architectural route
past that floor: a stage-1
prefilter scans the FULL corpus in a cheap representation (binary
simhash codes, int8 approx, or a PCA low-rank projection — all measured
production modes) to nominate a per-query candidate pool, and stage 2
(``ops.topk.rerank_topk``) gathers only those rows from the
full-precision corpus and ranks them exactly. End-to-end quality is
governed by stage-1 pool recall alone; with pools of a few hundred rows
the prefilter misses essentially nothing, and the full-dimension work
per query drops from O(n) corpus rows to O(pool).

The reference serves either a full-precision FAISS flat scan or a pure
binary index (fine_tune_ours.py:839-849, test_amazon_filterd.py:207-223)
— never both; quality there steps down to raw Hamming ranking the moment
speed requires codes. Here the codes only *shortlist* and the returned
ranking is the full-dim exact one over the pool.

Streaming contract (same as DenseIndex/BinaryIndex): every buffer is
allocated at full capacity once and searches mask with a dynamic
``valid_count``, so interleaved add/search never recompiles.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sessionsimilaritysearch.index.dense import (
    DenseIndex,
    _move_rows,
    _padded_moves,
    _quantize_rows_int8,
    _write_rows,
    compaction_plan,
)
from sessionsimilaritysearch.ops import topk as topk_ops
from sessionsimilaritysearch.ops.hamming import sign_topk


@functools.partial(jax.jit, static_argnames=("n_bits", "seed"))
def _simhash_signs(emb: jnp.ndarray, n_bits: int, seed: int) -> jnp.ndarray:
    """Device-side SimHash: sign(emb @ R) with a seed-deterministic shared
    Gaussian R (ops.hamming.simhash_codes semantics, Charikar'02)."""
    d = emb.shape[1]
    R = jax.random.normal(jax.random.PRNGKey(seed), (d, n_bits), jnp.float32)
    dots = jnp.dot(emb.astype(jnp.float32), R,
                   preferred_element_type=jnp.float32)
    return jnp.where(dots >= 0, 1.0, -1.0).astype(jnp.bfloat16)


@jax.jit
def _centered_signs(
    emb: jnp.ndarray, mean: jnp.ndarray, comp: jnp.ndarray
) -> jnp.ndarray:
    """Device-side learned binary codes: sign((x - mean) @ comp.T) for a
    fitted (ITQ-rotated) projector — see ops.projection.fit_itq."""
    y = jnp.dot(emb.astype(jnp.float32) - mean, comp.T,
                preferred_element_type=jnp.float32)
    return jnp.where(y >= 0, 1.0, -1.0).astype(jnp.bfloat16)


class TwoStageIndex:
    """Prefilter + exact re-rank over one embedding corpus.

    Args:
      dim: embedding dimension.
      capacity: max corpus size (scan cost is proportional to it).
      metric: 'cos' (rows/queries L2-normalized) | 'ip'.
      prefilter:
        'binary'  SimHash sign codes, approx-selected sign-matmul scan
                  (fastest stage 1; ``n_bits`` codes per row). Carries NO
                  signal on cone-collapsed trained embeddings (measured
                  null) — use 'itq' there;
        'itq'     LEARNED binary codes: sign of the centered ITQ-rotated
                  projection (pass ``projector`` from
                  ``ops.projection.fit_itq``) — same sign-scan cost as
                  'binary' with data-dependent bits;
        'int8x8'  int8 x int8 matmul scan with approx selection;
        'pca'     low-rank scan over a fitted projection (pass
                  ``projector`` from ``ops.projection.fit_pca``; cheapest
                  stage-1 matmul when the spectrum allows it).
      n_bits: code width for 'binary' (bf16 bits <= 256 keep the sign
        scan lossless, see ops.hamming.sign_topk).
      pool: default stage-1 candidates per query (override per search);
        the exactness knob — raise it to push pool recall to 1.
      store_dtype: full-row storage for the re-rank buffer (bf16 default:
        re-rank scores are exact at stored-row precision with f32
        accumulation; use f32 for strict end-to-end exactness).
      recall_target: stage-1 approx selection recall target.
      projector: fitted ``PCAProjector`` ('pca' prefilter only).
      seed: SimHash projection seed ('binary' only).
      stage1: code-scan engine for the 'binary'/'itq' prefilters --
        'matmul'  +-1 bf16 codes ranked by sign matmul (the default;
                  2 bytes/bit of device memory);
        'packed'  TRANSPOSED int32-packed codes scanned by the
                  unpack+matmul scan (ops.hamming.packed_t_topk) -- 1
                  BIT/bit of device memory (16x smaller stage-1 buffer)
                  and an EXACT Hamming top-pool (the matmul path
                  approx-selects).
    """

    def __init__(
        self,
        dim: int,
        capacity: int,
        metric: str = "cos",
        prefilter: str = "binary",
        n_bits: int = 256,
        pool: int = 512,
        store_dtype=jnp.bfloat16,
        recall_target: float = 0.95,
        projector=None,
        seed: int = 0,
        stage1: str = "matmul",
    ):
        assert metric in ("cos", "ip")
        assert prefilter in ("binary", "itq", "int8x8", "pca")
        assert stage1 in ("matmul", "packed")
        assert stage1 == "matmul" or prefilter in ("binary", "itq"), (
            "stage1='packed' scans sign codes; use the 'binary' or 'itq' "
            "prefilter"
        )
        if prefilter in ("pca", "itq"):
            assert projector is not None, (
                f"prefilter='{prefilter}' needs a fitted "
                "ops.projection projector (fit_pca / fit_itq)"
            )
        if prefilter == "itq":
            n_bits = int(np.asarray(projector.components).shape[0])
        self.dim = dim
        self.capacity = capacity
        self.metric = metric
        self.prefilter = prefilter
        self.n_bits = n_bits
        self.pool = pool
        self.store_dtype = jnp.dtype(store_dtype)
        self.recall_target = recall_target
        self.seed = seed
        self.stage1 = stage1
        self.size = 0
        self._buf = jnp.zeros((capacity, dim), dtype=self.store_dtype)
        self._codes_index = None
        if prefilter in ("pca", "itq"):
            self._proj_mean = jnp.asarray(projector.mean, jnp.float32)
            self._proj_comp = jnp.asarray(projector.components, jnp.float32)
            self._proj_explained = float(projector.explained)
        if stage1 == "packed":
            from sessionsimilaritysearch.index.binary import BinaryIndex

            self._codes_index = BinaryIndex(
                n_bits=n_bits, capacity=capacity, mode="packed",
            )
        elif prefilter in ("binary", "itq"):
            self._codes = -jnp.ones((capacity, n_bits), jnp.bfloat16)
        elif prefilter == "int8x8":
            self._codes = jnp.zeros((capacity, dim), jnp.int8)
            self._scales = jnp.zeros((capacity,), jnp.float32)
        else:
            self._codes = jnp.zeros(
                (capacity, self._proj_comp.shape[0]), jnp.bfloat16
            )

    @property
    def ntotal(self) -> int:
        return self.size

    def _project(self, emb: jnp.ndarray) -> jnp.ndarray:
        y = jnp.dot(
            emb.astype(jnp.float32) - self._proj_mean, self._proj_comp.T,
            preferred_element_type=jnp.float32,
        )
        return (topk_ops.l2_normalize(y, eps=1e-24)).astype(jnp.bfloat16)

    def add(self, emb) -> None:
        """Append [m, d] embeddings; writes the re-rank rows AND the
        stage-1 codes (one device pass each, O(batch))."""
        emb = jnp.asarray(emb, jnp.float32)
        assert emb.ndim == 2 and emb.shape[1] == self.dim
        m = emb.shape[0]
        if self.size + m > self.capacity:
            raise ValueError(
                f"index full: {self.size}+{m} > capacity {self.capacity}"
            )
        if self.metric == "cos":
            emb = topk_ops.l2_normalize(emb)
        start = jnp.asarray(self.size, jnp.int32)
        self._buf = _write_rows(
            self._buf, emb.astype(self.store_dtype), start
        )
        if self.prefilter == "binary":
            codes = _simhash_signs(emb, self.n_bits, self.seed)
        elif self.prefilter == "itq":
            codes = _centered_signs(emb, self._proj_mean, self._proj_comp)
        elif self.prefilter == "int8x8":
            codes, scales = _quantize_rows_int8(emb)
            self._scales = jax.lax.dynamic_update_slice(
                self._scales, scales, (start,)
            )
        else:
            codes = self._project(emb)
        if self._codes_index is not None:
            self._codes_index.add(codes)  # packs on device
        else:
            self._codes = _write_rows(self._codes, codes, start)
        self.size += m

    def remove_ids(self, ids) -> int:
        """Remove rows by id (FAISS ``remove_ids`` semantics — surviving
        row ids renumber per index.dense.compaction_plan). The re-rank
        rows, stage-1 codes, and int8 scales move together so both stages
        stay row-aligned. Returns the number of rows removed."""
        src, dst, new_size = compaction_plan(self.size, ids)
        if src.size:
            s, d = _padded_moves(src, dst, self.capacity - 1)
            self._buf = _move_rows(self._buf, s, d)
            if self._codes_index is None:
                self._codes = _move_rows(self._codes, s, d)
            if self.prefilter == "int8x8":
                self._scales = _move_rows(self._scales, s, d)
        if self._codes_index is not None:
            # identical compaction plan (same size, same ids) keeps the
            # packed stage-1 rows aligned with the re-rank rows
            self._codes_index.remove_ids(ids)
        removed = self.size - new_size
        self.size = new_size
        return removed

    def reconstruct_batch(self, ids) -> np.ndarray:
        """Return stage-2 (full-dim) stored rows by position: [m, d]
        float32, as the re-rank scores them (unit-norm under 'cos', at
        ``store_dtype`` precision). FAISS ``reconstruct_batch``
        counterpart; ids are positional (renumbered by remove_ids)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.size):
            raise IndexError(
                f"reconstruct ids must lie in [0, {self.size})"
            )
        rows = jnp.take(self._buf, jnp.asarray(ids), axis=0)
        return np.asarray(rows.astype(jnp.float32))

    def reconstruct(self, i: int) -> np.ndarray:
        """Single-row form: [d] float32."""
        return self.reconstruct_batch([int(i)])[0]

    def merge_from(self, other, batch: int = 65536) -> int:
        """Append ``other``'s stored rows (``faiss.Index.merge_from``
        counterpart). ``other`` is another :class:`TwoStageIndex` or a
        non-centered :class:`DenseIndex` — anything whose
        ``reconstruct_batch`` yields the stored full-dim rows. Rows
        stream through reconstruct -> :meth:`add` in ``batch`` chunks, so
        stage-1 codes are recomputed under THIS index's prefilter config
        (the two indexes' prefilter/pool/seed may differ freely). Ids
        shift by ``self.ntotal`` as in FAISS; ``other`` is left intact.
        Row values round-trip at ``other``'s storage precision (bf16 for
        the default store_dtype). Returns the row count appended."""
        if not isinstance(other, (TwoStageIndex, DenseIndex)):
            # gid-keyed sources (ShardedDenseIndex keeps STABLE global
            # ids) would silently merge wrong rows through the positional
            # np.arange(other.size) below — fail loudly instead
            raise TypeError(
                "merge_from source must be a TwoStageIndex or DenseIndex "
                f"(positional reconstruct ids), got {type(other).__name__}"
            )
        if getattr(other, "dim", None) != self.dim or getattr(
            other, "metric", None
        ) != self.metric:
            raise ValueError(
                "merge_from requires identical dim/metric: "
                f"({self.dim},{self.metric}) vs "
                f"({getattr(other, 'dim', None)},"
                f"{getattr(other, 'metric', None)})"
            )
        if isinstance(other, DenseIndex) and other._center is not None:
            raise ValueError(
                "cannot merge centered-cosine rows: the stored rows are "
                "post-center-transform and this index scores raw cosine"
            )
        if self.size + other.size > self.capacity:
            raise ValueError(
                f"index full: {self.size}+{other.size} > {self.capacity}"
            )
        for start in range(0, other.size, batch):
            ids = np.arange(start, min(start + batch, other.size))
            self.add(other.reconstruct_batch(ids))
        return other.size

    def _stage1(self, qn: jnp.ndarray, pool: int,
                row_mask=None) -> jnp.ndarray:
        vc = jnp.asarray(self.size, jnp.int32)
        if self.prefilter in ("binary", "itq"):
            if self.prefilter == "binary":
                q_signs = _simhash_signs(qn, self.n_bits, self.seed)
            else:
                q_signs = _centered_signs(
                    qn, self._proj_mean, self._proj_comp
                )
            if self._codes_index is not None:
                # packed stage 1: unpack+matmul scan over transposed-
                # packed codes, exact Hamming top-pool; device arrays flow
                # straight into the re-rank (no host sync)
                _, idx = self._codes_index.search_device(
                    q_signs, pool, row_mask=row_mask
                )
                return idx
            _, idx = sign_topk(
                q_signs, self._codes, pool, n_bits=self.n_bits,
                mode="approx", recall_target=self.recall_target,
                valid_count=vc, row_mask=row_mask,
            )
        elif self.prefilter == "int8x8":
            q8, q_scales = _quantize_rows_int8(qn.astype(jnp.float32))
            _, idx = topk_ops.chunked_topk(
                q8, self._codes, pool, chunk_size=self.capacity,
                mode="approx", recall_target=self.recall_target,
                score_dtype=jnp.bfloat16, valid_count=vc,
                corpus_scales=self._scales, query_scales=q_scales,
                row_mask=row_mask,
            )
        else:
            qp = self._project(qn)
            _, idx = topk_ops.chunked_topk(
                qp, self._codes, pool, chunk_size=self.capacity,
                mode="approx", recall_target=self.recall_target,
                score_dtype=jnp.bfloat16, valid_count=vc,
                row_mask=row_mask,
            )
        return idx

    def search(
        self, queries, k: int, pool: Optional[int] = None, row_mask=None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact-over-pool top-k: (D [q,k] descending, I [q,k]); missing
        slots are (-inf, -1). Query batches pad to powers of two (the
        DenseIndex convention) so variable serving batches compile
        O(log max_q) programs.

        ``row_mask``: optional bool array over the current rows (length
        ``size`` or ``capacity``) — filtered search: the mask applies
        INSIDE stage 1, so the candidate pool is spent entirely on
        allowed rows (filtering at re-rank time would silently shrink the
        effective pool). Dynamic operand — fresh masks never retrace.
        Positional ids (rebuild masks after :meth:`remove_ids`)."""
        pool = pool or self.pool
        pool = min(max(pool, k), max(self.capacity, 1))
        queries = jnp.asarray(queries, jnp.float32)
        nq = queries.shape[0]
        q_pad = max(8, 1 << (max(nq - 1, 1)).bit_length())
        if q_pad != nq:
            queries = jnp.pad(queries, ((0, q_pad - nq), (0, 0)))
        qn = (
            topk_ops.l2_normalize(queries)
            if self.metric == "cos" else queries
        )
        if row_mask is not None:
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
        cand = self._stage1(qn, pool, row_mask=row_mask)
        vals, idx = topk_ops.rerank_topk(
            qn, self._buf, cand, k, metric="ip",
            score_dtype=jnp.float32,
        )
        return np.asarray(vals)[:nq], np.asarray(idx)[:nq]

    # --- persistence (serving configuration travels with the data, the
    #     repo-wide snapshot-fidelity contract)
    def snapshot(self) -> dict:
        """Phase 1 of a two-phase save (DenseIndex.snapshot contract):
        point-in-time DEVICE copies of the serving buffers + host config.
        Cheap; pair with :meth:`write_snapshot` off-thread so snapshots
        don't block serving."""
        snap = {
            "buf": self._buf[: self.size],
            "dim": self.dim,
            "capacity": self.capacity,
            "metric": self.metric,
            "prefilter": self.prefilter,
            "n_bits": self.n_bits,
            "pool": self.pool,
            "store_dtype": self.store_dtype.name,
            "recall_target": self.recall_target,
            "seed": self.seed,
            "stage1": self.stage1,
        }
        if self.prefilter == "int8x8":
            snap["scales"] = self._scales[: self.size]
        if self.prefilter in ("pca", "itq"):
            snap["proj_mean"] = np.asarray(self._proj_mean)
            snap["proj_comp"] = np.asarray(self._proj_comp)
            snap["proj_explained"] = self._proj_explained
        if self._codes_index is not None:
            # packed stage 1: transposed-packed int32 words (npz-native),
            # trimmed to the used pack blocks (BinaryIndex.save layout);
            # the pack block is a LAYOUT property, so it travels with the
            # words and load validates it (BinaryIndex.load semantics)
            ci = self._codes_index
            snap["codes_packed_t"] = ci._buf[: ci._t_used_rows()]
            snap["codes_block_rows"] = ci.block_rows
        else:
            codes = self._codes[: self.size]
            if codes.dtype == jnp.bfloat16:
                # bf16 isn't a native npz dtype; sign/unit-norm codes
                # round-trip via f16 without ranking change
                snap["codes_f16"] = codes.astype(jnp.float16)
            else:
                snap["codes"] = codes
        return snap

    @staticmethod
    def write_snapshot(snap: dict, path: str) -> None:
        """Phase 2: download the captured device arrays and write the npz
        (safe off-thread). bf16 stage-2 rows persist as raw uint16 bit
        patterns (``buf_u16``) — half the transfer of f32 widening."""
        from sessionsimilaritysearch.index.dense import to_host_chunked

        snap = dict(snap)
        buf = snap.pop("buf")
        if buf.dtype == jnp.bfloat16:
            snap["buf_u16"] = to_host_chunked(buf).view(np.uint16)
        else:
            snap["buf"] = to_host_chunked(buf.astype(jnp.float32))
        for key in ("scales", "codes_packed_t", "codes_f16", "codes"):
            if key in snap:
                snap[key] = to_host_chunked(snap[key])
        np.savez(path, **snap)

    def save(self, path: str) -> None:
        self.write_snapshot(self.snapshot(), path)

    @classmethod
    def load(
        cls, path: str, capacity: Optional[int] = None, **kw
    ) -> "TwoStageIndex":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        prefilter = str(z["prefilter"])
        projector = None
        if prefilter in ("pca", "itq"):
            from sessionsimilaritysearch.ops.projection import (
                PCAProjector,
            )

            projector = PCAProjector(
                z["proj_mean"], z["proj_comp"], float(z["proj_explained"])
            )
        idx = cls(
            dim=int(z["dim"]),
            capacity=capacity or int(z["capacity"]),
            metric=str(z["metric"]),
            prefilter=prefilter,
            n_bits=int(z["n_bits"]),
            pool=int(kw.pop("pool", int(z["pool"]))),
            store_dtype=jnp.dtype(str(z["store_dtype"])),
            recall_target=float(z["recall_target"]),
            projector=projector,
            seed=int(z["seed"]),
            stage1=str(z["stage1"]) if "stage1" in z else "matmul",
            **kw,
        )
        if "buf_u16" in z.files:  # bf16 rows stored as raw bit patterns
            import ml_dtypes

            buf = z["buf_u16"].view(ml_dtypes.bfloat16)
        else:
            buf = z["buf"]
        n = buf.shape[0]
        if n:
            start = jnp.asarray(0, jnp.int32)
            idx._buf = _write_rows(
                idx._buf, jnp.asarray(buf, idx.store_dtype), start
            )
            if idx._codes_index is not None:
                ci = idx._codes_index
                if "codes_packed_t" in z.files:
                    saved_br = (
                        int(z["codes_block_rows"])
                        if "codes_block_rows" in z.files
                        else ci.block_rows
                    )
                    assert saved_br == ci.block_rows, (
                        "pack block mismatch: snapshot "
                        f"{saved_br} vs {ci.block_rows}"
                    )
                    ci._buf = _write_rows(
                        ci._buf, jnp.asarray(z["codes_packed_t"]), start
                    )
                    ci.size = n
                else:
                    # legacy row-major packed snapshot: unpack and
                    # re-ingest through the transposed append path
                    from sessionsimilaritysearch.ops.hamming import (
                        unpack_bits_np,
                    )

                    ci.add(unpack_bits_np(z["codes_packed"], ci.n_bits))
            else:
                codes = (
                    jnp.asarray(z["codes_f16"]).astype(jnp.bfloat16)
                    if "codes_f16" in z else jnp.asarray(z["codes"])
                )
                idx._codes = _write_rows(idx._codes, codes, start)
            if prefilter == "int8x8":
                idx._scales = jax.lax.dynamic_update_slice(
                    idx._scales, jnp.asarray(z["scales"], jnp.float32), (0,)
                )
            idx.size = n
        return idx


class ShardedTwoStageIndex:
    """Two-stage serving over a corpus row-sharded across a mesh axis.

    The scale-out form of :class:`TwoStageIndex` with the FULL prefilter
    menu ('binary' SimHash / learned 'itq' sign codes, 'int8x8' scaled
    integer rows — and 'pca' low-rank projections): full-precision
    rows AND their stage-1 codes stripe across the mesh's ``axis``, each
    chip prefilters + exactly re-ranks its own slice, and per-shard
    [q, k] slivers merge by all-gather
    (``parallel.collectives.sharded_twostage_topk``). Capacity and both
    scan costs scale linearly with chips; results carry GLOBAL
    insertion-order ids and match ``DenseIndex`` conventions.

    Streaming contract: fixed-capacity sharded buffers + dynamic
    per-shard valid counts — interleaved add/search never recompiles.

    ``stage1='packed'`` ('binary'/'itq' prefilters): each chip keeps its
    stage-1 codes TRANSPOSED-packed at 1 bit/bit of device memory and scans
    them with the unpack+matmul scan (ops.hamming.packed_t_topk) — the
    capacity tier of sharded serving. Requires whole pack blocks per
    shard (capacity % (ndev * hamming.TBLOCK) == 0); appends scatter-OR
    bits in place and removals move code bits with the rows
    (index/binary.py layout invariants, per shard).
    """

    def __init__(
        self,
        dim: int,
        capacity: int,
        mesh,
        axis: str = "data",
        metric: str = "cos",
        prefilter: str = "binary",
        n_bits: int = 256,
        pool: int = 512,
        store_dtype=jnp.bfloat16,
        recall_target: float = 0.95,
        score_dtype=jnp.float32,
        projector=None,
        seed: int = 0,
        stage1: str = "matmul",
    ):
        from jax.sharding import NamedSharding, PartitionSpec as P

        assert metric in ("cos", "ip")
        assert prefilter in ("binary", "itq", "int8x8", "pca")
        assert stage1 in ("matmul", "packed")
        assert stage1 == "matmul" or prefilter in ("binary", "itq"), (
            "stage1='packed' scans sign codes; use the 'binary' or 'itq' "
            "prefilter"
        )
        if prefilter in ("itq", "pca"):
            assert projector is not None, (
                f"prefilter='{prefilter}' needs a fitted ops.projection "
                "projector (fit_itq / fit_pca)"
            )
            n_bits = int(np.asarray(projector.components).shape[0])
            self._proj_mean = jnp.asarray(projector.mean, jnp.float32)
            self._proj_comp = jnp.asarray(projector.components, jnp.float32)
            self._proj_explained = float(projector.explained)
        elif prefilter == "int8x8":
            n_bits = dim  # stage-1 codes are full-width int8 rows
        self.prefilter = prefilter
        self.dim = dim
        self.mesh = mesh
        self.axis = axis
        self.ndev = mesh.shape[axis]
        assert capacity % self.ndev == 0, "capacity must divide the mesh axis"
        self.capacity = capacity
        self.shard_rows = capacity // self.ndev
        self.metric = metric
        self.n_bits = n_bits
        self.pool = pool
        self.store_dtype = jnp.dtype(store_dtype)
        self.recall_target = recall_target
        # canonical np.dtype: the class jnp.float32 and np.dtype('float32')
        # hash differently as jit static args (a loaded index would
        # recompile every program a fresh one owns; index/dense.py same fix)
        self.score_dtype = jnp.dtype(score_dtype)
        self.seed = seed
        self.stage1 = stage1
        self.size = 0
        sh = NamedSharding(mesh, P(axis, None))
        sh1 = NamedSharding(mesh, P(axis))
        self._row_sh, self._id_sh = sh, sh1
        # allocated sharded: each card materializes only its own rows
        self._buf = jnp.zeros((capacity, dim), self.store_dtype, device=sh)
        if stage1 == "packed":
            # transposed-packed stage-1 codes, 1 bit/bit PER CHIP
            # (ops.hamming.pack_bits_t_np layout per block within each
            # shard; BinaryIndex mode='packed' conventions)
            from sessionsimilaritysearch.ops.hamming import TBLOCK

            self.block_rows = TBLOCK
            self.bits_pad = -(-n_bits // 128) * 128
            assert self.shard_rows % self.block_rows == 0, (
                f"stage1='packed' needs whole {self.block_rows}-slot pack "
                f"blocks per shard; got shard_rows={self.shard_rows} "
                f"(capacity {capacity} over {self.ndev} shards)"
            )
            self._codes = jnp.zeros((capacity // 32, self.bits_pad),
                                    jnp.int32, device=sh)
        else:
            code_dtype = jnp.int8 if prefilter == "int8x8" else jnp.bfloat16
            self._codes = jnp.full(
                (capacity, n_bits),
                0 if prefilter in ("int8x8", "pca") else -1,
                code_dtype, device=sh,
            )
        self._scales = (
            jnp.zeros((capacity,), jnp.float32, device=sh1)
            if prefilter == "int8x8" else None
        )
        self._ids = jnp.full((capacity,), -1, jnp.int32, device=sh1)
        # removal bookkeeping (ShardedDenseIndex conventions): per-shard
        # fills diverge after remove_ids; global ids are stable and never
        # reused; the host mirror locates ids without pulling device state
        self._fill = np.zeros(self.ndev, np.int64)
        self._next_id = 0
        self._host_ids = np.full((self.ndev, self.shard_rows), -1, np.int64)
        self._write_fn = self._make_write_fn()
        self._move_fn = None  # built on first remove_ids

    def _make_write_fn(self):
        from jax.sharding import PartitionSpec as P

        axis = self.axis
        with_scales = self.prefilter == "int8x8"
        packed = self.stage1 == "packed"
        block_rows = getattr(self, "block_rows", 0)

        def write(buf, codes, ids, rows, row_codes, row_ids, start, *sc):
            s = start[0]
            if packed:
                # transposed-packed scatter-OR (BinaryIndex.add math):
                # target bits are zero by the zeroed-freed-range invariant
                from sessionsimilaritysearch.ops.hamming import (
                    t_slot_coords,
                )

                per = row_codes.shape[0]
                slots = s + jnp.arange(per, dtype=jnp.int32)
                p, j = t_slot_coords(slots, block_rows)
                bits01 = (row_codes > 0).astype(jnp.int32)
                new_codes = codes.at[p].add(bits01 << j[:, None])
            else:
                new_codes = jax.lax.dynamic_update_slice(
                    codes, row_codes, (s, 0)
                )
            out = (
                jax.lax.dynamic_update_slice(buf, rows, (s, 0)),
                new_codes,
                jax.lax.dynamic_update_slice(ids, row_ids, (s,)),
            )
            if with_scales:
                scales, row_scales = sc
                out += (
                    jax.lax.dynamic_update_slice(scales, row_scales, (s,)),
                )
            return out

        extra = (P(axis), P(axis)) if with_scales else ()
        return jax.jit(
            jax.shard_map(
                write,
                mesh=self.mesh,
                in_specs=(P(axis, None), P(axis, None), P(axis),
                          P(axis, None), P(axis, None), P(axis), P(axis),
                          *extra),
                out_specs=(P(axis, None), P(axis, None), P(axis))
                + ((P(axis),) if with_scales else ()),
            ),
            donate_argnums=(0, 1, 2) + ((7,) if with_scales else ()),
        )

    @property
    def ntotal(self) -> int:
        return self.size

    def _codes_of(self, emb: jnp.ndarray):
        """Stage-1 representation of [m, d] rows: (codes, scales-or-None)."""
        if self.prefilter == "itq":
            return _centered_signs(emb, self._proj_mean, self._proj_comp), None
        if self.prefilter == "binary":
            return _simhash_signs(emb, self.n_bits, self.seed), None
        if self.prefilter == "int8x8":
            return _quantize_rows_int8(emb.astype(jnp.float32))
        y = jnp.dot(
            emb.astype(jnp.float32) - self._proj_mean, self._proj_comp.T,
            preferred_element_type=jnp.float32,
        )
        return topk_ops.l2_normalize(y, eps=1e-24).astype(jnp.bfloat16), None

    def add(self, emb) -> None:
        """Append [m, d]; m must divide the mesh axis (pad on the host if
        needed). Rows keep global insertion-order ids."""
        emb = jnp.asarray(emb, jnp.float32)
        m = emb.shape[0]
        assert m % self.ndev == 0, (
            f"insert batch {m} not divisible by {self.ndev} shards"
        )
        per = m // self.ndev
        if int(self._fill.max()) + per > self.shard_rows:
            raise ValueError("sharded two-stage index full")
        if self.metric == "cos":
            emb = topk_ops.l2_normalize(emb)
        codes, scales = self._codes_of(emb)
        if self.stage1 == "packed" and self.bits_pad != self.n_bits:
            codes = jnp.pad(
                codes, ((0, 0), (0, self.bits_pad - self.n_bits))
            )
        ids = jnp.arange(self._next_id, self._next_id + m, dtype=jnp.int32)
        start = jax.device_put(
            jnp.asarray(self._fill, jnp.int32), self._id_sh
        )
        args = [
            self._buf, self._codes, self._ids,
            jax.device_put(emb.astype(self.store_dtype), self._row_sh),
            jax.device_put(codes, self._row_sh),
            jax.device_put(ids, self._id_sh),
            start,
        ]
        if self.prefilter == "int8x8":
            args.insert(7, self._scales)
            args.append(jax.device_put(scales, self._id_sh))
            self._buf, self._codes, self._ids, self._scales = (
                self._write_fn(*args)
            )
        else:
            self._buf, self._codes, self._ids = self._write_fn(*args)
        for s in range(self.ndev):
            f = int(self._fill[s])
            self._host_ids[s, f : f + per] = np.arange(
                self._next_id + s * per, self._next_id + (s + 1) * per
            )
        self._next_id += m
        self._fill += per
        self.size += m

    def _make_move_fn(self):
        from jax.sharding import PartitionSpec as P

        axis = self.axis
        with_scales = self.prefilter == "int8x8"
        packed = self.stage1 == "packed"
        block_rows = getattr(self, "block_rows", 0)
        last = self.shard_rows - 1

        def move(buf, codes, ids, src, dst, *extra):
            it = iter(extra)
            out_buf = buf.at[dst].set(buf[src])
            out_ids = ids.at[dst].set(ids[src])
            if packed:
                # transposed-layout bit moves + freed-range zeroing per
                # shard (index.binary._t_move_bits math). Identity pad
                # moves are (last, last) by plan_sharded_removal's
                # convention; a real move can never have dst == last.
                from sessionsimilaritysearch.ops.hamming import (
                    t_slot_coords,
                )

                nf, of = next(it), next(it)  # [1] per-shard fills
                one = jnp.int32(1)
                s_rows = block_rows // 32
                p_s, j_s = t_slot_coords(src, block_rows)
                p_d, j_d = t_slot_coords(dst, block_rows)
                real = ~((src == last) & (dst == last))
                bits = (codes[p_s] >> j_s[:, None]) & one
                clear_dst = jnp.zeros(
                    (codes.shape[0], 1), jnp.int32
                ).at[p_d].add(jnp.where(real, one << j_d, 0)[:, None])
                p_all = jnp.arange(codes.shape[0], dtype=jnp.int32)
                slot0 = (p_all // s_rows) * block_rows + p_all % s_rows
                j_ar = jnp.arange(32, dtype=jnp.int32)
                slots = slot0[:, None] + j_ar[None, :] * s_rows
                freed = (slots >= nf[0]) & (slots < of[0])
                clear_free = jnp.sum(
                    jnp.where(freed, one << j_ar, 0), axis=1,
                    dtype=jnp.int32,
                )[:, None]
                new_codes = codes & ~(clear_dst | clear_free)
                new_codes = new_codes.at[p_d].add(
                    jnp.where(real[:, None], bits << j_d[:, None], 0)
                )
            else:
                new_codes = codes.at[dst].set(codes[src])
            out = (out_buf, new_codes, out_ids)
            if with_scales:
                (scales,) = tuple(it)
                out += (scales.at[dst].set(scales[src]),)
            return out

        specs = (P(axis, None), P(axis, None), P(axis), P(axis), P(axis))
        extra = ()
        if packed:
            extra += (P(axis), P(axis))
        if with_scales:
            extra += (P(axis),)
        return jax.jit(
            jax.shard_map(
                move, mesh=self.mesh, in_specs=specs + extra,
                out_specs=(P(axis, None), P(axis, None), P(axis))
                + ((P(axis),) if with_scales else ()),
            ),
            # packed and scales are mutually exclusive (packed requires
            # the binary/itq prefilter), so scales stay at arg index 5
            donate_argnums=(0, 1, 2, 5) if with_scales else (0, 1, 2),
        )

    def remove_ids(self, gids) -> int:
        """Remove rows by GLOBAL id (stable-id semantics, matching
        ShardedDenseIndex.remove_ids): each owning shard compacts
        swap-with-last across rows, codes, ids, and scales together;
        surviving global ids never change. Returns rows removed."""
        from sessionsimilaritysearch.index.sharded import (
            plan_sharded_removal,
        )

        gids = np.unique(np.asarray(gids, np.int64).reshape(-1))
        if gids.size == 0:
            return 0
        src, dst, new_fills = plan_sharded_removal(
            self._host_ids, self._fill, gids
        )
        if self._move_fn is None:
            self._move_fn = self._make_move_fn()
        args = [
            self._buf, self._codes, self._ids,
            jax.device_put(jnp.asarray(src.reshape(-1)), self._id_sh),
            jax.device_put(jnp.asarray(dst.reshape(-1)), self._id_sh),
        ]
        if self.stage1 == "packed":
            args.append(jax.device_put(
                jnp.asarray(new_fills, jnp.int32), self._id_sh
            ))
            args.append(jax.device_put(
                jnp.asarray(self._fill, jnp.int32), self._id_sh
            ))
        if self.prefilter == "int8x8":
            self._buf, self._codes, self._ids, self._scales = (
                self._move_fn(*args, self._scales)
            )
        else:
            self._buf, self._codes, self._ids = self._move_fn(*args)
        for s in range(self.ndev):
            self._host_ids[s, dst[s]] = self._host_ids[s, src[s]]
            self._host_ids[s, new_fills[s] :] = -1
        removed = self.size - int(new_fills.sum())
        self._fill = new_fills
        self.size = int(new_fills.sum())
        return removed

    def reconstruct_batch(self, gids) -> np.ndarray:
        """Return stage-2 (full-dim) stored rows by GLOBAL id: [m, d]
        float32 in the order given (stable-id semantics — a gid stays
        reconstructable until removed; absent gids raise KeyError)."""
        from sessionsimilaritysearch.index.sharded import (
            global_id_positions,
        )

        gids = np.asarray(gids, np.int64).reshape(-1)
        pos = global_id_positions(self._host_ids, self._fill, gids)
        rows = jnp.take(self._buf, jnp.asarray(pos), axis=0)
        return np.asarray(rows.astype(jnp.float32))

    def reconstruct(self, gid: int) -> np.ndarray:
        """Single-row form: [d] float32 for one global id."""
        return self.reconstruct_batch([int(gid)])[0]

    def search(
        self, queries, k: int, pool: Optional[int] = None, row_mask=None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Global exact-over-pool top-k: (D [q,k] descending, I [q,k]
        global ids); missing slots are (-inf, -1).

        ``row_mask``: optional bool array keyed by GLOBAL id (length >=
        the highest id ever issued) — filtered search; rows whose gid
        maps to False never enter a shard's stage-1 pool. Ids are stable
        under removal, so gid-keyed masks stay valid across maintenance
        (ShardedDenseIndex semantics)."""
        from sessionsimilaritysearch.parallel.collectives import (
            sharded_twostage_topk,
        )

        pool = pool or self.pool
        pool = min(max(pool, k), self.shard_rows)
        queries = jnp.asarray(queries, jnp.float32)
        nq = queries.shape[0]
        q_pad = max(8, 1 << (max(nq - 1, 1)).bit_length())
        if q_pad != nq:
            queries = jnp.pad(queries, ((0, q_pad - nq), (0, 0)))
        qn = (
            topk_ops.l2_normalize(queries)
            if self.metric == "cos" else queries
        )
        q_codes, q_scales = self._codes_of(qn)
        valid = jax.device_put(
            jnp.asarray(self._fill, jnp.int32), self._id_sh
        )
        slot_mask = None
        if row_mask is not None:
            gmask = np.asarray(row_mask, bool)
            assert gmask.shape[0] >= self._next_id, (
                f"row_mask length {gmask.shape[0]} < highest issued id "
                f"{self._next_id} (masks are keyed by GLOBAL id)"
            )
            slots = np.zeros((self.ndev, self.shard_rows), bool)
            for s in range(self.ndev):
                f = int(self._fill[s])
                slots[s, :f] = gmask[self._host_ids[s, :f]]
            slot_mask = jax.device_put(
                jnp.asarray(slots.reshape(-1)), self._id_sh
            )
        packed_kw = {}
        if self.stage1 == "packed":
            if self.bits_pad != self.n_bits:
                q_codes = jnp.pad(
                    q_codes, ((0, 0), (0, self.bits_pad - self.n_bits))
                )
            packed_kw = dict(
                packed_bits=self.n_bits,
                packed_block_rows=self.block_rows,
            )
        vals, ids = sharded_twostage_topk(
            qn.astype(self.store_dtype), q_codes,
            self._buf, self._codes,
            k, self.mesh, axis=self.axis, shard_ids=self._ids,
            valid_per_shard=valid, pool=pool,
            recall_target=self.recall_target,
            score_dtype=self.score_dtype,
            code_scales=self._scales, q_code_scales=q_scales,
            row_mask=slot_mask,
            **packed_kw,
        )
        return np.asarray(vals)[:nq], np.asarray(ids)[:nq]

    # --- persistence (serving config travels with the data)
    def save(self, path: str) -> None:
        extra = {}
        if self.prefilter in ("itq", "pca"):
            extra["proj_mean"] = np.asarray(self._proj_mean)
            extra["proj_comp"] = np.asarray(self._proj_comp)
            extra["proj_explained"] = self._proj_explained
        if self.stage1 == "packed":
            # transposed-packed int32 words, npz-native; 1 bit/bit on
            # disk too. Re-striping on load unpacks per saved shard.
            extra["codes_packed_t"] = np.asarray(self._codes)
            extra["block_rows"] = self.block_rows
        elif self.prefilter == "int8x8":
            extra["codes"] = np.asarray(self._codes)  # int8, native npz
            extra["scales"] = np.asarray(self._scales)
        else:
            # +-1 sign codes / unit-norm projections round-trip exactly
            # via f16 (bf16 isn't a native npz dtype); persisted rather
            # than re-derived so a restore is bit-identical even though
            # rows are stored bf16
            extra["codes_f16"] = np.asarray(self._codes.astype(jnp.float16))
        np.savez(
            path,
            buf=np.asarray(self._buf.astype(jnp.float32)),
            ids=np.asarray(self._ids),
            size=self.size,
            fills=self._fill,
            next_id=self._next_id,
            dim=self.dim,
            capacity=self.capacity,
            ndev=self.ndev,
            metric=self.metric,
            prefilter=self.prefilter,
            n_bits=self.n_bits,
            pool=self.pool,
            store_dtype=self.store_dtype.name,
            recall_target=self.recall_target,
            score_dtype=jnp.dtype(self.score_dtype).name,
            seed=self.seed,
            stage1=self.stage1,
            **extra,
        )

    @classmethod
    def load(cls, path: str, mesh, **kw) -> "ShardedTwoStageIndex":
        """Restore on ``mesh`` (re-striping if the shard count changed)."""
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        prefilter = str(z["prefilter"]) if "prefilter" in z else "binary"
        projector = None
        if prefilter in ("itq", "pca"):
            from sessionsimilaritysearch.ops.projection import (
                PCAProjector,
            )

            projector = PCAProjector(
                z["proj_mean"], z["proj_comp"], float(z["proj_explained"])
            )
        idx = cls(
            dim=int(z["dim"]),
            capacity=int(kw.pop("capacity", int(z["capacity"]))),
            mesh=mesh,
            metric=str(z["metric"]),
            prefilter=prefilter,
            n_bits=int(z["n_bits"]),
            pool=int(kw.pop("pool", int(z["pool"]))),
            store_dtype=jnp.dtype(str(z["store_dtype"])),
            recall_target=float(z["recall_target"]),
            score_dtype=jnp.dtype(str(z["score_dtype"])),
            projector=projector,
            seed=int(z["seed"]),
            stage1=str(z["stage1"]) if "stage1" in z.files else "matmul",
            **kw,
        )
        size = int(z["size"])
        if size:
            if size % idx.ndev != 0:
                raise ValueError(
                    f"snapshot holds {size} rows, not divisible across "
                    f"{idx.ndev} shards"
                )
            saved_ndev = int(z["ndev"])
            old_rows = int(z["capacity"]) // saved_ndev
            fills = (
                np.asarray(z["fills"], np.int64) if "fills" in z
                else np.full(saved_ndev, size // saved_ndev, np.int64)
            )
            if "codes_packed_t" in z.files:
                # unpack the saved packed words back to sign codes so the
                # normal write path re-packs per the NEW striping —
                # per saved shard, trimmed to the used pack blocks, so
                # host memory scales with SIZE, not saved capacity
                from sessionsimilaritysearch.ops.hamming import (
                    unpack_bits_t_np,
                )

                br = int(z["block_rows"])
                s_rows = br // 32
                pw = np.asarray(z["codes_packed_t"]).reshape(
                    saved_ndev, old_rows // 32, -1
                )
                flat_cod = np.concatenate([
                    unpack_bits_t_np(
                        pw[s, : (-(-int(fills[s]) // br)) * s_rows], br
                    )[: fills[s]]
                    for s in range(saved_ndev)
                ])
            else:
                raw_cod = (
                    np.asarray(z["codes"]) if "codes" in z.files
                    else np.asarray(z["codes_f16"])
                )
                cod = raw_cod.reshape(saved_ndev, old_rows, idx.n_bits)
                flat_cod = np.concatenate(
                    [cod[s, : fills[s]] for s in range(saved_ndev)]
                )
            buf = np.asarray(z["buf"]).reshape(saved_ndev, old_rows, idx.dim)
            ids = np.asarray(z["ids"]).reshape(saved_ndev, old_rows)
            flat_buf = np.concatenate(
                [buf[s, : fills[s]] for s in range(saved_ndev)]
            )
            flat_ids = np.concatenate(
                [ids[s, : fills[s]] for s in range(saved_ndev)]
            )
            order = np.argsort(flat_ids)  # restore insertion order
            rows = jnp.asarray(flat_buf[order], jnp.float32)
            codes = (
                jnp.asarray(flat_cod[order])
                if prefilter == "int8x8"
                else jnp.asarray(flat_cod[order]).astype(jnp.bfloat16)
            )
            start = jax.device_put(
                jnp.zeros((idx.ndev,), jnp.int32), idx._id_sh
            )
            args = [
                idx._buf, idx._codes, idx._ids,
                jax.device_put(rows.astype(idx.store_dtype), idx._row_sh),
                jax.device_put(codes, idx._row_sh),
                jax.device_put(jnp.asarray(flat_ids[order]), idx._id_sh),
                start,
            ]
            if prefilter == "int8x8":
                sca = np.asarray(z["scales"]).reshape(saved_ndev, old_rows)
                flat_sca = np.concatenate(
                    [sca[s, : fills[s]] for s in range(saved_ndev)]
                )[order]
                args.insert(7, idx._scales)
                args.append(jax.device_put(
                    jnp.asarray(flat_sca, jnp.float32), idx._id_sh
                ))
                idx._buf, idx._codes, idx._ids, idx._scales = (
                    idx._write_fn(*args)
                )
            else:
                idx._buf, idx._codes, idx._ids = idx._write_fn(*args)
            idx.size = size
            per_new = size // idx.ndev
            idx._fill = np.full(idx.ndev, per_new, np.int64)
            idx._host_ids[:, :per_new] = (
                np.asarray(flat_ids[order], np.int64)
                .reshape(idx.ndev, per_new)
            )
            idx._next_id = (
                int(z["next_id"]) if "next_id" in z else size
            )
        return idx


def build_twostage_index(
    emb,
    prefilter: str = "binary",
    pca_dim: int = 64,
    metric: str = "cos",
    **kw,
) -> TwoStageIndex:
    """One-shot construction from a full corpus (the two-stage counterpart
    of ``index.dense.build_index``). For ``prefilter='pca'``/``'itq'`` the
    projector is fitted from the corpus itself (cos-normalized rows when
    ``metric='cos'``, matching what gets indexed); 'itq' fits ``n_bits``
    learned code directions (kw ``n_bits``, default 256)."""
    emb = np.asarray(emb, np.float32)
    projector = None
    if prefilter in ("pca", "itq"):
        from sessionsimilaritysearch.ops.projection import (
            fit_itq,
            fit_pca,
        )

        rows = (
            np.asarray(topk_ops.l2_normalize(jnp.asarray(emb)))
            if metric == "cos" else emb
        )
        if prefilter == "pca":
            projector = fit_pca(rows, min(pca_dim, emb.shape[1]))
        else:
            projector = fit_itq(
                rows, min(int(kw.get("n_bits", 256)), emb.shape[1])
            )
    idx = TwoStageIndex(
        dim=emb.shape[1], capacity=emb.shape[0], metric=metric,
        prefilter=prefilter, projector=projector, **kw,
    )
    idx.add(emb)
    return idx
