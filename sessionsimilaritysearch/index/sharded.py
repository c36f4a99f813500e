"""Multi-chip sharded dense index.

The scale-out form of ``DenseIndex`` (SURVEY.md §7 M5: a 10M-session
corpus over several devices): corpus rows stripe round-robin-by-batch across the
mesh's ``data`` axis, each chip keeps a ring buffer plus the global ids of
its rows, searches run per-shard and merge by all-gather
(parallel/collectives.py). Streaming inserts append to every shard in
parallel, so capacity and insert bandwidth both scale linearly with chips.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sessionsimilaritysearch.index.dense import (
    _quantize_rows_int8,
    _range_from_search,
    compaction_plan,
)
from sessionsimilaritysearch.ops import topk as topk_ops
from sessionsimilaritysearch.parallel.collectives import sharded_topk


def plan_sharded_removal(host_ids, fills, gids):
    """Per-shard swap-with-last plans for removing global ids from a
    striped corpus. ``host_ids``: [ndev, shard_rows] host mirror of each
    slot's global id (-1 = empty); ``fills``: [ndev] per-shard fill.

    Returns (src [ndev, P], dst [ndev, P], new_fills [ndev]) with every
    shard's move list padded to a common power-of-two length P (min 8)
    using identity moves of the shard's LAST slot (never a real
    destination), so removals compile O(log shard_rows) scatter programs.
    Unlike the single-chip compaction, global ids move WITH their rows —
    surviving ids never change. Raises if any gid is absent."""
    ndev, shard_rows = host_ids.shape
    gids = np.unique(np.asarray(gids, np.int64).reshape(-1))
    plans = []
    found = 0
    for s in range(ndev):
        valid = host_ids[s, : fills[s]]
        local = np.flatnonzero(np.isin(valid, gids))
        found += local.size
        plans.append(compaction_plan(int(fills[s]), local))
    if found != gids.size:
        present = np.isin(gids, host_ids[host_ids >= 0])
        missing = gids[~present]
        raise ValueError(
            f"{missing.size} ids not present (already removed or never "
            f"inserted), e.g. {missing[:5].tolist()}"
        )
    width = max(max((p[0].size for p in plans), default=0), 1)
    P = max(8, 1 << (width - 1).bit_length())
    src = np.full((ndev, P), shard_rows - 1, np.int32)
    dst = np.full((ndev, P), shard_rows - 1, np.int32)
    new_fills = np.empty(ndev, np.int64)
    for s, (ps, pd, nf) in enumerate(plans):
        src[s, : ps.size], dst[s, : pd.size] = ps, pd
        new_fills[s] = nf
    return src, dst, new_fills


def global_id_positions(host_ids, fills, gids) -> np.ndarray:
    """Locate global ids in a striped corpus: [m] global row positions
    (shard-major: shard * shard_rows + slot, the row order of the
    row-sharded device buffer) for ``gids``, in the order given.
    ``host_ids``/``fills`` as in :func:`plan_sharded_removal`. Raises
    KeyError for ids that are absent (never inserted, or removed)."""
    gids = np.asarray(gids, np.int64).reshape(-1)
    ndev, shard_rows = host_ids.shape
    valid = np.arange(shard_rows)[None, :] < np.asarray(fills)[:, None]
    flat_ids = np.where(valid, host_ids, -1).reshape(-1)
    order = np.argsort(flat_ids, kind="stable")
    pos_in_sorted = np.searchsorted(flat_ids, gids, sorter=order)
    if gids.size:
        bad = (pos_in_sorted >= flat_ids.size) | (
            flat_ids[order[np.minimum(pos_in_sorted, flat_ids.size - 1)]]
            != gids
        )
        if bad.any():
            raise KeyError(f"ids not present: {gids[bad][:8].tolist()}")
    return order[pos_in_sorted]


class ShardedDenseIndex:
    """Flat exact index over a corpus sharded across a mesh axis.

    Semantics match ``DenseIndex`` ('cos'/'ip' metrics, FAISS-style (D, I)
    results with GLOBAL insertion-order ids); rows live sharded and never
    leave their chip.
    """

    def __init__(
        self,
        dim: int,
        capacity: int,
        mesh: Mesh,
        axis: str = "data",
        metric: str = "cos",
        dtype=jnp.float32,
        chunk_size: int = 262144,
        mode: str = "exact",
        quantize: Optional[str] = None,
        score_dtype=jnp.float32,
    ):
        assert metric in ("cos", "ip")
        # same modes as DenseIndex: 'int8' stores int8 codes + per-row
        # scales on each shard (half/quarter the memory -> 2-4x rows per
        # device); 'int8x8' additionally quantizes queries at search time
        # so every shard's scan runs int8 x int8 -> int32.
        assert quantize in (None, "int8", "int8x8")
        self.dim = dim
        self.mesh = mesh
        self.axis = axis
        self.ndev = mesh.shape[axis]
        assert capacity % self.ndev == 0, "capacity must divide evenly"
        self.capacity = capacity
        self.shard_rows = capacity // self.ndev
        self.metric = metric
        self.quantize = quantize
        self.dtype = jnp.dtype(jnp.int8 if quantize else dtype)
        # canonical np.dtype: the class jnp.float32 and np.dtype('float32')
        # hash differently as jit static args (a loaded index would
        # recompile every program a fresh one owns; index/dense.py same fix)
        self.score_dtype = jnp.dtype(score_dtype)
        self.chunk_size = chunk_size
        self.mode = mode
        sh = NamedSharding(mesh, P(axis, None))
        sh1 = NamedSharding(mesh, P(axis))
        # allocated sharded: each card materializes only its own rows
        self._buf = jnp.zeros((capacity, dim), self.dtype, device=sh)
        self._ids = jnp.full((capacity,), -1, jnp.int32, device=sh1)
        self._scales = (
            jnp.zeros((capacity,), jnp.float32, device=sh1)
            if quantize else None
        )
        self.size = 0  # total valid rows (sum of per-shard fills)
        # per-shard fill counts: equal while the index is append-only,
        # divergent after remove_ids (searches mask per shard)
        self._fill = np.zeros(self.ndev, np.int64)
        # global ids are STABLE under removal (they move with their rows),
        # so this counter never reuses an id
        self._next_id = 0
        # host mirror of each slot's global id, for locating removals
        # without pulling the device ids
        self._host_ids = np.full((self.ndev, self.shard_rows), -1, np.int64)
        self._write_fn = self._make_write_fn()
        self._move_fn = None  # built on first remove_ids

    def _make_write_fn(self):
        axis = self.axis
        quantized = self.quantize is not None

        def write(buf, ids, rows, row_ids, start, *scale_args):
            new_buf = jax.lax.dynamic_update_slice(buf, rows, (start[0], 0))
            new_ids = jax.lax.dynamic_update_slice(ids, row_ids, (start[0],))
            if quantized:
                scales_buf, scales = scale_args
                new_scales = jax.lax.dynamic_update_slice(
                    scales_buf, scales, (start[0],)
                )
                return new_buf, new_ids, new_scales
            return new_buf, new_ids

        base = (P(axis, None), P(axis), P(axis, None), P(axis), P(axis))
        extra = (P(axis), P(axis)) if quantized else ()
        return jax.jit(
            jax.shard_map(
                write,
                mesh=self.mesh,
                in_specs=base + extra,
                out_specs=(P(axis, None), P(axis)) + ((P(axis),) if quantized else ()),
            ),
            donate_argnums=(0, 1, 5) if quantized else (0, 1),
        )

    @property
    def ntotal(self) -> int:
        return self.size

    def add(self, emb) -> None:
        """Append [m, d]; m must be divisible by the mesh axis size (pad on
        the host if needed). Rows keep global insertion-order ids."""
        emb = jnp.asarray(emb, jnp.float32 if self.quantize else self.dtype)
        m = emb.shape[0]
        assert m % self.ndev == 0, (
            f"insert batch {m} not divisible by {self.ndev} shards"
        )
        per = m // self.ndev
        if int(self._fill.max()) + per > self.shard_rows:
            raise ValueError("sharded index full")
        if self.metric == "cos":
            emb = topk_ops.l2_normalize(emb)
        scales = None
        if self.quantize:
            emb, scales = _quantize_rows_int8(emb)
        else:
            emb = emb.astype(self.dtype)
        # row i of the batch -> shard i // per, preserving global id order
        ids = jnp.arange(self._next_id, self._next_id + m, dtype=jnp.int32)
        sh = NamedSharding(self.mesh, P(self.axis, None))
        sh1 = NamedSharding(self.mesh, P(self.axis))
        rows = jax.device_put(emb, sh)
        row_ids = jax.device_put(ids, sh1)
        start = jax.device_put(
            jnp.asarray(self._fill, dtype=jnp.int32), sh1
        )
        if self.quantize:
            self._buf, self._ids, self._scales = self._write_fn(
                self._buf, self._ids, rows, row_ids, start,
                self._scales, jax.device_put(scales, sh1),
            )
        else:
            self._buf, self._ids = self._write_fn(
                self._buf, self._ids, rows, row_ids, start
            )
        for s in range(self.ndev):
            f = int(self._fill[s])
            self._host_ids[s, f : f + per] = np.arange(
                self._next_id + s * per, self._next_id + (s + 1) * per
            )
        self._next_id += m
        self._fill += per
        self.size += m

    def _make_move_fn(self):
        axis = self.axis
        quantized = self.quantize is not None

        def move(buf, ids, src, dst, *sc):
            out = (buf.at[dst].set(buf[src]), ids.at[dst].set(ids[src]))
            if quantized:
                (scales,) = sc
                out += (scales.at[dst].set(scales[src]),)
            return out

        specs = (P(axis, None), P(axis), P(axis), P(axis))
        extra = (P(axis),) if quantized else ()
        return jax.jit(
            jax.shard_map(
                move, mesh=self.mesh, in_specs=specs + extra,
                out_specs=(P(axis, None), P(axis)) + extra,
            ),
            donate_argnums=(0, 1, 4) if quantized else (0, 1),
        )

    def remove_ids(self, gids) -> int:
        """Remove rows by GLOBAL id (``faiss.Index.remove_ids``
        counterpart, maintenance op for expiry/erasure). Each owning shard
        compacts swap-with-last locally — global ids move WITH their rows,
        so surviving ids are STABLE (unlike the single-chip DenseIndex,
        whose results are positional); callers' id-keyed metadata needs no
        renumbering. Freed capacity is reusable per shard; searches never
        retrace (fixed buffers + per-shard valid counts). Returns the
        number of rows removed; raises if any id is absent."""
        gids = np.unique(np.asarray(gids, np.int64).reshape(-1))
        if gids.size == 0:
            return 0
        src, dst, new_fills = plan_sharded_removal(
            self._host_ids, self._fill, gids
        )
        if self._move_fn is None:
            self._move_fn = self._make_move_fn()
        sh1 = NamedSharding(self.mesh, P(self.axis))
        args = [
            self._buf, self._ids,
            jax.device_put(jnp.asarray(src.reshape(-1)), sh1),
            jax.device_put(jnp.asarray(dst.reshape(-1)), sh1),
        ]
        if self.quantize:
            out = self._move_fn(*args, self._scales)
            self._buf, self._ids, self._scales = out
        else:
            self._buf, self._ids = self._move_fn(*args)
        # mirror the moves on the host id map, then truncate each shard
        for s in range(self.ndev):
            self._host_ids[s, dst[s]] = self._host_ids[s, src[s]]
            self._host_ids[s, new_fills[s] :] = -1
        removed = self.size - int(new_fills.sum())
        self._fill = new_fills
        self.size = int(new_fills.sum())
        return removed

    def reconstruct_batch(self, gids) -> np.ndarray:
        """Return stored rows by GLOBAL id (``faiss.Index.reconstruct_batch``
        counterpart): [m, d] float32 in the order given, unit-normalized
        under 'cos' and dequantized (code × scale) under int8 modes. Ids
        here are STABLE (this index's :meth:`remove_ids` never renumbers),
        so a gid remains reconstructable until removed; absent gids raise.
        Host lookup via the id mirror, one device gather for the rows."""
        gids = np.asarray(gids, np.int64).reshape(-1)
        pos = global_id_positions(self._host_ids, self._fill, gids)
        rows = jnp.take(self._buf, jnp.asarray(pos), axis=0)
        rows = rows.astype(jnp.float32)
        if self.quantize:
            rows = rows * jnp.take(self._scales, jnp.asarray(pos))[:, None]
        return np.asarray(rows)

    def reconstruct(self, gid: int) -> np.ndarray:
        """Single-row form: [d] float32 for one global id."""
        return self.reconstruct_batch([int(gid)])[0]

    # --- live-state round-trip (the checkpoint-utils form of persistence:
    #     save/load below serialize to npz; these expose the FULL serving
    #     state as a pytree for utils.checkpoint.save_sharded /
    #     restore_sharded, which write each device shard without a host
    #     gather). ``size`` alone does NOT determine row validity — per-
    #     shard fills diverge after remove_ids — so raw _buf/_ids pokes
    #     are not a valid restore; round-trip through these.
    def state_dict(self) -> dict:
        """Complete serving state: sharded device arrays (buf, ids,
        scales) plus the host-side bookkeeping (fills, host id mirror,
        next id). Usable directly as a save_sharded tree and as the
        restore_sharded template."""
        state = {
            "buf": self._buf,
            "ids": self._ids,
            "size": np.asarray(self.size),
            "fills": np.asarray(self._fill),
            "next_id": np.asarray(self._next_id),
            "host_ids": np.asarray(self._host_ids),
        }
        if self.quantize:
            state["scales"] = self._scales
        return state

    def load_state(self, state: dict) -> None:
        """Adopt a :meth:`state_dict`-shaped tree (e.g. from
        restore_sharded): the inverse of :meth:`state_dict`."""
        self._buf = state["buf"]
        self._ids = state["ids"]
        self.size = int(state["size"])
        self._fill = np.asarray(state["fills"], np.int64).copy()
        self._next_id = int(state["next_id"])
        self._host_ids = np.asarray(state["host_ids"], np.int64).copy()
        if self.quantize:
            self._scales = state["scales"]

    def search(self, queries, k: int,
               row_mask=None, out: str = "np",
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Global exact top-k. ``row_mask``: optional bool array keyed by
        GLOBAL id (length >= the highest id ever issued) — filtered
        search; rows whose gid maps to False never rank. Ids are stable
        under removal, so gid-keyed masks stay valid across maintenance.
        ``out='device'`` skips the host materialization (DenseIndex.search
        semantics)."""
        qdtype = jnp.bfloat16 if self.quantize else self.dtype
        queries = jnp.asarray(queries, qdtype)
        nq = queries.shape[0]
        # bucket query batches to powers of two (bounded retraces for
        # variable-batch serving; same policy as DenseIndex.search)
        q_pad = max(8, 1 << (max(nq - 1, 1)).bit_length())
        if q_pad != nq:
            queries = jnp.pad(queries, ((0, q_pad - nq), (0, 0)))
        if self.metric == "cos":
            queries = topk_ops.l2_normalize(queries).astype(qdtype)
        query_scales = None
        if self.quantize == "int8x8":
            queries, query_scales = _quantize_rows_int8(
                queries.astype(jnp.float32)
            )
        valid = jax.device_put(
            jnp.asarray(self._fill, dtype=jnp.int32),
            NamedSharding(self.mesh, P(self.axis)),
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
                jnp.asarray(slots.reshape(-1)),
                NamedSharding(self.mesh, P(self.axis)),
            )
        vals, ids = sharded_topk(
            queries,
            self._buf,
            k,
            self.mesh,
            axis=self.axis,
            shard_ids=self._ids,
            valid_per_shard=valid,
            chunk_size=self.chunk_size,
            mode=self.mode,
            corpus_scales=self._scales,
            query_scales=query_scales,
            score_dtype=self.score_dtype,
            row_mask=slot_mask,
        )
        if out == "np":
            return np.asarray(vals)[:nq], np.asarray(ids)[:nq]
        assert out == "device", f"out must be 'np'|'device', got {out!r}"
        return vals[:nq], ids[:nq]

    def range_search(
        self, queries, radius: float, k0: int = 128, row_mask=None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All rows within ``radius`` across every shard
        (``faiss.Index.range_search`` counterpart at scale-out). Returns
        the FAISS CSR triple ``(lims [q+1] int64, D, I)``; ``I`` carries
        this index's STABLE global ids, slices sorted best-first. Exact
        via adaptive-depth top-k over the sharded scan (per-shard
        candidates clamp to the shard's rows, so the cross-shard merge stays
        exact at any depth); compiles O(log size) programs. ``row_mask``
        is gid-keyed as in :meth:`search`."""
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
            descending=True, total=self.size, k0=k0,
        )

    # --- persistence: the sharded corpus IS the index (SURVEY.md §5 plan)
    def save(self, path: str) -> None:
        extra = {}
        if self.quantize:
            extra["scales"] = np.asarray(self._scales)
            extra["quantize"] = self.quantize
        buf = self._buf
        np.savez(
            path,
            buf=np.asarray(
                buf.astype(jnp.float32)
                if buf.dtype == jnp.bfloat16 else buf
            ),
            dtype=jnp.dtype(self.dtype).name,
            ids=np.asarray(self._ids),
            size=self.size,
            fills=self._fill,
            next_id=self._next_id,
            dim=self.dim,
            capacity=self.capacity,
            metric=self.metric,
            ndev=self.ndev,
            # serving configuration
            mode=self.mode,
            score_dtype=jnp.dtype(self.score_dtype).name,
            chunk_size=self.chunk_size,
            **extra,
        )

    @classmethod
    def load(cls, path: str, mesh: Mesh, **kw) -> "ShardedDenseIndex":
        """Restore a snapshot on ``mesh`` (re-striping rows if the shard
        count changed), including its serving configuration. Keyword
        overrides win; ``quantize`` must match the snapshot's."""
        z = np.load(path if path.endswith(".npz") else path + ".npz")
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
            "chunk_size",
            int(z["chunk_size"]) if "chunk_size" in z else 262144,
        )
        if "dtype" in z and not quantize:
            kw.setdefault("dtype", jnp.dtype(str(z["dtype"])))
        idx = cls(
            dim=int(z["dim"]), capacity=int(z["capacity"]), mesh=mesh,
            metric=str(z["metric"]), quantize=quantize, **kw,
        )
        saved_ndev = int(z.get("ndev", idx.ndev))
        size = int(z["size"])
        fills = (
            np.asarray(z["fills"], np.int64) if "fills" in z
            else np.full(saved_ndev, size // saved_ndev, np.int64)
        )
        next_id = int(z["next_id"]) if "next_id" in z else size
        if saved_ndev != idx.ndev:
            # each OLD shard's valid rows sit at its head (fills[s] of
            # them — unequal after removals); re-stripe so the per-shard
            # fill mask stays correct on the new mesh
            if size % idx.ndev != 0:
                raise ValueError(
                    f"index saved on {saved_ndev} shards holds {size} rows, "
                    f"not divisible across {idx.ndev} shards"
                )
            old_rows = int(z["capacity"]) // saved_ndev
            buf = np.asarray(z["buf"]).reshape(saved_ndev, old_rows, idx.dim)
            ids = np.asarray(z["ids"]).reshape(saved_ndev, old_rows)
            flat_buf = np.concatenate(
                [buf[s, : fills[s]] for s in range(saved_ndev)]
            )
            flat_ids = np.concatenate(
                [ids[s, : fills[s]] for s in range(saved_ndev)]
            )
            order = np.argsort(flat_ids)  # restore insertion order
            # skip normalization: rows were normalized at original add
            # (and, in int8 mode, quantized -- codes round-trip bit-exactly)
            rows = jax.device_put(
                jnp.asarray(flat_buf[order], idx.dtype),
                NamedSharding(mesh, P(idx.axis, None)),
            )
            row_ids = jax.device_put(
                jnp.asarray(flat_ids[order]),
                NamedSharding(mesh, P(idx.axis)),
            )
            start = jax.device_put(
                jnp.zeros((idx.ndev,), jnp.int32),
                NamedSharding(mesh, P(idx.axis)),
            )
            if quantize:
                sca = np.asarray(z["scales"]).reshape(saved_ndev, old_rows)
                flat_scales = np.concatenate(
                    [sca[s, : fills[s]] for s in range(saved_ndev)]
                )[order]
                scales = jax.device_put(
                    jnp.asarray(flat_scales, jnp.float32),
                    NamedSharding(mesh, P(idx.axis)),
                )
                idx._buf, idx._ids, idx._scales = idx._write_fn(
                    idx._buf, idx._ids, rows, row_ids, start,
                    idx._scales, scales,
                )
            else:
                idx._buf, idx._ids = idx._write_fn(
                    idx._buf, idx._ids, rows, row_ids, start
                )
            idx.size = size
            per_new = size // idx.ndev
            idx._fill = np.full(idx.ndev, per_new, np.int64)
            idx._host_ids[:, :per_new] = (
                flat_ids[order].reshape(idx.ndev, per_new)
            )
            idx._next_id = next_id
            return idx
        sh = NamedSharding(mesh, P(idx.axis, None))
        sh1 = NamedSharding(mesh, P(idx.axis))
        idx._buf = jax.device_put(jnp.asarray(z["buf"], idx.dtype), sh)
        idx._ids = jax.device_put(jnp.asarray(z["ids"]), sh1)
        if quantize:
            idx._scales = jax.device_put(
                jnp.asarray(z["scales"], jnp.float32), sh1
            )
        idx.size = size
        idx._fill = fills.copy()
        idx._next_id = next_id
        all_ids = np.asarray(z["ids"], np.int64).reshape(
            idx.ndev, idx.shard_rows
        )
        for s in range(idx.ndev):
            idx._host_ids[s, : fills[s]] = all_ids[s, : fills[s]]
        return idx
