"""Multi-chip sharded binary (Hamming) index.

The scale-out form of ``BinaryIndex`` — the ``faiss.IndexBinaryFlat``
serve path (reference: fine_tune_ours.py:839-879) when the corpus no
longer fits one device: code rows stripe
round-robin-by-batch across the mesh's ``data`` axis, each chip ranks its
slice by Hamming distance — sign matmul for ``mode='sign'``, the
unpack+matmul scan over transposed-packed words for ``mode='packed'``
(1 bit/bit of device memory per chip) — and the per-shard [q, k]
slivers merge by all-gather on negated integer distances
(``parallel.collectives.sharded_hamming_topk``), so the merge is
tie-class exact and only O(q · k · ndev) ints cross chips.

Semantics follow ``ShardedDenseIndex``, not the single-chip
``BinaryIndex``: results carry STABLE global insertion-order ids
(``remove_ids`` compacts each shard swap-with-last but ids move WITH
their rows and are never reused — gid-keyed metadata and ``row_mask``
arrays stay valid across maintenance), and the full FAISS maintenance
surface (remove_ids / reconstruct / range_search / gid-keyed filtered
search) is supported on both storage modes. The streaming contract is
repo-standard: buffers allocate at ``capacity`` once and every search
scans whole shards under per-shard valid counts, so interleaved
add/search never recompiles.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sessionsimilaritysearch.index.binary import (
    _GROUP,
    _pow2,
    _t_move_bits_core,
)
from sessionsimilaritysearch.index.dense import _range_from_search
from sessionsimilaritysearch.index.sharded import (
    global_id_positions,
    plan_sharded_removal,
)
from sessionsimilaritysearch.ops import hamming
from sessionsimilaritysearch.parallel.collectives import (
    sharded_hamming_topk,
)


class ShardedBinaryIndex:
    """Flat exact Hamming index over codes sharded across a mesh axis.

    ``search`` returns FAISS-style ``(D, I)`` with D = Hamming distances
    ascending (int32; missing slots INT32_MAX) and I = STABLE global
    insertion-order ids (-1 missing).
    """

    def __init__(
        self,
        n_bits: int,
        capacity: int,
        mesh: Mesh,
        axis: str = "data",
        mode: str = "sign",
        selection: str = "exact",
        recall_target: float = 0.95,
    ):
        assert mode in ("sign", "packed")
        assert selection in ("exact", "approx")
        assert selection == "exact" or mode == "sign", (
            "approx selection is wired for the sign-matmul path"
        )
        self.n_bits = n_bits
        self.mesh = mesh
        self.axis = axis
        self.ndev = mesh.shape[axis]
        assert capacity % self.ndev == 0, "capacity must divide evenly"
        self.capacity = capacity
        self.shard_rows = capacity // self.ndev
        self.mode = mode
        self.selection = selection
        self.recall_target = recall_target
        self.size = 0
        self._fill = np.zeros(self.ndev, np.int64)
        self._next_id = 0
        self._host_ids = np.full((self.ndev, self.shard_rows), -1, np.int64)
        sh2 = NamedSharding(mesh, P(axis, None))
        sh1 = NamedSharding(mesh, P(axis))
        if mode == "packed":
            # per-shard transposed-packed storage (BinaryIndex layout per
            # shard): physical slots round up to whole pack blocks, so
            # each shard's buffer is [slots_pad/32, bits_pad] int32
            self.block_rows = hamming.TBLOCK
            self.bits_pad = -(-n_bits // 128) * 128
            self.slots_pad = -(-self.shard_rows // _GROUP) * _GROUP
            self._buf = jnp.zeros(
                (self.ndev * self.slots_pad // 32, self.bits_pad),
                jnp.int32, device=sh2,
            )
        else:
            self.slots_pad = self.shard_rows
            self._buf = jnp.full((capacity, n_bits), -1, jnp.bfloat16,
                                 device=sh2)
        # device ids are indexed by PHYSICAL slot (padded slots stay -1 and
        # are masked by the per-shard valid counts)
        self._ids = jnp.full((self.ndev * self.slots_pad,), -1, jnp.int32,
                             device=sh1)
        self._write_fn = None
        self._move_fn = None

    @property
    def ntotal(self) -> int:
        return self.size

    # ------------------------------------------------------------------
    def _make_write_fn(self):
        axis = self.axis
        packed = self.mode == "packed"

        if packed:
            def write(buf, ids, p_pad, vals, row_ids, start):
                # scatter-OR freshly packed bits into this shard's words
                # (targets are zero by the zeroed-freed-range invariant;
                # padded entries contribute literal 0)
                buf = buf.at[p_pad[0]].add(vals[0])
                ids = jax.lax.dynamic_update_slice(ids, row_ids, (start[0],))
                return buf, ids

            in_specs = (P(axis, None), P(axis), P(axis, None),
                        P(axis, None, None), P(axis), P(axis))
        else:
            def write(buf, ids, rows, row_ids, start):
                buf = jax.lax.dynamic_update_slice(buf, rows, (start[0], 0))
                ids = jax.lax.dynamic_update_slice(ids, row_ids, (start[0],))
                return buf, ids

            in_specs = (P(axis, None), P(axis), P(axis, None), P(axis),
                        P(axis))
        return jax.jit(
            jax.shard_map(
                write, mesh=self.mesh, in_specs=in_specs,
                out_specs=(P(axis, None), P(axis)),
            ),
            donate_argnums=(0, 1),
        )

    def add(self, signs) -> None:
        """Append [m, n_bits] sign codes (±1 or {0,1}); m must divide by
        the mesh axis size (pad on the host if needed). Row i of the batch
        lands on shard i // (m/ndev), preserving global id order."""
        signs = np.asarray(signs) if not isinstance(signs, jnp.ndarray) \
            else signs
        assert signs.ndim == 2 and signs.shape[1] == self.n_bits
        m = signs.shape[0]
        assert m % self.ndev == 0, (
            f"insert batch {m} not divisible by {self.ndev} shards"
        )
        per = m // self.ndev
        if int(self._fill.max()) + per > self.shard_rows:
            raise ValueError("sharded binary index full")
        if self._write_fn is None:
            self._write_fn = self._make_write_fn()
        sh1 = NamedSharding(self.mesh, P(self.axis))
        ids = jnp.arange(self._next_id, self._next_id + m, dtype=jnp.int32)
        row_ids = jax.device_put(ids, sh1)
        start = jax.device_put(
            jnp.asarray(self._fill, jnp.int32), sh1
        )
        if self.mode == "packed":
            bits01 = (jnp.asarray(signs) > 0).astype(jnp.int32)
            if self.bits_pad != self.n_bits:
                bits01 = jnp.pad(
                    bits01, ((0, 0), (0, self.bits_pad - self.n_bits))
                )
            mp = _pow2(per)
            p_pad = np.zeros((self.ndev, mp), np.int32)
            j_all = np.zeros((self.ndev, per), np.int32)
            for s in range(self.ndev):
                slots = np.arange(self._fill[s], self._fill[s] + per)
                p, j = hamming.t_slot_coords(slots, self.block_rows)
                p_pad[s, :per] = p
                j_all[s] = j
            vals = bits01.reshape(self.ndev, per, self.bits_pad) << \
                jnp.asarray(j_all, jnp.int32)[:, :, None]
            vals = jnp.pad(vals, ((0, 0), (0, mp - per), (0, 0)))
            self._buf, self._ids = self._write_fn(
                self._buf, self._ids,
                jax.device_put(jnp.asarray(p_pad), sh1),
                jax.device_put(
                    vals, NamedSharding(self.mesh, P(self.axis, None, None))
                ),
                row_ids, start,
            )
        else:
            rows = jnp.where(
                jnp.asarray(signs) > 0, 1.0, -1.0
            ).astype(jnp.bfloat16)
            self._buf, self._ids = self._write_fn(
                self._buf, self._ids,
                jax.device_put(
                    rows, NamedSharding(self.mesh, P(self.axis, None))
                ),
                row_ids, start,
            )
        for s in range(self.ndev):
            f = int(self._fill[s])
            self._host_ids[s, f : f + per] = np.arange(
                self._next_id + s * per, self._next_id + (s + 1) * per
            )
        self._next_id += m
        self._fill += per
        self.size += m

    # ------------------------------------------------------------------
    def search(self, q_signs, k: int, row_mask=None,
               out: str = "np") -> Tuple[np.ndarray, np.ndarray]:
        """Global exact Hamming top-k. ``row_mask``: optional bool array
        keyed by GLOBAL id (length >= the highest id ever issued) —
        filtered search; ids are stable under removal, so gid-keyed masks
        stay valid across maintenance (ShardedDenseIndex semantics).

        ``out='device'`` returns jax arrays without the device->host
        transfer — the device-resident serving contract every index in the
        repo follows. Pass device-resident ``q_signs`` too for a
        zero-host-hop query path."""
        q = jnp.where(
            jnp.asarray(q_signs) > 0, 1.0, -1.0
        ).astype(jnp.bfloat16)
        nq = q.shape[0]
        q_pad = max(8, 1 << (max(nq - 1, 1)).bit_length())
        if q_pad != nq:
            q = jnp.pad(q, ((0, q_pad - nq), (0, 0)))
        packed_bits = None
        if self.mode == "packed":
            packed_bits = self.n_bits
            if self.bits_pad != self.n_bits:
                # zero pad columns: padded corpus bits never score
                q = jnp.pad(q, ((0, 0), (0, self.bits_pad - self.n_bits)))
        slot_mask = None
        if row_mask is not None:
            gmask = np.asarray(row_mask, bool)
            assert gmask.shape[0] >= self._next_id, (
                f"row_mask length {gmask.shape[0]} < highest issued id "
                f"{self._next_id} (masks are keyed by GLOBAL id)"
            )
            slots = np.zeros((self.ndev, self.slots_pad), bool)
            for s in range(self.ndev):
                f = int(self._fill[s])
                slots[s, :f] = gmask[self._host_ids[s, :f]]
            slot_mask = jax.device_put(
                jnp.asarray(slots.reshape(-1)),
                NamedSharding(self.mesh, P(self.axis)),
            )
        valid = jax.device_put(
            jnp.asarray(self._fill, jnp.int32),
            NamedSharding(self.mesh, P(self.axis)),
        )
        dist, ids = sharded_hamming_topk(
            q, self._buf, k, self.mesh, n_bits=self.n_bits,
            axis=self.axis, shard_ids=self._ids, valid_per_shard=valid,
            selection=self.selection, recall_target=self.recall_target,
            row_mask=slot_mask, packed_bits=packed_bits,
            packed_block_rows=getattr(self, "block_rows", 2048),
        )
        if out == "device":
            return dist[:nq], ids[:nq]
        return np.asarray(dist)[:nq], np.asarray(ids)[:nq]

    def range_search(
        self, q_signs, radius: float, k0: int = 128, row_mask=None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All codes within Hamming distance ``radius`` across every shard
        (``faiss.IndexBinaryFlat.range_search`` counterpart at scale-out).
        Returns the FAISS CSR triple ``(lims [q+1] int64, D, I)`` with
        STABLE global ids, slices sorted nearest-first. Exact via
        adaptive-depth top-k over the sharded scan."""
        if self.selection == "approx":
            raise ValueError(
                "range_search needs selection='exact': approx top-k can "
                "silently drop in-radius rows"
            )
        q_signs = np.asarray(q_signs) if not isinstance(
            q_signs, jnp.ndarray
        ) else q_signs
        nq = int(q_signs.shape[0])
        return _range_from_search(
            lambda k: self.search(q_signs, k, row_mask=row_mask),
            nq, radius, descending=False, total=self.size, k0=k0,
        )

    # ------------------------------------------------------------------
    def _make_move_fn(self):
        axis = self.axis
        if self.mode == "packed":
            block_rows = self.block_rows

            def move(buf, ids, psrc, jsrc, pdst, jdst, real,
                     slot_src, slot_dst, new_size, old_size):
                buf = _t_move_bits_core(
                    buf, psrc[0], jsrc[0], pdst[0], jdst[0], real[0],
                    new_size[0], old_size[0], block_rows=block_rows,
                )
                ids = ids.at[slot_dst[0]].set(ids[slot_src[0]])
                return buf, ids

            specs = (P(axis, None), P(axis)) + (P(axis, None),) * 7 + (
                P(axis), P(axis))
        else:
            def move(buf, ids, src, dst):
                return (
                    buf.at[dst].set(buf[src]),
                    ids.at[dst].set(ids[src]),
                )

            specs = (P(axis, None), P(axis), P(axis), P(axis))
        return jax.jit(
            jax.shard_map(
                move, mesh=self.mesh, in_specs=specs,
                out_specs=(P(axis, None), P(axis)),
            ),
            donate_argnums=(0, 1),
        )

    def remove_ids(self, gids) -> int:
        """Remove rows by GLOBAL id (``faiss.IndexBinaryFlat.remove_ids``
        counterpart at scale-out). Each owning shard compacts
        swap-with-last locally — ids move WITH their codes, so surviving
        ids are STABLE (unlike the single-chip BinaryIndex's positional
        renumbering). Packed shards move individual code bits and zero the
        freed slot range (the invariant packed appends rely on). Returns
        the count removed; raises if any id is absent."""
        gids = np.unique(np.asarray(gids, np.int64).reshape(-1))
        if gids.size == 0:
            return 0
        src, dst, new_fills = plan_sharded_removal(
            self._host_ids, self._fill, gids
        )
        if self._move_fn is None:
            self._move_fn = self._make_move_fn()
        sh1 = NamedSharding(self.mesh, P(self.axis))
        sh2 = NamedSharding(self.mesh, P(self.axis, None))
        if self.mode == "packed":
            width = src.shape[1]
            psrc = np.empty_like(src)
            jsrc = np.empty_like(src)
            pdst = np.empty_like(src)
            jdst = np.empty_like(src)
            for s in range(self.ndev):
                psrc[s], jsrc[s] = hamming.t_slot_coords(
                    src[s], self.block_rows
                )
                pdst[s], jdst[s] = hamming.t_slot_coords(
                    dst[s], self.block_rows
                )
            # identity-padded entries are not real moves (src==dst==last
            # valid-slot sentinel from plan_sharded_removal)
            real = src != dst
            dev2 = lambda a: jax.device_put(jnp.asarray(a), sh2)
            self._buf, self._ids = self._move_fn(
                self._buf, self._ids,
                dev2(psrc), dev2(jsrc), dev2(pdst), dev2(jdst), dev2(real),
                dev2(src), dev2(dst),
                jax.device_put(jnp.asarray(new_fills, jnp.int32), sh1),
                jax.device_put(jnp.asarray(self._fill, jnp.int32), sh1),
            )
        else:
            self._buf, self._ids = self._move_fn(
                self._buf, self._ids,
                jax.device_put(jnp.asarray(src.reshape(-1)), sh1),
                jax.device_put(jnp.asarray(dst.reshape(-1)), sh1),
            )
        for s in range(self.ndev):
            self._host_ids[s, dst[s]] = self._host_ids[s, src[s]]
            self._host_ids[s, new_fills[s] :] = -1
        removed = self.size - int(new_fills.sum())
        self._fill = new_fills
        self.size = int(new_fills.sum())
        return removed

    # ------------------------------------------------------------------
    def reconstruct_batch(self, gids) -> np.ndarray:
        """Return stored codes by GLOBAL id as [m, n_bits] float32 ±1 rows
        (``faiss.IndexBinaryFlat.reconstruct_batch`` counterpart; the sign
        row is this engine's native code form). Ids are STABLE — a gid is
        reconstructable until removed; absent gids raise."""
        gids = np.asarray(gids, np.int64).reshape(-1)
        pos = global_id_positions(self._host_ids, self._fill, gids)
        shard = pos // self.shard_rows
        slot = pos % self.shard_rows
        if self.mode == "packed":
            p, j = hamming.t_slot_coords(slot, self.block_rows)
            p_global = shard * (self.slots_pad // 32) + p
            words = np.asarray(
                jnp.take(self._buf, jnp.asarray(p_global), axis=0)
            )[:, : self.n_bits]
            bits01 = (words >> np.asarray(j, np.int32)[:, None]) & 1
            return (2.0 * bits01 - 1.0).astype(np.float32)
        phys = shard * self.slots_pad + slot
        rows = jnp.take(self._buf, jnp.asarray(phys), axis=0)
        return np.asarray(rows.astype(jnp.float32))

    def reconstruct(self, gid: int) -> np.ndarray:
        """Single-row form: [n_bits] float32 ±1 for one global id."""
        return self.reconstruct_batch([int(gid)])[0]

    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        """Complete serving state as a pytree (sharded device arrays +
        host bookkeeping) for utils.checkpoint.save_sharded /
        restore_sharded — ShardedDenseIndex.state_dict semantics."""
        return {
            "buf": self._buf,
            "ids": self._ids,
            "size": np.asarray(self.size),
            "fills": np.asarray(self._fill),
            "next_id": np.asarray(self._next_id),
            "host_ids": np.asarray(self._host_ids),
        }

    def load_state(self, state: dict) -> None:
        self._buf = state["buf"]
        self._ids = state["ids"]
        self.size = int(state["size"])
        self._fill = np.asarray(state["fills"], np.int64).copy()
        self._next_id = int(state["next_id"])
        self._host_ids = np.asarray(state["host_ids"], np.int64).copy()

    def save(self, path: str) -> None:
        if self.mode == "sign":
            buf = np.asarray(self._buf.astype(jnp.int8))
        else:
            buf = np.asarray(self._buf)
        np.savez(
            path,
            buf=buf,
            n_bits=self.n_bits,
            capacity=self.capacity,
            mode=self.mode,
            selection=self.selection,
            recall_target=self.recall_target,
            size=self.size,
            fills=self._fill,
            next_id=self._next_id,
            host_ids=self._host_ids,
            ids=np.asarray(self._ids),
            ndev=self.ndev,
        )

    @classmethod
    def load(cls, path: str, mesh: Mesh,
             capacity: Optional[int] = None, **kw) -> "ShardedBinaryIndex":
        """Restore a snapshot on ``mesh``. The shard count must match the
        snapshot's (packed layouts are per-shard physical; re-striping a
        binary corpus is a reconstruct->add rebuild, not a load)."""
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        if int(z["ndev"]) != mesh.shape[kw.get("axis", "data")]:
            raise ValueError(
                f"snapshot saved on {int(z['ndev'])} shards; load onto a "
                "matching mesh or rebuild via reconstruct_batch/add"
            )
        idx = cls(
            n_bits=int(z["n_bits"]),
            capacity=capacity or int(z["capacity"]),
            mesh=mesh,
            mode=str(z["mode"]),
            selection=str(z["selection"]),
            recall_target=float(z["recall_target"]),
            **kw,
        )
        sh2 = NamedSharding(mesh, P(idx.axis, None))
        sh1 = NamedSharding(mesh, P(idx.axis))
        buf = jnp.asarray(z["buf"])
        if idx.mode == "sign":
            buf = buf.astype(jnp.bfloat16)
        idx._buf = jax.device_put(buf, sh2)
        idx._ids = jax.device_put(jnp.asarray(z["ids"]), sh1)
        idx.size = int(z["size"])
        idx._fill = np.asarray(z["fills"], np.int64).copy()
        idx._next_id = int(z["next_id"])
        idx._host_ids = np.asarray(z["host_ids"], np.int64).copy()
        return idx
