"""Binary hash-code index (Hamming search).

Replaces FAISS ``IndexBinaryFlat`` over packbits codes (reference:
fine_tune_ours.py:839-843 build, :871-879 timed search). Codes come from the
BinarizeHead's sign outputs. Two storage modes:

- 'packed': the CAPACITY tier -- 1 bit/bit of device memory (32 MB per
  1M x 250-bit rows, 1/16th of 'sign'). Codes are stored TRANSPOSED-packed
  (ops.hamming.pack_bits_t_np layout) and scanned by the exact
  unpack+matmul scan (ops.hamming.packed_t_topk): each corpus block is
  unpacked to +-1 bf16 and ranked by sign matmul.
- 'sign': +-1 bf16 rows, ranked by matmul (see ops/hamming.py for the
  dot<->Hamming identity) -- the SPEED tier and the default, and the only
  mode with approx selection.

Streaming contract (same as DenseIndex): the buffer is allocated at full
``capacity`` once and every search scans the whole buffer with a dynamic
``valid_count`` mask, so interleaved add/search NEVER recompiles -- scan
cost is proportional to capacity, which the caller sizes. Packed adds are
O(batch) scatter-ORs into the transposed layout; packed removals move
individual code BITS between words (see ``_t_move_bits``) so FAISS
``remove_ids`` semantics survive the layout.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sessionsimilaritysearch.index.dense import (
    _move_rows,
    _padded_moves,
    _range_from_search,
    _write_rows,
    compaction_plan,
)
from sessionsimilaritysearch.ops import hamming

# packed buffers pad their slot count to a multiple of _GROUP (a whole
# number of transposed-pack row blocks: 16384 % 2048 == 0)
_GROUP = 128 * 128
_TBLOCK = hamming.TBLOCK


def _pow2(m: int) -> int:
    return max(8, 1 << (max(m, 1) - 1).bit_length())


@functools.partial(jax.jit, donate_argnums=(0,))
def _t_scatter_bits(buf: jnp.ndarray, p: jnp.ndarray, vals: jnp.ndarray):
    """OR freshly-packed code bits into the transposed buffer. Correct
    because target bits are zero (zeroed-buffer / zeroed-freed-range
    invariant) and every real (row, bit) target is distinct, so wrapping
    int32 adds equal bitwise OR; padded entries contribute literal 0."""
    return buf.at[p].add(vals)


def _t_move_bits_core(
    buf: jnp.ndarray,
    p_src: jnp.ndarray,
    j_src: jnp.ndarray,
    p_dst: jnp.ndarray,
    j_dst: jnp.ndarray,
    real: jnp.ndarray,
    new_size: jnp.ndarray,
    old_size: jnp.ndarray,
    block_rows: int = _TBLOCK,
):
    """Transposed-layout compaction: move code bits src -> dst and zero the
    freed slot range [new_size, old_size) in one donated pass.

    A slot's code is bit j of packed row p across all columns
    (ops.hamming.t_slot_coords), so a row move is a bit move: gather the
    source bits, clear every destination bit and every freed-range bit
    (per-packed-row int32 masks; distinct bits make wrapping adds an OR),
    then scatter the gathered bits in. Gather happens before the clears,
    so padded identity entries (real=False) are no-ops by construction.
    Pure-function core so ShardedBinaryIndex can run it per shard inside
    shard_map; the jitted single-chip form is :func:`_t_move_bits`."""
    one = jnp.int32(1)
    bits = (buf[p_src] >> j_src[:, None]) & one  # [M, bits] {0,1}
    dst_bit = jnp.where(real, one << j_dst, 0)
    clear_dst = jnp.zeros((buf.shape[0], 1), jnp.int32).at[p_dst].add(
        dst_bit[:, None]
    )
    s_rows = block_rows // 32
    p_all = jnp.arange(buf.shape[0], dtype=jnp.int32)
    slot0 = (p_all // s_rows) * block_rows + p_all % s_rows
    j_ar = jnp.arange(32, dtype=jnp.int32)
    slots = slot0[:, None] + j_ar[None, :] * s_rows  # [P, 32] slot ids
    freed = (slots >= new_size) & (slots < old_size)
    clear_free = jnp.sum(
        jnp.where(freed, one << j_ar, 0), axis=1, dtype=jnp.int32
    )[:, None]
    buf = buf & ~(clear_dst | clear_free)
    set_vals = jnp.where(real[:, None], bits << j_dst[:, None], 0)
    return buf.at[p_dst].add(set_vals)


_t_move_bits = functools.partial(
    jax.jit, donate_argnums=(0,), static_argnames=("block_rows",)
)(_t_move_bits_core)


class BinaryIndex:
    def __init__(
        self,
        n_bits: int,
        capacity: int,
        mode: str = "sign",
        selection: str = "exact",
        recall_target: float = 0.95,
    ):
        """``selection='approx'`` (sign mode only) selects per chunk with
        ``lax.approx_max_k`` at ``recall_target`` (see
        ops.hamming.sign_topk)."""
        assert mode in ("packed", "sign")
        assert selection in ("exact", "approx")
        assert selection == "exact" or mode == "sign", (
            "approx selection is wired for the sign-matmul path"
        )
        self.n_bits = n_bits
        self.capacity = capacity
        self.mode = mode
        self.selection = selection
        self.recall_target = recall_target
        self.size = 0
        if mode == "packed":
            # transposed-packed storage (ops.hamming.pack_bits_t_np
            # layout): [slots/32, bits_pad] int32. Slot capacity rounds up
            # to whole pack blocks (slots past ``capacity`` are never
            # valid -- search masks at ``size``); the code width pads to a
            # full lane multiple, with query pad columns held at 0 so pad
            # bits never contribute to any dot.
            self.block_rows = _TBLOCK
            self.bits_pad = -(-n_bits // 128) * 128
            cap_pad = -(-capacity // _GROUP) * _GROUP
            self._buf = jnp.zeros(
                (cap_pad // 32, self.bits_pad), dtype=jnp.int32
            )
        else:
            self._buf = -jnp.ones((capacity, n_bits), dtype=jnp.bfloat16)

    @property
    def ntotal(self) -> int:
        return self.size

    def add(self, signs) -> None:
        """Append [m, n_bits] sign codes (+-1 or {0,1} floats). Device
        arrays pack on device (no host round-trip). O(batch) on both
        modes: packed appends scatter-OR shifted bit columns into the
        transposed words (move counts pad to powers of two so streaming
        adds compile O(log) programs)."""
        on_device = isinstance(signs, jnp.ndarray)
        if not on_device:
            signs = np.asarray(signs)
        assert signs.ndim == 2 and signs.shape[1] == self.n_bits
        m = signs.shape[0]
        if self.size + m > self.capacity:
            raise ValueError("binary index full")
        if self.mode == "packed":
            bits01 = (jnp.asarray(signs) > 0).astype(jnp.int32)
            if self.bits_pad != self.n_bits:
                bits01 = jnp.pad(
                    bits01, ((0, 0), (0, self.bits_pad - self.n_bits))
                )
            slots = np.arange(self.size, self.size + m)
            p, j = hamming.t_slot_coords(slots, self.block_rows)
            mp = _pow2(m)
            p_pad = np.zeros(mp, np.int32)
            p_pad[:m] = p
            vals = bits01 << jnp.asarray(j, jnp.int32)[:, None]
            vals = jnp.pad(vals, ((0, mp - m), (0, 0)))
            self._buf = _t_scatter_bits(self._buf, jnp.asarray(p_pad), vals)
        else:
            rows = jnp.where(
                jnp.asarray(signs) > 0, 1.0, -1.0
            ).astype(jnp.bfloat16)
            # O(batch) in-place append (donated dynamic_update_slice), not
            # an O(capacity) functional copy -- same as DenseIndex.add
            self._buf = _write_rows(
                self._buf, rows, jnp.asarray(self.size, jnp.int32)
            )
        self.size += m

    def reconstruct_batch(self, ids) -> np.ndarray:
        """Return stored codes by position as [m, n_bits] float32 ±1 rows
        (``faiss.IndexBinaryFlat.reconstruct_batch`` counterpart — FAISS
        returns the packed uint8 code bytes; the ±1 sign row is this
        engine's native code form, identical information). Packed mode
        extracts bit ``j`` of the transposed words at the slot's
        coordinates (ops.hamming.t_slot_coords); sign mode reads the row.
        Ids are positional (renumbered by :meth:`remove_ids`)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.size):
            raise IndexError(
                f"reconstruct ids must lie in [0, {self.size})"
            )
        if self.mode == "packed":
            p, j = hamming.t_slot_coords(ids, self.block_rows)
            words = np.asarray(
                jnp.take(self._buf, jnp.asarray(p), axis=0)
            )[:, : self.n_bits]
            bits01 = (words >> np.asarray(j, np.int32)[:, None]) & 1
            return (2.0 * bits01 - 1.0).astype(np.float32)
        rows = jnp.take(self._buf, jnp.asarray(ids), axis=0)
        return np.asarray(rows.astype(jnp.float32))

    def reconstruct(self, i: int) -> np.ndarray:
        """Single-row form: [n_bits] float32 ±1."""
        return self.reconstruct_batch([int(i)])[0]

    def remove_ids(self, ids) -> int:
        """Remove codes by row id (``faiss.IndexBinaryFlat.remove_ids``
        counterpart). Swap-with-last compaction: surviving row ids change
        exactly as in FAISS (see index.dense.compaction_plan); freed
        capacity is reusable; search never retraces. Returns the count."""
        src, dst, new_size = compaction_plan(self.size, ids)
        removed = self.size - new_size
        if self.mode == "packed":
            if removed:
                # bit-granular moves + zeroing of the freed slot range (the
                # zeroed-range invariant packed adds rely on); runs even
                # with zero moves (pure-tail removals still free slots)
                mlen = _pow2(int(src.size))
                p_src, j_src = hamming.t_slot_coords(src, self.block_rows)
                p_dst, j_dst = hamming.t_slot_coords(dst, self.block_rows)

                def _pad(a):
                    out = np.zeros(mlen, np.int32)
                    out[: a.size] = a
                    return jnp.asarray(out)

                real = np.zeros(mlen, bool)
                real[: src.size] = True
                self._buf = _t_move_bits(
                    self._buf,
                    _pad(p_src), _pad(j_src), _pad(p_dst), _pad(j_dst),
                    jnp.asarray(real),
                    jnp.asarray(new_size, jnp.int32),
                    jnp.asarray(self.size, jnp.int32),
                    block_rows=self.block_rows,
                )
        elif src.size:
            # pad with the buffer's last physical row (never a real
            # destination: real dsts are < new_size)
            s, d = _padded_moves(src, dst, self._buf.shape[0] - 1)
            self._buf = _move_rows(self._buf, s, d)
        self.size = new_size
        return removed

    @property
    def _n_slots(self) -> int:
        """Physical slot count of the scan buffer (packed capacity rounds
        up to whole pack blocks)."""
        if self.mode == "packed":
            return self._buf.shape[0] * 32
        return self._buf.shape[0]

    def _prep_mask(self, row_mask):
        """Validate a positional row mask and pad it to the scan buffer's
        physical slot count (packed mode rounds the buffer up past
        ``capacity``; padded slots are already dead via valid_count)."""
        if row_mask is None:
            return None
        row_mask = np.asarray(row_mask, bool)
        assert row_mask.shape[0] in (self.size, self.capacity), (
            f"row_mask length {row_mask.shape[0]} matches neither "
            f"size {self.size} nor capacity {self.capacity}"
        )
        n_buf = self._n_slots
        if row_mask.shape[0] < n_buf:
            row_mask = np.pad(row_mask, (0, n_buf - row_mask.shape[0]))
        return jnp.asarray(row_mask)

    def search(self, q_signs, k: int,
               row_mask=None) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (hamming distances ascending [q,k], indices [q,k]).

        ``row_mask``: optional bool array over the current rows (length
        ``size`` or ``capacity``) — filtered search (FAISS IDSelector
        counterpart): False rows never rank. A dynamic operand on every
        path, so fresh masks never retrace. NOTE after :meth:`remove_ids`
        row ids renumber — rebuild positional masks after removal.

        ``q_signs`` may be a device array (sign codes computed on the
        accelerator by an upstream projection, e.g. two-stage serving):
        packing then runs on device (``hamming.pack_bits``) with no host
        round-trip."""
        d, i = self.search_device(q_signs, k, row_mask=row_mask)
        return np.asarray(d), np.asarray(i)

    def search_device(self, q_signs, k: int, row_mask=None):
        """:meth:`search` that returns DEVICE arrays — the fused form for
        pipelines whose next stage is another device computation (e.g.
        two-stage serving's exact re-rank): no host sync between the code
        scan and the consumer."""
        if not isinstance(q_signs, jnp.ndarray):
            q_signs = np.asarray(q_signs)
        vc = jnp.asarray(self.size, jnp.int32)
        mask = self._prep_mask(row_mask)
        if self.mode == "packed":
            # queries stay sign vectors (only the corpus is packed): +-1
            # bf16 with ZERO pad columns so padded corpus bits never score
            q = jnp.where(
                jnp.asarray(q_signs) > 0, 1.0, -1.0
            ).astype(jnp.bfloat16)
            if self.bits_pad != self.n_bits:
                q = jnp.pad(q, ((0, 0), (0, self.bits_pad - self.n_bits)))
            d, i = hamming.packed_t_topk(
                q, self._buf, k, n_bits=self.n_bits,
                block_rows=self.block_rows,
                valid_count=vc, row_mask=mask,
            )
        else:
            q = jnp.where(jnp.asarray(q_signs) > 0, 1.0, -1.0).astype(jnp.bfloat16)
            d, i = hamming.sign_topk(
                q, self._buf, k, n_bits=self.n_bits,
                mode=self.selection, recall_target=self.recall_target,
                valid_count=vc, row_mask=mask,
            )
        return d, i

    def range_search(
        self, q_signs, radius: float, k0: int = 128, row_mask=None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All codes within Hamming distance ``radius`` of each query
        (``faiss.IndexBinaryFlat.range_search`` counterpart). Returns the
        FAISS CSR triple ``(lims [q+1] int64, D, I)`` with each query's
        slice sorted nearest-first. Exact via adaptive-depth top-k over
        the fixed-capacity scan (depth doubles from ``k0`` until each
        query's deepest hit exceeds the radius) — at most O(log size)
        compiled programs, shared with :meth:`search`'s cache.
        ``row_mask`` composes as in :meth:`search`."""
        if self.selection == "approx":
            raise ValueError(
                "range_search needs selection='exact': approx top-k can "
                "silently drop in-radius rows"
            )
        if not isinstance(q_signs, jnp.ndarray):
            q_signs = np.asarray(q_signs)
        nq = int(q_signs.shape[0])
        return _range_from_search(
            lambda k: self.search(q_signs, k, row_mask=row_mask),
            nq, radius, descending=False, total=self.size, k0=k0,
        )

    def merge_from(self, other: "BinaryIndex", batch: int = 65536) -> int:
        """Append ``other``'s stored codes (``faiss.IndexBinaryFlat.
        merge_from`` counterpart). Ids shift by ``self.ntotal`` as in
        FAISS; ``other`` is left intact. Works across storage modes
        (sign <-> packed): codes stream through
        :meth:`reconstruct_batch` -> :meth:`add` in ``batch``-row chunks,
        so the transposed-pack invariants (scatter-OR into zeroed bits)
        are preserved by construction. Returns the row count appended."""
        if not isinstance(other, BinaryIndex):
            # ValueError like the width/capacity checks below, not a bare
            # assert stripped under python -O
            raise TypeError(
                "merge_from source must be a BinaryIndex, got "
                f"{type(other).__name__}"
            )
        if other.n_bits != self.n_bits:
            raise ValueError(
                f"code width mismatch: {self.n_bits} vs {other.n_bits}"
            )
        if self.size + other.size > self.capacity:
            raise ValueError(
                f"index full: {self.size}+{other.size} > {self.capacity}"
            )
        for start in range(0, other.size, batch):
            ids = np.arange(start, min(start + batch, other.size))
            self.add(other.reconstruct_batch(ids))
        return other.size

    # --- persistence (reference: faiss.write_index/read_index for the
    #     binary index are absent upstream -- fine_tune_ours.py rebuilds
    #     from embeddings every run; first-class here, incl. the serving
    #     configuration so a tuned engine restores tuned)
    def _t_used_rows(self) -> int:
        """Packed rows that can hold set bits at the current fill (whole
        pack blocks; later blocks are all-zero by the invariant)."""
        blocks = -(-self.size // self.block_rows)
        return blocks * (self.block_rows // 32)

    def save(self, path: str) -> None:
        extra = {}
        if self.mode == "sign":
            # bf16 isn't a native npz dtype; +-1 rows round-trip via int8
            buf = np.asarray(self._buf[: self.size].astype(jnp.int8))
        else:
            # transposed-packed words, trimmed to the used pack blocks
            buf = np.asarray(self._buf[: self._t_used_rows()])
            extra = {"layout": "t", "block_rows": self.block_rows}
        np.savez(
            path,
            buf=buf,
            n_bits=self.n_bits,
            capacity=self.capacity,
            mode=self.mode,
            selection=self.selection,
            recall_target=self.recall_target,
            size=self.size,
            **extra,
        )

    @classmethod
    def load(cls, path: str, capacity: Optional[int] = None, **kw) -> "BinaryIndex":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        idx = cls(
            n_bits=int(z["n_bits"]),
            capacity=capacity or int(z["capacity"]),
            mode=str(z["mode"]),
            selection=str(z["selection"]),
            recall_target=float(z["recall_target"]),
            **kw,
        )
        size = int(z["size"])
        if size:
            if idx.mode == "sign":
                rows = jnp.asarray(z["buf"]).astype(jnp.bfloat16)
                idx._buf = _write_rows(
                    idx._buf, rows, jnp.asarray(0, jnp.int32)
                )
                idx.size = size
            elif "layout" in z.files:
                assert int(z["block_rows"]) == idx.block_rows, (
                    "pack block mismatch: snapshot "
                    f"{int(z['block_rows'])} vs {idx.block_rows}"
                )
                idx._buf = _write_rows(
                    idx._buf, jnp.asarray(z["buf"]),
                    jnp.asarray(0, jnp.int32),
                )
                idx.size = size
            else:
                # legacy row-major packed snapshot: unpack to signs and
                # re-ingest through the transposed append path
                idx.add(hamming.unpack_bits_np(z["buf"], idx.n_bits))
        return idx
