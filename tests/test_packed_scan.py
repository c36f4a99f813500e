"""The packed capacity tier's scan (ops.hamming.packed_t_topk) against a
numpy XOR + popcount oracle: every code width the indexes use, over the
whole buffer, a partly filled buffer (valid_count) and a row mask."""

import jax.numpy as jnp
import numpy as np
import pytest

from sessionsimilaritysearch.ops.hamming import (
    TBLOCK,
    pack_bits_t_np,
    packed_t_topk,
)

N_ROWS = 2 * TBLOCK  # two pack blocks
K = 9


def _xor_popcount(q_bits: np.ndarray, c_bits: np.ndarray) -> np.ndarray:
    """[q, n] Hamming distances from packed bytes (numpy only)."""
    qp = np.packbits(q_bits, axis=1)
    cp = np.packbits(c_bits, axis=1)
    x = np.bitwise_xor(qp[:, None, :], cp[None, :, :])
    return np.unpackbits(x, axis=2).sum(axis=2)


@pytest.mark.parametrize("case", ["full", "valid_count", "row_mask"])
@pytest.mark.parametrize("n_bits", [64, 250, 256, 512])
def test_packed_t_topk_matches_xor_popcount(n_bits, case):
    rng = np.random.default_rng(n_bits)
    c_bits = rng.random((N_ROWS, n_bits)) < 0.5
    q_bits = rng.random((5, n_bits)) < 0.5
    # the index's layout: code width padded to a lane multiple, query pad
    # columns held at zero so padded corpus bits never score
    bits_pad = -(-n_bits // 128) * 128
    c_signs = np.pad(np.where(c_bits, 1.0, -1.0), ((0, 0), (0, bits_pad - n_bits)),
                     constant_values=-1.0)
    q_signs = np.pad(np.where(q_bits, 1.0, -1.0), ((0, 0), (0, bits_pad - n_bits)))
    packed = jnp.asarray(pack_bits_t_np(c_signs))

    live = np.ones(N_ROWS, bool)
    kw = {}
    if case == "valid_count":
        live[TBLOCK + 77:] = False
        kw["valid_count"] = jnp.asarray(TBLOCK + 77, jnp.int32)
    elif case == "row_mask":
        live = rng.random(N_ROWS) < 0.3
        kw["row_mask"] = jnp.asarray(live)

    d, i = packed_t_topk(jnp.asarray(q_signs, jnp.bfloat16), packed, K,
                         n_bits=n_bits, chunk_size=TBLOCK, **kw)
    d, i = np.asarray(d), np.asarray(i)

    dist = _xor_popcount(q_bits, c_bits)
    want = np.sort(np.where(live[None, :], dist, np.iinfo(np.int32).max),
                   axis=1)[:, :K]
    np.testing.assert_array_equal(d, want)  # ascending, exact
    assert live[i].all()  # only live rows rank
    # every returned id carries the distance reported for it
    np.testing.assert_array_equal(np.take_along_axis(dist, i, 1), d)
