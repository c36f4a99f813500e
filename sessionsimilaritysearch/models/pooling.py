"""Graph-level readouts (poolings) over padded node sets.

Re-designs of model/gnn.py:123-217. The reference pools flat node lists via
``global_*_pool(x, batch)`` segment ops; with dense padding each pooling is a
masked reduction over the node axis [B, N, d] -- no segment scatter, fully
vectorized.
"""

from __future__ import annotations

from typing import Optional

from sessionsimilaritysearch import nn
import jax
import jax.numpy as jnp
import numpy as np


def masked_mean(x, mask, axis=1):
    """Mean over valid nodes; empty sets produce zeros."""
    m = mask[..., None]
    denom = jnp.clip(jnp.sum(m, axis=axis), 1.0, None)
    return jnp.sum(x * m, axis=axis) / denom


def masked_sum(x, mask, axis=1):
    return jnp.sum(x * mask[..., None], axis=axis)


def masked_max(x, mask, axis=1):
    neg = jnp.finfo(x.dtype).min
    out = jnp.max(jnp.where(mask[..., None] > 0, x, neg), axis=axis)
    return jnp.where(jnp.any(mask > 0, axis=axis)[..., None], out, 0.0)


class GraphPooling(nn.Module):
    """mean/add/max/sort pool -> dropout -> Linear
    (reference: model/gnn.py:123-143)."""

    pooling_key: str
    num_out: int
    dropout: float = 0.0
    sort_k: int = 4  # retained nodes for 'sort' (global_sort_pool's k)

    @nn.compact
    def __call__(self, x, mask, graph=None, deterministic: bool = True):
        if self.pooling_key == "mean":
            pooled = masked_mean(x, mask)
        elif self.pooling_key == "add":
            pooled = masked_sum(x, mask)
        elif self.pooling_key == "max":
            pooled = masked_max(x, mask)
        elif self.pooling_key == "sort":
            # global_sort_pool: sort nodes by their last feature channel,
            # keep the top sort_k, concatenate (padded nodes sort last)
            key = jnp.where(mask > 0, x[..., -1], jnp.finfo(x.dtype).min)
            _, order = jax.lax.top_k(key, min(self.sort_k, x.shape[1]))
            picked = jnp.take_along_axis(x, order[..., None], axis=1)
            picked = picked * jnp.take_along_axis(mask, order, axis=1)[..., None]
            pooled = picked.reshape(x.shape[0], -1)
        else:
            raise ValueError(f"unrecognized pooling key: {self.pooling_key}")
        pooled = nn.Dropout(self.dropout)(pooled, deterministic=deterministic)
        return nn.Dense(self.num_out, name="lin")(pooled)


class AttentionPooling(nn.Module):
    """Attention against the graph's mean vector
    (reference: model/gnn.py:145-161): att_i = x_i . mean(x), reweight,
    mean-pool, Linear."""

    num_out: int

    @nn.compact
    def __call__(self, x, mask, graph=None, deterministic: bool = True):
        coarse = masked_mean(x, mask)  # [B, d]
        att = jnp.einsum("bnd,bd->bn", x, coarse)  # [B, N]
        weighted = x * att[..., None]
        return nn.Dense(self.num_out, name="lin")(masked_mean(weighted, mask))


class SRGNNPooling(nn.Module):
    """SR-GNN readout (reference: model/gnn.py:164-181): local rep = the
    last-clicked node; attention lin3(sigmoid(lin1(local) + lin2(x)));
    global = sum att*x; out = Linear(concat(local, global))."""

    num_out: int

    @nn.compact
    def __call__(self, x, mask, graph, deterministic: bool = True):
        d = x.shape[-1]
        local = masked_sum(x, graph.last_click_mask * mask)  # [B, d]
        a = nn.Dense(d, name="lin1")(local)[:, None, :]  # [B, 1, d]
        b = nn.Dense(d, name="lin2")(x)  # [B, N, d]
        att = nn.Dense(1, use_bias=False, name="lin3")(nn.sigmoid(a + b))
        weighted = x * att
        global_rep = masked_sum(weighted, mask)
        rep = jnp.concatenate([local, global_rep], axis=-1)
        return nn.Dense(self.num_out, name="lin4")(rep)


class RecencySRGNNPooling(nn.Module):
    """SR-GNN readout with a learned STAN-style recency stream.

    Motivation (adversarial protocol): on overlap-hostile
    data the strongest sparse baseline is STAN — exponential recency decay
    concentrates weight on the session's *current* interest and suppresses
    interspersed trending noise. The SR-GNN readout (model/gnn.py:164-181)
    sees order only through the last click; this variant adds the decay
    as a differentiable readout stream: per-occurrence weights
    ``exp(-(rev_pos - 1) / lambda)`` over the occurrence stream
    (data/graph.py occ_*; rev_pos 1 = most recent, the STAN convention of
    index/sparse.py sequence_to_stan_vec) with a LEARNED decay length
    ``lambda`` (softplus-parameterized, initialized to STAN's 1.04), a
    recency-weighted mean of the occurrence node states, and that
    representation both injected into the attention gate and concatenated
    into the final projection. With lambda -> inf the recency stream
    degrades to a count-weighted mean, so the model can learn recency OUT
    as well as in.
    """

    num_out: int
    init_lambda: float = 1.04

    @nn.compact
    def __call__(self, x, mask, graph, deterministic: bool = True):
        d = x.shape[-1]
        local = masked_sum(x, graph.last_click_mask * mask)  # [B, d]
        # STAN-style decay over occurrences, learnable length scale
        raw0 = float(np.log(np.expm1(self.init_lambda)))
        lam = nn.softplus(
            self.param("raw_lambda", lambda k: jnp.asarray(raw0, jnp.float32))
        )
        rev = jnp.clip(graph.occ_pos.astype(jnp.float32) - 1.0, 0.0, None)
        w = jnp.exp(-rev / lam) * graph.occ_mask  # [B, O]
        occ_x = jnp.take_along_axis(
            x, graph.occ_product[..., None], axis=1
        )  # [B, O, d]
        denom = jnp.clip(jnp.sum(w, axis=1, keepdims=True), 1e-6, None)
        rec = jnp.sum(occ_x * w[..., None].astype(x.dtype), axis=1) / (
            denom.astype(x.dtype)
        )  # [B, d]
        # SR-GNN gated attention, recency rep joining the gate
        a = nn.Dense(d, name="lin1")(local)[:, None, :]
        r = nn.Dense(d, name="lin_rec")(rec)[:, None, :]
        b = nn.Dense(d, name="lin2")(x)
        att = nn.Dense(1, use_bias=False, name="lin3")(nn.sigmoid(a + r + b))
        global_rep = masked_sum(x * att, mask)
        rep = jnp.concatenate([local, rec, global_rep], axis=-1)
        return nn.Dense(self.num_out, name="lin4")(rep)


class PositionalAttentionPooling(nn.Module):
    """Unified query+product pooling (reference: model/gnn.py:183-217).

    Projects both node types to ``num_out - pos_dim``, concatenates a learned
    positional embedding indexed by reverse position, expands products by
    occurrence count (the reference's ``repeat_interleave`` -- here the
    pre-flattened ``occ_*`` stream from data/graph.py), then soft-attention
    pools the union of occurrence and query nodes.

    The positional table has ``max_seq_len + 1`` rows (the reference indexes
    an Embedding(max_seq_len) with values that can reach max_seq_len -- we
    size the table to make that in-range).
    """

    num_out: int
    max_seq_len: int

    @nn.compact
    def __call__(self, q_emb, p_emb, graph, deterministic: bool = True):
        """q_emb [B, Q, dq]; p_emb [B, P, dp]; graph: batched SessionGraph."""
        pos_dim = self.max_seq_len
        feat = self.num_out - pos_dim
        q = nn.Dense(feat, name="query_lin")(q_emb)
        p = nn.Dense(feat, name="product_lin")(p_emb)
        pos_table = nn.Embed(self.max_seq_len + 1, pos_dim, name="positional_emb")

        q_pos = pos_table(graph.query_pos)  # [B, Q, pos_dim]
        q_nodes = jnp.tanh(jnp.concatenate([q, q_pos], axis=-1))

        # expand products to per-occurrence rows via the occ stream
        occ = jnp.take_along_axis(
            p, graph.occ_product[..., None], axis=1
        )  # [B, O, feat]
        occ_pos = pos_table(graph.occ_pos)
        p_nodes = jnp.tanh(jnp.concatenate([occ, occ_pos], axis=-1))

        nodes = jnp.concatenate([p_nodes, q_nodes], axis=1)  # [B, O+Q, num_out]
        mask = jnp.concatenate([graph.occ_mask, graph.query_node_mask], axis=1)

        coarse = masked_mean(nodes, mask)[:, None, :]  # [B, 1, num_out]
        a = nn.Dense(self.num_out, name="node_emb_lin")(nodes)
        b = nn.Dense(self.num_out, use_bias=False, name="coarse_rep_lin")(coarse)
        att = nn.Dense(1, use_bias=False, name="att_lin")(nn.sigmoid(a + b))
        weighted = nodes * att
        return masked_mean(weighted, mask)
