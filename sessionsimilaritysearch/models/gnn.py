"""Heterogeneous GNN backbones on dense padded session graphs.

Re-designs of model/gnn.py. The reference runs PyG sparse message passing
(GatedGraphConv / GATConv / HGTConv / SAGEConv inside HeteroConv) over ragged
edge lists; here every session graph is a fixed-shape dense adjacency
(<=21x20 -- see data/graph.py), so message passing is batched einsum/matmul
that XLA maps straight onto dense matmuls, with no gather/scatter.

Edge multiplicity conventions: ``adj[b, i, j]`` counts edges i->j. GAT
attention weights each parallel edge separately (count-weighted softmax),
reproducing the reference's repeated-edge-list semantics; GatedGraphConv
binarizes the adjacency by default because the reference's main path never
passes edge weights into the GNN (model/model.py:238 calls gnn() without
edge_weight_dict) -- set ``use_edge_weight=True`` to exploit the merged
transition weights instead.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from sessionsimilaritysearch import nn
import jax.numpy as jnp


class GRUCell(nn.Module):
    """Torch-parity GRUCell used by GatedGraphConv."""

    features: int

    @nn.compact
    def __call__(self, m, h):
        ih = nn.Dense(3 * self.features, name="ih")(m)
        hh = nn.Dense(3 * self.features, name="hh")(h)
        i_r, i_z, i_n = jnp.split(ih, 3, axis=-1)
        h_r, h_z, h_n = jnp.split(hh, 3, axis=-1)
        r = nn.sigmoid(i_r + h_r)
        z = nn.sigmoid(i_z + h_z)
        n = jnp.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h


class DenseGatedGraphConv(nn.Module):
    """GatedGraphConv(out_channels, num_layers=1) on a dense adjacency
    (reference: model/gnn.py:58 uses it on same-type product->product edges).

    Semantics follow PyG: input zero-padded to ``out_channels``; message
    m_dst = sum_src A[src,dst] * (W x_src); state update by GRU cell.
    """

    out_channels: int
    use_edge_weight: bool = False

    @nn.compact
    def __call__(self, x, adj):
        """x [B, N, d_in]; adj [B, N, N] counts.

        PyG requires d_in <= out_channels and zero-pads; we keep that and
        additionally project down when d_in > out_channels (the reference
        avoids that case by feeding 768-d features into an 800-wide conv,
        pretrain_filtered_amazon.py:265-267 with use_id_embedding=False).
        """
        d_in = x.shape[-1]
        if d_in > self.out_channels:
            x = nn.Dense(self.out_channels, name="in_proj")(x)
        elif d_in < self.out_channels:
            x = jnp.pad(x, ((0, 0), (0, 0), (0, self.out_channels - d_in)))
        a = adj if self.use_edge_weight else (adj > 0).astype(x.dtype)
        msg = nn.Dense(self.out_channels, use_bias=False, name="weight")(x)
        # m[b, dst] = sum_src a[b, src, dst] * msg[b, src]
        m = jnp.einsum("bsd,bsf->bdf", a, msg)
        return GRUCell(self.out_channels, name="gru")(m, x)


class DenseGATConv(nn.Module):
    """Single-head bipartite GATConv((-1,-1), out) on dense adjacency
    (reference: model/gnn.py:54 for cross-type query<->product edges).

    Count-weighted softmax over incoming edges == PyG softmax over a
    repeated edge list. Destinations with no incoming edges output bias
    only, matching sparse scatter semantics.
    """

    out_channels: int
    negative_slope: float = 0.2

    @nn.compact
    def __call__(self, x_src, x_dst, adj):
        """x_src [B, S, ds]; x_dst [B, D, dd]; adj [B, S, D] counts.
        Returns [B, D, out_channels]."""
        h_src = nn.Dense(self.out_channels, use_bias=False, name="lin_src")(x_src)
        h_dst = nn.Dense(self.out_channels, use_bias=False, name="lin_dst")(x_dst)
        a_src = self.param(
            "att_src", nn.initializers.glorot_uniform(), (self.out_channels, 1)
        )
        a_dst = self.param(
            "att_dst", nn.initializers.glorot_uniform(), (self.out_channels, 1)
        )
        e_src = (h_src @ a_src)[..., 0]  # [B, S]
        e_dst = (h_dst @ a_dst)[..., 0]  # [B, D]
        e = e_src[:, :, None] + e_dst[:, None, :]  # [B, S, D]
        e = nn.leaky_relu(e, self.negative_slope)
        # count-weighted masked softmax over src (incoming edges of dst)
        w = adj * jnp.exp(e - jnp.max(e, axis=1, keepdims=True))
        denom = jnp.sum(w, axis=1, keepdims=True)
        alpha = w / jnp.clip(denom, 1e-16, None)
        out = jnp.einsum("bsd,bsf->bdf", alpha, h_src)
        bias = self.param("bias", nn.initializers.zeros, (self.out_channels,))
        return out + bias


class DenseSAGEConv(nn.Module):
    """Bipartite SAGEConv (mean aggregation) on dense adjacency
    (reference: model/gnn.py:97-99)."""

    out_channels: int

    @nn.compact
    def __call__(self, x_src, x_dst, adj):
        a = (adj > 0).astype(x_src.dtype)
        deg = jnp.clip(jnp.sum(a, axis=1), 1.0, None)  # [B, D]
        neigh = jnp.einsum("bsd,bsf->bdf", a, x_src) / deg[..., None]
        return nn.Dense(self.out_channels, name="lin_l")(neigh) + nn.Dense(
            self.out_channels, use_bias=False, name="lin_r"
        )(x_dst)


class DenseGCNConv(nn.Module):
    """Bipartite GCN conv with symmetric degree normalization
    (the 'GCN' conv_key of the reference's GNN factory, model/gnn.py:104-105):
    out_dst = sum_src A[s,d] / sqrt(deg_s * deg_d) * (W x_src) + b."""

    out_channels: int

    @nn.compact
    def __call__(self, x_src, x_dst, adj):
        a = (adj > 0).astype(x_src.dtype)
        deg_s = jnp.clip(jnp.sum(a, axis=2), 1.0, None)  # out-degree [B, S]
        deg_d = jnp.clip(jnp.sum(a, axis=1), 1.0, None)  # in-degree  [B, D]
        norm = a / jnp.sqrt(deg_s[:, :, None] * deg_d[:, None, :])
        h = nn.Dense(self.out_channels, use_bias=False, name="lin")(x_src)
        out = jnp.einsum("bsd,bsf->bdf", norm, h)
        bias = self.param("bias", nn.initializers.zeros, (self.out_channels,))
        return out + bias


def _adj_dict(graph) -> Dict[str, jnp.ndarray]:
    """Dense adjacency per edge type from a batched SessionGraph."""
    return {
        "qp": graph.adj_qp,          # query -> product ('clicks')
        "pq": jnp.swapaxes(graph.adj_qp, 1, 2),  # product -> query ('clicked by')
        "pp": graph.adj_pp,          # product -> product ('to')
    }


class HeteroGGNN(nn.Module):
    """The main backbone (reference: model/gnn.py:43-81): per layer a
    HeteroConv with GATConv on cross-type edges and GatedGraphConv on
    same-type edges, aggr='sum', ReLU between layers; output is the
    jumping-knowledge concat of all layer outputs (optionally incl. the
    input features)."""

    hidden_channels: int
    num_layers: int
    use_edge_weight: bool = False

    @nn.compact
    def __call__(self, x_dict, graph, add_input_feat: bool = True):
        adj = _adj_dict(graph)
        outs = [x_dict]
        cur = x_dict
        for i in range(self.num_layers):
            q_in, p_in = cur["query"], cur["product"]
            # product receives: GAT(query->product) + GGC(product->product)
            p_from_q = DenseGATConv(self.hidden_channels, name=f"l{i}_qp")(
                q_in, p_in, adj["qp"]
            )
            p_from_p = DenseGatedGraphConv(
                self.hidden_channels,
                use_edge_weight=self.use_edge_weight,
                name=f"l{i}_pp",
            )(p_in, graph.adj_pp)
            # query receives: GAT(product->query)
            q_from_p = DenseGATConv(self.hidden_channels, name=f"l{i}_pq")(
                p_in, q_in, adj["pq"]
            )
            cur = {
                "query": nn.relu(q_from_p),
                "product": nn.relu(p_from_q + p_from_p),
            }
            outs.append(cur)
        start = 0 if add_input_feat else 1
        return {
            t: jnp.concatenate([o[t] for o in outs[start:]], axis=-1)
            for t in x_dict
        }


class HGT(nn.Module):
    """Heterogeneous graph transformer backbone
    (reference: model/gnn.py:9-41): per-node-type input Linear+ReLU, then
    ``num_layers`` hetero attention convs (grouped sum), output the concat
    of all layer outputs.

    Dense redesign of HGTConv: type-specific Q/K/V projections with
    per-edge-type attention over the dense adjacency mask.
    """

    hidden_channels: int
    num_heads: int
    num_layers: int

    @nn.compact
    def __call__(self, x_dict, graph, add_input_feat: bool = True):
        h = {
            t: nn.relu(nn.Dense(self.hidden_channels, name=f"lin_{t}")(x))
            for t, x in x_dict.items()
        }
        adj = _adj_dict(graph)
        edge_types = [("query", "product", "qp"), ("product", "query", "pq"),
                      ("product", "product", "pp")]
        outs = [h]
        cur = h
        H, C = self.num_heads, self.hidden_channels
        hd = C // H
        for i in range(self.num_layers):
            q_proj = {
                t: nn.Dense(C, name=f"l{i}_q_{t}")(cur[t]) for t in cur
            }
            k_proj = {
                t: nn.Dense(C, name=f"l{i}_k_{t}")(cur[t]) for t in cur
            }
            v_proj = {
                t: nn.Dense(C, name=f"l{i}_v_{t}")(cur[t]) for t in cur
            }
            agg = {t: jnp.zeros_like(cur[t]) for t in cur}
            for src, dst, key in edge_types:
                a = adj[key]  # [B, S, D]
                B, S, D = a.shape
                q = q_proj[dst].reshape(B, D, H, hd)
                k = k_proj[src].reshape(B, S, H, hd)
                v = v_proj[src].reshape(B, S, H, hd)
                scores = jnp.einsum("bdhc,bshc->bhsd", q, k) / jnp.sqrt(
                    jnp.asarray(hd, q.dtype)
                )
                mask = (a > 0)[:, None, :, :]  # [B, 1, S, D]
                neg = jnp.finfo(scores.dtype).min
                scores = jnp.where(mask, scores, neg)
                att = nn.softmax(scores, axis=2)
                att = jnp.where(mask, att, 0.0)  # isolated dst -> zero
                msg = jnp.einsum("bhsd,bshc->bdhc", att, v).reshape(B, D, C)
                agg[dst] = agg[dst] + nn.Dense(C, name=f"l{i}_out_{key}")(msg)
            cur = {t: nn.gelu(agg[t]) + cur[t] for t in cur}
            outs.append(cur)
        start = 0 if add_input_feat else 1
        return {
            t: jnp.concatenate([o[t] for o in outs[start:]], axis=-1)
            for t in x_dict
        }


class HeteroSAGE(nn.Module):
    """3-layer conv stack lifted to hetero with sum aggregation
    (reference: model/gnn.py:83-121 ``GNN`` + ``to_hetero``). ``conv_key``
    selects SAGE / GCN / GAT per the reference factory's choices."""

    hidden_dim: int
    out_dim: int
    conv_key: str = "SAGE"  # 'SAGE' | 'GCN' | 'GAT'

    def _conv(self, d, name):
        if self.conv_key == "SAGE":
            return DenseSAGEConv(d, name=name)
        if self.conv_key == "GCN":
            return DenseGCNConv(d, name=name)
        if self.conv_key == "GAT":
            return DenseGATConv(d, name=name)
        raise ValueError("ConvKey can only be GAT, GCN or SAGE.")

    @nn.compact
    def __call__(self, x_dict, graph, add_input_feat: bool = False):
        adj = _adj_dict(graph)
        dims = [self.hidden_dim, self.hidden_dim, self.out_dim]
        cur = x_dict
        for i, d in enumerate(dims):
            p_new = self._conv(d, f"l{i}_qp")(
                cur["query"], cur["product"], adj["qp"]
            ) + self._conv(d, f"l{i}_pp")(
                cur["product"], cur["product"], adj["pp"]
            )
            q_new = self._conv(d, f"l{i}_pq")(
                cur["product"], cur["query"], adj["pq"]
            )
            cur = {"query": nn.relu(q_new), "product": nn.relu(p_new)}
        return cur
