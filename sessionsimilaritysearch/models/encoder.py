"""Session encoders: the model zoo's top level.

Re-designs of model/model.py:174-351 plus the text-only baseline encoder
(QAEA_Linear, model/model.py:75-103). Encoders consume a batched
``SessionGraph`` (data/graph.py) and emit fixed-length session embeddings;
all shapes are static, so one jit covers corpus embedding, training and
query encoding.
"""

from __future__ import annotations

from typing import Optional

from sessionsimilaritysearch import nn
import jax.numpy as jnp

from sessionsimilaritysearch.config import Config
from sessionsimilaritysearch.models.embedding import (
    NodeAsinEmbedding,
    NodeTextTransformer,
    TextEncoder,
)
from sessionsimilaritysearch.models.gnn import HGT, HeteroGGNN, HeteroSAGE
from sessionsimilaritysearch.models.heads import CrossAttentionTransformer
from sessionsimilaritysearch.models.pooling import (
    AttentionPooling,
    GraphPooling,
    PositionalAttentionPooling,
    RecencySRGNNPooling,
    SRGNNPooling,
    masked_mean,
)


def _embed_nodes(embedder, ids, typ, att, get_token=False, deterministic=True):
    """Run a text embedder over a [B, N, T] token grid -> [B, N, d]."""
    B, N, T = ids.shape
    flat = lambda x: x.reshape(B * N, T)
    if isinstance(embedder, NodeTextTransformer):
        out = embedder(flat(ids), flat(att), deterministic=deterministic)
        tok = None
    else:
        out = embedder(
            flat(ids), flat(typ), flat(att), get_token=get_token,
            deterministic=deterministic,
        )
        if get_token:
            out, tok = out
            tok = tok.reshape(B, N, T, -1)
    out = out.reshape(B, N, -1)
    if get_token:
        return out, tok
    return out


class NodeLevelEncoder(nn.Module):
    """Embedders -> GNN -> per-node embeddings (model/model.py:174-190)."""

    query_node_embedder: nn.Module
    product_node_embedder: nn.Module
    gnn: nn.Module

    def __call__(self, graph, deterministic: bool = True):
        emb = {
            "query": _embed_nodes(
                self.query_node_embedder,
                graph.query_input_ids,
                graph.query_type_ids,
                graph.query_attention_mask,
                deterministic=deterministic,
            ),
            "product": self.product_node_embedder(graph.product_asin),
        }
        return self.gnn(emb, graph)


class GraphLevelEncoder(nn.Module):
    """The two-pool session encoder (reference: model/model.py:192-260).

    query nodes <- text embedder; product nodes <- concat(asin-id embedding,
    title text embedding) (``use_id_embedding`` toggle); optional node-mask
    multiply (node-masking pretraining); hetero GNN; separate query/product
    poolings; output = concat(query_emb, product_emb).
    """

    query_node_embedder: nn.Module
    product_node_embedder: nn.Module
    gnn: nn.Module
    product_pooling: nn.Module
    query_pooling: nn.Module
    use_id_embedding: bool = True

    def embed_texts(self, ids, typ, att, deterministic: bool = True):
        """Text backbone over bare [N, T] token rows — the builder hook for
        the catalog title-embedding cache (see ``title_table`` below)."""
        return self.query_node_embedder(
            ids, typ, att, deterministic=deterministic
        )

    def __call__(
        self,
        graph,
        query_node_mask=None,
        product_node_mask=None,
        get_node: bool = False,
        deterministic: bool = True,
        title_table=None,
        query_table=None,
        query_kw=None,
    ):
        """``title_table``: optional [asin_num, d_text] catalog of
        precomputed title embeddings (built via :meth:`embed_texts` over the
        canonical catalog titles). When given, product node text embeddings
        become a gather by ``graph.product_asin`` instead of a text-encoder
        pass — titles repeat across sessions, so corpus builds skip almost
        all text-encoder FLOPs (with ignore_query only the constant root
        query node still runs it). Identical output to the uncached path
        when catalog titles match the session titles (tests/test_models.py).
        Pass the table as a traced argument, never a closure capture.

        ``query_table`` + ``query_kw``: the same trick for the QUERY node
        store — a [n_keywords, d_text] table of precomputed keyword
        embeddings and a [B, Q] id grid mapping each query node to its
        table row (search keywords repeat across sessions exactly like
        titles; the query node embedding depends only on its token row —
        positions enter at the poolings — so the gather is exact). Built
        with :func:`evalharness.harness.build_keyword_table`. Requires
        ``title_table`` too: together they remove the text backbone from
        the serving forward entirely."""
        Q = graph.query_input_ids.shape[1]
        if query_table is not None:
            assert title_table is not None and query_kw is not None, (
                "query_table requires title_table and query_kw (the fully "
                "cached serving forward)"
            )
            emb = {"query": jnp.take(query_table, query_kw, axis=0)}
            b = jnp.take(title_table, graph.product_asin, axis=0)
        elif title_table is not None:
            emb = {
                "query": _embed_nodes(
                    self.query_node_embedder,
                    graph.query_input_ids,
                    graph.query_type_ids,
                    graph.query_attention_mask,
                    deterministic=deterministic,
                )
            }
            b = jnp.take(title_table, graph.product_asin, axis=0)
        else:
            # one fused text pass over both node stores (same embedder
            # params; a single [B*(Q+P), T] pass uses the matmul units better
            # than two smaller ones)
            both = _embed_nodes(
                self.query_node_embedder,
                jnp.concatenate(
                    [graph.query_input_ids, graph.product_input_ids], axis=1
                ),
                jnp.concatenate(
                    [graph.query_type_ids, graph.product_type_ids], axis=1
                ),
                jnp.concatenate(
                    [graph.query_attention_mask,
                     graph.product_attention_mask],
                    axis=1,
                ),
                deterministic=deterministic,
            )
            emb = {"query": both[:, :Q]}
            b = both[:, Q:]
        if self.use_id_embedding:
            a = self.product_node_embedder(graph.product_asin)
            emb["product"] = jnp.concatenate([a, b], axis=-1)
        else:
            emb["product"] = b

        # random node-masking for pretraining (model/model.py:215-218)
        if query_node_mask is not None:
            emb["query"] = emb["query"] * query_node_mask[..., None]
        if product_node_mask is not None:
            emb["product"] = emb["product"] * product_node_mask[..., None]
        # zero padded rows (nonexistent nodes in the reference's ragged form)
        emb["query"] = emb["query"] * graph.query_node_mask[..., None]
        emb["product"] = emb["product"] * graph.product_node_mask[..., None]

        node_emb = self.gnn(emb, graph)

        query_embedding = self.query_pooling(
            node_emb["query"], graph.query_node_mask, graph,
            deterministic=deterministic,
        )
        product_embedding = self.product_pooling(
            node_emb["product"], graph.product_node_mask, graph,
            deterministic=deterministic,
        )
        graph_embedding = jnp.concatenate(
            [query_embedding, product_embedding], axis=-1
        )
        if get_node:
            return graph_embedding, node_emb, None
        return graph_embedding


class UnifyPoolingGraphLevelEncoder(nn.Module):
    """Single-pooling variant (reference: model/model.py:263-351): one
    PositionalAttentionPooling over the union of node types, with an
    optional cross-attention token branch for the token-level losses.

    NOTE: initialize with ``get_token=True`` if the token branch will ever
    be used -- parameters exist only for branches traced at init.
    """

    query_node_embedder: nn.Module
    product_node_embedder: nn.Module
    gnn: nn.Module
    pooling: nn.Module
    cross_attention_transformer: Optional[nn.Module] = None
    use_id_embedding: bool = True

    def embed_texts(self, ids, typ, att, deterministic: bool = True):
        """Text backbone over bare [N, T] token rows — the builder hook for
        the catalog title/keyword tables (GraphLevelEncoder.embed_texts
        twin, used by evalharness.harness.build_title_table)."""
        return self.query_node_embedder(
            ids, typ, att, deterministic=deterministic
        )

    def __call__(
        self,
        graph,
        query_node_mask=None,
        product_node_mask=None,
        get_node: bool = False,
        get_token: bool = False,
        deterministic: bool = True,
        title_table=None,
        query_table=None,
        query_kw=None,
    ):
        """``title_table``/``query_table``+``query_kw``: precomputed text
        embedding catalogs (GraphLevelEncoder.__call__ semantics) — node
        text embeddings become gathers instead of text-encoder passes.
        The PRETRAIN payoff: the text backbone is frozen by construction
        (TextEncoder.freeze stop_gradient, reference .detach()
        model/NodeEmbedding.py:115), so under the default pretrain config
        its per-step forward recomputes a constant function of the token
        rows — ~70%% of the step's FLOPs at flagship dims (measured:
        examples/mfu_sweep.py). Incompatible with ``get_token`` (the token
        branch needs true per-token embeddings)."""
        emb, tok = {}, {}
        Q = graph.query_input_ids.shape[1]
        if title_table is not None:
            assert not get_token, (
                "cached text tables cannot serve the token branch "
                "(token_w>0 needs real token embeddings)"
            )
            b = jnp.take(title_table, graph.product_asin, axis=0)
            if query_table is not None:
                assert query_kw is not None, "query_table needs query_kw"
                emb["query"] = jnp.take(query_table, query_kw, axis=0)
            else:
                emb["query"] = _embed_nodes(
                    self.query_node_embedder,
                    graph.query_input_ids,
                    graph.query_type_ids,
                    graph.query_attention_mask,
                    deterministic=deterministic,
                )
        else:
            both, both_tok = _embed_nodes(
                self.query_node_embedder,
                jnp.concatenate(
                    [graph.query_input_ids, graph.product_input_ids], axis=1
                ),
                jnp.concatenate(
                    [graph.query_type_ids, graph.product_type_ids], axis=1
                ),
                jnp.concatenate(
                    [graph.query_attention_mask,
                     graph.product_attention_mask],
                    axis=1,
                ),
                get_token=True,
                deterministic=deterministic,
            )
            emb["query"], tok["query"] = both[:, :Q], both_tok[:, :Q]
            b, tok["product"] = both[:, Q:], both_tok[:, Q:]
        if self.use_id_embedding:
            a = self.product_node_embedder(graph.product_asin)
            emb["product"] = jnp.concatenate([a, b], axis=-1)
        else:
            emb["product"] = b

        if query_node_mask is not None:
            emb["query"] = emb["query"] * query_node_mask[..., None]
        if product_node_mask is not None:
            emb["product"] = emb["product"] * product_node_mask[..., None]
        emb["query"] = emb["query"] * graph.query_node_mask[..., None]
        emb["product"] = emb["product"] * graph.product_node_mask[..., None]

        node_emb = self.gnn(emb, graph, add_input_feat=True)

        token_emb = {}
        if get_token and self.cross_attention_transformer is not None:
            # token branch (reference :322-333; disabled-by-default upstream)
            B, P, T, D = tok["product"].shape
            token_emb["product"] = self.cross_attention_transformer(
                node_emb["product"].reshape(B * P, -1),
                tok["product"].reshape(B * P, T, D),
                (graph.product_attention_mask == 0).reshape(B * P, T),
                deterministic=deterministic,
            ).reshape(B, P, T, D)
            Q = tok["query"].shape[1]
            token_emb["query"] = self.cross_attention_transformer(
                node_emb["query"].reshape(B * Q, -1),
                tok["query"].reshape(B * Q, T, D),
                (graph.query_attention_mask == 0).reshape(B * Q, T),
                deterministic=deterministic,
            ).reshape(B, Q, T, D)

        graph_embedding = self.pooling(
            node_emb["query"], node_emb["product"], graph,
            deterministic=deterministic,
        )
        if not get_node and not get_token:
            return graph_embedding
        if get_node and not get_token:
            return graph_embedding, node_emb
        if get_token and not get_node:
            return graph_embedding, token_emb
        return graph_embedding, node_emb, token_emb


class TextSessionEncoder(nn.Module):
    """Text-only session encoder (the QAEA_Linear baseline,
    reference: model/model.py:75-103): frozen text encoder over each
    sentence, masked token mean inside the encoder, mean over the session's
    sentences, optional trainable Linear."""

    text_encoder: nn.Module
    n_out: Optional[int] = None

    @nn.compact
    def __call__(self, graph, deterministic: bool = True):
        sent = _embed_nodes(
            self.text_encoder,
            graph.text_input_ids,
            graph.text_type_ids,
            graph.text_attention_mask,
            deterministic=deterministic,
        )  # [B, TXT, d]
        emb = masked_mean(sent, graph.text_node_mask)
        if self.n_out is not None:
            emb = nn.Dense(self.n_out, name="lin")(emb)
        return emb


# ---------------------------------------------------------------------------
# Factories wiring the zoo per the reference drivers
# ---------------------------------------------------------------------------

def build_text_backbone(cfg: Config, nout: Optional[int] = None) -> TextEncoder:
    return TextEncoder(
        vocab_size=cfg.vocab_size,
        d_model=cfg.text_encoder_dim,
        nhead=cfg.query_embedder_nhead,
        nhid=cfg.query_embedder_nhid,
        nlayers=2,
        max_len=cfg.token_len,
        nout=nout,
    )


def build_graph_encoder(cfg: Config) -> GraphLevelEncoder:
    """Two-pool flagship (the 'HGGNN-SrGNNPooling' configuration implied by
    config.py:62): text backbone + asin ids -> HeteroGGNN -> SRGNN product
    pooling + attention query pooling -> 2*gnn_nout embedding."""
    poolings = {
        "srgnn": SRGNNPooling,
        "recency": RecencySRGNNPooling,  # learned STAN-style decay stream
    }
    return GraphLevelEncoder(
        query_node_embedder=build_text_backbone(cfg),
        product_node_embedder=NodeAsinEmbedding(cfg.asin_num, cfg.emb_len),
        gnn=HeteroGGNN(cfg.gnn_nhid, cfg.gnn_nlayers),
        product_pooling=poolings[cfg.product_pooling](cfg.gnn_nout),
        query_pooling=AttentionPooling(cfg.gnn_nout),
    )


def build_pretrain_encoder(cfg: Config) -> UnifyPoolingGraphLevelEncoder:
    """The pretrainer's encoder (pretrain_filtered_amazon.py:262-287):
    frozen text embedder (no id embedding: use_id_embedding=False, :287) +
    HeteroGGNN(gnn_nout) + PositionalAttentionPooling(out=2*gnn_nout) +
    CrossAttentionTransformer(3 layers, K=2)."""
    return UnifyPoolingGraphLevelEncoder(
        query_node_embedder=build_text_backbone(cfg),
        product_node_embedder=NodeAsinEmbedding(cfg.asin_num, cfg.emb_len),
        gnn=HeteroGGNN(cfg.gnn_nout, cfg.gnn_nlayers),
        pooling=PositionalAttentionPooling(cfg.session_emb_dim, cfg.max_seq_len),
        cross_attention_transformer=CrossAttentionTransformer(
            nlayers=3,
            node_emb_K=2,
            token_dim=cfg.text_encoder_dim,
            nhead=cfg.query_embedder_nhead,
            nhid=cfg.query_embedder_nhid,
            dropout=0.0,
        ),
        use_id_embedding=False,
    )


def build_text_session_encoder(cfg: Config) -> TextSessionEncoder:
    return TextSessionEncoder(
        text_encoder=build_text_backbone(cfg), n_out=cfg.n_out
    )
