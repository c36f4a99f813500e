"""Session / subsession / joint embedding trainers.

Re-designs of the three standalone trainers:

- ``mode='subsession'``: prefix -> predict FUTURE items + NEXT query
  (train_subsession_embedding.py:390-467)
- ``mode='session'``: full session -> predict ALL its items + LAST query
  (train_session_embedding.py:277-352)
- ``JointModel``: two encoders, both query objectives in MLM+ELECTRA form,
  and a contrastive alignment between session and subsession embeddings
  (train_session_subsession_embedding.py:139-296)

Encoder wiring follows train_subsession_embedding.py:405-419: from-scratch
NodeTextTransformer + NodeAsinEmbedding -> hetero SAGE GNN -> mean pooling;
the asin loss scores against the encoder's own product embedding table
(:444 passes graph_encoder.product_node_embedder), unlike the pretrainer's
separate target table.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from sessionsimilaritysearch import nn
import jax
import jax.numpy as jnp

from sessionsimilaritysearch.config import Config
from sessionsimilaritysearch.data.graph import SessionGraph
from sessionsimilaritysearch.models.embedding import (
    NodeAsinEmbedding,
    NodeTextTransformer,
)
from sessionsimilaritysearch.models.encoder import (
    GraphLevelEncoder,
    build_graph_encoder,
)
from sessionsimilaritysearch.models.gnn import HeteroSAGE
from sessionsimilaritysearch.models.heads import MLP, TransformerDecoderHead
from sessionsimilaritysearch.models.pooling import GraphPooling
from sessionsimilaritysearch.models.transformer import causal_mask
from sessionsimilaritysearch.training import losses
from sessionsimilaritysearch.training.train_state import (
    TrainState,
    adam_with_clip,
    create_train_state,
)


def _build_scratch_encoder(cfg: Config) -> GraphLevelEncoder:
    """NodeTextTransformer + asin ids -> HeteroSAGE -> mean poolings
    (train_subsession_embedding.py:405-417)."""
    return GraphLevelEncoder(
        query_node_embedder=NodeTextTransformer(
            ntoken=cfg.vocab_size,
            ninp=cfg.emb_len,
            nhead=cfg.query_embedder_nhead,
            nhid=cfg.query_embedder_nhid,
            nlayers=cfg.query_embedder_nlayers,
            dropout=cfg.query_embedder_dropout,
        ),
        product_node_embedder=NodeAsinEmbedding(cfg.asin_num, cfg.emb_len),
        gnn=HeteroSAGE(cfg.gnn_nhid, cfg.gnn_nout),
        product_pooling=GraphPooling("mean", cfg.gnn_pooling_out, cfg.gnn_dropout),
        query_pooling=GraphPooling("mean", cfg.gnn_pooling_out, cfg.gnn_dropout),
        use_id_embedding=True,
    )


class SessionEmbeddingModel(nn.Module):
    """One encoder + product head + query decoder, trained on either the
    subsession (next-*) or session (all-/last-*) objectives."""

    cfg: Config
    mode: str = "subsession"  # 'subsession' | 'session'
    query_loss_style: str = "autoregressive"  # or 'mlm_electra'
    # 'scratch' = NodeTextTransformer/HeteroSAGE (the reference subsession
    # trainer's shape, train_subsession_embedding.py:405-417); 'flagship' =
    # build_graph_encoder (TextEncoder backbone + HeteroGGNN + SRGNN
    # pooling, 2*gnn_nout output) -- the production serving encoder, which
    # also supports the catalog title-embedding cache
    encoder_kind: str = "scratch"

    def setup(self):
        cfg = self.cfg
        self.encoder = (
            build_graph_encoder(cfg) if self.encoder_kind == "flagship"
            else _build_scratch_encoder(cfg)
        )
        emb_dim = 2 * cfg.gnn_pooling_out
        self.next_product_head = MLP(
            cfg.emb_len, cfg.ph_nhid, cfg.ph_nlayers, cfg.ph_dropout,
            name="next_product_head",
        )
        self.query_decoder = TransformerDecoderHead(
            ninp=cfg.emb_len,
            nout=cfg.emb_len,
            nhead=cfg.qh_nhead,
            nhid=cfg.qh_nhid,
            nlayers=cfg.qh_nlayers,
            dropout=cfg.qh_dropout,
            name="query_decoder",
        )
        if self.query_loss_style == "mlm_electra":
            # replaced-token-detection decoder (2-way logits per position,
            # train_subsession_embedding.py:232-241)
            self.electra_decoder = TransformerDecoderHead(
                ninp=cfg.emb_len,
                nout=2,
                nhead=cfg.qh_nhead,
                nhid=cfg.qh_nhid,
                nlayers=cfg.qh_nlayers,
                dropout=cfg.qh_dropout,
                name="electra_decoder",
            )
        self.memory_proj = nn.Dense(cfg.emb_len, name="memory_proj")
        if self.encoder_kind == "flagship":
            # the flagship text backbone's token table is
            # [vocab, text_encoder_dim]; the tied-logit query decoder works
            # at emb_len -- bridge with a learned projection
            self.token_table_proj = nn.Dense(
                cfg.emb_len, name="token_table_proj"
            )

    def encode(self, graph: SessionGraph, deterministic: bool = True):
        return self.encoder(graph, deterministic=deterministic)

    def product_rep(self, graph: SessionGraph, deterministic: bool = True):
        emb = self.encoder(graph, deterministic=deterministic)
        return self.next_product_head(emb, deterministic=deterministic)

    def _query_target(self, graph: SessionGraph):
        """Target query tokens: the NEXT query (first future query) for
        subsession mode, the LAST real query node for session mode."""
        if self.mode == "subsession":
            y = graph.query_target_input_ids[:, 0, :]
            y_mask = graph.query_target_attention_mask[:, 0, :].astype(jnp.float32)
            y_mask = y_mask * graph.query_target_mask[:, :1]
        else:
            # last real query node (index = #real nodes - 1; node 0 is root)
            last = jnp.sum(graph.query_node_mask, axis=1).astype(jnp.int32) - 1
            y = jnp.take_along_axis(
                graph.query_input_ids, last[:, None, None], axis=1
            )[:, 0, :]
            att = jnp.take_along_axis(
                graph.query_attention_mask, last[:, None, None], axis=1
            )[:, 0, :].astype(jnp.float32)
            # only sessions with a non-root query contribute
            has_query = (last > 0).astype(jnp.float32)
            y_mask = att * has_query[:, None]
        return y, y_mask

    def __call__(
        self, graph: SessionGraph, rng, deterministic: bool = False
    ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
        cfg = self.cfg
        r_neg, r_tok = jax.random.split(rng)
        embedding = self.encoder(graph, deterministic=deterministic)
        rep = self.next_product_head(embedding, deterministic=deterministic)

        asin_table = self.encoder.product_node_embedder.variables["params"][
            "encoder"
        ]["embedding"]
        if self.mode == "subsession":
            tgt_y, tgt_mask = graph.product_target_y, graph.product_target_mask
        else:
            tgt_y, tgt_mask = graph.product_asin, graph.product_node_mask
        product_loss = losses.product_asin_loss(
            r_neg, rep, asin_table, tgt_y, tgt_mask, cfg.neg_sample_count
        )

        # query generation over the graph-embedding memory
        y, y_mask = self._query_target(graph)
        qvars = self.encoder.query_node_embedder.variables["params"]
        # scratch NodeTextTransformer names its table 'embedding'; the
        # flagship TextEncoder backbone names it 'tok_emb'
        token_table = (
            qvars["tok_emb"]["embedding"] if "tok_emb" in qvars
            else qvars["embedding"]["embedding"]
        )
        if self.encoder_kind == "flagship":
            token_table = self.token_table_proj(token_table)
        memory = self.memory_proj(embedding)[:, None, :]
        if self.query_loss_style == "mlm_electra":
            # MLM stage: decode masked target, logits tied to the token
            # embedding table (train_subsession_embedding.py:205-230)
            r_tok, r_mask = jax.random.split(r_tok)
            masked_y, pred_target = losses.make_mlm_target(
                r_mask, y, y_mask, max(cfg.mask_token_ratio, 0.05), 4
            )
            dec_out = self.query_decoder(
                token_table[masked_y],
                memory,
                tgt_key_padding_mask=(pred_target | (y_mask == 0)),
                deterministic=deterministic,
            )
            logits = dec_out @ token_table.T
            mlm, output = losses.next_query_mlm_loss(logits, y, pred_target)
            # ELECTRA stage over the argmax-infilled sequence (:232-241)
            logits2 = self.electra_decoder(
                token_table[output],
                memory,
                tgt_key_padding_mask=y_mask == 0,
                deterministic=deterministic,
            )
            electra = losses.next_query_electra_loss(logits2, output, y, y_mask)
            query_loss = mlm + electra
        else:
            dec_out = self.query_decoder(
                token_table[y],
                memory,
                tgt_mask=causal_mask(y.shape[1]),
                tgt_key_padding_mask=y_mask == 0,
                deterministic=deterministic,
            )
            query_loss = losses.autoregressive_query_loss(
                r_tok, dec_out, y, y_mask, token_table, cfg.neg_k
            )

        loss = cfg.ph_w * product_loss + cfg.qh_w * query_loss
        if cfg.ph_w == 0 and cfg.qh_w == 0:
            # the reference defaults both weights to 0 (config.py:43-44) and
            # relies on editing config.py; an all-zero objective trains
            # nothing, so fall back to equal weighting.
            loss = product_loss + query_loss
        metrics = {
            "loss": loss,
            "product_loss": product_loss,
            "query_loss": query_loss,
        }
        return loss, metrics

    def retrieval_metrics(self, graph: SessionGraph, k: int = 20):
        rep = self.product_rep(graph)
        asin_table = self.encoder.product_node_embedder.variables["params"][
            "encoder"
        ]["embedding"]
        if self.mode == "subsession":
            tgt_y, tgt_mask = graph.product_target_y, graph.product_target_mask
        else:
            tgt_y, tgt_mask = graph.product_asin, graph.product_node_mask
        return losses.product_asin_precision_recall(
            rep, asin_table, tgt_y, tgt_mask, k
        )


class JointModel(nn.Module):
    """Two encoders aligned by a contrastive loss
    (train_session_subsession_embedding.py:139-160, :296): the session
    encoder sees the full session, the subsession encoder its prefix; the
    same row in each view is the positive pair."""

    cfg: Config
    encoder_kind: str = "scratch"  # see SessionEmbeddingModel.encoder_kind

    def setup(self):
        # both query objectives in MLM+ELECTRA form, per the joint trainer
        # (train_session_subsession_embedding.py:256-294)
        self.session_model = SessionEmbeddingModel(
            self.cfg, mode="session", query_loss_style="mlm_electra",
            encoder_kind=self.encoder_kind, name="session_model",
        )
        self.subsession_model = SessionEmbeddingModel(
            self.cfg, mode="subsession", query_loss_style="mlm_electra",
            encoder_kind=self.encoder_kind, name="subsession_model",
        )

    def __call__(
        self,
        session_graph: SessionGraph,
        subsession_graph: SessionGraph,
        rng,
        deterministic: bool = False,
    ):
        r1, r2 = jax.random.split(rng)
        s_loss, s_metrics = self.session_model(
            session_graph, r1, deterministic=deterministic
        )
        ss_loss, ss_metrics = self.subsession_model(
            subsession_graph, r2, deterministic=deterministic
        )
        s_emb = self.session_model.encode(session_graph, deterministic)
        ss_emb = self.subsession_model.encode(subsession_graph, deterministic)
        ctv = losses.contrastive_loss(ss_emb, s_emb)
        ctv_w = self.cfg.ctv_w if self.cfg.ctv_w > 0 else 1.0
        loss = s_loss + ss_loss + ctv_w * ctv
        metrics = {
            "loss": loss,
            "session_loss": s_loss,
            "subsession_loss": ss_loss,
            "ctv_loss": ctv,
        }
        return loss, metrics


def make_session_train_step(model):
    @jax.jit
    def step(state: TrainState, graph: SessionGraph, rng):
        def loss_fn(params):
            variables = {"params": params}
            if state.batch_stats is not None:
                variables["batch_stats"] = state.batch_stats
            (loss, metrics), updates = state.apply_fn(
                variables, graph, rng, deterministic=False,
                mutable=["batch_stats"], rngs={"dropout": rng},
            )
            return loss, (metrics, updates.get("batch_stats"))

        grads, (metrics, bs) = jax.grad(loss_fn, has_aux=True)(state.params)
        state = state.apply_gradients(grads=grads)
        if bs is not None:
            state = state.replace(batch_stats=bs)
        return state, metrics

    return step


def make_joint_train_step(model):
    @jax.jit
    def step(state: TrainState, session_graph, subsession_graph, rng):
        def loss_fn(params):
            variables = {"params": params}
            if state.batch_stats is not None:
                variables["batch_stats"] = state.batch_stats
            (loss, metrics), updates = state.apply_fn(
                variables, session_graph, subsession_graph, rng,
                deterministic=False, mutable=["batch_stats"],
                rngs={"dropout": rng},
            )
            return loss, (metrics, updates.get("batch_stats"))

        grads, (metrics, bs) = jax.grad(loss_fn, has_aux=True)(state.params)
        state = state.apply_gradients(grads=grads)
        if bs is not None:
            state = state.replace(batch_stats=bs)
        return state, metrics

    return step


def create_session_state(cfg: Config, rng, sample_graph, mode="subsession",
                         encoder_kind="scratch"):
    model = SessionEmbeddingModel(cfg, mode=mode, encoder_kind=encoder_kind)
    tx = adam_with_clip(cfg.lr, cfg.grad_clip_norm, cfg.weight_decay)
    state = create_train_state(
        model, rng, (sample_graph, rng), tx, init_kwargs={"deterministic": True}
    )
    return model, state


def create_joint_state(cfg: Config, rng, sample_session, sample_subsession,
                       encoder_kind: str = "scratch"):
    model = JointModel(cfg, encoder_kind=encoder_kind)
    tx = adam_with_clip(cfg.lr, cfg.grad_clip_norm, cfg.weight_decay)
    state = create_train_state(
        model, rng, (sample_session, sample_subsession, rng), tx,
        init_kwargs={"deterministic": True},
    )
    return model, state
