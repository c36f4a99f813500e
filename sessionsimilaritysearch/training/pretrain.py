"""Pretraining driver (reference: pretrain_filtered_amazon.py).

``PretrainModel`` bundles the UnifyPooling encoder with the ten heads of the
reference pretrainer (:290-299) and the separately-optimized target asin
embedding (:262, :328) into one module / one parameter tree. The loss
menu reproduces :417-490: the active objective is the next-product asin BCE,
with every auxiliary (all-product, next/cur query, next/cur title, qaea
distillation, node reconstruction, token ELECTRA, contrastive augmentation)
available behind its config weight -- auxiliaries with zero weight are not
traced at all, so they cost nothing.

Device shape: one jitted ``train_step`` over a data-parallel mesh; the asin
tables shard row-wise (parallel/sharding.py) so the [B, 200] x [200, 391k]
logit matmuls of the product losses run as per-shard partials.

Design deviation from upstream, by necessity: the reference's frozen
pretrained text encoder ("QAEA") has no public checkpoint, so the encoder's
own (frozen) text backbone doubles as the target text embedder -- one
consistent embedding space instead of three copies of the same checkpoint.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

from sessionsimilaritysearch import nn
import jax
import jax.numpy as jnp
import numpy as np

from sessionsimilaritysearch.config import Config
from sessionsimilaritysearch.data.graph import SessionGraph
from sessionsimilaritysearch.models.embedding import NodeAsinEmbedding
from sessionsimilaritysearch.models.encoder import (
    _embed_nodes,
    build_pretrain_encoder,
)
from sessionsimilaritysearch.models.heads import MLP
from sessionsimilaritysearch.models.pooling import masked_mean
from sessionsimilaritysearch.training import losses
from sessionsimilaritysearch.training.train_state import (
    TrainState,
    adam_with_clip,
    create_train_state,
)


class PretrainModel(nn.Module):
    """Encoder + heads + target embeddings (pretrain_filtered_amazon.py:262-299)."""

    cfg: Config

    def setup(self):
        cfg = self.cfg
        gnn_out = cfg.session_emb_dim
        node_out_dim = cfg.gnn_nlayers * cfg.gnn_nout + cfg.text_encoder_dim
        self.encoder = build_pretrain_encoder(cfg)
        self.target_asin_embedding = nn.Embed(
            cfg.asin_num, cfg.emb_len, name="target_asin_embedding"
        )
        self.next_product_head = MLP(cfg.emb_len, cfg.ph_nhid, cfg.ph_nlayers,
                                     cfg.ph_dropout, name="next_product_head")
        self.all_product_head = MLP(cfg.emb_len, cfg.ph_nhid, cfg.ph_nlayers,
                                    cfg.ph_dropout, name="all_product_head")
        self.next_query_head = MLP(cfg.text_encoder_dim, cfg.qh_nhid,
                                   cfg.qh_nlayers, cfg.qh_dropout,
                                   name="next_query_head")
        self.all_query_head = MLP(cfg.text_encoder_dim, cfg.qh_nhid,
                                  cfg.qh_nlayers, cfg.qh_dropout,
                                  name="all_query_head")
        self.next_title_head = MLP(cfg.text_encoder_dim, cfg.text_encoder_dim,
                                   2, cfg.qh_dropout, name="next_title_head")
        self.all_title_head = MLP(cfg.text_encoder_dim, cfg.text_encoder_dim,
                                  2, cfg.qh_dropout, name="all_title_head")
        self.qaea_head = MLP(cfg.text_encoder_dim, 2000, 2, 0.0, name="qaea_head")
        self.query_node_head = MLP(cfg.text_encoder_dim, cfg.text_encoder_dim,
                                   2, 0.0, name="query_node_head")
        self.product_node_head = MLP(cfg.text_encoder_dim, cfg.text_encoder_dim,
                                     2, 0.0, name="product_node_head")
        self.token_electra_head = nn.Dense(1, name="token_electra_head")

    @property
    def _target_text_embedder(self):
        # shared frozen text backbone (see module docstring)
        return self.encoder.query_node_embedder

    def _embed_targets(self, ids, typ, att, deterministic):
        return _embed_nodes(
            self._target_text_embedder, ids, typ, att, deterministic=deterministic
        )

    def encode(self, graph: SessionGraph, deterministic: bool = True):
        """Plain session embedding (for corpus building / serving)."""
        return self.encoder(graph, deterministic=deterministic)

    def __call__(
        self,
        graph: SessionGraph,
        rng,
        view_graph: Optional[SessionGraph] = None,
        deterministic: bool = False,
        tables: Optional[dict] = None,
    ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
        """``tables``: optional cached-text catalogs
        ``{"title_table": [asin_num, d_text], "query_table": [n_kw, d_text]
        (optional), "query_kw": [B, Q] (with query_table)}`` — the text
        backbone is frozen (stop_gradient + zero weight decay), so its
        per-step forward is a constant function of the token rows;
        serving-style gather tables make the training step skip it
        entirely (bit-identical loss, tests/test_pretrain.py; ~2.4x step
        at flagship dims, examples/mfu_sweep.py). Requires every
        token-consuming auxiliary weight (qh/pt/qaea/node/token) to be 0 —
        exactly the reference's active configuration
        (pretrain_filtered_amazon.py:473-490)."""
        cfg = self.cfg
        if tables is not None:
            assert cfg.qh_w == 0 and cfg.pt_w == 0 and cfg.qaea_w == 0 \
                and cfg.node_w == 0 and cfg.token_w == 0, (
                "cached text tables serve only the active next-product "
                "objective; token-consuming auxiliaries need the real "
                "text forward"
            )
        r_qmask, r_pmask, r_neg1, r_neg2, r_tok = jax.random.split(rng, 5)

        # random node keep-masks (pretrain_filtered_amazon.py:418-419)
        qmask = (
            jax.random.uniform(r_qmask, graph.query_node_mask.shape)
            > cfg.node_mask_prob
        ).astype(jnp.float32)
        pmask = (
            jax.random.uniform(r_pmask, graph.product_node_mask.shape)
            > cfg.node_mask_prob
        ).astype(jnp.float32)

        want_token = cfg.token_w > 0
        enc_graph = graph
        if want_token:
            # replaced-token-detection corruption: mask tokens in both node
            # stores before encoding (pretrain_filtered_amazon.py:31-45; the
            # reference's generator-sampling stage is disabled upstream, so
            # plain [MASK] corruption is the faithful active behavior)
            r_tok, r_tok2 = jax.random.split(r_tok)
            q_corrupt = losses.make_token_mask(
                r_tok, graph.query_input_ids, cfg.mask_token_ratio
            )
            p_corrupt = losses.make_token_mask(
                r_tok2, graph.product_input_ids, cfg.mask_token_ratio
            )
            enc_graph = graph._replace(
                query_input_ids=jnp.where(q_corrupt, 4, graph.query_input_ids),
                product_input_ids=jnp.where(p_corrupt, 4, graph.product_input_ids),
            )
        out = self.encoder(
            enc_graph, qmask, pmask, get_node=True, get_token=want_token,
            deterministic=deterministic,
            **(tables or {}),
        )
        if want_token:
            embedding, node_emb, token_emb = out
        else:
            embedding, node_emb = out
            token_emb = None

        metrics: Dict[str, jnp.ndarray] = {}
        table = self.target_asin_embedding.embedding  # [A, emb_len]

        # --- active objective (:441, :473)
        next_rep = self.next_product_head(embedding, deterministic=deterministic)
        next_product_loss = losses.product_asin_loss(
            r_neg1, next_rep, table, graph.product_target_y,
            graph.product_target_mask, cfg.neg_sample_count,
        )
        metrics["next_product_loss"] = next_product_loss
        loss = next_product_loss

        # --- weighted auxiliaries (skipped entirely at weight 0)
        if cfg.ph_w > 0:
            all_rep = self.all_product_head(embedding, deterministic=deterministic)
            all_product_loss = losses.product_asin_loss(
                r_neg2, all_rep, table, graph.product_asin,
                graph.product_node_mask, cfg.neg_sample_count,
            )
            metrics["all_product_loss"] = all_product_loss
            loss = loss + cfg.ph_w * next_product_loss + 2 * cfg.ph_w * all_product_loss

        if cfg.qh_w > 0:
            qt_emb = self._embed_targets(
                graph.query_target_input_ids, graph.query_target_type_ids,
                graph.query_target_attention_mask, deterministic,
            )
            nq = losses.all_text_embedding_loss(
                self.next_query_head(embedding, deterministic=deterministic),
                qt_emb, graph.query_target_node_mask, graph.query_target_mask,
            )
            q_emb = self._embed_targets(
                graph.query_input_ids, graph.query_type_ids,
                graph.query_attention_mask, deterministic,
            )
            cq = losses.all_text_embedding_loss(
                self.all_query_head(embedding, deterministic=deterministic),
                q_emb, graph.query_node_mask, graph.query_loss_mask,
            )
            metrics["next_query_loss"], metrics["cur_query_loss"] = nq, cq
            loss = loss + cfg.qh_w * (nq + cq)

        if cfg.pt_w > 0:
            nt_emb = self._embed_targets(
                graph.product_target_input_ids, graph.product_target_type_ids,
                graph.product_target_attention_mask, deterministic,
            )
            nt = losses.all_text_embedding_loss(
                self.next_title_head(embedding, deterministic=deterministic),
                nt_emb, graph.product_target_mask,
            )
            t_emb = self._embed_targets(
                graph.product_input_ids, graph.product_type_ids,
                graph.product_attention_mask, deterministic,
            )
            ct = losses.all_text_embedding_loss(
                self.all_title_head(embedding, deterministic=deterministic),
                t_emb, graph.product_node_mask,
            )
            metrics["next_title_loss"], metrics["cur_title_loss"] = nt, ct
            loss = loss + cfg.pt_w * (nt + ct)

        if cfg.qaea_w > 0:
            # distill toward the frozen text embedding of the whole-session
            # text (:449-458)
            label = self._embed_targets(
                graph.text_input_ids, graph.text_type_ids,
                graph.text_attention_mask, deterministic,
            )
            label = masked_mean(label, graph.text_node_mask)
            qaea_loss = losses.qaea_distill_loss(
                self.qaea_head(embedding, deterministic=deterministic), label
            )
            metrics["qaea_loss"] = qaea_loss
            loss = loss + cfg.qaea_w * qaea_loss

        if cfg.node_w > 0:
            q_feat = self._embed_targets(
                graph.query_input_ids, graph.query_type_ids,
                graph.query_attention_mask, deterministic,
            )
            p_feat = self._embed_targets(
                graph.product_input_ids, graph.product_type_ids,
                graph.product_attention_mask, deterministic,
            )
            qn = losses.node_reconstruction_loss(
                self.query_node_head(
                    node_emb["query"].reshape(-1, node_emb["query"].shape[-1]),
                    deterministic=deterministic,
                ).reshape(q_feat.shape),
                q_feat, qmask, graph.query_node_mask,
            )
            pn = losses.node_reconstruction_loss(
                self.product_node_head(
                    node_emb["product"].reshape(-1, node_emb["product"].shape[-1]),
                    deterministic=deterministic,
                ).reshape(p_feat.shape),
                p_feat, pmask, graph.product_node_mask,
            )
            metrics["query_node_loss"], metrics["product_node_loss"] = qn, pn
            loss = loss + cfg.node_w * (qn + pn)

        if want_token:
            q_pred = jax.nn.sigmoid(
                self.token_electra_head(token_emb["query"])
            )[..., 0]
            p_pred = jax.nn.sigmoid(
                self.token_electra_head(token_emb["product"])
            )[..., 0]
            token_loss = losses.electra_loss(
                q_pred, enc_graph.query_input_ids, graph.query_input_ids,
                graph.query_attention_mask,
            ) + losses.electra_loss(
                p_pred, enc_graph.product_input_ids, graph.product_input_ids,
                graph.product_attention_mask,
            )
            metrics["token_loss"] = token_loss
            loss = loss + cfg.token_w * token_loss

        if cfg.ctv_w > 0 and view_graph is not None:
            view_emb = self.encoder(view_graph, deterministic=deterministic)
            ctv = losses.contrastive_loss(embedding, view_emb)
            metrics["ctv_loss"] = ctv
            loss = loss + cfg.ctv_w * ctv

        metrics["loss"] = loss
        return loss, metrics

    def retrieval_metrics(self, graph: SessionGraph, k: int = 20):
        """Next-product top-K precision/recall
        (train_subsession_embedding.py:318-339)."""
        embedding = self.encoder(graph, deterministic=True)
        rep = self.next_product_head(embedding, deterministic=True)
        return losses.product_asin_precision_recall(
            rep, self.target_asin_embedding.embedding,
            graph.product_target_y, graph.product_target_mask, k,
        )


def make_train_step(model: PretrainModel, has_view: bool):
    """One jitted pretrain step: grads of the composite loss, global-norm
    clip, Adam (the reference's optimizer2+optimizer3 pair at equal lr
    collapses to one Adam -- both step every iteration, :506-507)."""

    @jax.jit
    def step(state: TrainState, graph: SessionGraph, rng,
             view_graph: Optional[SessionGraph] = None,
             tables: Optional[dict] = None):
        def loss_fn(params):
            variables = {"params": params}
            if state.batch_stats is not None:
                variables["batch_stats"] = state.batch_stats
            (loss, metrics), updates = state.apply_fn(
                variables, graph, rng,
                view_graph if has_view else None,
                deterministic=False,
                tables=tables,
                mutable=["batch_stats"],
                rngs={"dropout": rng},
            )
            return loss, (metrics, updates.get("batch_stats"))

        grads, (metrics, new_bs) = jax.grad(loss_fn, has_aux=True)(state.params)
        state = state.apply_gradients(grads=grads)
        if new_bs is not None:
            state = state.replace(batch_stats=new_bs)
        return state, metrics

    return step


def make_eval_step(model: PretrainModel):
    @jax.jit
    def step(state: TrainState, graph: SessionGraph, rng):
        variables = {"params": state.params}
        if state.batch_stats is not None:
            variables["batch_stats"] = state.batch_stats
        loss, metrics = state.apply_fn(
            variables, graph, rng, None, deterministic=True,
        )
        return metrics

    return step


def make_encode_fn(model: PretrainModel):
    @jax.jit
    def encode(state: TrainState, graph: SessionGraph):
        variables = {"params": state.params}
        if state.batch_stats is not None:
            variables["batch_stats"] = state.batch_stats
        return state.apply_fn(variables, graph, method=model.encode)

    return encode


def create_pretrain_state(cfg: Config, rng, sample_graph: SessionGraph) -> Tuple[
    PretrainModel, TrainState
]:
    model = PretrainModel(cfg)
    tx = adam_with_clip(cfg.lr, cfg.grad_clip_norm, cfg.weight_decay)
    state = create_train_state(
        model, rng, (sample_graph, rng), tx,
        init_kwargs={"deterministic": True},
    )
    return model, state
