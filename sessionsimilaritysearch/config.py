"""Configuration registry.

The reference keeps every hyperparameter in one static class ``CFG``
(reference: config.py:1-72) with no CLI. Here the same knob set is a frozen
dataclass so configs are hashable (usable as jit static args), serializable,
and per-experiment instances instead of module-global mutable state.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class GraphDims:
    """Static padded shapes for the dense session-graph representation.

    The reference bounds everything tiny by construction (config.py:5,13,65:
    max_seq_len=20, query_max_len=20, token_len=20), which is exactly what
    makes fixed-shape padding the right accelerator design: every session graph
    becomes a handful of small dense arrays that jit to static shapes.
    """

    max_seq_len: int = 20       # max actions per session
    token_len: int = 20         # tokens per text field
    max_query_nodes: int = 21   # root node + one per search action
    max_product_nodes: int = 20  # distinct products
    max_occurrences: int = 20   # product occurrences (per-click positions)
    max_target_products: int = 20
    max_target_queries: int = 20
    max_text_sentences: int = 21  # root '' + one per action

    def __post_init__(self):
        # a query node exists for the root plus every search action, so the
        # padded store must fit max_seq_len + 1 rows or click edges would be
        # silently misattributed after truncation
        assert self.max_query_nodes >= self.max_seq_len + 1, (
            self.max_query_nodes,
            self.max_seq_len,
        )


@dataclasses.dataclass(frozen=True)
class Config:
    """Canonical hyperparameter registry (parity with reference config.py)."""

    # --- model architecture (reference: config.py:2-30)
    emb_len: int = 200          # token embedding width for from-scratch text enc
    code_len: int = 250         # binary hash code length (bits)
    max_seq_len: int = 20
    mask_token_ratio: float = 0.2
    # query embedder
    ignore_query: bool = True
    query_embedder_nhead: int = 4
    query_embedder_nhid: int = 800
    query_embedder_nlayers: int = 4
    query_embedder_dropout: float = 0.0
    query_max_len: int = 20
    # gnn
    gnn_nhid: int = 800
    gnn_nout: int = 800
    gnn_nhead: int = 4
    gnn_aggr: str = "sum"
    gnn_dropout: float = 0.0
    gnn_pooling_out: int = 400
    gnn_nlayers: int = 3
    # product readout of the two-pool flagship encoder: 'srgnn' (reference
    # model/gnn.py:164-181) or 'recency' (SR-GNN + learned STAN-style
    # exponential recency stream -- models/pooling.py RecencySRGNNPooling,
    # built for the overlap-hostile regime where recency is the signal)
    product_pooling: str = "srgnn"
    # product head
    ph_nhid: int = 400
    ph_nlayers: int = 1
    ph_dropout: float = 0.0
    # query head
    qh_nhead: int = 5
    qh_nhid: int = 768
    qh_nlayers: int = 1
    qh_dropout: float = 0.0
    # embedding output
    n_out: int = 500
    text_encoder_dim: int = 768  # frozen text ("QAEA"-class) encoder width

    # --- training (reference: config.py:37-57)
    node_mask_prob: float = 0.05
    batch_size: int = 50
    ft_batch_size: int = 10
    lr: float = 3e-4
    weight_decay: float = 0.0
    ph_w: float = 0.0
    qh_w: float = 0.0
    pt_w: float = 0.0
    ctv_w: float = 0.0
    bin_w: float = 0.3
    qaea_w: float = 0.0
    node_w: float = 0.0
    token_w: float = 0.0
    max_epoch: int = 60
    neg_k: int = 10
    rec_w: float = 1.0
    aux_w: float = 20.0
    max_train_num: int = 1_000_000
    ckpt_iter: int = 500
    mask_prob: float = 0.0
    grad_clip_norm: float = 1.0

    # --- fine-tune (reference: config.py:58-63)
    fine_tune_data_num: int = 10_000
    # Separate lr for the hash-head fine-tune (0.0 = fall back to ``lr``).
    # The reference shares CFG.lr=3e-4 across phases; at that rate the tiny
    # two-tower heads overshoot on small triplet sets (measured: retrieval
    # quality DROPS below the tied-init/simhash starting point), while
    # 10x lower trains past it (examples/binary_quality.py).
    ft_lr: float = 3e-5
    loss_type: str = "MSE"      # 'MSE' | 'L1'
    sim_type: str = "all_product_type_score"
    fine_tune_epoch: int = 70
    load_path: str = ""

    # --- tokenizer
    token_len: int = 20
    vocab_size: int = 30522

    # --- corpus scale anchors (reference: pretrain_filtered_amazon.py:200)
    asin_num: int = 391_572

    # --- retrieval
    retrieval_k: int = 100
    neg_sample_count: int = 1000  # sampled negatives in asin BCE loss

    # --- runtime
    savedir: str = "runs/default/"
    seed: int = 0
    dtype: str = "bfloat16"      # compute dtype for matmul-heavy paths
    mesh_shape: tuple = ()       # () = all local devices on one axis "data"

    @property
    def dims(self) -> GraphDims:
        return GraphDims(
            max_seq_len=self.max_seq_len,
            token_len=self.token_len,
            max_query_nodes=self.max_seq_len + 1,
            max_product_nodes=self.max_seq_len,
            max_occurrences=self.max_seq_len,
            max_target_products=self.max_seq_len,
            max_target_queries=self.max_seq_len,
            max_text_sentences=self.max_seq_len + 1,
        )

    @property
    def session_emb_dim(self) -> int:
        """Output width of the two-pool GraphLevelEncoder.

        Reference: concat(query_pool, product_pool) = 2*gnn_nout = 1600
        (model/model.py:254 with config.py:16).
        """
        return 2 * self.gnn_nout

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        d = json.loads(s)
        if isinstance(d.get("mesh_shape"), list):
            d["mesh_shape"] = tuple(d["mesh_shape"])
        return cls(**d)


def tiny_test_config(**kw) -> Config:
    """A small config for unit tests / CPU runs."""
    base = dict(
        emb_len=16,
        code_len=32,
        query_embedder_nhead=2,
        query_embedder_nhid=32,
        query_embedder_nlayers=1,
        gnn_nhid=32,
        gnn_nout=32,
        gnn_nlayers=2,
        gnn_pooling_out=16,
        n_out=24,
        text_encoder_dim=32,
        # the query-decoder heads split emb_len across qh_nhead; the full
        # config's 200/5 divides, tiny's 16 needs a matching head count
        qh_nhead=2,
        qh_nhid=32,
        batch_size=4,
        ft_batch_size=4,
        asin_num=1000,
        vocab_size=1000,
        retrieval_k=10,
        neg_sample_count=50,
    )
    base.update(kw)
    return Config(**base)
