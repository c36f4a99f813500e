"""Loss library.

Pure JAX re-implementations of every training objective in the reference,
with the same numerics (clips, weightings, sampled negatives):

- contrastive JS estimator (pretrain_filtered_amazon.py:73-91)
- MLM / ELECTRA token losses (pretrain_filtered_amazon.py:31-69)
- next/all text-embedding BCE (pretrain_filtered_amazon.py:148-190)
- next/all product-asin BCE with sampled negatives
  (train_subsession_embedding.py:271-302, train_session_embedding.py:122-174)
- top-K asin precision/recall (train_subsession_embedding.py:318-339)
- pairwise / matrix / triplet similarity losses (fine_tune_ours.py:99-153)
- binary regularizer (util_amazon_filtered.py:25-26)
- aux-consistency and normalized-reconstruction losses
  (fine_tune_ours.py:494-534)
- masked-node reconstruction (pretrain_filtered_amazon.py:431-438)
- QAEA distillation (pretrain_filtered_amazon.py:449-458)

All functions are shape-polymorphic over a leading batch axis and contain no
Python branching on traced values, so they jit and shard cleanly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import optax


def _clipped_norm_rows(x, eps=1e-6):
    return x / jnp.sqrt(jnp.clip(jnp.sum(x * x, axis=1, keepdims=True), eps, None))


def cosine_similarity(a, b, axis=-1, eps=1e-8):
    """torch.F.cosine_similarity parity (per-row)."""
    an = jnp.linalg.norm(a, axis=axis)
    bn = jnp.linalg.norm(b, axis=axis)
    return jnp.sum(a * b, axis=axis) / jnp.clip(an * bn, eps, None)


def contrastive_loss(view1, view2):
    """JS-style contrastive estimator (pretrain_filtered_amazon.py:73-91):
    normalized cosine score matrix clipped to [1e-4, 0.9999]; off-diagonal
    log(1-s); diagonal 10*log(s); normalized by B^2 + 9B."""
    n1 = _clipped_norm_rows(view1)
    n2 = _clipped_norm_rows(view2)
    score = jnp.clip(n1 @ n2.T, 1e-4, 0.9999)
    b = view1.shape[0]
    eye = jnp.eye(b, dtype=score.dtype)
    js = jnp.log(1.0 - score) * (1.0 - eye) + 10.0 * jnp.log(score) * eye
    return -jnp.sum(js) / (b * b + 9 * b)


def binary_regularize(out):
    """Push embeddings to +-1 (util_amazon_filtered.py:25-26)."""
    return jnp.mean(jnp.abs(1.0 - jnp.abs(out)))


# ---------------------------------------------------------------------------
# Token-level losses (MLM / ELECTRA)
# ---------------------------------------------------------------------------

def make_token_mask(rng, input_ids, mask_ratio, min_maskable_id: int = 5):
    """Random maskable-token selection
    (pretrain_filtered_amazon.py:31-45: rand < ratio AND id >= 5)."""
    r = jax.random.uniform(rng, input_ids.shape)
    return (r < mask_ratio) & (input_ids >= min_maskable_id)


def mlm_loss(logits, gt_ids, token_mask):
    """CE over masked positions (pretrain_filtered_amazon.py:56-62).
    logits [..., T, V]; gt_ids/token_mask [..., T]."""
    ce = optax.softmax_cross_entropy_with_integer_labels(logits, gt_ids)
    m = token_mask.astype(ce.dtype)
    return jnp.sum(ce * m) / jnp.clip(jnp.sum(m), 1.0, None)


def electra_loss(pred, input_ids, gt_ids, valid_mask=None):
    """Replaced-token-detection BCE (pretrain_filtered_amazon.py:64-69).
    pred in (0,1), same shape as ids.

    Intentional deviation: when ``valid_mask`` is given (the pretrain driver
    passes the attention mask), padded positions are EXCLUDED from the mean,
    whereas the reference's ElectraLoss averages BCE over all positions
    including padding. Averaging over padding dilutes the signal with
    trivially-classified positions and couples the loss scale to pad length;
    masking is a strict improvement. Pass ``valid_mask=None`` for bit-level
    parity with upstream."""
    label = (input_ids != gt_ids).astype(pred.dtype)
    p = jnp.clip(pred, 1e-7, 1.0 - 1e-7)
    bce = -(label * jnp.log(p) + (1.0 - label) * jnp.log(1.0 - p))
    if valid_mask is None:
        return jnp.mean(bce)
    m = valid_mask.astype(bce.dtype)
    return jnp.sum(bce * m) / jnp.clip(jnp.sum(m), 1.0, None)


# ---------------------------------------------------------------------------
# Text-embedding target losses
# ---------------------------------------------------------------------------

def next_text_embedding_loss(rep, target, valid_mask):
    """One target row per graph (pretrain_filtered_amazon.py:148-162):
    val = sigmoid(rep @ target.T) [B, B]; y = diag(valid); mean BCE."""
    val = jax.nn.sigmoid(rep @ target.T)
    val = jnp.clip(val, 1e-7, 1.0 - 1e-7)
    y = jnp.diag(valid_mask.astype(val.dtype))
    loss_mat = -(y * jnp.log(val) + (1.0 - y) * jnp.log(1.0 - val))
    return jnp.mean(loss_mat)


def all_text_embedding_loss(rep, targets, node_mask, valid_mask=None):
    """Batch-membership BCE over a padded target store
    (pretrain_filtered_amazon.py:165-190).

    rep [B, d]; targets [B, T, d] (embedded target texts per graph);
    node_mask [B, T] marks real rows; valid_mask [B, T] marks rows allowed
    as positives (defaults to node_mask). Membership entries with
    valid_mask=0 are excluded from the loss (the reference's loss_mask);
    padded rows are excluded everywhere (they don't exist upstream).
    """
    if valid_mask is None:
        valid_mask = node_mask
    B, T, d = targets.shape
    flat = targets.reshape(B * T, d)
    val = jax.nn.sigmoid(rep @ flat.T)  # [B, B*T]
    val = jnp.clip(val, 1e-7, 1.0 - 1e-7)
    col_graph = jnp.repeat(jnp.arange(B), T)[None, :]  # [1, B*T]
    member = (col_graph == jnp.arange(B)[:, None]).astype(val.dtype)
    y = member
    exists = jnp.tile(node_mask.reshape(1, B * T), (B, 1))
    valid = jnp.tile(valid_mask.reshape(1, B * T), (B, 1))
    include = exists * (1.0 - member * (1.0 - valid))
    loss_mat = -(y * jnp.log(val) + (1.0 - y) * jnp.log(1.0 - val))
    return jnp.sum(loss_mat * include) / jnp.clip(jnp.sum(include), 1.0, None)


# ---------------------------------------------------------------------------
# Product-asin retrieval losses
# ---------------------------------------------------------------------------

def product_target_onehot(target_y, target_mask, asin_num: int):
    """y [B, asin_num]: 1 at each (masked-valid) future item
    (train_subsession_embedding.py:273-275)."""
    B, T = target_y.shape
    y = jnp.zeros((B, asin_num), jnp.float32)
    rows = jnp.repeat(jnp.arange(B), T)
    y = y.at[rows, target_y.reshape(-1)].max(target_mask.reshape(-1))
    return y


def product_asin_loss(
    rng,
    rep,
    asin_table,
    target_y,
    target_mask,
    neg_sample_count: int = 1000,
):
    """The key retrieval-pretraining loss
    (train_subsession_embedding.py:271-302): sigmoid logits over the full
    asin vocabulary, clipped BCE, averaged over positives plus ~1000
    randomly sampled negatives per row.

    asin_table [A, d] is the target asin embedding matrix; at scale it is
    sharded over the mesh and this matmul runs per shard.
    """
    A = asin_table.shape[0]
    y = product_target_onehot(target_y, target_mask, A)
    val = jax.nn.sigmoid(rep @ asin_table.T)
    val = jnp.clip(val, 1e-4, 0.9999)
    loss_mat = -(y * jnp.log(val) + (1.0 - y) * jnp.log(1.0 - val))
    neg_mask = jax.random.uniform(rng, loss_mat.shape) < (neg_sample_count / A)
    loss_mask = jnp.logical_or(neg_mask, y > 0).astype(loss_mat.dtype)
    return jnp.sum(loss_mat * loss_mask) / jnp.clip(jnp.sum(loss_mask), 1.0, None)


def product_asin_precision_recall(rep, asin_table, target_y, target_mask, k: int):
    """Top-K precision/recall over the asin vocabulary
    (train_subsession_embedding.py:318-339). Returns batch means, skipping
    graphs with no targets, like the reference."""
    val = rep @ asin_table.T
    _, pred = jax.lax.top_k(val, k)  # [B, K]
    A = asin_table.shape[0]
    y = product_target_onehot(target_y, target_mask, A)
    hit = jnp.sum(jnp.take_along_axis(y, pred, axis=1), axis=1)  # [B]
    gt_count = jnp.sum(y, axis=1)
    has_gt = (gt_count > 0).astype(val.dtype)
    denom = jnp.clip(jnp.sum(has_gt), 1.0, None)
    precision = jnp.sum(has_gt * hit / k) / denom
    recall = jnp.sum(has_gt * hit / jnp.clip(gt_count, 1.0, None)) / denom
    return precision, recall


# ---------------------------------------------------------------------------
# Similarity fine-tune losses
# ---------------------------------------------------------------------------

def _criterion(pred, tgt, loss_type: str):
    if loss_type == "MSE":
        return jnp.mean((pred - tgt) ** 2)
    if loss_type == "L1":
        return jnp.mean(jnp.abs(pred - tgt))
    raise ValueError(f"unrecognized loss type {loss_type}")


def pair_loss(out1, out2, lab, loss_type: str = "MSE"):
    """Per-row cosine vs scalar labels (fine_tune_ours.py:123-147 reg=False
    branch)."""
    pred = cosine_similarity(out1, out2)
    return _criterion(pred, lab.astype(pred.dtype), loss_type)


def pair_matrix_loss(out1, out2, lab, loss_type: str = "MSE"):
    """Full-matrix variant with the reference's diagonal-heavy weights
    (fine_tune_ours.py:132-137): weight = sqrt(0.001 + 0.999 I)."""
    n1 = out1 / jnp.clip(jnp.linalg.norm(out1, axis=1, keepdims=True), 1e-12, None)
    n2 = out2 / jnp.clip(jnp.linalg.norm(out2, axis=1, keepdims=True), 1e-12, None)
    pred = n1 @ n2.T
    tgt = jnp.diag(lab.astype(pred.dtype))
    b = out1.shape[0]
    weight = jnp.sqrt(0.001 * jnp.ones((b, b)) + 0.999 * jnp.eye(b))
    return _criterion(pred * weight, tgt * weight, loss_type)


def sim_matrix_loss(out, label_matrix, loss_type: str = "MSE"):
    """Cosine matrix vs ground-truth label matrix with positive upweighting
    (fine_tune_ours.py:99-119): weight = sqrt(10 where label>0 else 1)."""
    n = out / jnp.clip(jnp.linalg.norm(out, axis=1, keepdims=True), 1e-12, None)
    pred = n @ n.T
    label = label_matrix.astype(pred.dtype)
    weight = jnp.sqrt(jnp.where(label > 0, 10.0, 1.0))
    return _criterion(pred * weight, label * weight, loss_type), pred, label


def triplet_loss(out, pos_out, neg_out, pos_score, neg_score):
    """Margin triplet on cosine similarities (fine_tune_ours.py:149-153)."""
    pos_pred = cosine_similarity(out, pos_out)
    neg_pred = cosine_similarity(out, neg_out)
    margin = pos_score - neg_score
    return jnp.mean(jnp.clip(neg_pred - pos_pred + margin, 0.0, None))


def aux_consistency_loss(aux_sub_out, aux_out, base_pred):
    """Keep the fine-tuned similarity matrix close to the frozen base
    model's (fine_tune_ours.py:494-496)."""
    n1 = aux_sub_out / jnp.clip(
        jnp.linalg.norm(aux_sub_out, axis=1, keepdims=True), 1e-12, None
    )
    n2 = aux_out / jnp.clip(
        jnp.linalg.norm(aux_out, axis=1, keepdims=True), 1e-12, None
    )
    pred = n1 @ n2.T
    return jnp.mean((pred - jax.lax.stop_gradient(base_pred)) ** 2)


def reconstruction_loss(target_emb, rec_emb):
    """Normalized L2 + cosine reconstruction of the base embedding
    (fine_tune_ours.py:523-534)."""
    target_emb = jax.lax.stop_gradient(target_emb)
    norm = jnp.clip(jnp.sum(target_emb**2, axis=1), 1e-12, None)
    l2 = jnp.mean(jnp.sum((target_emb - rec_emb) ** 2, axis=1) / norm)
    cos = jnp.mean(cosine_similarity(target_emb, rec_emb))
    return l2 - cos


# ---------------------------------------------------------------------------
# Pretraining auxiliaries
# ---------------------------------------------------------------------------

def node_reconstruction_loss(node_pred, node_feat, keep_mask, node_exists=None):
    """Masked-node feature reconstruction
    (pretrain_filtered_amazon.py:431-438): squared (1 - cos) on nodes whose
    keep_mask is 0 (i.e. the masked-out nodes)."""
    node_pred = node_pred.reshape(-1, node_pred.shape[-1])
    node_feat = node_feat.reshape(-1, node_feat.shape[-1])
    keep = keep_mask.reshape(-1)
    dropped = 1.0 - keep
    if node_exists is not None:
        dropped = dropped * node_exists.reshape(-1)
    err = (1.0 - cosine_similarity(node_pred, node_feat)) ** 2
    return jnp.sum(dropped * err) / (jnp.sum(dropped) + 1e-3)


def qaea_distill_loss(pred, label):
    """Session-embedding distillation toward the frozen text encoder
    (pretrain_filtered_amazon.py:449-458): mean(1 - cos)."""
    return jnp.mean(1.0 - cosine_similarity(pred, jax.lax.stop_gradient(label)))


# ---------------------------------------------------------------------------
# Decoder-based query-generation losses
# ---------------------------------------------------------------------------

def make_mlm_target(rng, y, y_mask, mask_prob, mask_token_id, min_maskable_id=5):
    """Bernoulli-select positions of the target query to predict and replace
    them with [MASK] (the to_subsession target construction,
    train_subsession_embedding.py:35-203)."""
    pred_target = (jax.random.uniform(rng, y.shape) < mask_prob) & (
        y >= min_maskable_id
    )
    masked_y = jnp.where(pred_target, mask_token_id, y)
    return masked_y, pred_target


def next_query_mlm_loss(logits, y, pred_target):
    """Decoder-over-graph-memory MLM
    (train_subsession_embedding.py:205-230): CE at predicted positions,
    plus the argmax-infilled output for the ELECTRA stage."""
    ce = optax.softmax_cross_entropy_with_integer_labels(logits, y)
    w = pred_target.astype(ce.dtype)
    loss = jnp.sum(ce * w) / jnp.clip(jnp.sum(w), 1.0, None)
    pred = jnp.argmax(logits, axis=-1)
    output = jnp.where(pred_target, pred, y)
    return loss, jax.lax.stop_gradient(output)


def autoregressive_query_loss(rng, dec_out, y, y_mask, token_table, neg_k: int):
    """Autoregressive next-token loss with sampled negatives
    (train_subsession_embedding.py:343-388). The reference unrolls every
    prefix into a separate decoder call via a repeat construction; a single
    causal decode is mathematically the same prefix representation, so this
    takes the causally-decoded sequence ``dec_out`` [B, T, d] where position
    t predicts token t+1.

    token_table [V, d] is the query token embedding matrix; pos score =
    sigmoid(rep . emb(y_next)), neg = sigmoid(-rep . emb(random)), averaged
    with the reference's 1/(1+neg_k) weighting.
    """
    B, T, d = dec_out.shape
    rep = dec_out[:, :-1, :]                      # predicts positions 1..T-1
    y_next = y[:, 1:]
    mask = y_mask[:, 1:].astype(rep.dtype)

    pos_emb = token_table[y_next]                 # [B, T-1, d]
    pos_val = jax.nn.sigmoid(jnp.sum(rep * pos_emb, axis=-1))

    neg_ids = jax.random.randint(rng, (B, T - 1, neg_k), 0, token_table.shape[0])
    neg_emb = token_table[neg_ids]                # [B, T-1, K, d]
    neg_val = jax.nn.sigmoid(-jnp.einsum("btd,btkd->btk", rep, neg_emb))
    neg_val = jnp.sum(neg_val, axis=-1)           # [B, T-1]

    denom = jnp.clip(jnp.sum(mask), 1.0, None)
    total = jnp.sum(pos_val * mask) / denom + jnp.sum(neg_val * mask) / denom
    return -total / (1 + neg_k)


def next_query_electra_loss(logits2, output, y, y_mask):
    """Decoder ELECTRA (train_subsession_embedding.py:232-241): classify
    each position as original/replaced. logits2 [..., T, 2]."""
    label = (output == y).astype(jnp.int32)
    ce = optax.softmax_cross_entropy_with_integer_labels(logits2, label)
    m = y_mask.astype(ce.dtype)
    return jnp.sum(ce * m) / jnp.clip(jnp.sum(m), 1.0, None)
