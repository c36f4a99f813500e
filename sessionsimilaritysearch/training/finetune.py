"""Similarity fine-tuning: asymmetric query/db dual-encoder with binary
hashing (reference: fine_tune_ours.py:155-744 and fine_tune_QAEA.py).

In the reference's active configuration all three encoder copies are frozen
(fine_tune_ours.py:262-267) and the optimizers cover only the BinarizeHeads
and decode heads (:319-320). This re-design makes that explicit: the
encoder runs ONCE over the fine-tune corpus to produce frozen embeddings
(one big jitted corpus-embed pass), and fine-tuning operates purely in
embedding space -- a tiny two-tower head model trained with the reference's
alternating even/odd scheme (:384-406: even iters train the db side with the
query side in eval/hard-code mode, odd iters the reverse).

Because the same head model works on any frozen session embedding, this one
module covers both fine_tune_ours (GNN embeddings) and fine_tune_QAEA
(text-only embeddings): feed it the corresponding encoder's outputs.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

from sessionsimilaritysearch import nn
import jax
import jax.numpy as jnp
import numpy as np
import optax

from sessionsimilaritysearch.config import Config
from sessionsimilaritysearch.models.heads import BinarizeHead
from sessionsimilaritysearch.training import losses
from sessionsimilaritysearch.training.train_state import adam_with_clip


class TripletBatch(NamedTuple):
    """One fine-tune batch in embedding space: the 7-tuple of
    fine_tune_ours.py:234 with graphs replaced by frozen embeddings, plus a
    random aux pair (subsession, full session) (:332-340)."""

    ori: jnp.ndarray        # [B, d] query-side sessions
    pos: jnp.ndarray        # [B, d]
    half: jnp.ndarray       # [B, d]
    neg: jnp.ndarray        # [B, d]
    pos_score: jnp.ndarray  # [B]
    half_score: jnp.ndarray
    neg_score: jnp.ndarray
    aux_sub: jnp.ndarray    # [B_aux, d]
    aux: jnp.ndarray        # [B_aux, d]


class FinetuneHeads(nn.Module):
    """Two BinarizeHeads + two linear decode heads
    (fine_tune_ours.py:279-294: BinarizeHead(1600, code_len, None) per side,
    nn.Linear(code_len, 1600) decoders)."""

    code_len: int
    emb_dim: int

    def setup(self):
        self.q_bin = BinarizeHead(self.code_len, name="q_bin")
        self.db_bin = BinarizeHead(self.code_len, name="db_bin")
        self.q_dec = nn.Dense(self.emb_dim, name="q_dec")
        self.db_dec = nn.Dense(self.emb_dim, name="db_dec")

    def encode_query(self, emb, train: bool = False):
        return self.q_bin(emb, train=train)

    def encode_db(self, emb, train: bool = False):
        return self.db_bin(emb, train=train)

    def __call__(self, batch: TripletBatch, parity: int, loss_type: str,
                 aux_w: float, bin_w: float, rec_w: float):
        """parity 0 = even iteration (db side trains, query side hard-codes);
        parity 1 = odd (reverse). Returns (loss, metrics)."""
        train_db = parity == 0
        train_q = not train_db

        # similarity target of the frozen base: cosine of raw embeddings
        # (fine_tune_ours.py:476-481)
        n_sub = batch.aux_sub / jnp.clip(
            jnp.linalg.norm(batch.aux_sub, axis=1, keepdims=True), 1e-12, None
        )
        n_aux = batch.aux / jnp.clip(
            jnp.linalg.norm(batch.aux, axis=1, keepdims=True), 1e-12, None
        )
        aux_base_pred = jax.lax.stop_gradient(n_sub @ n_aux.T)

        ori = self.q_bin(batch.ori, train=train_q)
        pos = self.db_bin(batch.pos, train=train_db)
        half = self.db_bin(batch.half, train=train_db)
        neg = self.db_bin(batch.neg, train=train_db)
        aux_sub = self.q_bin(batch.aux_sub, train=train_q)
        aux = self.db_bin(batch.aux, train=train_db)

        reg_loss = (
            losses.binary_regularize(ori)
            + losses.binary_regularize(pos)
            + losses.binary_regularize(half)
            + losses.binary_regularize(neg)
            + losses.binary_regularize(aux_sub)
            + losses.binary_regularize(aux)
        )
        aux_loss = losses.aux_consistency_loss(aux_sub, aux, aux_base_pred)
        pair = (
            losses.pair_loss(ori, pos, batch.pos_score, loss_type)
            + losses.pair_loss(ori, neg, batch.neg_score, loss_type)
            + losses.pair_loss(ori, half, batch.half_score, loss_type)
        )

        rec_aux_sub = self.q_dec(aux_sub)
        rec_aux = self.db_dec(aux)
        if train_db:  # even: reconstruct the db-side aux embedding (:525-528)
            rec_loss = losses.reconstruction_loss(batch.aux, rec_aux)
        else:         # odd: the query-side (:529-532)
            rec_loss = losses.reconstruction_loss(batch.aux_sub, rec_aux_sub)

        loss = pair + aux_w * aux_loss + bin_w * reg_loss + rec_w * rec_loss
        metrics = {
            "loss": loss,
            "pair_loss": pair,
            "aux_loss": aux_loss,
            "reg_loss": reg_loss,
            "rec_loss": rec_loss,
        }
        return loss, metrics

    def valid_losses(self, batch: TripletBatch, loss_type: str,
                     aux_w: float, bin_w: float, rec_w: float):
        """Validation breakdown, everything in eval (hard-code) mode
        (fine_tune_ours.py:615-646)."""
        n_sub = batch.aux_sub / jnp.clip(
            jnp.linalg.norm(batch.aux_sub, axis=1, keepdims=True), 1e-12, None
        )
        n_aux = batch.aux / jnp.clip(
            jnp.linalg.norm(batch.aux, axis=1, keepdims=True), 1e-12, None
        )
        aux_base_pred = n_sub @ n_aux.T
        ori = self.q_bin(batch.ori, train=False)
        pos = self.db_bin(batch.pos, train=False)
        half = self.db_bin(batch.half, train=False)
        neg = self.db_bin(batch.neg, train=False)
        aux_sub = self.q_bin(batch.aux_sub, train=False)
        aux = self.db_bin(batch.aux, train=False)
        reg = (
            losses.binary_regularize(ori) + losses.binary_regularize(pos)
            + losses.binary_regularize(half) + losses.binary_regularize(neg)
            + losses.binary_regularize(aux_sub) + losses.binary_regularize(aux)
        )
        rec = losses.reconstruction_loss(
            batch.aux_sub, self.q_dec(aux_sub)
        ) + losses.reconstruction_loss(batch.aux, self.db_dec(aux))
        return {
            "pos_loss": losses.pair_loss(ori, pos, batch.pos_score, loss_type),
            "neg_loss": losses.pair_loss(ori, neg, batch.neg_score, loss_type),
            "half_loss": losses.pair_loss(ori, half, batch.half_score, loss_type),
            "aux_loss": aux_w * losses.aux_consistency_loss(aux_sub, aux, aux_base_pred),
            "reg_loss": bin_w * reg,
            "rec_loss": rec_w * rec,
        }


class FinetuneState(NamedTuple):
    params: dict
    opt_db: optax.OptState
    opt_q: optax.OptState
    step: jnp.ndarray


def _side_mask(params, side: str):
    """Gradient mask selecting one tower's parameters (db: db_bin + db_dec;
    q: q_bin + q_dec) -- the reference's optimizer1/optimizer2 split
    (fine_tune_ours.py:319-320)."""
    prefix = {"db": ("db_bin", "db_dec"), "q": ("q_bin", "q_dec")}[side]

    return jax.tree_util.tree_map_with_path(
        lambda path, _: any(
            str(getattr(p, "key", "")) in prefix for p in path
        ),
        params,
    )


def create_finetune_state(cfg: Config, rng, emb_dim: Optional[int] = None,
                          shared_init: bool = False):
    """``shared_init=True`` copies the query tower's init into the db tower
    so both sides start as the SAME random projection — i.e. the hash starts
    at simhash/cosine-LSH quality (``ops.hamming.simhash_codes``) and the
    alternating fine-tune improves from there instead of first having to
    re-align two unrelated projections. The reference inits its towers
    independently (fine_tune_ours.py:279-294), which is why its serve path
    is unusable before fine-tuning; default False for parity."""
    emb_dim = emb_dim or cfg.session_emb_dim
    model = FinetuneHeads(code_len=cfg.code_len, emb_dim=emb_dim)
    dummy = TripletBatch(*([jnp.zeros((2, emb_dim))] * 4),
                         *([jnp.zeros(2)] * 3),
                         jnp.zeros((2, emb_dim)), jnp.zeros((2, emb_dim)))
    params = model.init(rng, dummy, 0, cfg.loss_type, cfg.aux_w, cfg.bin_w,
                        cfg.rec_w)["params"]
    if shared_init:
        params = dict(params)
        params["db_bin"] = jax.tree.map(lambda x: x, params["q_bin"])
    tx = adam_with_clip(cfg.ft_lr or cfg.lr, cfg.grad_clip_norm)
    state = FinetuneState(
        params=params,
        opt_db=tx.init(params),
        opt_q=tx.init(params),
        step=jnp.asarray(0),
    )
    return model, state, tx


def make_finetune_step(model: FinetuneHeads, tx, cfg: Config):
    """Returns step(state, batch): alternates sides by step parity, exactly
    the even/odd optimizer switch of fine_tune_ours.py:384-406, 551-555."""

    def _one(parity: int):
        def step(state: FinetuneState, batch: TripletBatch):
            def loss_fn(params):
                return model.apply(
                    {"params": params}, batch, parity, cfg.loss_type,
                    cfg.aux_w, cfg.bin_w, cfg.rec_w,
                )

            grads, metrics = jax.grad(loss_fn, has_aux=True)(state.params)
            side = "db" if parity == 0 else "q"
            mask = _side_mask(state.params, side)
            grads = jax.tree.map(
                lambda g, m: g if m else jnp.zeros_like(g), grads, mask
            )
            opt = state.opt_db if parity == 0 else state.opt_q
            updates, new_opt = tx.update(grads, opt, state.params)
            params = optax.apply_updates(state.params, updates)
            if parity == 0:
                new_state = FinetuneState(params, new_opt, state.opt_q,
                                          state.step + 1)
            else:
                new_state = FinetuneState(params, state.opt_db, new_opt,
                                          state.step + 1)
            return new_state, metrics

        return jax.jit(step)

    even, odd = _one(0), _one(1)

    def step(state: FinetuneState, batch: TripletBatch):
        if int(state.step) % 2 == 0:
            return even(state, batch)
        return odd(state, batch)

    return step


def make_valid_fn(model: FinetuneHeads, cfg: Config):
    @jax.jit
    def run(state: FinetuneState, batch: TripletBatch):
        return model.apply(
            {"params": state.params}, batch, cfg.loss_type, cfg.aux_w,
            cfg.bin_w, cfg.rec_w, method=model.valid_losses,
        )

    return run


def make_code_fns(model: FinetuneHeads):
    """Hard-code encoders for serving: db side for the corpus, query side
    for queries (fine_tune_ours.py:821-864)."""

    @jax.jit
    def db_codes(state: FinetuneState, emb):
        return model.apply(
            {"params": state.params}, emb, False, method=model.encode_db
        )

    @jax.jit
    def q_codes(state: FinetuneState, emb):
        return model.apply(
            {"params": state.params}, emb, False, method=model.encode_query
        )

    return db_codes, q_codes


def build_triplet_batches(
    triplets, embed_fn, aux_pairs, batch_size: int, rng: np.random.Generator
):
    """Host-side: turn mined raw triplets + aux pairs into embedding-space
    TripletBatch streams. ``embed_fn(list_of_data) -> np.ndarray`` embeds
    (prefix, future) pairs with the frozen encoder."""
    ori = embed_fn([t[0] for t in triplets])
    pos = embed_fn([t[1] for t in triplets])
    half = embed_fn([t[2] for t in triplets])
    neg = embed_fn([t[3] for t in triplets])
    scores = np.asarray([[t[4], t[5], t[6]] for t in triplets], np.float32)
    aux_sub = embed_fn([a[0] for a in aux_pairs])
    aux = embed_fn([a[1] for a in aux_pairs])

    n = len(triplets)
    na = len(aux_pairs)

    def batches(shuffle=True):
        idx = rng.permutation(n) if shuffle else np.arange(n)
        for s in range(0, n - batch_size + 1, batch_size):
            sel = idx[s : s + batch_size]
            a_sel = rng.integers(0, na, size=batch_size)
            yield TripletBatch(
                ori=jnp.asarray(ori[sel]),
                pos=jnp.asarray(pos[sel]),
                half=jnp.asarray(half[sel]),
                neg=jnp.asarray(neg[sel]),
                pos_score=jnp.asarray(scores[sel, 0]),
                half_score=jnp.asarray(scores[sel, 1]),
                neg_score=jnp.asarray(scores[sel, 2]),
                aux_sub=jnp.asarray(aux_sub[a_sel]),
                aux=jnp.asarray(aux[a_sel]),
            )

    return batches
