"""Node embedders: text -> vector, asin-id -> vector.

JAX re-designs of model/NodeEmbedding.py. Node text fields arrive as
[B, N, T] token grids (every node of every session, statically padded); the
embedders flatten to [B*N, T], run one batched transformer, and reshape back
-- one big matmul stream instead of the reference's per-node
ragged batching.
"""

from __future__ import annotations

import math
from typing import Optional

from sessionsimilaritysearch import nn
import jax
import jax.numpy as jnp

from sessionsimilaritysearch.models.transformer import (
    PositionalEncoding,
    TransformerEncoder,
)


class AveragePooling(nn.Module):
    """Mean over one axis (reference: model/NodeEmbedding.py:51-60)."""

    axis: int = 1

    def __call__(self, x):
        return jnp.mean(x, axis=self.axis)


class NodeTextTransformer(nn.Module):
    """From-scratch text-to-node-vector encoder
    (reference: model/NodeEmbedding.py:62-98): token embedding * sqrt(d) +
    sinusoidal PE -> transformer encoder with key-padding mask -> mean pool.

    NOTE the reference mean-pools over ALL positions including padding
    (AveragePooling over dim 1); we keep that behavior for parity.
    """

    ntoken: int
    ninp: int
    nhead: int
    nhid: int
    nlayers: int
    dropout: float = 0.5

    @nn.compact
    def __call__(self, input_ids, attention_mask, deterministic: bool = True):
        """input_ids [B', T] int32; attention_mask [B', T] (1 = real token).
        Returns [B', ninp]."""
        x = nn.Embed(self.ntoken, self.ninp, name="embedding")(input_ids)
        x = x * math.sqrt(self.ninp)
        x = PositionalEncoding(self.ninp, self.dropout)(x, deterministic)
        pad = attention_mask == 0
        x = TransformerEncoder(
            self.ninp, self.nhead, self.nhid, self.nlayers, self.dropout
        )(x, key_padding_mask=pad, deterministic=deterministic)
        return jnp.mean(x, axis=1)


class TextEncoder(nn.Module):
    """BERT-style frozen-target text encoder (the "QAEA" role).

    The reference loads a pretrained ELECTRA/BERT checkpoint and uses it as
    a frozen embedding oracle: masked mean over last_hidden_state, detached,
    plus optional Linear (reference: model/NodeEmbedding.py:100-125). No
    such checkpoint ships, so this is a from-scratch encoder with the
    same interface; ``stop_gradient`` reproduces the ``.detach()``
    (the optional Linear stays trainable, as upstream).
    """

    vocab_size: int
    d_model: int = 768
    nhead: int = 4
    nhid: int = 1024
    nlayers: int = 2
    max_len: int = 64
    nout: Optional[int] = None
    freeze: bool = True

    @nn.compact
    def __call__(
        self,
        input_ids,
        token_type_ids,
        attention_mask,
        get_token: bool = False,
        deterministic: bool = True,
    ):
        """input_ids/token_type_ids/attention_mask: [B', T].
        Returns [B', nout or d_model] (and token embs [B', T, d_model] when
        ``get_token``)."""
        tok = nn.Embed(self.vocab_size, self.d_model, name="tok_emb")(input_ids)
        pos_ids = jnp.arange(input_ids.shape[-1])[None, :]
        pos = nn.Embed(self.max_len, self.d_model, name="pos_emb")(pos_ids)
        typ = nn.Embed(2, self.d_model, name="type_emb")(
            jnp.clip(token_type_ids, 0, 1)
        )
        x = nn.LayerNorm(name="emb_ln")(tok + pos + typ)
        pad = attention_mask == 0
        token_emb = TransformerEncoder(
            self.d_model, self.nhead, self.nhid, self.nlayers, 0.0, name="encoder"
        )(x, key_padding_mask=pad, deterministic=deterministic)

        mask = attention_mask.astype(token_emb.dtype)
        denom = jnp.clip(jnp.sum(mask, axis=1, keepdims=True), 1.0, None)
        out = jnp.sum(token_emb * mask[..., None], axis=1) / denom
        if self.freeze:
            out = jax.lax.stop_gradient(out)  # reference .detach() (:115)
        if self.nout is not None:
            out_p = nn.Dense(self.nout, name="lin")(out)
        else:
            out_p = out
        if get_token:
            return out_p, token_emb
        return out_p


class NodeAsinEmbedding(nn.Module):
    """One learned vector per product id
    (reference: model/NodeEmbedding.py:128-138). At the reference's scale
    (asin_num=391,572) this table is the big parameter; the trainers shard
    it over the mesh (parallel/sharding.py)."""

    nproducts: int
    ninp: int

    @nn.compact
    def __call__(self, ids):
        return nn.Embed(self.nproducts, self.ninp, name="encoder")(ids)
