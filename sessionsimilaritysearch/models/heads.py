"""Projection / hashing / generation heads.

Re-designs of model/model.py:15-172: MLP (BatchNorm stack), BinarizeHead
(straight-through sign hashing), transformer decoder head, cross-attention
token injector.
"""

from __future__ import annotations

from typing import Optional

from sessionsimilaritysearch import nn
import jax
import jax.numpy as jnp

from sessionsimilaritysearch.models.transformer import (
    PositionalEncoding,
    TransformerDecoder,
    TransformerEncoder,
)


class MLP(nn.Module):
    """Linear+BatchNorm stack with ReLU/dropout, optional input-jump concat
    and optional tanh on the last layer (reference: model/model.py:40-73)."""

    n_output: int
    n_hidden: int
    n_hidden_layers: int = 0
    dropout: float = 0.0
    last_act: bool = True
    jump: bool = False

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        inp = x
        widths = [self.n_hidden] * (1 + self.n_hidden_layers)
        for i, w in enumerate(widths):
            x = nn.Dense(w, name=f"dense_{i}")(x)
            x = nn.BatchNorm(
                use_running_average=deterministic, name=f"bn_{i}"
            )(x)
            x = nn.relu(x)
            x = nn.Dropout(self.dropout)(x, deterministic=deterministic)
        if self.jump:
            x = jnp.concatenate([inp, x], axis=-1)
        x = nn.Dense(self.n_output, name="dense_out")(x)
        if self.last_act:
            x = jnp.tanh(x)
        return x


class BinarizeHead(nn.Module):
    """Hashing head (reference: model/model.py:105-138).

    Training: ``tanh(out)`` (relaxed codes). Eval: straight-through sign
    ``stop_gradient(sign(out) - tanh(out)) + tanh(out)`` -- exact +-1 codes
    with tanh gradients, the same train/eval asymmetry as upstream.
    """

    n_output: int
    use_mlp: bool = False
    mlp_hidden: int = 0
    jump: bool = False

    @nn.compact
    def __call__(self, x, train: bool = True, deterministic: Optional[bool] = None):
        if deterministic is None:
            deterministic = not train
        if self.use_mlp:
            out = jnp.tanh(
                MLP(
                    self.mlp_hidden,
                    self.mlp_hidden,
                    0,
                    0.0,
                    last_act=False,
                    name="mlp",
                )(x, deterministic=deterministic)
            )
            if self.jump:
                out = jnp.concatenate([out, x], axis=-1)
        else:
            out = x
        out = nn.Dense(self.n_output, name="lin1")(out)
        soft = jnp.tanh(out)
        if train:
            return soft
        return jax.lax.stop_gradient(jnp.sign(out) - soft) + soft


class TransformerDecoderHead(nn.Module):
    """PE -> transformer decoder over a session-embedding memory -> Linear
    (reference MyTransformerDecoder: model/model.py:15-38). Used by the
    next/last-query generation losses."""

    ninp: int
    nout: int
    nhead: int
    nhid: int
    nlayers: int
    dropout: float = 0.5

    @nn.compact
    def __call__(
        self,
        tgt,
        memory,
        tgt_mask=None,
        tgt_key_padding_mask=None,
        deterministic: bool = True,
    ):
        tgt = PositionalEncoding(self.ninp, self.dropout)(tgt, deterministic)
        out = TransformerDecoder(
            self.ninp, self.nhead, self.nhid, self.nlayers, self.dropout
        )(
            tgt,
            memory,
            tgt_mask=tgt_mask,
            tgt_key_padding_mask=tgt_key_padding_mask,
            deterministic=deterministic,
        )
        out = nn.Dropout(self.dropout)(out, deterministic=deterministic)
        return nn.Dense(self.nout, name="lin")(out)


class CrossAttentionTransformer(nn.Module):
    """Injects K latent tokens derived from a node embedding into a token
    sequence; transformer-encodes with a mask blocking latent->token
    attention; returns the updated token embeddings
    (reference: model/model.py:141-172)."""

    nlayers: int
    node_emb_K: int
    token_dim: int
    nhead: int
    nhid: int
    dropout: float = 0.5

    @nn.compact
    def __call__(self, node_emb, token_emb, token_mask, deterministic=True):
        """node_emb [B, node_dim]; token_emb [B, S, token_dim];
        token_mask [B, S] True = PAD."""
        B, S, _ = token_emb.shape
        K = self.node_emb_K
        lat = nn.Dense(K * self.token_dim, name="node_lin")(node_emb)
        lat = lat.reshape(B, K, self.token_dim)
        x = jnp.concatenate([lat, token_emb], axis=1)  # [B, K+S, D]
        # latent rows may not attend to token rows (ref :152-155)
        attn_mask = jnp.zeros((K + S, K + S))
        attn_mask = attn_mask.at[:K, K:].set(-jnp.inf)
        pad = jnp.concatenate(
            [jnp.zeros((B, K), dtype=bool), token_mask.astype(bool)], axis=1
        )
        out = TransformerEncoder(
            self.token_dim, self.nhead, self.nhid, self.nlayers, self.dropout
        )(x, attn_mask=attn_mask, key_padding_mask=pad, deterministic=deterministic)
        return out[:, K:, :]
