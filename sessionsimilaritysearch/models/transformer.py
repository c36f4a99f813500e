"""Torch-parity transformer building blocks.

The reference leans on ``nn.TransformerEncoder`` / ``nn.TransformerDecoder``
(post-LayerNorm, ReLU FFN) for its text embedders and decoder heads
(reference: model/NodeEmbedding.py:62-98, model/model.py:15-38, 141-172).
These modules reproduce that computation (post-norm residual blocks,
additive attention masks, key-padding masks) so the encoder zoo's math
matches the reference while jitting to static shapes.
"""

from __future__ import annotations

import math
from typing import Optional

from sessionsimilaritysearch import nn
import jax.numpy as jnp
import numpy as np


def sinusoidal_pe(max_len: int, d_model: int) -> np.ndarray:
    """Standard sine/cosine positional table
    (reference: model/NodeEmbedding.py:23-34)."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * (-math.log(10000.0) / d_model)
    )
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term[: pe[:, 1::2].shape[1]])
    return pe


class PositionalEncoding(nn.Module):
    """Add sinusoidal PE then dropout (model/NodeEmbedding.py:7-48)."""

    d_model: int
    dropout: float = 0.1
    max_len: int = 5000

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        pe = jnp.asarray(sinusoidal_pe(self.max_len, self.d_model))
        x = x + pe[None, : x.shape[1], :]
        return nn.Dropout(self.dropout)(x, deterministic=deterministic)


def _attention(q, k, v, nhead, attn_mask, key_padding_mask, dropout, deterministic):
    """Multi-head scaled dot-product attention with torch mask semantics.

    attn_mask: [Lq, Lk] additive (-inf blocks) or None.
    key_padding_mask: [B, Lk] True = PAD (ignored) or None.
    """
    B, Lq, D = q.shape
    Lk = k.shape[1]
    H = nhead
    hd = D // H
    q = q.reshape(B, Lq, H, hd).transpose(0, 2, 1, 3)
    k = k.reshape(B, Lk, H, hd).transpose(0, 2, 1, 3)
    v = v.reshape(B, Lk, H, hd).transpose(0, 2, 1, 3)
    scores = jnp.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
    if attn_mask is not None:
        scores = scores + attn_mask[None, None, :, :]
    if key_padding_mask is not None:
        neg = jnp.finfo(scores.dtype).min
        scores = jnp.where(key_padding_mask[:, None, None, :], neg, scores)
    att = nn.softmax(scores, axis=-1)
    # fully-masked rows produce uniform garbage; zero them like torch does
    if key_padding_mask is not None:
        all_masked = jnp.all(key_padding_mask, axis=-1)
        att = jnp.where(all_masked[:, None, None, None], 0.0, att)
    out = jnp.einsum("bhqk,bhkd->bhqd", att, v)
    return out.transpose(0, 2, 1, 3).reshape(B, Lq, D)


class MultiHeadAttention(nn.Module):
    d_model: int
    nhead: int
    dropout: float = 0.0

    @nn.compact
    def __call__(
        self,
        query,
        key,
        value,
        attn_mask=None,
        key_padding_mask=None,
        deterministic: bool = True,
    ):
        q = nn.Dense(self.d_model, name="q_proj")(query)
        k = nn.Dense(self.d_model, name="k_proj")(key)
        v = nn.Dense(self.d_model, name="v_proj")(value)
        out = _attention(
            q, k, v, self.nhead, attn_mask, key_padding_mask, self.dropout,
            deterministic,
        )
        return nn.Dense(self.d_model, name="out_proj")(out)


class EncoderLayer(nn.Module):
    """Post-norm torch ``nn.TransformerEncoderLayer`` (ReLU FFN)."""

    d_model: int
    nhead: int
    dim_feedforward: int
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, attn_mask=None, key_padding_mask=None, deterministic=True):
        a = MultiHeadAttention(self.d_model, self.nhead, self.dropout)(
            x, x, x, attn_mask, key_padding_mask, deterministic
        )
        a = nn.Dropout(self.dropout)(a, deterministic=deterministic)
        x = nn.LayerNorm()(x + a)
        f = nn.Dense(self.dim_feedforward)(x)
        f = nn.relu(f)
        f = nn.Dropout(self.dropout)(f, deterministic=deterministic)
        f = nn.Dense(self.d_model)(f)
        f = nn.Dropout(self.dropout)(f, deterministic=deterministic)
        return nn.LayerNorm()(x + f)


class TransformerEncoder(nn.Module):
    d_model: int
    nhead: int
    dim_feedforward: int
    nlayers: int
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, attn_mask=None, key_padding_mask=None, deterministic=True):
        for i in range(self.nlayers):
            x = EncoderLayer(
                self.d_model, self.nhead, self.dim_feedforward, self.dropout,
                name=f"layer_{i}",
            )(x, attn_mask, key_padding_mask, deterministic)
        return x


class DecoderLayer(nn.Module):
    """Post-norm torch ``nn.TransformerDecoderLayer``: self-attn ->
    cross-attn over memory -> FFN."""

    d_model: int
    nhead: int
    dim_feedforward: int
    dropout: float = 0.0

    @nn.compact
    def __call__(
        self,
        tgt,
        memory,
        tgt_mask=None,
        tgt_key_padding_mask=None,
        memory_key_padding_mask=None,
        deterministic=True,
    ):
        a = MultiHeadAttention(self.d_model, self.nhead, self.dropout, name="self_attn")(
            tgt, tgt, tgt, tgt_mask, tgt_key_padding_mask, deterministic
        )
        a = nn.Dropout(self.dropout)(a, deterministic=deterministic)
        x = nn.LayerNorm()(tgt + a)
        c = MultiHeadAttention(self.d_model, self.nhead, self.dropout, name="cross_attn")(
            x, memory, memory, None, memory_key_padding_mask, deterministic
        )
        c = nn.Dropout(self.dropout)(c, deterministic=deterministic)
        x = nn.LayerNorm()(x + c)
        f = nn.Dense(self.dim_feedforward)(x)
        f = nn.relu(f)
        f = nn.Dropout(self.dropout)(f, deterministic=deterministic)
        f = nn.Dense(self.d_model)(f)
        f = nn.Dropout(self.dropout)(f, deterministic=deterministic)
        return nn.LayerNorm()(x + f)


class TransformerDecoder(nn.Module):
    d_model: int
    nhead: int
    dim_feedforward: int
    nlayers: int
    dropout: float = 0.0

    @nn.compact
    def __call__(
        self,
        tgt,
        memory,
        tgt_mask=None,
        tgt_key_padding_mask=None,
        memory_key_padding_mask=None,
        deterministic=True,
    ):
        x = tgt
        for i in range(self.nlayers):
            x = DecoderLayer(
                self.d_model, self.nhead, self.dim_feedforward, self.dropout,
                name=f"layer_{i}",
            )(
                x,
                memory,
                tgt_mask,
                tgt_key_padding_mask,
                memory_key_padding_mask,
                deterministic,
            )
        return x


def causal_mask(size: int) -> jnp.ndarray:
    """Upper-triangular -inf mask (torch ``generate_square_subsequent_mask``)."""
    m = jnp.triu(jnp.full((size, size), -jnp.inf), k=1)
    return m
