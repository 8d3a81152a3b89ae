"""Transformer blocks: the causal TransformerLM and its parts.

Counterpart of ``mxnet_tpu/gluon/contrib/transformer.py``, whole:

- ``MultiHeadAttention`` — fused qkv projection, flash attention
  (``F._contrib_flash_attention``: the Hopper kernels, forward and
  backward, on the card), output projection.
- ``TransformerEncoderCell`` / ``TransformerDecoderCell`` (causal) —
  pre-norm residual blocks (post-norm with ``pre_norm=False``).
- ``TransformerEncoder`` — a stack.
- ``SinusoidalPositionalEmbedding`` — the fixed encoding, a ``Constant``.
- ``TransformerLM`` — embeddings, causal stack, tied or untied head.
"""
from __future__ import annotations

import numpy as np

from ...base import MXNetError
from ..block import Block, HybridBlock
from ..nn import Dense, Dropout, Embedding, LayerNorm, HybridSequential

__all__ = ["MultiHeadAttention", "TransformerEncoderCell",
           "TransformerDecoderCell", "TransformerEncoder",
           "SinusoidalPositionalEmbedding", "TransformerLM"]


class MultiHeadAttention(HybridBlock):
    """Self-attention with the flash kernels on the hot path.

    Input/output layout (B, T, C); internally (B, H, T, D) for the kernel.
    """

    def __init__(self, units, num_heads, dropout=0.0, causal=False,
                 use_bias=True, **kw):
        super().__init__(**kw)
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self._units = units
        self._heads = num_heads
        self._causal = causal
        with self.name_scope():
            self.qkv = Dense(3 * units, flatten=False, use_bias=use_bias,
                             prefix="qkv_")
            self.proj = Dense(units, flatten=False, use_bias=use_bias,
                              prefix="proj_")
            self.drop = Dropout(dropout)

    def hybrid_forward(self, F, x):
        h, d = self._heads, self._units // self._heads
        qkv = self.qkv(x)                                   # (B, T, 3C)
        qkv = F.reshape(qkv, shape=(0, 0, 3 * h, d))        # (B, T, 3H, D)
        qkv = F.transpose(qkv, axes=(0, 2, 1, 3))           # (B, 3H, T, D)
        q = F.slice_axis(qkv, axis=1, begin=0, end=h)
        k = F.slice_axis(qkv, axis=1, begin=h, end=2 * h)
        v = F.slice_axis(qkv, axis=1, begin=2 * h, end=3 * h)
        out = F.contrib_flash_attention(q, k, v, causal=self._causal)
        out = F.transpose(out, axes=(0, 2, 1, 3))           # (B, T, H, D)
        out = F.reshape(out, shape=(0, 0, -1))              # (B, T, C)
        return self.drop(self.proj(out))


class _FFN(HybridBlock):
    def __init__(self, units, hidden, dropout, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.fc1 = Dense(hidden, flatten=False, activation="relu",
                             prefix="fc1_")
            self.fc2 = Dense(units, flatten=False, prefix="fc2_")
            self.drop = Dropout(dropout)

    def hybrid_forward(self, F, x):
        return self.drop(self.fc2(self.fc1(x)))


class TransformerEncoderCell(HybridBlock):
    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 pre_norm=True, causal=False, **kw):
        super().__init__(**kw)
        self._pre = pre_norm
        with self.name_scope():
            self.attn = MultiHeadAttention(units, num_heads, dropout,
                                           causal=causal, prefix="attn_")
            self.ffn = _FFN(units, hidden_size, dropout, prefix="ffn_")
            self.ln1 = LayerNorm(prefix="ln1_")
            self.ln2 = LayerNorm(prefix="ln2_")

    def hybrid_forward(self, F, x):
        if self._pre:
            x = x + self.attn(self.ln1(x))
            return x + self.ffn(self.ln2(x))
        x = self.ln1(x + self.attn(x))
        return self.ln2(x + self.ffn(x))


class TransformerDecoderCell(TransformerEncoderCell):
    """Causal (masked) self-attention block — GPT-style decoder cell."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 pre_norm=True, **kw):
        super().__init__(units, hidden_size, num_heads, dropout=dropout,
                         pre_norm=pre_norm, causal=True, **kw)


class TransformerEncoder(HybridBlock):
    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.0, pre_norm=True, causal=False, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.layers = HybridSequential(prefix="layers_")
            with self.layers.name_scope():
                for _ in range(num_layers):
                    self.layers.add(TransformerEncoderCell(
                        units, hidden_size, num_heads, dropout,
                        pre_norm=pre_norm, causal=causal))
            self.final_ln = LayerNorm(prefix="lnf_") if pre_norm else None

    def hybrid_forward(self, F, x):
        x = self.layers(x)
        return self.final_ln(x) if self.final_ln is not None else x


class SinusoidalPositionalEmbedding(HybridBlock):
    """Fixed sin/cos table, registered as a Constant (no gradient); sliced
    to the input's length with ``slice_like`` so one table serves every
    bucket length."""

    def __init__(self, max_len, units, **kw):
        super().__init__(**kw)
        pos = np.arange(max_len)[:, None]
        dim = np.arange(0, units, 2)[None, :]
        angle = pos / np.power(10000.0, dim / units)
        table = np.zeros((max_len, units), "float32")
        table[:, 0::2] = np.sin(angle)
        table[:, 1::2] = np.cos(angle[:, : units // 2])
        with self.name_scope():
            self.table = self.params.get_constant("pos_table", table)

    def hybrid_forward(self, F, x, table):
        # x: (B, T, C); table (max_len, C) -> (T, C) -> broadcast over B
        tab = F.slice_like(F.expand_dims(table, axis=0), x, axes=(1,))
        return F.broadcast_add(x, tab)


class TransformerLM(Block):
    """GPT-style causal language model.

    forward(tokens (B, T) int) -> logits (B, T, vocab).
    """

    def __init__(self, vocab_size, units=256, num_layers=4, num_heads=8,
                 hidden_size=None, max_len=1024, dropout=0.0,
                 tie_weights=False, **kw):
        super().__init__(**kw)
        hidden_size = hidden_size or 4 * units
        self._tie = tie_weights
        with self.name_scope():
            self.embed = Embedding(vocab_size, units, prefix="embed_")
            self.pos = SinusoidalPositionalEmbedding(max_len, units)
            self.body = TransformerEncoder(num_layers, units, hidden_size,
                                           num_heads, dropout, pre_norm=True,
                                           causal=True, prefix="body_")
            if not tie_weights:   # tied head reuses the embedding table
                self.head = Dense(vocab_size, flatten=False, use_bias=False,
                                  prefix="head_")

    def forward(self, tokens):
        x = self.pos(self.embed(tokens))
        x = self.body(x)
        if self._tie:
            from ... import nd as _nd
            w = self.embed.weight.data()
            return _nd.dot(x.reshape((-1, x.shape[-1])), w,
                           transpose_b=True).reshape(
                               (x.shape[0], x.shape[1], -1))
        return self.head(x)
