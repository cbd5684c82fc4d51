"""Part b, transformer encoder variant - the chunk encoder of a
`seq_arch: transformer` gesture tokenizer.

Port of the JAX package's `models/seq_encoder.py`: in_layer -> sinusoidal
positions -> pre-LN blocks (`models/transformer.Block`, no mask) ->
final_ln over the chunk's frames, then the unmasked mean-pool over the
frames and `hidden_proj` to the (n_layers, B, H) hidden that the
quantizer reads. Contract of `seq_ae.SeqEncoder`: (T, B, D) time-major
frames -> (outputs (T, B, H), hidden (n_layers, B, H)); the tokenizer's
`[:n_layers]` slice of the hidden is then the identity. The JAX package
builds it with 4 heads. In training mode dropout (the tokenizer's
dropout_prob) acts after the positions and on each block's residual
branches, as in JAX (masks drawn inside `models/layers.dropout_generator`).
With a compute dtype the in_layer, the blocks and final_ln run in it
(`models/transformer`); the frames' outputs, the pool and `hidden_proj`
(the quantizer's input) are fp32, as in JAX.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from gesture2vec_tpu_torch.models.layers import (Dense, Dtype, LayerNorm,
                                                 dropout)
from gesture2vec_tpu_torch.models.transformer import (LN_EPS, add_blocks,
                                                      position_table)


class TransformerSeqEncoder(nn.Module):
    """Chunk frames -> contextual frame embeddings + pooled hidden."""

    def __init__(self, input_size: int, hidden_size: int, n_layers: int,
                 n_heads: int = 4, dropout_rate: float = 0.0,
                 dtype: Dtype = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        self.dropout_rate = dropout_rate
        self.in_layer = Dense(input_size, hidden_size, compute_dtype=dtype)
        add_blocks(self, n_layers, hidden_size, n_heads,
                   dropout_rate=dropout_rate, dtype=dtype)
        self.final_ln = LayerNorm(hidden_size, eps=LN_EPS,
                                  compute_dtype=dtype)
        self.hidden_proj = Dense(hidden_size, n_layers * hidden_size)

    def forward(self, xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """xs (T, B, D) -> (outputs (T, B, H), hidden (n_layers, B, H))."""
        x = self.in_layer(xs).transpose(0, 1)                  # (B, T, H)
        x = dropout(x + position_table(x.shape[1], self.hidden_size,
                                       x.device).to(x.dtype),
                    self.dropout_rate, self.training)
        for i in range(self.n_layers):
            x, _ = getattr(self, f"layer_{i}")(x, None)
        x = self.final_ln(x).float()
        flat = self.hidden_proj(x.mean(dim=1))                 # (B, L*H)
        hidden = flat.reshape(-1, self.n_layers,
                              self.hidden_size).transpose(0, 1)
        return x.transpose(0, 1), hidden
