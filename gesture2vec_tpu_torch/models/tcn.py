"""Temporal Convolutional Network text encoder.

Port of the JAX package's `models/tcn.py`: causal dilated convolutions
(left pad (k-1)*dilation, dilation 2**i per block), a 1x1 downsample
only where the width changes, and a decoder-initial hidden projected
from each sequence's last valid TCN state. The convolutions keep flax's
weight normalisation as their parameters, a direction `kernel` and a
per-output `scale`: the weight is kernel * rsqrt(sum over (in, k) of
kernel^2 + 1e-12) * scale, so training moves the same parameters with
the same gradients as the JAX package does.

In training mode (`.train()`, see `models/layers`) the embeddings take
dropout 0.1 and each block's two activations dropout 0.3, the rates the
JAX package's Text2Token builds the encoder with.

Layouts follow the JAX package at the public functions: token ids are
batch-major (B, S); outputs are time-major (S, B, H) and the hidden is
(n_layers, B, H).

With a compute dtype (the JAX package's bf16 mode) the embeddings are
cast to it, the convolutions (their weight normalised in fp32, then cast),
the per-step projection and hidden_proj run in it, and the outputs and
hidden come back in fp32.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gesture2vec_tpu_torch.models.layers import (Dense, Dtype, Embedding,
                                                 dropout)

# flax's WeightNorm epsilon
WN_EPS = 1e-12


class CausalConv1d(nn.Module):
    """Weight-normalised 1D causal convolution over (B, C, T): kernel
    (out, in, k), scale (out,), bias (out,)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, dilation: int, dtype: Dtype = None):
        super().__init__()
        self.dtype = dtype
        self.dilation = dilation
        self.pad = (kernel_size - 1) * dilation
        self.kernel = nn.Parameter(
            torch.zeros(out_channels, in_channels, kernel_size))
        self.scale = nn.Parameter(torch.ones(out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    @property
    def weight(self) -> torch.Tensor:
        """The effective convolution weight (out, in, k)."""
        norm = (self.kernel * self.kernel).sum(dim=(1, 2), keepdim=True)
        return self.kernel * torch.rsqrt(norm + WN_EPS) \
            * self.scale[:, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(x, self.weight, self.bias, self.dtype, self.pad,
                    self.dilation)


def conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
         dtype: Dtype, pad: int = 0, dilation: int = 1) -> torch.Tensor:
    """A left-padded 1D convolution over (B, C, T), in dtype (flax's Conv
    with a dtype: input, weight and bias cast to it) when given."""
    if dtype is not None:
        x, weight, bias = x.to(dtype), weight.to(dtype), bias.to(dtype)
    return F.conv1d(F.pad(x, (pad, 0)), weight, bias, dilation=dilation)


class TemporalBlock(nn.Module):
    """conv -> relu -> dropout, twice, plus a residual (1x1 downsample
    where the width changes), then relu."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, dilation: int, dropout_rate: float = 0.3,
                 dtype: Dtype = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.conv1 = CausalConv1d(in_channels, out_channels, kernel_size,
                                  dilation, dtype)
        self.conv2 = CausalConv1d(out_channels, out_channels, kernel_size,
                                  dilation, dtype)
        self.downsample = (nn.Conv1d(in_channels, out_channels, 1)
                           if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = dropout(torch.relu(self.conv1(x)), self.dropout_rate,
                    self.training)
        h = dropout(torch.relu(self.conv2(h)), self.dropout_rate,
                    self.training)
        ds = self.downsample
        res = x if ds is None else conv(x, ds.weight, ds.bias, self.dtype)
        return torch.relu(h + res)


class TemporalConvNet(nn.Module):
    """Stacked blocks with dilation 2**i, over (B, C, T)."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 kernel_size: int = 2, dropout_rate: float = 0.3,
                 dtype: Dtype = None):
        super().__init__()
        blocks = []
        for i, ch in enumerate(channels):
            blocks.append(TemporalBlock(in_channels, ch, kernel_size, 2 ** i,
                                        dropout_rate, dtype))
            in_channels = ch
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class TextEncoderTCN(nn.Module):
    """Embedding -> TCN -> per-step projection, plus decoder-init hidden
    hidden_proj(tanh(y[last valid])) reshaped to (n_layers, B, H)."""

    def __init__(self, n_words: int, embed_size: int, hidden_size: int,
                 n_layers: int, kernel_size: int = 2,
                 dropout_rate: float = 0.3, emb_dropout: float = 0.1,
                 dtype: Dtype = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.emb_dropout = emb_dropout
        self.n_layers = n_layers
        self.dtype = dtype
        self.embedding_table = Embedding(n_words, embed_size)
        self.tcn = TemporalConvNet(embed_size, [hidden_size] * n_layers,
                                   kernel_size, dropout_rate, dtype)
        self.decoder = Dense(hidden_size, hidden_size, compute_dtype=dtype)
        self.hidden_proj = Dense(hidden_size, n_layers * hidden_size,
                                 compute_dtype=dtype)

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) ids, lengths (B,) -> (outputs (S, B, H),
        hidden (n_layers, B, H)), fp32."""
        B, S = tokens.shape
        emb = self.embedding_table(tokens)
        if self.dtype is not None:
            emb = emb.to(self.dtype)
        emb = dropout(emb, self.emb_dropout, self.training)  # (B, S, E)
        y = self.tcn(emb.transpose(1, 2)).transpose(1, 2)   # (B, S, H)
        outputs = self.decoder(y)
        idx = (lengths.long() - 1).clamp(0, S - 1)
        last = y[torch.arange(B, device=y.device), idx]     # (B, H)
        hidden = self.hidden_proj(torch.tanh(last))
        hidden = hidden.reshape(B, self.n_layers, self.hidden_size)
        return (outputs.transpose(0, 1).float(),
                hidden.transpose(0, 1).float())
