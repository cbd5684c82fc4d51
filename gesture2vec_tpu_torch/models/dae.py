"""Part a - the frame-level denoising autoencoder.

Port of the JAX package's `models/dae.py` DAE: Dropout -> Linear -> ReLU
encoder, Linear decoder. The latent_dim sentinels are kept:
  -1: identity (no network at all)
  -2: linear 200-dim bottleneck, no ReLU, dropout 0.3
The denoising corruption is the input dropout (0.2), which acts only in
training mode (`.train()`, see `models/layers`).
"""
from __future__ import annotations

import torch
from torch import nn

from gesture2vec_tpu_torch.models.layers import dropout


class DAE(nn.Module):
    def __init__(self, motion_dim: int, latent_dim: int):
        super().__init__()
        self.motion_dim = motion_dim
        self.latent_dim = latent_dim
        if latent_dim == -1:
            self.encoder = self.decoder = None
            return
        self.dropout_rate = 0.3 if latent_dim == -2 else 0.2
        width = 200 if latent_dim == -2 else latent_dim
        self.encoder = nn.Linear(motion_dim, width)
        self.decoder = nn.Linear(width, motion_dim)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        if self.latent_dim == -1:
            return x
        h = self.encoder(x)
        return h if self.latent_dim == -2 else torch.relu(h)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        if self.latent_dim == -1:
            return z
        return self.decoder(z)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, motion_dim) -> reconstruction; the input takes dropout in
        training mode."""
        if self.latent_dim == -1:
            return x
        return self.decode(self.encode(
            dropout(x, self.dropout_rate, self.training)))
