"""Part a - the frame-level denoising autoencoder (inference half).

Port of the JAX package's `models/dae.py` DAE: Linear -> ReLU encoder,
Linear decoder. The latent_dim sentinels are kept:
  -1: identity (no network at all)
  -2: linear 200-dim bottleneck, no ReLU
Input dropout only acts in training, which the port does not do yet.
"""
from __future__ import annotations

import torch
from torch import nn


class DAE(nn.Module):
    def __init__(self, motion_dim: int, latent_dim: int):
        super().__init__()
        self.motion_dim = motion_dim
        self.latent_dim = latent_dim
        if latent_dim == -1:
            self.encoder = self.decoder = None
            return
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
