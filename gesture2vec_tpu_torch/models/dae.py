"""Part a - the frame-level models.

Port of the JAX package's `models/dae.py`:
  DAE       Dropout -> Linear -> ReLU encoder, Linear decoder, the paper's
            default. The latent_dim sentinels are kept:
              -1: identity (no network at all)
              -2: linear 200-dim bottleneck, no ReLU, dropout 0.3
            The denoising corruption is the input dropout (0.2).
  VAEFrame  input dropout 0.5, Tanh encoder, fc_mean / fc_std heads, the
            reparameterised z through fc_decoder and the output layer.
  VQFrame   input dropout 0.5, a Linear encoder, flax's BatchNorm, the
            optional VAE heads, the EMA quantizer (`models/vq.VQEma`,
            its state the module's buffers) and a Linear decoder.
Dropout and the reparameterisation noise act only in training mode
(`.train()`) inside `models/layers.dropout_generator`.

As frozen teachers (Parts b and d, the sweeps, generation) every model
serves through `encode` and `decode`, as in JAX: a VQFrame's `encode` is
the raw encoder output (no BatchNorm, VAE head or quantizer) and its
`decode` the output layer; a VAEFrame's `encode` is tanh(encoder(x)) and
its `decode` decoder(fc_decoder(fc_mean(h))).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from gesture2vec_tpu_torch.models.layers import (BatchNorm, dropout,
                                                 reparameterize)
from gesture2vec_tpu_torch.models.vq import VQEma, VQOutput


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


class VAEFrame(nn.Module):
    """The frame-level VAE; forward gives (output, logvar, mean)."""

    def __init__(self, motion_dim: int, latent_dim: int):
        super().__init__()
        self.motion_dim, self.latent_dim = motion_dim, latent_dim
        self.encoder = nn.Linear(motion_dim, latent_dim)
        self.fc_mean = nn.Linear(latent_dim, latent_dim)
        self.fc_std = nn.Linear(latent_dim, latent_dim)
        self.fc_decoder = nn.Linear(latent_dim, latent_dim)
        self.decoder = nn.Linear(latent_dim, motion_dim)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.encoder(x))

    def decode(self, h: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.fc_decoder(self.fc_mean(h)))

    def forward(self, x: torch.Tensor):
        h = self.encode(dropout(x, 0.5, self.training))
        mean, logvar = self.fc_mean(h), self.fc_std(h)
        z = reparameterize(mean, logvar, self.training)
        return self.decoder(self.fc_decoder(z)), logvar, mean


class VQFrame(nn.Module):
    """The frame-level VQ-DAE: encoder -> BatchNorm -> (VAE heads) -> EMA
    quantizer (decay 0.99) -> decoder."""

    def __init__(self, motion_dim: int, latent_dim: int, vq_components: int,
                 vae: bool = False, commitment_cost: float = 0.25,
                 decay: float = 0.99):
        super().__init__()
        self.motion_dim, self.latent_dim = motion_dim, latent_dim
        self.vq_components, self.vae = vq_components, vae
        self.encoder = nn.Linear(motion_dim, latent_dim)
        self.bn = BatchNorm(latent_dim)
        if vae:
            self.fc_mean = nn.Linear(latent_dim, latent_dim)
            self.fc_std = nn.Linear(latent_dim, latent_dim)
            self.fc_decoder = nn.Linear(latent_dim, latent_dim)
        self.vq = VQEma(vq_components, latent_dim, commitment_cost, decay)
        self.decoder = nn.Linear(latent_dim, motion_dim)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def forward(self, x: torch.Tensor, skip_vq: bool = False
                ) -> Dict[str, Any]:
        """{"output", "latent" (the post-BatchNorm value, detached), "vq"
        (VQOutput), "mean", "logvar" (None without the VAE heads)}. In
        training the BatchNorm statistics and the EMA state update (not
        under skip_vq, the delayed-VQ warmup, which passes h through with
        zero loss, perplexity and encodings)."""
        h = self.bn(self.encoder(dropout(x, 0.5, self.training)))
        latent = h.detach()
        mean = logvar = None
        if self.vae:
            mean, logvar = self.fc_mean(h), self.fc_std(h)
            h = self.fc_decoder(reparameterize(mean, logvar, self.training))
        if skip_vq:
            zero = h.new_zeros(())
            vq_out = VQOutput(zero, h, zero,
                              h.new_zeros((h.shape[0], self.vq_components)))
        else:
            vq_out = self.vq(h)
        return {"output": self.decoder(vq_out.quantized), "latent": latent,
                "vq": vq_out, "mean": mean, "logvar": logvar}
