"""Sequence-level vector quantizers (the tokenizer's).

Port of the JAX package's `models/vq.py` pieces the Part-c path runs:
`codebook_distances`, `gssoft_probs` (log-space, log-smoothing clamped
to +-30), `VQGSSoft` (the reference's Part-b quantizer) and `VQResidual`
(the opt-in residual quantizer). Parameter names match the JAX
variables (`codebook`, `codebook_r{s}`, `mean_layer`, `logvar_layer`).

GS-Soft tokens are the argmax of the soft assignment softmax(logp),
with per-code smoothing: no argmin of distances computes them. The
residual stages' hard assignments are argmins and go through
`ops/vq_kernel.vq_argmin`; an argmin needs no gradient, so training
differentiates through the gathered codebook rows.

The losses have the JAX package's training form, whose values are the
eval values too: q_latent + beta * e_latent with e_latent = mse(sg(q), x)
and q_latent = mse(q, sg(x)) (sg: detach), and the straight-through
output x + sg(q - x); the residual stages quantize resid - sg(q).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from gesture2vec_tpu_torch.ops.vq_kernel import (codebook_distances,
                                                 vq_argmin, vq_argmin_plain)

__all__ = ["VQOutput", "VQGSSoft", "VQResidual", "codebook_distances",
           "gssoft_logp", "gssoft_probs", "perplexity_of"]


class VQOutput(NamedTuple):
    loss: torch.Tensor        # scalar codebook/commitment loss
    quantized: torch.Tensor   # x + sg(quantized - x), the straight-through value
    perplexity: torch.Tensor  # codebook-usage perplexity
    encodings: torch.Tensor   # (N, K) assignment weights (hard or soft)


def perplexity_of(encodings: torch.Tensor) -> torch.Tensor:
    avg = encodings.mean(dim=0)
    return torch.exp(-torch.sum(avg * torch.log(avg + 1e-10)))


def gssoft_logp(distances: torch.Tensor,
                z_logvar: torch.Tensor) -> torch.Tensor:
    """Unnormalised log-assignment of the Gaussian-smoothed soft VQ:
    smooth = exp(z_logvar)^-2 with log(smooth) clamped to +-30,
    logp = -(d / 400) * smooth / 2 - log(smooth) / 2."""
    log_smooth = torch.clamp(-2.0 * z_logvar, -30.0, 30.0)
    smooth = torch.exp(log_smooth)
    return -(distances / 400.0) * 0.5 * smooth - 0.5 * log_smooth


def gssoft_probs(distances: torch.Tensor,
                 z_logvar: torch.Tensor) -> torch.Tensor:
    return torch.softmax(gssoft_logp(distances, z_logvar), dim=1)


def _losses(q: torch.Tensor, x: torch.Tensor, beta: float) -> torch.Tensor:
    """q_latent + beta * e_latent: the codebook term moves q, the
    commitment term x."""
    e_latent = torch.mean((q.detach() - x) ** 2)
    q_latent = torch.mean((q - x.detach()) ** 2)
    return q_latent + beta * e_latent


class VQGSSoft(nn.Module):
    """GS-Soft VQ: mean_layer projects the input, logvar_layer gives a
    per-code smoothing, and the assignment is the normalised Gaussian
    kernel weighting."""

    def __init__(self, num_codes: int, dim: int,
                 commitment_cost: float = 0.25):
        super().__init__()
        self.dim = dim
        self.commitment_cost = commitment_cost
        self.codebook = nn.Parameter(torch.zeros(num_codes, dim))
        self.mean_layer = nn.Linear(dim, dim)
        self.logvar_layer = nn.Linear(dim, num_codes)

    def logp(self, flat: torch.Tensor) -> torch.Tensor:
        """(N, dim) -> (N, K) log-assignment (before the softmax)."""
        projected = self.mean_layer(flat)
        z_logvar = self.logvar_layer(projected)
        return gssoft_logp(codebook_distances(projected, self.codebook),
                           z_logvar)

    def forward(self, x: torch.Tensor) -> VQOutput:
        flat = x.reshape(-1, self.dim)
        probs = torch.softmax(self.logp(flat), dim=1)
        quantized = torch.matmul(probs, self.codebook).reshape(x.shape)
        loss = _losses(quantized, x, self.commitment_cost)
        st = x + (quantized - x).detach()
        return VQOutput(loss, st, perplexity_of(probs), probs)

    @staticmethod
    def tokens(probs: torch.Tensor) -> torch.Tensor:
        """Gesture-token ids: argmax of the soft assignment (first index
        on ties)."""
        return torch.argmax(probs, dim=-1)


class VQResidual(nn.Module):
    """Residual VQ: stage 0 quantizes the input, each later stage what
    the earlier stages left over, each with its own codebook. Stage 0's
    index is THE gesture token. Hard assignments go through vq_argmin
    (use_kernel=False, set by `SeqVQAutoencoder.set_use_kernels`, takes
    its plain version on any device)."""

    def __init__(self, num_codes: int, dim: int, stages: int = 2,
                 commitment_cost: float = 0.25):
        super().__init__()
        self.dim = dim
        self.stages = stages
        self.commitment_cost = commitment_cost
        self.use_kernel = True
        for s in range(stages):
            self.register_parameter(
                "codebook" if s == 0 else f"codebook_r{s}",
                nn.Parameter(torch.zeros(num_codes, dim)))

    def codebooks(self):
        return [self.codebook] + [getattr(self, f"codebook_r{s}")
                                  for s in range(1, self.stages)]

    def _argmin(self, x: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
        fn = vq_argmin if self.use_kernel else vq_argmin_plain
        return fn(x.contiguous(), cb.contiguous())[0]

    def forward(self, x: torch.Tensor) -> VQOutput:
        flat = x.reshape(-1, self.dim)
        resid, total_q = flat, torch.zeros_like(flat)
        loss = flat.new_zeros(())
        out0 = None
        for s, cb in enumerate(self.codebooks()):
            idx = self._argmin(resid, cb)
            q = cb[idx]
            loss = loss + _losses(q, resid, self.commitment_cost)
            total_q = total_q + q
            if s == 0:
                out0 = torch.nn.functional.one_hot(
                    idx, cb.shape[0]).to(flat.dtype)
            resid = resid - q.detach()
        st = (flat + (total_q - flat).detach()).reshape(x.shape)
        return VQOutput(loss, st, perplexity_of(out0), out0)

    @staticmethod
    def tokens(probs: torch.Tensor) -> torch.Tensor:
        return torch.argmax(probs, dim=-1)

    def stage_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """(N, dim) -> (N, stages) per-stage code ids; column 0 is the
        pipeline token."""
        resid = x.reshape(-1, self.dim)
        toks = []
        for cb in self.codebooks():
            idx = self._argmin(resid, cb)
            toks.append(idx)
            resid = resid - cb[idx]
        return torch.stack(toks, dim=1)

    def embed_stage_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """(..., S') stage ids -> (..., dim): the sum of the first S'
        stages' codebook rows."""
        cbs = self.codebooks()
        total = cbs[0][tokens[..., 0]]
        for s in range(1, tokens.shape[-1]):
            total = total + cbs[s][tokens[..., s]]
        return total
