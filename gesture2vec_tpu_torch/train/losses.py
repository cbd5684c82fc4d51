"""Loss functions of the trainers (the port's copy of the JAX package's
`train/losses.py`): the reference's weighted L1 + continuity + variance
loss, MSE, the two KLD forms of the VAEs, and the gesture-token
cross-entropy over positions 1.. with optional label smoothing
(optax.smooth_labels: (1 - a) * onehot + a / K).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def custom_loss(output: torch.Tensor, target: torch.Tensor, *,
                l1_weight: float, cont_weight: float,
                var_weight: float) -> torch.Tensor:
    """output/target (B, T, D):
      l1   = mean |out - tgt| * w_l1
      cont = sum_t |out_t - out_{t-1}| / numel * w_cont
      var  = -sum(norm2(out, over T)) / numel * w_var
    (the reference divides the cont and var sums by output.numel())."""
    n_element = output.numel()
    l1 = torch.mean(torch.abs(output - target)) * l1_weight
    diff = torch.abs(output[:, 1:, :] - output[:, :-1, :])
    cont = torch.sum(diff) / n_element * cont_weight
    norm = torch.linalg.vector_norm(output, ord=2, dim=1)
    var = -torch.sum(norm) / n_element * var_weight
    return l1 + cont + var


def mse_loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((output - target) ** 2)


def kld_loss(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """-0.5 * mean_b mean_d (1 + logvar - exp(logvar) - mu^2)."""
    return -0.5 * torch.mean(torch.mean(
        1 + logvar - torch.exp(logvar) - mean ** 2, dim=1))


def kld_loss_standard(mean: torch.Tensor,
                      logvar: torch.Tensor) -> torch.Tensor:
    """0.5 * mean(exp(logvar) - logvar - 1 + mu^2)."""
    return 0.5 * torch.mean(torch.exp(logvar) - logvar - 1 + mean ** 2)


def token_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                        ignore_first: bool = True,
                        label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean CE of logits (B, T, K) against integer targets (B, T),
    skipping position 0 (the seed) unless ignore_first is False."""
    if ignore_first:
        logits = logits[:, 1:, :]
        targets = targets[:, 1:]
    flat = logits.reshape(-1, logits.shape[-1])
    tgt = targets.reshape(-1).long()
    logp = F.log_softmax(flat, dim=-1)
    if label_smoothing:
        k = flat.shape[-1]
        labels = F.one_hot(tgt, k).to(flat.dtype) * (1.0 - label_smoothing) \
            + label_smoothing / k
        return -(labels * logp).sum(dim=-1).mean()
    return -logp.gather(1, tgt[:, None])[:, 0].mean()


def stage_ce(res: Dict[str, torch.Tensor],
             stage_targets: torch.Tensor) -> torch.Tensor:
    """Sum of the residual-stage heads' CE: head s predicts stage s+1's
    code at steps 1.. (stage_targets (B, T, S); column 0, the primary
    token, is the stage-0 CE's)."""
    sl = res["stage_logits"]                       # (B, T-1, S-1, K)
    loss = sl.new_zeros(())
    for s in range(sl.shape[2]):
        loss = loss + token_cross_entropy(
            sl[:, :, s], stage_targets[:, 1:, s + 1], ignore_first=False)
    return loss
