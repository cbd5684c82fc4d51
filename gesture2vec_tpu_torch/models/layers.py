"""Train-mode building blocks with the JAX package's semantics.

Dropout. A module applies dropout only in training mode (`.train()`)
and only inside `dropout_generator(gen)`: the masks are drawn from that
explicit torch.Generator (on the tensors' device), as flax draws them
from the "dropout" rng stream. Outside the context, or in eval mode,
dropout is the identity; the CPU parity tests train with dropout off
that way. A mask keeps each value with probability 1 - rate and scales
it by 1 / (1 - rate) (flax's nn.Dropout); rate 1 zeroes everything.
The VAEs' reparameterisation noise (flax's "reparam" stream) comes from
the same generator (`reparam_noise`); outside the context it is zero, so
a train-mode VAE samples z = mean there.

BatchNorm. `BatchNorm` is a BatchNorm1d whose training mode is flax's
nn.BatchNorm(use_running_average=False): it normalises with the batch
mean and the biased batch variance, and updates the running statistics
once per call with momentum 0.99 (torch's momentum 0.01) from that same
biased variance, where torch's BatchNorm1d would use the unbiased one.
An autoregressive decoder that calls it once a step updates the running
statistics once a step, as flax's nn.scan carries them. Eval mode reads
the running statistics, as BatchNorm1d does.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional

import torch
from torch import nn

_GENERATOR: contextvars.ContextVar = contextvars.ContextVar(
    "dropout_generator", default=None)


@contextlib.contextmanager
def dropout_generator(gen: Optional[torch.Generator]) -> Iterator[None]:
    """Draw every train-mode dropout mask inside the block from gen (None:
    dropout off)."""
    token = _GENERATOR.set(gen)
    try:
        yield
    finally:
        _GENERATOR.reset(token)


def dropout(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """flax's nn.Dropout(rate) with the current generator (see the module
    note)."""
    gen = _GENERATOR.get()
    if not training or rate <= 0.0 or gen is None:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=gen, device=x.device,
                      dtype=x.dtype) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), x.new_zeros(()))


def reparam_noise(like: torch.Tensor) -> torch.Tensor:
    """eps ~ N(0, 1) of like's shape for z = mean + exp(logvar / 2) * eps,
    from the current generator; zeros outside `dropout_generator`."""
    gen = _GENERATOR.get()
    if gen is None:
        return torch.zeros_like(like)
    return torch.randn(like.shape, generator=gen, device=like.device,
                       dtype=like.dtype)


def reparameterize(mean: torch.Tensor, logvar: torch.Tensor,
                   training: bool) -> torch.Tensor:
    """The VAE's latent: a sample in training, the mean in eval."""
    if not training:
        return mean
    return mean + torch.exp(logvar / 2) * reparam_noise(mean)


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over (B, C) with flax's train-mode statistics (see the
    module note); eps 1e-5 and momentum 0.99 are flax's defaults."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        # torch's momentum weighs the new statistic: flax's 0.99 is 0.01
        super().__init__(num_features, eps=eps, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mean = x.mean(dim=0)
        var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean.detach())
            self.running_var.mul_(1.0 - m).add_(m * var.detach())
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias
