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
In fp32 the variance is the mean of the centred squares: flax's E[x^2] -
E[x]^2 in exact arithmetic, without its cancellation where a column's
mean is large against its spread (as an autoregressive decoder's columns
are when every row feeds back much the same frame), which in fp32 moved
a c2g step's gradients by 1.6e-4 of their size from float64's. With a
compute dtype it is flax's E[x^2] - E[x]^2 of the bf16 values, as the
JAX package's bf16 modules take it: bf16 inputs round far above that
cancellation.
An autoregressive decoder that calls it once a step updates the running
statistics once a step, as flax's nn.scan carries them. Eval mode reads
the running statistics, as BatchNorm1d does.

Data parallelism (the dp axis of a mesh, `parallel/mesh`). Inside
`batch_shard(shard)` a module sees this rank's rows of a global batch
and computes what the single run computes on all of it: BatchNorm's
training statistics are sums over the dp group (the fp32 variance still
two-pass: the sum, then the centred squares), a batch-max attention
mask reads the global batch's longest sentence (`batch_max`), and
every draw of the
dropout generator (`dropout`, `reparam_noise`, `global_draw`) is made at
the global batch's shape, every rank keeping its rows, so the generator
stays in step on every rank and the masks are the single run's. A draw
names its batch dimension (`batch_dim`). Outside the context, or with a
shard of one rank, nothing changes.

Compute dtype (the JAX package's compute_dtype: bfloat16). Parameters,
running statistics and gradients stay fp32; a module built with
`compute_dtype=torch.bfloat16` computes as the flax module with
`dtype=jnp.bfloat16` does: `Dense` casts its input, weight and bias to
bf16 and returns bf16 (flax's promote_dtype); `BatchNorm` and `LayerNorm`
take their statistics and normalise in fp32 and return bf16; `Embedding`
returns its rows in bf16. With no compute dtype a module computes in the
promoted type of its input and parameters (a bf16 input to an fp32
module gives fp32, as in flax), which for fp32 inputs is the plain torch
module.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

Dtype = Optional[torch.dtype]

_GENERATOR: contextvars.ContextVar = contextvars.ContextVar(
    "dropout_generator", default=None)
_SHARD: contextvars.ContextVar = contextvars.ContextVar(
    "batch_shard", default=None)


@contextlib.contextmanager
def batch_shard(shard) -> Iterator[None]:
    """Inside: the batch is this rank's rows of a global batch (see the
    module note); shard has `rank`, `size` and `sum(x)`, the
    differentiable sum over the dp group (`parallel/mesh`), or is None."""
    token = _SHARD.set(shard if shard is not None and shard.size > 1
                       else None)
    try:
        yield
    finally:
        _SHARD.reset(token)


def batch_axis(axis) -> contextlib.AbstractContextManager:
    """`batch_shard` over a mesh's dp axis (a `parallel/mesh.Mesh`; the
    JAX package's axis_name); None leaves the current shard."""
    if axis is None:
        return contextlib.nullcontext()
    if isinstance(axis, str):
        raise ValueError(f"axis_name {axis!r}: the port names no axes; pass "
                         f"the parallel.mesh.Mesh whose dp axis to sum over")
    return batch_shard(axis.batch_shard())


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the dp ranks under `batch_shard` (x outside)."""
    shard = _SHARD.get()
    return x if shard is None else shard.sum(x)


def batch_max(x: torch.Tensor) -> torch.Tensor:
    """x's largest value over the global batch (a batch-max mask's
    length): over the dp ranks under `batch_shard`."""
    shard = _SHARD.get()
    m = x.max()
    return m if shard is None else shard.max(m)


def global_draw(draw, shape, batch_dim: int = 0) -> torch.Tensor:
    """draw(shape) for the global batch under `batch_shard`, this rank's
    rows of it; draw(shape) outside."""
    shard = _SHARD.get()
    if shard is None:
        return draw(tuple(shape))
    shape = list(shape)
    b = shape[batch_dim]
    shape[batch_dim] = b * shard.size
    return draw(tuple(shape)).narrow(batch_dim, shard.rank * b, b)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over dim 0 of the global batch (this rank's rows under
    `batch_shard`)."""
    shard = _SHARD.get()
    if shard is None:
        return x.mean(dim=0)
    return shard.sum(x.sum(dim=0)) / (x.shape[0] * shard.size)


@contextlib.contextmanager
def dropout_generator(gen: Optional[torch.Generator]) -> Iterator[None]:
    """Draw every train-mode dropout mask inside the block from gen (None:
    dropout off)."""
    token = _GENERATOR.set(gen)
    try:
        yield
    finally:
        _GENERATOR.reset(token)


def dropout(x: torch.Tensor, rate: float, training: bool,
            batch_dim: int = 0) -> torch.Tensor:
    """flax's nn.Dropout(rate) with the current generator (see the module
    note); batch_dim is x's batch dimension."""
    gen = _GENERATOR.get()
    if not training or rate <= 0.0 or gen is None:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    # bf16 values are kept with an fp32 draw (a bf16 uniform is coarse)
    dt = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    keep = global_draw(lambda shape: torch.rand(
        shape, generator=gen, device=x.device, dtype=dt), x.shape,
        batch_dim) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), x.new_zeros(()))


def reparam_noise(like: torch.Tensor) -> torch.Tensor:
    """eps ~ N(0, 1) of like's shape for z = mean + exp(logvar / 2) * eps,
    from the current generator; zeros outside `dropout_generator`."""
    gen = _GENERATOR.get()
    if gen is None:
        return torch.zeros_like(like)
    return global_draw(lambda shape: torch.randn(
        shape, generator=gen, device=like.device, dtype=like.dtype),
        like.shape)


def reparameterize(mean: torch.Tensor, logvar: torch.Tensor,
                   training: bool) -> torch.Tensor:
    """The VAE's latent: a sample in training, the mean in eval."""
    if not training:
        return mean
    return mean + torch.exp(logvar / 2) * reparam_noise(mean)


def compute_dtype(name: str) -> Dtype:
    """The models' compute dtype for a config's `compute_dtype`: bf16 for
    "bfloat16", else None (fp32), as the JAX models read it."""
    return torch.bfloat16 if name == "bfloat16" else None


def _out_dtype(x: torch.Tensor, param: torch.Tensor,
               compute_dtype: Dtype) -> torch.dtype:
    """A module's compute type: its compute dtype, else the promoted type
    of its input and parameters (flax's)."""
    return compute_dtype or torch.promote_types(x.dtype, param.dtype)


def as_fp32(x: torch.Tensor) -> torch.Tensor:
    """bf16 as fp32 (a normalisation's statistics, the kernels' registers
    in their plain versions); else as it is."""
    return x.float() if x.dtype == torch.bfloat16 else x


class Dense(nn.Linear):
    """nn.Linear with flax's Dense dtype semantics (see the module note)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, compute_dtype: Dtype = None):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _out_dtype(x, self.weight, self.compute_dtype)
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm with flax's dtype semantics: fp32 statistics and
    normalisation, the result in the compute dtype."""

    def __init__(self, normalized_shape: int, eps: float = 1e-5,
                 compute_dtype: Dtype = None):
        super().__init__(normalized_shape, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _out_dtype(x, self.weight, self.compute_dtype)
        return super().forward(as_fp32(x)).to(dt)


class Embedding(nn.Embedding):
    """nn.Embedding whose rows come out in the compute dtype (flax's Embed
    with a dtype). A table row-sharded over a mesh's tp axis looks its
    ids up on their shard, summed over tp (`parallel/mesh.TP.lookup`)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 compute_dtype: Dtype = None):
        super().__init__(num_embeddings, embedding_dim)
        self.compute_dtype = compute_dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        tp = getattr(self.weight, "_tp", None)   # a tp row shard
        out = super().forward(ids) if tp is None \
            else tp.lookup(self.weight, ids)
        return out if self.compute_dtype is None \
            else out.to(self.compute_dtype)


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over (B, C) with flax's train-mode statistics (see the
    module note); eps 1e-5 and momentum 0.99 are flax's defaults. The
    statistics and the normalisation are fp32 whatever the input; the
    result comes in the compute dtype (flax's BatchNorm dtype)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 compute_dtype: Dtype = None):
        # torch's momentum weighs the new statistic: flax's 0.99 is 0.01
        super().__init__(num_features, eps=eps, momentum=0.01)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _out_dtype(x, self.weight, self.compute_dtype)
        return self._normalise(as_fp32(x)).to(dt)

    def _normalise(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mean = batch_mean(x)
        centred = x - mean
        if self.compute_dtype is None:
            var = batch_mean(centred * centred)
        else:
            var = torch.clamp(batch_mean(x * x) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean.detach())
            self.running_var.mul_(1.0 - m).add_(m * var.detach())
        return centred * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias
