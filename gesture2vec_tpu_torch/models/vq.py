"""Vector quantizers: the tokenizer's and the frame model's.

Port of the JAX package's `models/vq.py`: `codebook_distances`,
`gssoft_probs` (log-space, log-smoothing clamped to +-30), `VQGSSoft`
(the reference's Part-b quantizer) and `VQResidual` (the opt-in
residual quantizer), with parameter names matching the JAX variables
(`codebook`, `codebook_r{s}`, `mean_layer`, `logvar_layer`); and the
frame-level quantizers: `vq_ema` (the Part-a `VQFrame`'s, behind the
`VQEma` module that keeps its state as buffers), `vq_st` and
`vq_gumbel`.

GS-Soft tokens are the argmax of the soft assignment softmax(logp),
with per-code smoothing: no argmin of distances computes them. The
residual stages' hard assignments are argmins and go through
`ops/vq_kernel.vq_argmin`; an argmin needs no gradient, so training
differentiates through the gathered codebook rows.

The losses have the JAX package's training form, whose values are the
eval values too: q_latent + beta * e_latent with e_latent = mse(sg(q), x)
and q_latent = mse(q, sg(x)) (sg: detach), and the straight-through
output x + sg(q - x); the residual stages quantize resid - sg(q).

Under a mesh (`parallel/mesh`) the batch statistics are the global
batch's: the perplexity's code usage and the EMA update's counts and
assigned sums are summed over the dp ranks (`models/layers.batch_shard`,
the JAX package's axis_name psum). A codebook row-sharded over tp
(`_tp` on the tensor) computes this shard's distances: the hard
assignments run the VQ-argmin kernel on the shard and take the global
nearest code over the ranks (`parallel/mesh.TP.argmin`), the rows are
looked up on their shard and summed over tp, and GS-Soft gathers the
(N, K) distances for its softmax over all K, as the JAX package's
partitioner does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gesture2vec_tpu_torch.models.layers import (batch_axis, batch_mean,
                                                 batch_sum, global_draw)
from gesture2vec_tpu_torch.ops.vq_kernel import (codebook_distances,
                                                 vq_argmin, vq_argmin_plain)

__all__ = ["VQEma", "VQEmaState", "VQOutput", "VQGSSoft", "VQResidual",
           "codebook_distances", "gssoft_logp", "gssoft_probs",
           "init_ema_state", "perplexity_of", "vq_ema", "vq_gumbel",
           "vq_st"]


class VQOutput(NamedTuple):
    loss: torch.Tensor        # scalar codebook/commitment loss
    quantized: torch.Tensor   # x + sg(quantized - x), the straight-through value
    perplexity: torch.Tensor  # codebook-usage perplexity
    encodings: torch.Tensor   # (N, K) assignment weights (hard or soft)


def perplexity_of(encodings: torch.Tensor) -> torch.Tensor:
    avg = batch_mean(encodings)
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


def _shard(table: torch.Tensor):
    """The tp row shard a table carries (None: the whole table)."""
    return getattr(table, "_tp", None)


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] for global ids, over a tp shard too."""
    tp = _shard(table)
    return table[ids] if tp is None else tp.lookup(table, ids)


def _codes(table: torch.Tensor) -> int:
    """The table's number of codes (all shards')."""
    tp = _shard(table)
    return table.shape[0] if tp is None else tp.total


def _argmin(fn, x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The nearest code's global index: fn (the kernel or its plain
    version) on the table or on its shard."""
    idx, dmin = fn(x.contiguous(), table.detach().contiguous())
    tp = _shard(table)
    return idx if tp is None else tp.argmin(idx, dmin)


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
        tp = _shard(self.codebook)
        if tp is None:
            d = codebook_distances(projected, self.codebook)
        else:
            d = tp.gather_columns(codebook_distances(tp.enter(projected),
                                                     self.codebook))
        return gssoft_logp(d, z_logvar)

    def mix(self, probs: torch.Tensor) -> torch.Tensor:
        """probs (N, K) @ codebook, over a tp shard too."""
        tp = _shard(self.codebook)
        if tp is None:
            return torch.matmul(probs, self.codebook)
        cols = tp.enter(probs)[:, tp.offset:tp.offset
                               + self.codebook.shape[0]]
        return tp.sum(torch.matmul(cols, self.codebook))

    def forward(self, x: torch.Tensor) -> VQOutput:
        flat = x.reshape(-1, self.dim)
        probs = torch.softmax(self.logp(flat), dim=1)
        quantized = self.mix(probs).reshape(x.shape)
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
        return _argmin(vq_argmin if self.use_kernel else vq_argmin_plain,
                       x, cb)

    def forward(self, x: torch.Tensor) -> VQOutput:
        flat = x.reshape(-1, self.dim)
        resid, total_q = flat, torch.zeros_like(flat)
        loss = flat.new_zeros(())
        out0 = None
        for s, cb in enumerate(self.codebooks()):
            idx = self._argmin(resid, cb)
            q = _rows(cb, idx)
            loss = loss + _losses(q, resid, self.commitment_cost)
            total_q = total_q + q
            if s == 0:
                out0 = torch.nn.functional.one_hot(
                    idx, _codes(cb)).to(flat.dtype)
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
            resid = resid - _rows(cb, idx)
        return torch.stack(toks, dim=1)

    def embed_stage_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """(..., S') stage ids -> (..., dim): the sum of the first S'
        stages' codebook rows."""
        cbs = self.codebooks()
        total = _rows(cbs[0], tokens[..., 0])
        for s in range(1, tokens.shape[-1]):
            total = total + _rows(cbs[s], tokens[..., s])
        return total


# -- the frame-level quantizers (Part a) ----------------------------------
class VQEmaState(NamedTuple):
    """The EMA codebook state."""

    codebook: torch.Tensor      # (K, D)
    cluster_size: torch.Tensor  # (K,)
    ema_w: torch.Tensor         # (K, D)


def init_ema_state(num_codes: int, dim: int,
                   generator: torch.Generator) -> VQEmaState:
    """codebook ~ U(-1/K, 1/K), ema_w ~ N(0, 1), cluster_size 0 (the
    reference's init), drawn on the CPU from generator."""
    codebook = (torch.rand(num_codes, dim, generator=generator) * 2 - 1) \
        / num_codes
    ema_w = torch.randn(num_codes, dim, generator=generator)
    return VQEmaState(codebook, torch.zeros(num_codes), ema_w)


def _hard_assign(flat: torch.Tensor, codebook: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices, one-hot (N, K)) of the nearest codes (first index on
    ties), through vq_argmin (over a tp shard too)."""
    idx = _argmin(vq_argmin, flat.detach(), codebook)
    return idx, F.one_hot(idx, _codes(codebook)).to(flat.dtype)


def vq_st(x: torch.Tensor, codebook: torch.Tensor,
          commitment_cost: float = 0.25) -> VQOutput:
    """Plain straight-through VQ: loss = mse(q, sg(x)) + beta mse(sg(q),
    x); the gradient reaches the codebook through the gathered rows."""
    flat = x.reshape(-1, codebook.shape[-1])
    idx, onehot = _hard_assign(flat, codebook)
    quantized = codebook[idx].reshape(x.shape)
    st = x + (quantized - x).detach()
    return VQOutput(_losses(quantized, x, commitment_cost), st,
                    perplexity_of(onehot), onehot)


@torch.no_grad()
def _ema_update(state: VQEmaState, flat: torch.Tensor, onehot: torch.Tensor,
                decay: float, epsilon: float) -> VQEmaState:
    """The EMA step; the counts and sums over the global batch. A tp
    shard keeps cluster_size and ema_w whole (replicated, as the JAX
    package places them) and its rows of the new codebook."""
    counts = batch_sum(onehot.sum(dim=0))
    dw = batch_sum(onehot.t() @ flat)
    cluster_size = state.cluster_size * decay + (1 - decay) * counts
    n = cluster_size.sum()
    cluster_size = (cluster_size + epsilon) \
        / (n + cluster_size.shape[0] * epsilon) * n
    ema_w = state.ema_w * decay + (1 - decay) * dw
    codebook = ema_w / cluster_size[:, None]
    tp = _shard(state.codebook)
    if tp is not None:
        codebook = codebook[tp.offset:tp.offset + state.codebook.shape[0]]
    return VQEmaState(codebook, cluster_size, ema_w)


def vq_ema(x: torch.Tensor, state: VQEmaState, *,
           commitment_cost: float = 0.25, decay: float = 0.99,
           epsilon: float = 1e-5, train: bool = True,
           axis_name: Optional[str] = None
           ) -> Tuple[VQOutput, VQEmaState]:
    """EMA-codebook VQ: (VQOutput, the new state). loss = beta *
    mse(sg(q), x) (the codebook learns by the EMA, not by gradients); the
    quantized value uses the pre-update codebook. In training the state
    decays towards the batch's counts and assigned-vector sums (fp32),
    cluster_size Laplace-smoothed with epsilon, codebook = ema_w /
    cluster_size; in eval the state is returned as it is. axis_name (a
    Mesh of `parallel/mesh`, or None) sums the counts and sums over its
    dp ranks, as the JAX package's psum over the named axis; under a
    trainer's mesh the batch shard does (`models/layers.batch_shard`)."""
    flat = x.reshape(-1, state.codebook.shape[-1])
    idx, onehot = _hard_assign(flat, state.codebook)
    quantized = _rows(state.codebook, idx).reshape(x.shape)
    new_state = state
    if train:
        with batch_axis(axis_name):
            new_state = _ema_update(state, flat.detach(), onehot, decay,
                                    epsilon)
    loss = commitment_cost * torch.mean((quantized.detach() - x) ** 2)
    st = x + (quantized - x).detach()
    return VQOutput(loss, st, perplexity_of(onehot), onehot), new_state


class VQEma(nn.Module):
    """vq_ema with its state as the module's buffers (`codebook`,
    `cluster_size`, `ema_w`): training mode replaces them by the updated
    state in place, eval mode leaves them."""

    def __init__(self, num_codes: int, dim: int,
                 commitment_cost: float = 0.25, decay: float = 0.99):
        super().__init__()
        self.commitment_cost, self.decay = commitment_cost, decay
        self.register_buffer("codebook", torch.zeros(num_codes, dim))
        self.register_buffer("cluster_size", torch.zeros(num_codes))
        self.register_buffer("ema_w", torch.zeros(num_codes, dim))

    def state(self) -> VQEmaState:
        return VQEmaState(self.codebook, self.cluster_size, self.ema_w)

    @torch.no_grad()
    def load_state(self, state: VQEmaState) -> None:
        """Copy a state in (the buffers never alias its tensors)."""
        for buf, value in zip(self.state(), state):
            buf.copy_(value)

    def forward(self, x: torch.Tensor) -> VQOutput:
        out, new = vq_ema(x, self.state(),
                          commitment_cost=self.commitment_cost,
                          decay=self.decay, train=self.training)
        if self.training:
            self.load_state(new)
        return out


def vq_gumbel(x: torch.Tensor, codebook: torch.Tensor, *,
              temperature: float = 0.5, train: bool = True,
              gumbel: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> VQOutput:
    """Relaxed one-hot (Gumbel-softmax) VQ. Training: encodings =
    softmax((-d + g) / temperature), g the Gumbel noise (N, K) given, or
    drawn from generator; eval: the hard argmin (through vq_argmin). The
    loss is the KL of softmax(-d) to the uniform prior."""
    flat = x.reshape(-1, codebook.shape[-1])
    d = codebook_distances(flat, codebook)
    log_probs = torch.log_softmax(-d, dim=-1)
    probs = torch.exp(log_probs)
    if train:
        if gumbel is None:
            u = global_draw(lambda shape: torch.rand(
                shape, generator=generator, device=d.device, dtype=d.dtype),
                d.shape)
            gumbel = -torch.log(-torch.log(u.clamp_min(
                torch.finfo(d.dtype).tiny)))
        encodings = torch.softmax(-d / temperature + gumbel / temperature,
                                  dim=-1)
    else:
        encodings = _hard_assign(flat, codebook)[1]
    quantized = torch.matmul(encodings, codebook).reshape(x.shape)
    kl_el = probs * (log_probs + torch.log(torch.tensor(
        float(codebook.shape[0]))))
    kl_el = torch.where(probs == 0, torch.zeros_like(kl_el), kl_el)
    kl = torch.mean(torch.sum(kl_el, dim=0))
    st = x + (quantized - x).detach()
    return VQOutput(kl, st, perplexity_of(encodings), encodings)
