"""GRUs: cells for the autoregressive decoders, the sequence layer, the
unidirectional stack (c2g's and the GAN discriminator's) and the
bidirectional stack of the tokenizer's encoder.

Gate math matches torch.nn.GRU and the JAX package's `models/gru.py`
(gate order r, z, n; separate input and hidden biases; weights in
torch layout (3H, in)):
    r = sigmoid(x W_ir^T + b_ir + h W_hr^T + b_hr)
    z = sigmoid(x W_iz^T + b_iz + h W_hz^T + b_hz)
    n = tanh(x W_in^T + b_in + r * (h W_hn^T + b_hn))
    h' = (1 - z) * n + z * h
`gru_layer` hoists the input projections of every step into one matmul
and runs the recurrence through `ops/gru_kernel.gru_sequence` (the
Hopper kernel on CUDA, its plain version on the CPU); with grad enabled
that call carries its gradient through the backward kernel
(`GRUSequenceFn`), and d w_ih, d b_ih and d xs come from autograd
through the input projection.

In training mode (`.train()`, see `models/layers`) the stacks apply
dropout to the outputs of every layer but the last, as the JAX package's
GRUCellStack, BiGRU and MaskedBiGRU do.

`masked_gru_layer` / `MaskedBiGRU` are the text encoder's GRU over padded
sequences (torch pack_padded_sequence semantics: outputs past a
sequence's length are zero, its last hidden is the state at its last
valid step, the reverse direction reads each sequence backwards from its
own last word). The state at step t < length depends only on the steps
before t, so the unmasked recurrence gives every valid output: the
layer runs the same kernel unmasked and masks afterwards.

`dtype` (None or torch.bfloat16) is the JAX package's GRU dtype
(`_cast_gru`): with bf16 the inputs, h0 and the weights are cast to bf16
before anything else, the input projection comes out in bf16, and the
recurrence runs in bf16 (`ops/gru_kernel`: the bf16 kernel instantiations
on the card, their plain versions on the CPU), carrying h in bf16; the
cell (`gru_cell`) computes each step in bf16 torch ops. Outputs and
hidden come out in bf16; parameters and their gradients stay fp32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from gesture2vec_tpu_torch.models.layers import Dtype, dropout
from gesture2vec_tpu_torch.ops.gru_kernel import (gru_sequence,
                                                  gru_sequence_plain)


def cast_gru(dtype: Dtype, *ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The JAX package's `_cast_gru`: every tensor in dtype (None: as it
    is)."""
    return ts if dtype is None else tuple(t.to(dtype) for t in ts)


def gru_cell(x: torch.Tensor, h: torch.Tensor, w_ih: torch.Tensor,
             w_hh: torch.Tensor, b_ih: torch.Tensor,
             b_hh: torch.Tensor, dtype: Dtype = None) -> torch.Tensor:
    """Single GRU step (B, in) x (B, H) -> (B, H)."""
    x, h, w_ih, w_hh, b_ih, b_hh = cast_gru(dtype, x, h, w_ih, w_hh, b_ih,
                                            b_hh)
    H = h.shape[-1]
    gi = torch.addmm(b_ih, x, w_ih.t())
    gh = torch.addmm(b_hh, h, w_hh.t())
    if dtype is not None:
        # the gate math of one step in fp32 from the products in dtype,
        # the new h rounded to dtype: XLA fuses a step's elementwise ops
        # and keeps their intermediates in fp32 (excess precision), and so
        # does the kernel
        gi, gh, h = gi.float(), gh.float(), h.float()
    r = torch.sigmoid(gi[:, :H] + gh[:, :H])
    z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
    h_new = (1.0 - z) * n + z * h
    return h_new if dtype is None else h_new.to(dtype)


class GRUCellStack(nn.Module):
    """n_layers GRU cells for one timestep; hidden is (n_layers, B, H).
    Parameters are named l{n}_w_ih / l{n}_w_hh / l{n}_b_ih / l{n}_b_hh,
    as in the JAX package, so weights copy across by name."""

    def __init__(self, input_size: int, hidden_size: int, n_layers: int,
                 dropout_rate: float = 0.0, dtype: Dtype = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        H = hidden_size
        for layer in range(n_layers):
            in_dim = input_size if layer == 0 else H
            self.register_parameter(
                f"l{layer}_w_ih", nn.Parameter(torch.zeros(3 * H, in_dim)))
            self.register_parameter(
                f"l{layer}_w_hh", nn.Parameter(torch.zeros(3 * H, H)))
            self.register_parameter(
                f"l{layer}_b_ih", nn.Parameter(torch.zeros(3 * H)))
            self.register_parameter(
                f"l{layer}_b_hh", nn.Parameter(torch.zeros(3 * H)))

    def layer_weights(self, layer: int) -> Tuple[torch.Tensor, ...]:
        """(w_ih, w_hh, b_ih, b_hh) of one layer."""
        return tuple(getattr(self, f"l{layer}_{n}")
                     for n in ("w_ih", "w_hh", "b_ih", "b_hh"))

    def forward(self, x: torch.Tensor, h: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        outs = x
        new_h = []
        for layer in range(self.n_layers):
            outs = gru_cell(outs, h[layer], *self.layer_weights(layer),
                            dtype=self.dtype)
            new_h.append(outs)
            if layer < self.n_layers - 1:
                outs = dropout(outs, self.dropout_rate, self.training)
        return outs, torch.stack(new_h, dim=0)


def _input_projection(xs: torch.Tensor, w_ih: torch.Tensor,
                      b_ih: torch.Tensor) -> torch.Tensor:
    """xs (T, B, in) -> x_proj = xs @ w_ih^T + b_ih (T, B, 3H)."""
    T, B, _ = xs.shape
    return torch.addmm(b_ih, xs.reshape(T * B, -1), w_ih.t()).reshape(
        T, B, -1)


def gru_layer(xs: torch.Tensor, h0: torch.Tensor, w_ih: torch.Tensor,
              w_hh: torch.Tensor, b_ih: torch.Tensor, b_hh: torch.Tensor,
              reverse: bool = False, dtype: Dtype = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One GRU layer over a sequence: xs (T, B, in) time-major, h0 (B, H)
    -> (outputs (T, B, H), last hidden (B, H)). reverse walks the last
    step first; outputs stay at their time positions and the last hidden
    is the state after t = 0."""
    xs, h0, w_ih, w_hh, b_ih, b_hh = cast_gru(dtype, xs, h0, w_ih, w_hh,
                                              b_ih, b_hh)
    return gru_sequence(_input_projection(xs, w_ih, b_ih), h0.contiguous(),
                        w_hh, b_hh, reverse)


class GRU(nn.Module):
    """Multi-layer unidirectional GRU (torch.nn.GRU semantics; the JAX
    package's `models/gru.GRU`, same parameter names l{n}_w_ih / w_hh /
    b_ih / b_hh): xs (T, B, in) time-major, h0 (layers, B, H) or None
    (zeros) -> (outputs (T, B, H), hidden (layers, B, H)). Each layer is
    one `gru_layer` (`gru_sequence`, through `GRUSequenceFn` when a
    gradient is needed); in training dropout acts on the outputs of every
    layer but the last."""

    def __init__(self, input_size: int, hidden_size: int, n_layers: int = 1,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        self.dropout_rate = dropout_rate
        H = hidden_size
        for layer in range(n_layers):
            in_dim = input_size if layer == 0 else H
            for name, shape in (("w_ih", (3 * H, in_dim)),
                                ("w_hh", (3 * H, H)), ("b_ih", (3 * H,)),
                                ("b_hh", (3 * H,))):
                self.register_parameter(f"l{layer}_{name}",
                                        nn.Parameter(torch.zeros(shape)))

    def forward(self, xs: torch.Tensor, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if h0 is None:
            h0 = xs.new_zeros((self.n_layers, xs.shape[1], self.hidden_size))
        outs, h_finals = xs, []
        for layer in range(self.n_layers):
            outs, h_last = gru_layer(outs, h0[layer], *(
                getattr(self, f"l{layer}_{n}")
                for n in ("w_ih", "w_hh", "b_ih", "b_hh")))
            h_finals.append(h_last)
            if layer < self.n_layers - 1:
                outs = dropout(outs, self.dropout_rate, self.training,
                               batch_dim=1)
        return outs, torch.stack(h_finals, dim=0)


class BiGRU(nn.Module):
    """Multi-layer bidirectional GRU (torch.nn.GRU bidirectional=True
    semantics). Parameters are named l{n}_w_ih[_reverse] etc., as in the
    JAX package. Each layer's two directions read the concatenated (2H)
    outputs of the layer below. The returned hidden is (2 * layers, B, H)
    ordered [l0_fwd, l0_bwd, l1_fwd, l1_bwd, ...]; outputs are (T, B, 2H).
    use_kernel=False runs the plain recurrence on any device. dtype as in
    `gru_layer`.
    """

    def __init__(self, input_size: int, hidden_size: int, n_layers: int,
                 dropout_rate: float = 0.0, dtype: Dtype = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.use_kernel = True
        H = hidden_size
        for layer in range(n_layers):
            in_dim = input_size if layer == 0 else 2 * H
            for sfx in ("", "_reverse"):
                for name, shape in ((f"w_ih{sfx}", (3 * H, in_dim)),
                                    (f"w_hh{sfx}", (3 * H, H)),
                                    (f"b_ih{sfx}", (3 * H,)),
                                    (f"b_hh{sfx}", (3 * H,))):
                    self.register_parameter(
                        f"l{layer}_{name}", nn.Parameter(torch.zeros(shape)))

    def layer_weights(self, layer: int, reverse: bool
                      ) -> Tuple[torch.Tensor, ...]:
        sfx = "_reverse" if reverse else ""
        return tuple(getattr(self, f"l{layer}_{n}{sfx}")
                     for n in ("w_ih", "w_hh", "b_ih", "b_hh"))

    def forward(self, xs: torch.Tensor, n_run: Optional[int] = None,
                lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """xs (T, B, in), every state starting from zeros. n_run runs only
        the first n_run layers (the hidden of the rest is not computed and
        not returned). lengths (B,) runs each layer as `masked_gru_layer`
        over padded sequences."""
        n_run = self.n_layers if n_run is None else n_run
        recurrence = gru_sequence if self.use_kernel else gru_sequence_plain
        xs, = cast_gru(self.dtype, xs)
        h0 = xs.new_zeros((xs.shape[1], self.hidden_size))
        outs, h_finals = xs, []
        for layer in range(n_run):
            ys = []
            for reverse in (False, True):
                w_ih, w_hh, b_ih, b_hh = cast_gru(
                    self.dtype, *self.layer_weights(layer, reverse))
                if lengths is None:
                    y, h_last = recurrence(
                        _input_projection(outs, w_ih, b_ih), h0, w_hh, b_hh,
                        reverse)
                else:
                    y, h_last = masked_gru_layer(
                        outs, lengths, h0, w_ih, w_hh, b_ih, b_hh, reverse,
                        self.use_kernel)
                ys.append(y)
                h_finals.append(h_last)
            outs = torch.cat(ys, dim=-1)
            if layer < self.n_layers - 1:
                outs = dropout(outs, self.dropout_rate, self.training,
                               batch_dim=1)
        return outs, torch.stack(h_finals, dim=0)


def reverse_padded(xs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each sequence within its own length: xs (T, B, D), lengths
    (B,) -> out[t, b] = xs[lengths[b] - 1 - t, b], zero at t >= lengths[b]
    (the JAX package's `_reverse_padded`)."""
    T = xs.shape[0]
    src = lengths[None, :] - 1 - torch.arange(T, device=xs.device)[:, None]
    valid = src >= 0
    src = src.clamp(0, T - 1)
    gathered = torch.gather(xs, 0, src[:, :, None].expand(-1, -1,
                                                          xs.shape[2]))
    return torch.where(valid[:, :, None], gathered, gathered.new_zeros(()))


def masked_gru_layer(xs: torch.Tensor, lengths: torch.Tensor,
                     h0: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                     b_ih: torch.Tensor, b_hh: torch.Tensor,
                     reverse: bool = False, use_kernel: bool = True,
                     dtype: Dtype = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One GRU layer over padded sequences: xs (T, B, in), lengths (B,),
    h0 (B, H) -> (outputs (T, B, H), zero at t >= length; last hidden
    (B, H), the state after each sequence's last valid step, h0 where the
    length is 0). reverse reads each sequence from its last valid step."""
    lengths = lengths.long()
    if reverse:
        xs = reverse_padded(xs, lengths)
    xs, h0, w_ih, w_hh, b_ih, b_hh = cast_gru(dtype, xs, h0, w_ih, w_hh,
                                              b_ih, b_hh)
    recurrence = gru_sequence if use_kernel else gru_sequence_plain
    ys, _ = recurrence(_input_projection(xs, w_ih, b_ih), h0.contiguous(),
                       w_hh, b_hh, False)
    T, B, _ = ys.shape
    last = ys[(lengths - 1).clamp(min=0), torch.arange(B, device=ys.device)]
    h_last = torch.where((lengths > 0)[:, None], last, h0)
    valid = torch.arange(T, device=ys.device)[:, None] < lengths[None, :]
    ys = torch.where(valid[:, :, None], ys, ys.new_zeros(()))
    if reverse:
        ys = reverse_padded(ys, lengths)
    return ys, h_last


class MaskedBiGRU(BiGRU):
    """BiGRU over padded sequences with lengths (the JAX package's
    MaskedBiGRU, same parameter names): 2 recurrences a layer, each one
    `gru_sequence` launch on the card."""

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """xs (T, B, in), lengths (B,) -> (outputs (T, B, 2H), hidden
        (2 * layers, B, H) ordered [l0_fwd, l0_bwd, l1_fwd, ...])."""
        return super().forward(xs, lengths=lengths)
