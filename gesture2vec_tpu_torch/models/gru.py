"""GRUs: cells for the autoregressive decoders, and the sequence layer
and bidirectional stack of the tokenizer's encoder.

Gate math matches torch.nn.GRU and the JAX package's `models/gru.py`
(gate order r, z, n; separate input and hidden biases; weights in
torch layout (3H, in)):
    r = sigmoid(x W_ir^T + b_ir + h W_hr^T + b_hr)
    z = sigmoid(x W_iz^T + b_iz + h W_hz^T + b_hz)
    n = tanh(x W_in^T + b_in + r * (h W_hn^T + b_hn))
    h' = (1 - z) * n + z * h
`gru_layer` hoists the input projections of every step into one matmul
and runs the recurrence through `ops/gru_kernel.gru_sequence` (the
Hopper kernel on CUDA, its plain version on the CPU). The masked
bidirectional GRU (the text encoder's) is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from gesture2vec_tpu_torch.ops.gru_kernel import (gru_sequence,
                                                  gru_sequence_plain)


def gru_cell(x: torch.Tensor, h: torch.Tensor, w_ih: torch.Tensor,
             w_hh: torch.Tensor, b_ih: torch.Tensor,
             b_hh: torch.Tensor) -> torch.Tensor:
    """Single GRU step (B, in) x (B, H) -> (B, H)."""
    H = h.shape[-1]
    gi = torch.addmm(b_ih, x, w_ih.t())
    gh = torch.addmm(b_hh, h, w_hh.t())
    r = torch.sigmoid(gi[:, :H] + gh[:, :H])
    z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
    return (1.0 - z) * n + z * h


class GRUCellStack(nn.Module):
    """n_layers GRU cells for one timestep; hidden is (n_layers, B, H).
    Parameters are named l{n}_w_ih / l{n}_w_hh / l{n}_b_ih / l{n}_b_hh,
    as in the JAX package, so weights copy across by name."""

    def __init__(self, input_size: int, hidden_size: int, n_layers: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.n_layers = n_layers
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
            outs = gru_cell(outs, h[layer], *self.layer_weights(layer))
            new_h.append(outs)
        return outs, torch.stack(new_h, dim=0)


def _input_projection(xs: torch.Tensor, w_ih: torch.Tensor,
                      b_ih: torch.Tensor) -> torch.Tensor:
    """xs (T, B, in) -> x_proj = xs @ w_ih^T + b_ih (T, B, 3H)."""
    T, B, _ = xs.shape
    return torch.addmm(b_ih, xs.reshape(T * B, -1), w_ih.t()).reshape(
        T, B, -1)


def gru_layer(xs: torch.Tensor, h0: torch.Tensor, w_ih: torch.Tensor,
              w_hh: torch.Tensor, b_ih: torch.Tensor, b_hh: torch.Tensor,
              reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One GRU layer over a sequence: xs (T, B, in) time-major, h0 (B, H)
    -> (outputs (T, B, H), last hidden (B, H)). reverse walks the last
    step first; outputs stay at their time positions and the last hidden
    is the state after t = 0."""
    return gru_sequence(_input_projection(xs, w_ih, b_ih), h0.contiguous(),
                        w_hh, b_hh, reverse)


class BiGRU(nn.Module):
    """Multi-layer bidirectional GRU (torch.nn.GRU bidirectional=True
    semantics). Parameters are named l{n}_w_ih[_reverse] etc., as in the
    JAX package. Each layer's two directions read the concatenated (2H)
    outputs of the layer below. The returned hidden is (2 * layers, B, H)
    ordered [l0_fwd, l0_bwd, l1_fwd, l1_bwd, ...]; outputs are (T, B, 2H).
    use_kernel=False runs the plain recurrence on any device.
    """

    def __init__(self, input_size: int, hidden_size: int, n_layers: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.n_layers = n_layers
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

    def forward(self, xs: torch.Tensor, n_run: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """xs (T, B, in), every state starting from zeros. n_run runs only
        the first n_run layers (the hidden of the rest is not computed and
        not returned)."""
        n_run = self.n_layers if n_run is None else n_run
        recurrence = gru_sequence if self.use_kernel else gru_sequence_plain
        h0 = xs.new_zeros((xs.shape[1], self.hidden_size))
        outs, h_finals = xs, []
        for layer in range(n_run):
            ys = []
            for reverse in (False, True):
                w_ih, w_hh, b_ih, b_hh = self.layer_weights(layer, reverse)
                y, h_last = recurrence(_input_projection(outs, w_ih, b_ih),
                                       h0, w_hh, b_hh, reverse)
                ys.append(y)
                h_finals.append(h_last)
            outs = torch.cat(ys, dim=-1)
        return outs, torch.stack(h_finals, dim=0)
