"""GRU cells for the autoregressive decoders.

Gate math matches torch.nn.GRU and the JAX package's `models/gru.py`
(gate order r, z, n; separate input and hidden biases; weights in
torch layout (3H, in)):
    r = sigmoid(x W_ir^T + b_ir + h W_hr^T + b_hr)
    z = sigmoid(x W_iz^T + b_iz + h W_hz^T + b_hz)
    n = tanh(x W_in^T + b_in + r * (h W_hn^T + b_hn))
    h' = (1 - z) * n + z * h
The masked bidirectional GRU (the tokenizer's encoder) is not ported
yet.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


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
