"""Part b - the decoder side of the sequence VQ autoencoder (inference).

Port of the JAX package's `models/seq_ae.py` pieces that token -> motion
synthesis runs: Bahdanau attention (shared with the text->token
decoder), one decoder step (pre_linear -> BatchNorm (running stats) ->
ReLU -> GRU stack -> out_layer) and the generative rollout, plus the
token codebook. The encoder and the quantizer (the tokenizer sweep)
are not ported yet.

Every module here is inference-only: BatchNorm reads its running
statistics and no dropout is applied, which is the JAX package's eval
mode with `eval_step_dropout=False`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from gesture2vec_tpu_torch.models.gru import GRUCellStack


class Attn(nn.Module):
    """Bahdanau additive attention: hidden (B, H), encoder_outputs
    (T, B, H) -> weights (B, T). mask (T,) bool marks VALID positions;
    the rest are -inf'd out of the softmax."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.attn = nn.Linear(2 * hidden_size, hidden_size)
        self.v = nn.Parameter(torch.zeros(hidden_size))

    def forward(self, hidden: torch.Tensor, encoder_outputs: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        T = encoder_outputs.shape[0]
        h = hidden.unsqueeze(0).expand(T, -1, -1)              # (T, B, H)
        energy = torch.tanh(self.attn(torch.cat([h, encoder_outputs],
                                                dim=-1)))
        scores = (energy @ self.v).t()                         # (B, T)
        if mask is not None:
            scores = scores.masked_fill(~mask[None, :], float("-inf"))
        return torch.softmax(scores, dim=-1)


class DecoderStep(nn.Module):
    """One Part-b decoder timestep without attention: pre_linear ->
    BatchNorm -> ReLU -> GRU stack -> out_layer. conditioned=False
    zeroes the input, as the JAX module does."""

    def __init__(self, input_size: int, hidden_size: int, n_layers: int,
                 conditioned: bool = True):
        super().__init__()
        self.conditioned = conditioned
        self.pre_linear = nn.Linear(input_size, hidden_size)
        self.pre_bn = nn.BatchNorm1d(hidden_size, eps=1e-5)
        self.gru = GRUCellStack(hidden_size, hidden_size, n_layers)
        self.out_layer = nn.Linear(hidden_size, input_size)

    def forward(self, x: torch.Tensor, hidden: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if not self.conditioned:
            x = torch.zeros_like(x)
        h = torch.relu(self.pre_bn(self.pre_linear(x)))
        out, new_hidden = self.gru(h, hidden)
        return self.out_layer(out), new_hidden


class SeqDecoder(nn.Module):
    """The token -> latent-chunk half of the gesture tokenizer: the
    codebook (n_codes, n_layers * H) and the decoder step."""

    def __init__(self, rep_dim: int, hidden_size: int, n_layers: int,
                 n_frames: int, n_codes: int, n_pre_poses: int = 1,
                 conditioned: bool = True):
        super().__init__()
        self.rep_dim = rep_dim
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        self.n_frames = n_frames
        self.n_pre_poses = n_pre_poses
        self.conditioned = conditioned
        self.codebook = nn.Parameter(
            torch.zeros(n_codes, n_layers * hidden_size))
        self.decoder_step = DecoderStep(rep_dim, hidden_size, n_layers,
                                        conditioned)

    def token_hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """(N,) token ids -> (n_layers, N, H) decoder-initial hidden from
        the codebook rows."""
        flat = self.codebook[tokens]
        return flat.reshape(-1, self.n_layers,
                            self.hidden_size).transpose(0, 1)

    def rollout(self, dec_hidden: torch.Tensor, seed_frame: torch.Tensor,
                n_steps: Optional[int] = None) -> torch.Tensor:
        """Generative rollout: the seed frame (B, D) is the first input
        and is never emitted; each output feeds back as the next input.
        dec_hidden (L, B, H) -> (B, n_steps or n_frames, D)."""
        x, hidden = seed_frame, dec_hidden
        outs = []
        for _ in range(n_steps or self.n_frames):
            x, hidden = self.decoder_step(x, hidden)
            outs.append(x)
        return torch.stack(outs, dim=1)
