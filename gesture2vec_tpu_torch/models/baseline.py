"""The baseline text -> pose regressor (Yoon-style Seq2SeqNet).

Port of the JAX package's `models/baseline.py`: the text encoder
(`models/text2token.TextEncoderRNN`, an embedding and the masked BiGRU,
directions summed; its recurrences run `gru_sequence` on the card) and an
always-attention decoder step (`models/seq_ae.DecoderStep` with
use_attention and no step dropout) that emits continuous pose frames.
The attention runs in plain PyTorch: the chunk-decoder kernel has none
(nor has the JAX package's).

The decoder-initial hidden is the encoder hidden's first n_layers
entries, [l0_fwd, l0_bwd] at 2 layers (the reference's quirk, kept). The
attention reads positions below max(lengths), one mask for the whole
batch, as the JAX module masks what torch's pad_packed_sequence trims.
Step t reads the target frame t - 1 while t - 1 < n_pre_poses (in eval
too) and the previous output after that; frame 0 of the output is the
seed, the target's frame 0.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from gesture2vec_tpu_torch.models.layers import batch_max
from gesture2vec_tpu_torch.models.seq_ae import DecoderStep
from gesture2vec_tpu_torch.models.text2token import TextEncoderRNN


def batch_mask(tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(S,) bool: the positions below the batch's longest sequence."""
    return torch.arange(tokens.shape[1], device=tokens.device) \
        < batch_max(lengths)


class Seq2SeqNet(nn.Module):
    """tokens (B, S), lengths (B,), poses (B, T, pose_dim) -> {"outputs"
    (B, n_frames, pose_dim)}. Parameter names are the JAX module's
    (`encoder`, `decoder_step`)."""

    def __init__(self, n_words: int, pose_dim: int, n_frames: int,
                 hidden_size: int, n_layers: int, n_pre_poses: int = 5,
                 dropout_rate: float = 0.3, word_embed_size: int = 300):
        super().__init__()
        self.pose_dim = pose_dim
        self.n_frames = n_frames
        self.n_layers = n_layers
        self.n_pre_poses = n_pre_poses
        self.encoder = TextEncoderRNN(n_words, word_embed_size, hidden_size,
                                      n_layers, dropout_rate)
        self.decoder_step = DecoderStep(
            pose_dim, hidden_size, n_layers, conditioned=True,
            dropout_rate=dropout_rate, use_attention=True, step_dropout=0.0)

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor,
                poses: torch.Tensor) -> Dict[str, torch.Tensor]:
        enc_outs, enc_hidden = self.encoder(tokens, lengths)
        hidden = enc_hidden[: self.n_layers]
        mask = batch_mask(tokens, lengths)
        prev = poses[:, 0]
        outs = [prev]
        for t in range(1, self.n_frames):
            x = poses[:, t - 1] if t - 1 < self.n_pre_poses else prev
            prev, hidden = self.decoder_step(x, hidden, enc_outs, mask)
            outs.append(prev)
        return {"outputs": torch.stack(outs, dim=1)}
