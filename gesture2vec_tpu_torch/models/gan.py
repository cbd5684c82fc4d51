"""The text -> gesture GAN (the reference's experimental variant).

Port of the JAX package's `models/gan.py`:
  T2GGenerator     the text encoder (`models/text2token.TextEncoderRNN`,
                   masked BiGRU on `gru_sequence`); its first n_layers
                   hidden entries laid out batch-major and flattened to
                   (B, L*H), concatenated with a noise vector, through
                   `fuse` to (B, L*H), reshaped to (B, L, H) and put
                   layer-major as the decoder-initial hidden; then the
                   always-attention decoder step (`models/seq_ae.
                   DecoderStep`, no step dropout) from the seed pose,
                   each output fed back. Frame 0 is the seed.
  T2GDiscriminator the text encoder's last hidden entry and a pose
                   encoder (`pose_in`, then `models/gru.GRU`, run without
                   dropout as the JAX module calls it without `train`)'s
                   last layer, concatenated, through `head` (Dense ->
                   ReLU -> Dense: flax's nn.Sequential, whose parameters
                   are layers_0 and layers_2) to one real/fake logit.
The attention mask is positions below max(lengths), one for the batch
(`models/baseline.batch_mask`). The decoder's attention runs in plain
PyTorch: the chunk-decoder kernel has none. Parameter names are the JAX
modules'.
"""
from __future__ import annotations

import torch
from torch import nn

from gesture2vec_tpu_torch.models.baseline import batch_mask
from gesture2vec_tpu_torch.models.gru import GRU
from gesture2vec_tpu_torch.models.layers import Dense
from gesture2vec_tpu_torch.models.seq_ae import DecoderStep
from gesture2vec_tpu_torch.models.text2token import TextEncoderRNN


class T2GGenerator(nn.Module):
    """(tokens (B, S), lengths (B,), noise (B, noise_dim), seed_pose (B,
    pose_dim)) -> (B, n_frames, pose_dim)."""

    def __init__(self, n_words: int, pose_dim: int, n_frames: int,
                 hidden_size: int, n_layers: int, noise_dim: int = 200,
                 dropout_rate: float = 0.2, word_embed_size: int = 300):
        super().__init__()
        self.pose_dim = pose_dim
        self.n_frames = n_frames
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        self.noise_dim = noise_dim
        self.encoder = TextEncoderRNN(n_words, word_embed_size, hidden_size,
                                      n_layers, dropout_rate)
        self.fuse = Dense(n_layers * hidden_size + noise_dim,
                          n_layers * hidden_size)
        self.decoder_step = DecoderStep(
            pose_dim, hidden_size, n_layers, conditioned=True,
            dropout_rate=dropout_rate, use_attention=True, step_dropout=0.0)

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor,
                noise: torch.Tensor, seed_pose: torch.Tensor
                ) -> torch.Tensor:
        enc_outs, enc_hidden = self.encoder(tokens, lengths)
        B, L, H = tokens.shape[0], self.n_layers, self.hidden_size
        flat = enc_hidden[:L].transpose(0, 1).reshape(B, L * H)
        fused = self.fuse(torch.cat([flat, noise], dim=-1))
        hidden = fused.reshape(B, L, H).transpose(0, 1)
        mask = batch_mask(tokens, lengths)
        prev, outs = seed_pose, [seed_pose]
        for _ in range(self.n_frames - 1):
            prev, hidden = self.decoder_step(prev, hidden, enc_outs, mask)
            outs.append(prev)
        return torch.stack(outs, dim=1)


class T2GDiscriminator(nn.Module):
    """(tokens (B, S), lengths (B,), poses (B, T, pose_dim)) -> logits
    (B, 1)."""

    def __init__(self, n_words: int, pose_dim: int, hidden_size: int,
                 n_layers: int, dropout_rate: float = 0.2,
                 word_embed_size: int = 300):
        super().__init__()
        self.text_encoder = TextEncoderRNN(n_words, word_embed_size,
                                           hidden_size, n_layers,
                                           dropout_rate)
        self.pose_in = Dense(pose_dim, hidden_size)
        self.pose_gru = GRU(hidden_size, hidden_size, n_layers)
        self.head = nn.ModuleDict({"layers_0": Dense(2 * hidden_size,
                                                     hidden_size),
                                   "layers_2": Dense(hidden_size, 1)})

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor,
                poses: torch.Tensor) -> torch.Tensor:
        _, text_hidden = self.text_encoder(tokens, lengths)
        _, pose_hidden = self.pose_gru(self.pose_in(poses.transpose(0, 1)))
        feat = torch.cat([text_hidden[-1], pose_hidden[-1]], dim=-1)
        return self.head["layers_2"](torch.relu(self.head["layers_0"](feat)))
