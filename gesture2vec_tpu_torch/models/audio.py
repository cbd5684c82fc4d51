"""Audio encoders of the audio-context Part d.

Port of the JAX package's `models/audio.py`:
  WavEncoderRaw           strided convs over raw 16 kHz waveforms
                          (B, S) -> (B, T', 200);
  WavEncoderSpectral      one 1-second mel chunk (B, 128 mels, 32 frames)
                          -> (B, out_dim): convs over time with the
                          frequencies as channels, each ReLU then
                          BatchNorm, then flatten, `fc`, `fc_bn`, tanh;
  WavEncoderTri           one 1-second raw chunk (B, 16000) -> (B,
                          out_dim): convs 16/32/64/32 (kernel 15, strides
                          5/6/6/6, the first padded 1600), BatchNorm and
                          LeakyReLU(0.3) after the first three, flatten,
                          `out_layer` (480 inputs: 1 s at 16 kHz);
  AudioContextEncoder     mel chunks (B, S, 128, 32) -> the BiGRU's
                          outputs (S, B, H), directions summed, and its
                          hidden (2 * layers, B, H);
  AudioTextFusionEncoder  word ids (B, T) and 1-second raw chunks
                          (B, S, 16000): each word step t reads chunk
                          floor(t * S / T); the word embedding and that
                          chunk's WavEncoderTri features go through the
                          BiGRU (outputs (T, B, H), directions summed).
Layouts. flax convolves channels-last and flattens (B, T', C) with time
outer; here convs run channels-first (nn.Conv1d, weight (out, in, k)),
and the activations go back to (B, T', C) before the flatten, so a Dense
kernel carries across as it is. BatchNorm is the port's flax-semantics
`models/layers.BatchNorm` over (B * T', C): every axis but the channel.
The BiGRU is `models/gru.BiGRU`, so on the card its recurrences run the
GRU-sequence kernel (and under autograd its backward kernel).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gesture2vec_tpu_torch.models.gru import BiGRU
from gesture2vec_tpu_torch.models.layers import BatchNorm, Dtype

N_MELS = 128
# (channels out, kernel, stride, padding) of the raw-wave conv stacks
RAW_SPECS = ((16, 15, 5, 1600), (32, 15, 6, 0), (64, 15, 6, 0),
             (128, 20, 6, 0), (200, 15, 8, 0))
TRI_SPECS = ((16, 15, 5, 1600), (32, 15, 6, 0), (64, 15, 6, 0),
             (32, 15, 6, 0))
SPECTRAL_SPECS = ((32, 1, 1, 0), (16, 3, 2, 0), (8, 3, 2, 0))
LEAKY_SLOPE = 0.3


def conv_length(n: int, specs: Sequence[Tuple[int, int, int, int]]) -> int:
    """The time length after a conv stack."""
    for _, k, s, pad in specs:
        n = (n + 2 * pad - k) // s + 1
    return n


def batch_norm_last(bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm of a channels-last (B, T, C) tensor over B and T."""
    return bn(x.reshape(-1, x.shape[-1])).reshape(x.shape)


class _ConvStack(nn.Module):
    """Convs `conv{i}` over channels-last inputs; after each of the first
    `n_norm`, BatchNorm `bn{i}` then LeakyReLU(0.3) (norm_first), or ReLU
    then BatchNorm."""

    def __init__(self, in_ch: int, specs, n_norm: int, norm_first: bool):
        super().__init__()
        self.specs, self.n_norm, self.norm_first = specs, n_norm, norm_first
        for i, (ch, k, s, pad) in enumerate(specs):
            setattr(self, f"conv{i}", nn.Conv1d(in_ch, ch, k, s, pad))
            if i < n_norm:
                setattr(self, f"bn{i}", BatchNorm(ch))
            in_ch = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C_in) -> (B, T', C_out)."""
        for i in range(len(self.specs)):
            x = getattr(self, f"conv{i}")(x.transpose(1, 2)).transpose(1, 2)
            if i >= self.n_norm:
                continue
            bn = getattr(self, f"bn{i}")
            if self.norm_first:
                x = F.leaky_relu(batch_norm_last(bn, x), LEAKY_SLOPE)
            else:
                x = batch_norm_last(bn, torch.relu(x))
        return x


class WavEncoderRaw(nn.Module):
    """(B, samples) -> (B, T', 200)."""

    def __init__(self):
        super().__init__()
        self.convs = _ConvStack(1, RAW_SPECS, 3, norm_first=True)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return self.convs(wav[..., None])


class WavEncoderSpectral(nn.Module):
    """(B, 128 mels, frames) -> (B, out_dim)."""

    def __init__(self, out_dim: int = 200, n_frames: int = 32):
        super().__init__()
        self.convs = _ConvStack(N_MELS, SPECTRAL_SPECS, 3, norm_first=False)
        self.fc = nn.Linear(conv_length(n_frames, SPECTRAL_SPECS)
                            * SPECTRAL_SPECS[-1][0], out_dim)
        self.fc_bn = BatchNorm(out_dim)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.convs(mel.transpose(1, 2))             # (B, T', 8)
        return torch.tanh(self.fc_bn(self.fc(x.reshape(x.shape[0], -1))))


class WavEncoderTri(nn.Module):
    """(B, 16000) -> (B, out_dim)."""

    def __init__(self, out_dim: int = 200, samples: int = 16000):
        super().__init__()
        self.convs = _ConvStack(1, TRI_SPECS, 3, norm_first=True)
        self.out_layer = nn.Linear(conv_length(samples, TRI_SPECS)
                                   * TRI_SPECS[-1][0], out_dim)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = self.convs(wav[..., None])                   # (B, 15, 32)
        return self.out_layer(x.reshape(x.shape[0], -1))


def _summed(gru: BiGRU, seq: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The BiGRU's directions summed (in its dtype), then outputs and
    hidden as fp32, as the JAX encoders return them."""
    outs, hidden = gru(seq)
    H = gru.hidden_size
    return (outs[..., :H] + outs[..., H:]).float(), hidden.float()


class AudioContextEncoder(nn.Module):
    """Mel chunks (B, S, 128, frames) -> (outputs (S, B, H), hidden
    (2 * layers, B, H))."""

    def __init__(self, hidden_size: int, n_layers: int = 2,
                 dropout_rate: float = 0.0, n_frames: int = 32,
                 dtype: Dtype = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.wav_encoder = WavEncoderSpectral(hidden_size, n_frames)
        self.gru = BiGRU(hidden_size, hidden_size, n_layers, dropout_rate,
                         dtype=dtype)

    def forward(self, mel_chunks: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, S = mel_chunks.shape[:2]
        feats = self.wav_encoder(mel_chunks.flatten(0, 1))
        return _summed(self.gru, feats.reshape(B, S, -1).transpose(0, 1))


class AudioTextFusionEncoder(nn.Module):
    """(word_ids (B, T), raw chunks (B, S, samples)) -> (outputs (T, B,
    H), hidden (2 * layers, B, H))."""

    def __init__(self, n_words: int, hidden_size: int,
                 embed_size: int = 300, n_layers: int = 2,
                 dropout_rate: float = 0.0, samples: int = 16000,
                 dtype: Dtype = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.embedding = nn.Embedding(n_words, embed_size)
        self.wav_encoder = WavEncoderTri(hidden_size, samples)
        self.gru = BiGRU(embed_size + hidden_size, hidden_size, n_layers,
                         dropout_rate, dtype=dtype)

    def forward(self, word_ids: torch.Tensor, wav_chunks: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, S = wav_chunks.shape[:2]
        T = word_ids.shape[1]
        feats = self.wav_encoder(wav_chunks.flatten(0, 1)).reshape(B, S, -1)
        idx = torch.arange(T, device=word_ids.device) * S // T
        fused = torch.cat([self.embedding(word_ids), feats[:, idx]], dim=-1)
        return _summed(self.gru, fused.transpose(0, 1))
