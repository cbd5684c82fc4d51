"""The audio-context Part d: speech -> gesture tokens.

Port of the JAX package's `models/audio2token.py`. The encoder is
`models/audio.AudioContextEncoder` (fusion "audio": one-second mel chunks)
or `AudioTextFusionEncoder` (fusion "both": word ids and one-second raw
chunks); the decoder is the text model's `TokenDecoderStep`, and the
decode is the text model's: `models/text2token.decode_tokens_impl`
(greedy, sampled on caller-given Gumbel noise, the stage heads with or
without the chain, teacher-forced in training) and `beam_decode_impl`.
The encoder outputs are attended to at every position (no mask). The
decoder-initial hidden is the encoder's first n_layers hidden rows, as
`Text2Token.encode_text` takes them.

Training mode (`.train()`, dropout inside
`models/layers.dropout_generator`) is the JAX package's train=True:
dropout between the encoder BiGRU's layers and in the decoder, BatchNorm
on batch statistics (the encoder's convs and the decoder's pre_bn).

compute_dtype=torch.bfloat16 (the JAX package's bf16 mode) runs the
encoder's BiGRU (the bf16 GRU kernel on the card) and the decoder step in
bf16 (`models/text2token`); the wav encoders, the attention, the encoder's
outputs and the logits stay fp32, as in JAX.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from gesture2vec_tpu_torch.models.audio import (AudioContextEncoder,
                                               AudioTextFusionEncoder)
from gesture2vec_tpu_torch.models.layers import Dtype
from gesture2vec_tpu_torch.models.text2token import (TokenDecoderStep,
                                                     beam_decode_impl,
                                                     decode_tokens_impl)

EncoderInputs = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


class Audio2Token(nn.Module):
    """Speech windows -> n_steps gesture tokens (and residual-stage
    codes)."""

    def __init__(self, n_tokens: int, hidden_size: int, n_layers: int,
                 n_steps: int, n_pre_poses: int = 2,
                 use_attention: bool = True, fusion: str = "audio",
                 n_words: int = 0, embed_size: int = 300,
                 token_stages: int = 1, stage_conditional: bool = False,
                 dropout_rate: float = 0.2, compute_dtype: Dtype = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.n_tokens = n_tokens
        self.n_layers = n_layers
        self.n_steps = n_steps
        self.n_pre_poses = n_pre_poses
        self.fusion = fusion
        self.token_stages = token_stages
        self.stage_conditional = stage_conditional and token_stages > 1
        if fusion == "both":
            if n_words <= 0:
                raise ValueError("audio_fusion='both' needs n_words > 0")
            self.encoder = AudioTextFusionEncoder(
                n_words, hidden_size, embed_size, n_layers, dropout_rate,
                dtype=compute_dtype)
        elif fusion == "audio":
            self.encoder = AudioContextEncoder(hidden_size, n_layers,
                                               dropout_rate,
                                               dtype=compute_dtype)
        else:
            raise ValueError(f"unknown fusion {fusion!r}")
        self.decoder_step = TokenDecoderStep(
            hidden_size, n_tokens, n_layers, use_attention,
            n_stage_heads=token_stages - 1,
            stage_conditional=stage_conditional, dropout_rate=dropout_rate,
            dtype=compute_dtype)

    @property
    def n_pre(self) -> int:
        """Teacher steps a window takes from its seed: the last n_pre
        tokens of a window seed the next one."""
        return self.n_pre_poses

    @property
    def decode_positions(self) -> Tuple[int, int]:
        """(positions the decoder computes, positions the choices read) in
        one row of a window's eval decode: one GRU step a token, each
        read."""
        return self.n_steps - 1, self.n_steps - 1

    def set_use_kernels(self, on: bool) -> "Audio2Token":
        """Route the encoder BiGRU's recurrences through the Hopper kernel
        (True, the default) or its plain version."""
        self.encoder.gru.use_kernel = on
        return self

    def encode_audio(self, encoder_inputs: EncoderInputs
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """fusion "audio": mel chunks (B, S, 128, frames); "both": (word
        ids (B, T), raw chunks (B, S, samples)). Returns (encoder outputs
        (S or T, B, H), decoder-initial hidden (L, B, H))."""
        if self.fusion == "both":
            enc_outs, hidden = self.encoder(*encoder_inputs)
        else:
            enc_outs, hidden = self.encoder(encoder_inputs)
        return enc_outs, hidden[: self.n_layers]

    def decode_tokens(self, enc_outs: torch.Tensor, dec_hidden: torch.Tensor,
                      target_tokens: torch.Tensor,
                      enc_mask: Optional[torch.Tensor] = None,
                      **decode_kw) -> Dict[str, torch.Tensor]:
        """`decode_tokens_impl` on an audio encoding."""
        return decode_tokens_impl(self, enc_outs, dec_hidden, target_tokens,
                                  enc_mask, **decode_kw)

    def beam_decode(self, enc_outs: torch.Tensor, dec_hidden: torch.Tensor,
                    target_tokens: torch.Tensor, beam_width: int = 4,
                    enc_mask: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
        """`beam_decode_impl` on an audio encoding (eval only)."""
        return beam_decode_impl(self, enc_outs, dec_hidden, target_tokens,
                                beam_width, enc_mask)

    def forward(self, encoder_inputs: EncoderInputs,
                target_tokens: torch.Tensor, **decode_kw
                ) -> Dict[str, torch.Tensor]:
        """Encode + decode; target_tokens (B, n_steps), decode_kw as in
        decode_tokens_impl."""
        enc_outs, dec_hidden = self.encode_audio(encoder_inputs)
        return self.decode_tokens(enc_outs, dec_hidden, target_tokens,
                                  **decode_kw)
