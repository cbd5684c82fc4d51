"""Part d - text to gesture-token translation (greedy inference).

Port of the JAX package's `models/text2token.py` for the decode path
that generation runs: the TCN text encoder, then an autoregressive
decoder step (token embedding -> Bahdanau attention -> pre_linear ->
BatchNorm -> ReLU -> GRU stack -> logits) for n_steps - 1 steps.

Step 0 is the seed: its logits are the seed's one-hot and its token is
the seed. The input at step t is the teacher token while
t - 1 < n_pre_poses, else the previous step's argmax (ties go to the
first index, as in jnp.argmax).

Not ported yet: the biGRU text encoder (encoder_type="gru"), sampled
and beam decodes, and residual-stage heads (token_stages > 1).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gesture2vec_tpu_torch.models.gru import GRUCellStack
from gesture2vec_tpu_torch.models.seq_ae import Attn
from gesture2vec_tpu_torch.models.tcn import TextEncoderTCN

# the later slice that ports each decode option (ROADMAP.md queue A)
_LATER = "not ported yet (the decode-policies slice of the PyTorch port)"


class TokenDecoderStep(nn.Module):
    """One decoder step over gesture tokens -> (logits (B, K) fp32,
    new hidden (L, B, H))."""

    def __init__(self, hidden_size: int, n_tokens: int, n_layers: int,
                 use_attention: bool = True):
        super().__init__()
        self.use_attention = use_attention
        self.token_embedding = nn.Embedding(n_tokens, hidden_size)
        in_dim = 2 * hidden_size if use_attention else hidden_size
        self.attn = Attn(hidden_size) if use_attention else None
        self.pre_linear = nn.Linear(in_dim, hidden_size)
        self.pre_bn = nn.BatchNorm1d(hidden_size, eps=1e-5)
        self.gru = GRUCellStack(hidden_size, hidden_size, n_layers)
        self.out_layer = nn.Linear(hidden_size, n_tokens)

    def forward(self, token: torch.Tensor, hidden: torch.Tensor,
                encoder_outputs: torch.Tensor,
                enc_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.token_embedding(token)                        # (B, H)
        if self.use_attention:
            w = self.attn(hidden[-1], encoder_outputs, mask=enc_mask)
            context = torch.einsum("bt,tbh->bh", w, encoder_outputs)
            x = torch.cat([x, context], dim=-1)
        h = torch.relu(self.pre_bn(self.pre_linear(x)))
        out, new_hidden = self.gru(h, hidden)
        return self.out_layer(out), new_hidden


class Text2Token(nn.Module):
    """Sentence -> n_steps gesture tokens."""

    def __init__(self, n_words: int, n_tokens: int, hidden_size: int,
                 n_layers: int, n_steps: int, n_pre_poses: int = 2,
                 word_embed_size: int = 300, encoder_type: str = "tcn",
                 use_attention: bool = True, token_stages: int = 1,
                 kernel_size: int = 2):
        super().__init__()
        if encoder_type != "tcn":
            raise NotImplementedError(
                f"encoder_type={encoder_type!r} is {_LATER}")
        if token_stages != 1:
            raise NotImplementedError(f"token_stages > 1 is {_LATER}")
        self.n_tokens = n_tokens
        self.n_layers = n_layers
        self.n_steps = n_steps
        self.n_pre_poses = n_pre_poses
        self.encoder = TextEncoderTCN(n_words, word_embed_size, hidden_size,
                                      n_layers, kernel_size)
        self.decoder_step = TokenDecoderStep(hidden_size, n_tokens, n_layers,
                                             use_attention)

    def encode_text(self, tokens: torch.Tensor, lengths: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, S) word ids -> (encoder outputs (S, B, H), decoder-initial
        hidden (L, B, H))."""
        enc_outs, hidden = self.encoder(tokens, lengths)
        return enc_outs, hidden[: self.n_layers]

    def decode_tokens(self, enc_outs: torch.Tensor, dec_hidden: torch.Tensor,
                      target_tokens: torch.Tensor,
                      enc_mask: Optional[torch.Tensor] = None,
                      temperature: float = 0.0, beam_width: int = 0
                      ) -> Dict[str, torch.Tensor]:
        """Greedy decode given a text encoding. target_tokens (B, n_steps)
        is the teacher signal (column 0 the seed). Returns "logits"
        (B, n_steps, K) and "tokens" (B, n_steps)."""
        if temperature > 0.0:
            raise NotImplementedError(f"sampled decode is {_LATER}")
        if beam_width > 1:
            raise NotImplementedError(f"beam search is {_LATER}")
        seed = target_tokens[:, 0]
        logits = [F.one_hot(seed, self.n_tokens).to(enc_outs.dtype)]
        tokens = [seed]
        prev, hidden = seed, dec_hidden
        for t in range(1, self.n_steps):
            token_in = (target_tokens[:, t - 1] if t - 1 < self.n_pre_poses
                        else prev)
            lg, hidden = self.decoder_step(token_in, hidden, enc_outs,
                                           enc_mask=enc_mask)
            prev = torch.argmax(lg, dim=-1)
            logits.append(lg)
            tokens.append(prev)
        return {"logits": torch.stack(logits, dim=1),
                "tokens": torch.stack(tokens, dim=1)}

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor,
                target_tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Encode + decode with the batch-max mask: attention only over
        positions < max(lengths), like the reference's packed-sequence
        trimming."""
        enc_outs, dec_hidden = self.encode_text(tokens, lengths)
        enc_mask = (torch.arange(tokens.shape[1], device=tokens.device)
                    < lengths.max())
        return self.decode_tokens(enc_outs, dec_hidden, target_tokens,
                                  enc_mask=enc_mask)
